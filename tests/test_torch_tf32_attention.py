"""GCViT's f32-product window attention (``csrc/tf32_attention.cuh``:
``window_attention_f32`` and ``_mmf32`` as 3xTF32 mma.sync) and
``ln_qkv_mmbf16``'s TMA-staged f32 epilogue (``csrc/hopper_gemm.cuh``:
``ln_qkv_tma_kernel``), without a card.

- The attention's arithmetic emulated in PyTorch: q, k, P and v split into
  TF32 hi / lo (``tf32_split``), three products a step, small terms first,
  in the kernel's order and padding (rows to 16, keys to 8; the scores' k8
  steps over its dimension order, P.V's over 8-key tiles), each product
  added to the f32 accumulator rounded toward zero (the tensor cores' f32
  sums), P divided by its row sum after P.V. It is held against
  ``window_attention_plain`` in f32 within the card tests' 1e-5 of max|ref|
  at N = 9, 49 and 196, local and global query, and under ``_mmf32`` (bf16
  output) within the mixed modes' 1e-2.
- The kernel's fragment addressing emulated in numpy lane by lane: the
  shared-memory rows (128 bytes, chunk c of row r at c ^ (r % 8)), the q and
  k fragments over the permuted dimensions, the score accumulators handed
  to P.V as its A fragment unshuffled (keys 2t, 2t + 1 as slots t, t + 4),
  V's B fragment in the same key order, the outputs' dimensions; each
  quarter warp's 16-byte reads conflict free.
- The f32 output tile of ``ln_qkv_mmbf16``: every element written once at
  the TMA store's swizzled address, each half warp's 8-byte writes on 32
  different banks.
- The plans: the attention's CTA and ``mlp_gemm_plan("qkv_tma")`` fit a
  block's 232,448 bytes at GCViTTiny's L1-L4 with two stages or more.
"""
import math

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G
from vip_cup_2022_tpu_torch.ops.kernels.tf32 import tf32_split

F32_BOUND = 1e-5  # the card tests' gate for f32 outputs of f32 products
MIXED_BOUND = 1e-2  # for bf16 outputs
GCVIT_LEVELS = {"L1": (64, 49), "L2": (128, 49), "L3": (256, 196), "L4": (512, 49)}  # C, N


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------
def _rz(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _mma3(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc += a b as the kernel's three TF32 products of one k8 step (a_lo
    b_hi, a_hi b_lo, a_hi b_hi), each exact and added to the f32
    accumulator rounded toward zero."""
    (ah, al), (bh, bl) = tf32_split(a.contiguous()), tf32_split(b.contiguous())
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        acc = _rz(acc.double() + x.double() @ y.double())
    return acc


# the scores' k8 step kk takes dimensions 8t + 2kk and 8t + 2kk + 1 (t = 0 ... 3)
SCORE_STEPS = [[8 * t + 2 * kk + e for t in range(4) for e in (0, 1)] for kk in range(4)]


def emulate_tf32_attention(q, k, v, bias, n, scale, q_is_global=False,
                           out_dtype=torch.float32) -> torch.Tensor:
    """The f32-product kernel's arithmetic on (B, nWin*N, C) token rows."""
    b, toks, c = k.shape
    heads = bias.shape[0]
    nwin = toks // n
    rows, keys = -(-n // 16) * 16, -(-n // 8) * 8

    def items(t):  # -> (B, nWin, heads, N, 32)
        return t.float().reshape(b, -1, n, heads, 32).transpose(2, 3)

    qi = (items(q) * scale).expand(b, nwin, heads, n, 32)  # q times the scale in f32
    qp = torch.zeros(b, nwin, heads, rows, 32)
    qp[..., :n, :] = qi
    kp, vp = torch.zeros(b, nwin, heads, keys, 32), torch.zeros(b, nwin, heads, keys, 32)
    kp[..., :n, :], vp[..., :n, :] = items(k), items(v)
    s = torch.zeros(b, nwin, heads, rows, keys)
    for dims in SCORE_STEPS:
        s = _mma3(s, qp[..., dims], kp[..., dims].transpose(-1, -2))
    bp = torch.zeros(heads, rows, keys)
    bp[:, :n, :n] = bias.float()
    s = s + bp  # in f32, after q k^T
    s[..., n:] = -math.inf
    m = s.amax(-1, keepdim=True)
    p = torch.exp2((s - m) * 1.4426950408889634)
    lsum = p.sum(-1, keepdim=True)
    o = torch.zeros(b, nwin, heads, rows, 32)
    for j in range(keys // 8):
        o = _mma3(o, p[..., 8 * j:8 * j + 8], vp[..., 8 * j:8 * j + 8, :])
    o = (o / lsum)[..., :n, :]
    return o.transpose(2, 3).reshape(b, toks, c).to(out_dtype)


def _attention_inputs(n, heads, nwin, b, global_query, seed):
    rng = np.random.RandomState(seed)
    c = heads * 32
    u = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))  # noqa: E731
    k, v = u(b, nwin * n, c), u(b, nwin * n, c)
    q = u(b, n, c) if global_query else u(b, nwin * n, c)
    return q, k, v, u(heads, n, n)


def _rel(a, ref):
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("n,heads,nwin,b", [(9, 1, 4, 1), (49, 2, 3, 2), (196, 2, 1, 2)])
@pytest.mark.parametrize("global_query", [False, True])
def test_tf32_attention_arithmetic_holds_the_f32_bound(n, heads, nwin, b, global_query):
    """3xTF32 products in the kernel's order and padding, the accumulators
    rounded toward zero, P.V divided by the row sum after: within 1e-5 of
    max|ref| of the f32 plain version (softmax before P.V)."""
    q, k, v, bias = _attention_inputs(n, heads, nwin, b, global_query, seed=n + global_query)
    scale = 32 ** -0.5
    got = emulate_tf32_attention(q, k, v, bias, n, scale, global_query)
    ref = G.window_attention_plain(q, k, v, bias, n, scale, global_query)
    assert got.shape == ref.shape and _rel(got, ref) <= F32_BOUND


@pytest.mark.parametrize("n,heads,nwin,b", [(9, 1, 4, 1), (49, 2, 3, 2), (196, 2, 1, 2)])
@pytest.mark.parametrize("global_query", [False, True])
def test_tf32_attention_arithmetic_in_the_mixed_mode(n, heads, nwin, b, global_query):
    """``window_attention_mmf32``: f32 q (or a bf16 global query), f32 k and
    v, the output rounded once to bf16: within the mixed modes' 1e-2 of the
    plain version."""
    q, k, v, bias = _attention_inputs(n, heads, nwin, b, global_query, seed=3 * n + global_query)
    if global_query:
        q = q.to(torch.bfloat16)
    scale = 32 ** -0.5
    got = emulate_tf32_attention(q, k, v, bias, n, scale, global_query, torch.bfloat16)
    ref = G.window_attention_plain(q, k, v, bias, n, scale, global_query, torch.float32,
                                   torch.bfloat16)
    assert got.dtype == torch.bfloat16 and _rel(got, ref) <= MIXED_BOUND


def test_tf32_split_products_beat_one_tf32_product():
    """The third term matters: a single TF32 product of the same scores
    misses the f32 bound that three meet (so the emulation above tests the
    split, not a tolerance wide enough for anything)."""
    q, k, v, bias = _attention_inputs(196, 2, 1, 2, False, seed=5)
    scale = 32 ** -0.5
    ref = G.window_attention_plain(q, k, v, bias, 196, scale)
    hi = lambda t: tf32_split(t.contiguous())[0]  # noqa: E731
    one = G.window_attention_plain(hi(q * scale) / scale, hi(k), hi(v), bias, 196, scale)
    assert _rel(one, ref) > 10 * F32_BOUND


# ---------------------------------------------------------------------------
# the fragments, lane by lane (PTX mma.m16n8k8 .tf32 layouts)
# ---------------------------------------------------------------------------
def _a_pos(lane, i):  # A (16 x 8, row): register i of lane
    return (lane >> 2) + 8 * (i & 1), (lane & 3) + 4 * (i >> 1)


def _b_pos(lane, i):  # B (8 x 8, col): (k, n)
    return (lane & 3) + 4 * i, lane >> 2


def _c_pos(lane, i):  # C / D (16 x 8)
    return (lane >> 2) + 8 * (i >> 1), 2 * (lane & 3) + (i & 1)


def _mma_from_lanes(a_regs, b_regs) -> np.ndarray:
    """D = A B from the 32 lanes' A (4) and B (2) registers."""
    a, bm = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        for i in range(4):
            a[_a_pos(lane, i)] = a_regs[lane][i]
        for i in range(2):
            bm[_b_pos(lane, i)] = b_regs[lane][i]
    return a @ bm


def _chunk_offset(r, c):  # byte offset of 16-byte chunk c of a 128-byte row r
    return r * 128 + ((c ^ (r & 7)) << 4)


def _smem_rows(rows: np.ndarray) -> np.ndarray:
    """(R, 32) f32 rows laid out as the kernel's shared memory (f32 words)."""
    out = np.zeros(rows.shape[0] * 32)
    for r in range(rows.shape[0]):
        for c in range(8):
            w = _chunk_offset(r, c) // 4
            out[w:w + 4] = rows[r, 4 * c:4 * c + 4]
    return out


def _read4(smem, off):
    return smem[off // 4:off // 4 + 4]


def test_fragments_compute_both_products_without_a_shuffle():
    """One warp, one 16-row query tile, two 8-key tiles: the q and k
    fragments read as the kernel reads them give Q K^T; the score
    accumulators, taken as P.V's A fragment in the order (c0, c2, c1, c3),
    against V's B fragment read from rows 2t and 2t + 1 give P V, each lane
    then holding dimensions 8t ... 8t + 7 of its two rows."""
    rng = np.random.RandomState(0)
    q, kk_, v = rng.randn(16, 32), rng.randn(16, 32), rng.randn(16, 32)
    qs, ks, vs = _smem_rows(q), _smem_rows(kk_), _smem_rows(v)
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    # q fragments: dimensions 8t ... 8t + 7 of rows g and g + 8, two 16-byte reads a row
    qv = {lane: [np.concatenate([_read4(qs, _chunk_offset(r, 2 * t)),
                                 _read4(qs, _chunk_offset(r, 2 * t + 1))]) for r in (g, g + 8)]
          for lane, (g, t) in enumerate(lanes)}
    for j in range(2):  # key tiles
        acc = np.zeros((16, 8))
        for step in range(4):
            a = [[qv[lane][0][2 * step], qv[lane][1][2 * step], qv[lane][0][2 * step + 1],
                  qv[lane][1][2 * step + 1]] for lane in range(32)]
            b = []
            for lane, (g, t) in enumerate(lanes):
                kv = np.concatenate([_read4(ks, _chunk_offset(8 * j + g, 2 * t)),
                                     _read4(ks, _chunk_offset(8 * j + g, 2 * t + 1))])
                b.append([kv[2 * step], kv[2 * step + 1]])
            acc += _mma_from_lanes(a, b)
        np.testing.assert_allclose(acc, q @ kk_[8 * j:8 * j + 8].T, rtol=1e-12, atol=1e-12)
    out = np.zeros((4, 32, 4))  # n-tile jn, lane, register
    p = rng.rand(16, 16)  # any P: the test is the movement, not the softmax
    for j in range(2):
        # the lane's score registers hold P at the same positions
        s_regs = [[p[_c_pos(lane, i)[0], 8 * j + _c_pos(lane, i)[1]] for i in range(4)]
                  for lane in range(32)]
        a = [[r[0], r[2], r[1], r[3]] for r in s_regs]  # slot t: key 2t, slot t + 4: key 2t + 1
        for jn in range(4):
            b = []
            for lane, (g, t) in enumerate(lanes):
                va = _read4(vs, _chunk_offset(8 * j + 2 * t, g))
                vb = _read4(vs, _chunk_offset(8 * j + 2 * t + 1, g))
                b.append([va[jn], vb[jn]])
            d = _mma_from_lanes(a, b)
            for lane in range(32):
                for i in range(4):
                    out[jn, lane, i] += d[_c_pos(lane, i)]
    want = p @ v
    for lane, (g, t) in enumerate(lanes):
        for half, row in enumerate((g, g + 8)):
            got = [out[jn, lane, 2 * half] for jn in range(4)] + \
                  [out[jn, lane, 2 * half + 1] for jn in range(4)]
            np.testing.assert_allclose(got, want[row, 8 * t:8 * t + 8], rtol=1e-12, atol=1e-12)


def _chunk_positions(offsets):
    return [(o % 128) // 16 for o in offsets]


@pytest.mark.parametrize("j", [0, 1, 24])
def test_attention_fragment_reads_are_conflict_free(j):
    """Every 16-byte shared-memory read of the kernel (q rows g and g + 8,
    chunks 2t and 2t + 1; k row 8j + g, the same chunks; v rows 8j + 2t and
    8j + 2t + 1, chunk g): each quarter warp's 8 lanes hit 8 different chunk
    positions of the 128-byte bank window."""
    reads = {
        "q row g, chunk 2t": lambda g, t, w: _chunk_offset(16 * w + g, 2 * t),
        "q row g, chunk 2t + 1": lambda g, t, w: _chunk_offset(16 * w + g, 2 * t + 1),
        "q row g + 8, chunk 2t": lambda g, t, w: _chunk_offset(16 * w + g + 8, 2 * t),
        "k chunk 2t": lambda g, t, w: _chunk_offset(8 * j + g, 2 * t),
        "k chunk 2t + 1": lambda g, t, w: _chunk_offset(8 * j + g, 2 * t + 1),
        "v key 2t": lambda g, t, w: _chunk_offset(8 * j + 2 * t, g),
        "v key 2t + 1": lambda g, t, w: _chunk_offset(8 * j + 2 * t + 1, g),
    }
    for name, addr in reads.items():
        for warp in (0, 5):
            offsets = [addr(lane >> 2, lane & 3, warp) for lane in range(32)]
            for quarter in range(4):
                pos = _chunk_positions(offsets[8 * quarter:8 * quarter + 8])
                assert len(set(pos)) == 8, (name, warp, quarter, pos)


def test_bf16_global_query_rows_are_conflict_free():
    """A bf16 global query's 64-byte rows (unswizzled): lane (g, t) reads 16
    bytes at 64 g + 16 t, 8 different chunk positions a quarter warp."""
    for rows in ((0,), (8,)):
        offsets = [64 * ((lane >> 2) + rows[0]) + 16 * (lane & 3) for lane in range(32)]
        for quarter in range(4):
            assert len(set(_chunk_positions(offsets[8 * quarter:8 * quarter + 8]))) == 8


# ---------------------------------------------------------------------------
# ln_qkv_mmbf16's f32 output tile
# ---------------------------------------------------------------------------
def _stage32_offset(r, col):
    return r * 128 + ((((col >> 2) ^ (r & 7))) << 4) + ((col & 3) << 2)


def _tile_writes(bn):
    """stage_qkv_tile's writes: per instruction (box, step s, h), each lane's
    (row, column, byte address) for warp w of the warpgroup."""
    writes = []
    for w in range(4):
        for b in range(bn // 32):
            for s in range(4):
                for h in range(2):
                    ins = []
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        c = s ^ 2 if g & 1 else s
                        row, col = 16 * w + g + 8 * h, 8 * c + 2 * t
                        ins.append((row, 32 * b + col, b * 8192 + _stage32_offset(row, col)))
                    writes.append(ins)
    return writes


@pytest.mark.parametrize("bn", [32, 64])
def test_qkv_tile_writes_every_element_once_at_the_tma_address(bn):
    """Each of the 64 x bn f32 of a warpgroup's tile is written once, at the
    address the TMA store reads it from (boxes of 32 f32 x 64 rows, 128-byte
    swizzle: chunk c of row r at c ^ (r % 8)); a lane writes the two columns
    its accumulators hold (8 c8 + 2t and + 1 of rows g and g + 8)."""
    seen = {}
    for ins in _tile_writes(bn):
        for lane, (row, col, addr) in enumerate(ins):
            g, t = lane >> 2, lane & 3
            assert row % 8 == g and col % 8 == 2 * t
            for e in range(2):
                box = (col + e) // 32
                tma = box * 8192 + row * 128 + ((((col + e) % 32) // 4) ^ (row % 8)) * 16 + \
                    ((col + e) % 4) * 4
                assert addr + 4 * e == tma
                assert (row, col + e) not in seen
                seen[(row, col + e)] = addr + 4 * e
    assert len(seen) == 64 * bn and len(set(seen.values())) == 64 * bn


@pytest.mark.parametrize("bn", [32, 64])
def test_qkv_tile_writes_are_conflict_free(bn):
    """Each half warp's 16 8-byte writes land on 32 different banks (one
    wavefront a half warp); with the same n8 tile in every lane, rows g and
    g ^ 1 would share banks."""
    for ins in _tile_writes(bn):
        for half in range(2):
            banks = []
            for _, _, addr in ins[16 * half:16 * half + 16]:
                banks += [(addr // 4) % 32, (addr // 4 + 1) % 32]
            assert len(set(banks)) == 32
    naive = [_stage32_offset(g, 2 * (lane & 3)) for lane in range(16) for g in [lane >> 2]]
    banks = [(a // 4 + e) % 32 for a in naive for e in (0, 1)]
    assert len(set(banks)) < 32


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 9, 49, 64, 65, 196, 200, 201, 224])
def test_tf32_attention_plan_fits(n):
    """The attention's CTA: one warp a 16-row query tile, two stages of q, k
    and v (rows padded to 16 and 8), within a block's shared memory; its
    instantiation holds every key tile in registers."""
    plan = G.tf32_attention_plan(n)
    assert plan["smem"] <= K.SMEM_LIMIT and plan["stages"] >= 2
    assert plan["warps"] * 16 >= n > (plan["warps"] - 1) * 16
    assert plan["key_tiles"] * 8 >= n and plan["key_tiles"] <= plan["held_tiles"]
    assert plan["stage"] == (16 * plan["warps"] + 16 * plan["key_tiles"]) * 128


@pytest.mark.parametrize("level", sorted(GCVIT_LEVELS))
def test_tf32_attention_plan_at_gcvit_levels(level):
    """L1, L2, L4 (N = 49): 4 warps, 45 KB (four CTAs an SM fit); L3 (N =
    196): 13 warps, 25 key tiles (no padded tile), 152 KB."""
    _, n = GCVIT_LEVELS[level]
    plan = G.tf32_attention_plan(n)
    if n == 49:
        assert plan["warps"] == 4 and plan["held_tiles"] == 8 and 4 * plan["smem"] <= 232_448
    else:
        assert plan["warps"] == 13 and plan["key_tiles"] == plan["held_tiles"] == 25
        assert plan["smem"] == 155_648


def test_tf32_attention_plan_refuses_windows_past_224():
    with pytest.raises(ValueError, match="1 <= N <= 224"):
        G.tf32_attention_plan(225)


@pytest.mark.parametrize("c", [32, 64, 96, 128, 192, 256, 384, 512, 768])
@pytest.mark.parametrize("s", [2, 3])
def test_qkv_tma_plan_fits(c, s):
    """``ln_qkv_mmbf16``'s launch at every width: the "qkv_tma" plan, where
    there is one, keeps W_qkv resident beside two A tiles (or one) and the
    four warpgroups' f32 tiles within 232,448 bytes, every (column tile, K
    tile) a stage, column tiles that divide C and that the kernel is built
    for; the launch takes it where its column tile is the LN kernel's "qkv"
    plan's, else the LN kernel with that plan."""
    args, ln = K._qkv_tma_plan_args(c, s * c), K._ln_plan_args(c, s * c, "qkv")
    try:
        plan = K.mlp_gemm_plan("qkv_tma", c, s * c)
    except ValueError:
        assert args == (0, *ln)
        return
    assert args == ((1, plan["bn"], plan["stages"], plan["a_buffers"], 1, 0)
                    if plan["bn"] == ln[0] else (0, *ln))
    assert plan["smem"] <= K.SMEM_LIMIT and c % plan["bn"] == 0
    assert plan["bn"] in K.QKV_TMA_WIDTHS and plan["a_buffers"] in (1, 2) and plan["resident"]
    assert plan["stages"] == (s * c // plan["bn"]) * -(-c // 64)
    assert plan["tile"] == 64 * plan["bn"] * 4
    cpad = -(-c // 64) * 64
    assert plan["smem"] == (8 * (2 * plan["stages"] + 3) + 1024 + 4 * plan["tile"]
                            + plan["a_buffers"] * 128 * cpad * 2
                            + plan["stages"] * plan["bn"] * 128)


@pytest.mark.parametrize("level", sorted(GCVIT_LEVELS))
def test_qkv_tma_plan_at_gcvit_levels(level):
    """L1 on ``ln_qkv_tma_kernel`` (W_qkv resident, 64-column items as the
    LN kernel's, the f32 tiles in room of their own); L2 (where the tiles'
    room would narrow the items to 64 columns against the LN kernel's 128),
    L3 and L4 (W_qkv streams) on the LN kernel."""
    c, _ = GCVIT_LEVELS[level]
    for s in (2, 3):
        assert K._qkv_tma_plan_args(c, s * c)[:2] == ((1, 64) if c == 64 else (0, 128))


def test_qkv_tma_plan_rejects_widths_that_are_not_two_or_three_c():
    with pytest.raises(ValueError, match="2 or 3 x C"):
        K.mlp_gemm_plan("qkv_tma", 64, 256)


@pytest.mark.parametrize("m,c,s", [(5, 64, 3), (130, 96, 2)])
def test_ln_qkv_mmbf16_takes_the_plain_version_on_cpu(m, c, s):
    """f32 x and a bf16 W_qkv on the CPU: the plain version (f32 q, k, v),
    no launch counted."""
    rng = np.random.RandomState(m)
    x = torch.from_numpy(rng.uniform(-1, 1, (m, c)).astype(np.float32))
    lg, lb = torch.ones(c), torch.zeros(c)
    w = torch.from_numpy(rng.uniform(-0.1, 0.1, (s * c, c)).astype(np.float32)).to(torch.bfloat16)
    b = torch.zeros(s * c)
    G.reset_launches()
    got = G.ln_qkv(x, lg, lb, w, b, 1e-5, mm_dtype=torch.bfloat16)
    assert not any(G.LAUNCHES.values())
    for o, ref in zip(got, G.ln_qkv_plain(x, lg, lb, w, b, 1e-5, torch.bfloat16)):
        assert o.dtype == torch.float32 and torch.equal(o, ref)
