"""The tile plan of the kernels on the wgmma + TMA engine (``ln_fc1_gelu``,
``fc2_scale_residual`` and GCViT's ``ln_qkv`` and ``proj_scale_residual``)
and their CPU dispatch, without a card.

``mlp_gemm_plan`` picks, per shape, the column tile (a wgmma n), the TMA
ring's depth, the LN A buffers and whether fc1 stays resident in shared
memory; ``csrc/hopper_gemm.cuh`` checks the same limits before a launch. For
every shape of the main path (ConvNeXt s1-s4 at N = 4C, GCViTTiny L1-L4 at
N = 3C) and of the card tests (C = 32 ... 768, N = 3C and 4C), each plan must
fit a block's 227 KB of shared memory, use a width the kernels are built
for, and tile the output width exactly. On CPU tensors the wrappers run the
plain versions and count no launch.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G

MAIN_PATH = [(96, 384), (192, 768), (384, 1536), (768, 3072),  # ConvNeXt s1-s4
             (64, 192), (128, 384), (256, 768), (512, 1536)]  # GCViTTiny L1-L4
CARD_TESTS = [(c, r * c) for c in (32, 64, 96, 128, 192, 256, 384, 512, 768) for r in (3, 4)]
SHAPES = sorted(set(MAIN_PATH + CARD_TESTS))
QKV_WIDTHS = sorted({64, 128, 256, 512}  # GCViTTiny L1-L4
                    | {32, 64, 96, 128, 192, 256, 384, 512})  # the card tests


@pytest.mark.parametrize("c,n", SHAPES)
@pytest.mark.parametrize("kind", ["ln", "res"])
def test_plan_fits_and_tiles_exactly(kind, c, n):
    plan = K.mlp_gemm_plan(kind, c, n)
    assert plan["smem"] <= K.SMEM_LIMIT
    assert plan["bn"] in K.WGMMA_N and plan["bn"] in K.WIDTHS
    assert (n if kind == "ln" else c) % plan["bn"] == 0  # no column tile is ragged
    assert plan["bm"] == (K.BM // 2 if plan["split_n"] else K.BM)
    assert plan["swizzle"] == 128 and plan["ctas_per_sm"] == 1
    if plan["split_n"]:  # each warpgroup of a pair multiplies half the chunk's columns
        assert kind == "ln" and plan["bn"] in K.SPLIT_WIDTHS and plan["bn"] // 2 in K.WGMMA_N
    if plan["resident"]:  # every (N chunk, K tile) of fc1 has its own stage
        assert kind == "ln" and plan["stages"] == (n // plan["bn"]) * -(-c // 64)
        assert plan["stages"] <= K.MAX_RESIDENT
    else:
        assert 2 <= plan["stages"] <= K.MAX_RING
    assert plan["a_buffers"] in ((1, 2) if kind == "ln" else (0,))


@pytest.mark.parametrize("c,n", MAIN_PATH)
def test_plan_keeps_small_fc1_resident(c, n):
    """fc1 stays in shared memory where it fits (s1 96 KB padded, L1 24 KB,
    L2 96 KB), and streams elsewhere; only s4's 192 KB A tile needs the
    64-row, column-split tiles to leave the ring four stages."""
    plan = K.mlp_gemm_plan("ln", c, n)
    assert plan["resident"] == ((c, n) in [(96, 384), (64, 192), (128, 384)])
    assert plan["split_n"] == (c == 768)
    assert plan["resident"] or plan["stages"] >= 4


@pytest.mark.parametrize("kind,c,n", [("ln", 48, 192), ("res", 64, 200), ("ln", 0, 128),
                                      ("both", 64, 256)])
def test_plan_rejects_what_the_kernels_do_not_take(kind, c, n):
    with pytest.raises(ValueError):
        K.mlp_gemm_plan(kind, c, n)


@pytest.mark.parametrize("m,c,n", [(1, 32, 128), (37, 64, 192), (130, 96, 384)])
@pytest.mark.parametrize("f32_residual", [False, True])
def test_wrappers_take_the_plain_versions_on_cpu(m, c, n, f32_residual):
    rng = np.random.RandomState(m + c)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.uniform(-1, 1, shape) * scale).astype(np.float32))

    x, lg, lb, b1, b2, gamma = t(m, c), t(c) + 1, t(c, scale=0.1), t(n), t(c), t(c)
    w1, w2 = t(n, c, scale=c ** -0.5), t(c, n, scale=n ** -0.5)
    res = t(m, c) if f32_residual else t(m, c).to(torch.bfloat16)
    K.reset_launches()
    hid = K.ln_fc1_gelu(x, lg, lb, w1, b1, 1e-6)
    out = K.fc2_scale_residual(hid, w2, b2, gamma, res)
    assert K.LAUNCHES == {
        "dwconv7x7_nhwc": 0, "ln_fc1_gelu": 0, "fc2_scale_residual": 0,
        "dwconv7x7_nhwc_f32": 0, "ln_fc1_gelu_f32": 0, "fc2_scale_residual_f32": 0,
        "fc2_scale_residual_mmbf16": 0, "fc2_scale_residual_mmf32": 0}
    torch.testing.assert_close(hid, K.ln_fc1_gelu_plain(x, lg, lb, w1, b1, 1e-6), rtol=0, atol=0)
    torch.testing.assert_close(out, K.fc2_scale_residual_plain(hid, w2, b2, gamma, res), rtol=0,
                               atol=0)


@pytest.mark.parametrize("c", QKV_WIDTHS)
@pytest.mark.parametrize("s", [2, 3])
def test_qkv_plan_fits_and_keeps_each_tile_in_one_output(c, s):
    plan = K.mlp_gemm_plan("qkv", c, s * c)
    assert plan["kind"] == "qkv" and plan["smem"] <= K.SMEM_LIMIT
    assert plan["bn"] in K.WGMMA_N and plan["bn"] in K.WIDTHS
    assert c % plan["bn"] == 0  # a column tile never straddles two of q, k, v
    assert (s * c) % plan["bn"] == 0  # the S outputs are tiled exactly
    assert plan["bm"] == (K.BM // 2 if plan["split_n"] else K.BM)
    if plan["split_n"]:
        assert plan["bn"] in K.SPLIT_WIDTHS
    if plan["resident"]:
        assert plan["stages"] == (s * c // plan["bn"]) * -(-c // 64) <= K.MAX_RESIDENT
    else:
        assert 2 <= plan["stages"] <= K.MAX_RING
    assert plan["a_buffers"] in (1, 2)


@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_qkv_plan_at_gcvit_levels(c):
    """L1 and L2 keep W_qkv resident in shared memory (24 and 96 KB at S =
    3); L3 and L4 stream it through the ring in 128-row tiles, with four
    stages or more."""
    for s in (2, 3):
        plan = K.mlp_gemm_plan("qkv", c, s * c)
        assert plan["resident"] == (c <= 128) and not plan["split_n"]
        assert plan["resident"] or plan["stages"] >= 4


def test_qkv_plan_rejects_widths_that_are_not_two_or_three_c():
    with pytest.raises(ValueError, match="2 or 3"):
        K.mlp_gemm_plan("qkv", 64, 256)


@pytest.mark.parametrize("m,c,s", [(1, 32, 2), (37, 64, 3), (130, 128, 2)])
def test_ln_qkv_takes_the_plain_version_on_cpu(m, c, s):
    rng = np.random.RandomState(m + c + s)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.uniform(-1, 1, shape) * scale).astype(np.float32))

    x, lg, lb = t(m, c), t(c) + 1, t(c, scale=0.1)
    w, b = t(s * c, c, scale=c ** -0.5), t(s * c)
    G.reset_launches()
    got = G.ln_qkv(x, lg, lb, w, b, 1e-5)
    assert G.LAUNCHES == {"ln_qkv": 0, "window_attention": 0, "proj_scale_residual": 0,
                          "ln_qkv_f32": 0, "window_attention_f32": 0, "proj_scale_residual_f32": 0,
                          "ln_qkv_mmf32": 0, "window_attention_mmf32": 0,
                          "proj_scale_residual_mmf32": 0, "ln_qkv_mmbf16": 0,
                          "window_attention_mmbf16": 0, "proj_scale_residual_mmbf16": 0}
    assert len(got) == s and all(o.shape == (m, c) for o in got)
    for o, ref in zip(got, G.ln_qkv_plain(x, lg, lb, w, b, 1e-5)):
        torch.testing.assert_close(o, ref, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1, 5, 6, 32), (2, 9, 13, 96)])
def test_dwconv_takes_the_plain_version_on_cpu(shape):
    rng = np.random.RandomState(shape[-1])
    c = shape[-1]
    x = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(torch.bfloat16)
    taps = torch.from_numpy(rng.uniform(-0.2, 0.2, (7, 7, c)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-0.1, 0.1, (c,)).astype(np.float32))
    K.reset_launches()
    got = K.dwconv7x7_nhwc(x, taps, bias)
    assert K.LAUNCHES["dwconv7x7_nhwc"] == 0 and got.dtype == torch.float32
    torch.testing.assert_close(got, K.dwconv7x7_nhwc_plain(x, taps, bias), rtol=0, atol=0)


PROJ_WIDTHS = sorted({64, 128, 256, 512}  # GCViTTiny L1-L4
                     | {32, 64, 96, 128, 192, 256, 384, 512, 768})  # the card tests' and kAll's


@pytest.mark.parametrize("c", PROJ_WIDTHS)
def test_proj_plan_fits_and_tiles_c_exactly(c):
    """``proj_scale_residual``'s plan (K = C): a built wgmma width dividing
    C, 227 KB at most, and W_p held apart from the ring only where four A
    stages still fit beside it."""
    plan = K.mlp_gemm_plan("proj", c, c)
    assert plan["kind"] == "proj" and plan["smem"] <= K.SMEM_LIMIT
    assert plan["bn"] in K.WGMMA_N and plan["bn"] in K.WIDTHS and c % plan["bn"] == 0
    assert plan["bm"] == K.BM and not plan["split_n"] and plan["a_buffers"] == 0
    assert 2 <= plan["stages"] <= K.MAX_RING
    if plan["resident"]:  # every (column tile, K tile) of W_p, beside 4+ A-only stages
        assert plan["held"] == (c // plan["bn"]) * -(-c // 64) * plan["bn"] * 128  # K padded to 64
        assert plan["stages"] >= 4
    else:
        assert plan["held"] == 0


@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_proj_plan_at_gcvit_levels(c):
    """W_p stays in shared memory at L1-L3 (8, 32, 128 KB) and streams
    through the ring at L4 (512 KB)."""
    plan = K.mlp_gemm_plan("proj", c, c)
    assert plan["resident"] == (c <= 256)
    assert plan["bn"] == min(c, 128)


def test_proj_plan_rejects_k_other_than_c():
    with pytest.raises(ValueError, match="is not C"):
        K.mlp_gemm_plan("proj", 64, 128)


@pytest.mark.parametrize("m,c", [(1, 32), (37, 64), (130, 128)])
def test_proj_scale_residual_takes_the_plain_version_on_cpu(m, c):
    rng = np.random.RandomState(m + c)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.uniform(-1, 1, shape) * scale).astype(np.float32))

    a, x = t(m, c), t(m, c).to(torch.bfloat16)
    wp, bp, gamma = t(c, c, scale=c ** -0.5), t(c), t(c) + 1
    G.reset_launches()
    got = G.proj_scale_residual(a, wp, bp, gamma, x)
    assert G.LAUNCHES == {"ln_qkv": 0, "window_attention": 0, "proj_scale_residual": 0,
                          "ln_qkv_f32": 0, "window_attention_f32": 0, "proj_scale_residual_f32": 0,
                          "ln_qkv_mmf32": 0, "window_attention_mmf32": 0,
                          "proj_scale_residual_mmf32": 0, "ln_qkv_mmbf16": 0,
                          "window_attention_mmbf16": 0, "proj_scale_residual_mmbf16": 0}
    assert got.dtype == torch.float32 and got.shape == (m, c)
    torch.testing.assert_close(got, G.proj_scale_residual_plain(a, wp, bp, gamma, x), rtol=0,
                               atol=0)



# TTA's fold mode at tta = 2, 4 and 8 on the default batch 256: the rows of
# ConvNeXt's stage 1 (99 x 99 tokens an image) and GCViT's level 1 (56 x 56)
@pytest.mark.parametrize("m", [512 * 99 * 99, 1024 * 99 * 99, 2048 * 99 * 99, 2048 * 56 * 56,
                               K.MAX_ROWS])
def test_fold_mode_rows_fit_the_engine(m):
    K._check_rows(m)


def test_rows_past_32_bits_raise():
    """The launchers take M as a 32-bit int, which ctypes would wrap silently."""
    with pytest.raises(ValueError, match="more than the GEMM engine takes"):
        K._check_rows(K.MAX_ROWS + 1)


# ---------------------------------------------------------------------------
# the f32 residual GEMMs of VIPTPU_GCVIT_MM=bf16 (hopper_gemm.cuh: tma_res_kernel)
# ---------------------------------------------------------------------------
HOPPER_GEMM = pathlib.Path(K.__file__).resolve().parents[2] / "csrc" / "hopper_gemm.cuh"
KMAX_STAGES, KMAX_TX_BYTES, KALIGN = 64, (1 << 20) - 1, 1024  # hopper_gemm.cuh's limits
TMA_RES_SHAPES = ([("res_tma", c, r * c) for c in (64, 96, 128, 192, 256, 384, 512, 768)
                   for r in (3, 4)]
                  + [("proj_tma", c, c) for c in (32, 64, 96, 128, 192, 256, 384, 512, 768)])


def _launcher_stage(bn: int, a_bytes: int, resident: bool) -> int:
    """``tma_res_stage``: an A tile (128 rows x 64 K columns) and, streamed,
    a W tile (bn rows x 128 bytes); or a warpgroup's f32 tile (64 rows x bn),
    whichever is larger."""
    return max(128 * 64 * a_bytes + (0 if resident else bn * 128), 64 * bn * 4)


def _launcher_smem(bn: int, stages: int, a_bytes: int, resident: bool, c: int, k: int) -> int:
    """``tma_res_smem_bytes`` of the launcher, term by term: the ring's
    mbarriers (two a stage, two order, one held), the alignment slack, the
    held weight, the stages."""
    held = (c // bn) * -(-k // 64) * bn * 128 if resident else 0
    return (2 * stages + 3) * 8 + KALIGN + held + stages * _launcher_stage(bn, a_bytes, resident)


@pytest.mark.parametrize("kind,c,k", TMA_RES_SHAPES)
def test_tma_res_plan_fits_and_the_launcher_takes_it(kind, c, k):
    """fc2 at C = 64 ... 768 with K = 3C and 4C, proj at C = 32 ... 768 with
    K = C: a built column tile dividing C, 2 to MAX_RING stages each large
    enough for a warpgroup's f32 residual tile, the weight held only beside
    MIN_TMA_RES_STAGES stages, every buffer on a 1024-byte swizzle boundary,
    and the shared memory the launcher counts (the same bytes) within the
    card's 227 KB."""
    plan = K.mlp_gemm_plan(kind, c, k)
    bn, stages, a_bytes = plan["bn"], plan["stages"], 4 if kind == "proj_tma" else 2
    assert plan["kind"] == kind and plan["bm"] == K.BM and not plan["split_n"]
    assert bn in K.TMA_RES_BUILT[kind] and bn in K.WGMMA_N and c % bn == 0 and k % 32 == 0
    assert 2 <= stages <= min(K.MAX_RING, KMAX_STAGES)
    assert plan["tile"] == K.RES_TILE_ROWS * bn * 4 <= plan["stage"]
    assert plan["stage"] == _launcher_stage(bn, a_bytes, plan["resident"]) <= KMAX_TX_BYTES
    smem = _launcher_smem(bn, stages, a_bytes, plan["resident"], c, k)
    assert plan["smem"] == smem <= K.SMEM_LIMIT
    if plan["resident"]:
        assert stages >= K.MIN_TMA_RES_STAGES and 0 < plan["held"] <= KMAX_TX_BYTES
    else:  # a held weight would leave fewer stages than that
        assert plan["held"] == 0
        held = (c // bn) * -(-k // 64) * bn * 128
        room = K.SMEM_LIMIT - KALIGN - 24 - held
        assert room // (_launcher_stage(bn, a_bytes, True) + 16) < K.MIN_TMA_RES_STAGES
    for size in (plan["tile"], bn * 128, plan["stage"], plan["held"]):
        assert size % KALIGN == 0


@pytest.mark.parametrize("level", [(64, 64, True), (128, 128, True), (256, 128, False),
                                   (512, 128, False)], ids=["L1", "L2", "L3", "L4"])
def test_tma_res_plan_at_gcvit_levels(level):
    """GCViTTiny's levels: fc2's items 64 columns wide at L1 (C = 64), else
    128, proj's 64 at every level; W2 (3C x C) and W_p held at L1 and L2,
    streamed with A at L3 and L4; four ring stages or more."""
    c, fc2_bn, held = level
    for kind, k, bn in (("res_tma", 3 * c, fc2_bn), ("proj_tma", c, 64)):
        plan = K.mlp_gemm_plan(kind, c, k)
        assert plan["bn"] == bn and plan["resident"] == held
        assert plan["stages"] >= K.MIN_TMA_RES_STAGES


def test_tma_res_launcher_builds_the_plan_widths():
    """The column tiles ``launch_tma_res`` dispatches are TMA_RES_BUILT's:
    every one for the bf16 hidden, all but 128 for the f32 A; the main
    path's two (64, 128) are built without kAll (the cut library)."""
    src = HOPPER_GEMM.read_text()
    body = src[src.index("cudaError_t launch_tma_res("):]
    body = body[:body.index("\n}\n")]
    built = {int(w) for w in re.findall(r"launch_tma_res_bn<(\d+), TA, kCut>", body)}
    bf16_only = {int(w) for w in re.findall(
        r"if constexpr \(sizeof\(TA\) == 2\)\s+return launch_tma_res_bn<(\d+),", body)}
    assert built == set(K.TMA_RES_BUILT["res_tma"])
    assert built - bf16_only == set(K.TMA_RES_BUILT["proj_tma"]) and bf16_only == {128}
    main = body[:body.index("if constexpr (kAll)")]
    assert {int(w) for w in re.findall(r"launch_tma_res_bn<(\d+),", main)} == {64, 128}
    assert all(K.mlp_gemm_plan(kind, c, k)["bn"] in (64, 128)
               for kind, c, k in [("res_tma", c, 3 * c) for c in (64, 128, 256, 512)]
               + [("proj_tma", c, c) for c in (64, 128, 256, 512)])


@pytest.mark.parametrize("kind,c,k,widths", [
    ("res_tma", 64, 192, (96,)), ("proj_tma", 96, 96, (48,)), ("proj_tma", 128, 128, (128,)),
    ("proj_tma", 96, 64, None), ("res_tma", 48, 144, None)])
def test_tma_res_plan_refuses_tiles_the_kernels_do_not_take(kind, c, k, widths, monkeypatch):
    """No plan where no column tile of the kind divides C, where the tile
    that does is not built (48; 128 with f32 A), where proj's K is not C,
    or where C is not a multiple of 32."""
    if widths is not None:
        monkeypatch.setitem(K.TMA_RES_WIDTHS, kind, widths)
    with pytest.raises(ValueError):
        K.mlp_gemm_plan(kind, c, k)


def _tma_swizzled(a: np.ndarray) -> dict:
    """A box of f32 rows of 128 bytes as TMA's 128-byte swizzle lays it out
    in shared memory (the box 1024-byte aligned): 16-byte chunk c of row r at
    chunk c XOR r % 8. Byte offset -> value, one entry a 4-byte value."""
    smem = {}
    for r in range(a.shape[0]):
        for col in range(32):
            chunk, within = col // 4, 4 * (col % 4)
            smem[r * 128 + ((chunk ^ (r % 8)) * 16) + within] = a[r, col]
    return smem


def _pack_bf16(lo: float, hi: float) -> tuple:
    """A bf16 pair as the kernel packs it (round to nearest even)."""
    return tuple(torch.tensor([lo, hi], dtype=torch.float32).to(torch.bfloat16).tolist())


def test_f32_a_fragments_are_the_bf16_tile_a_wgmma_reads():
    """proj_scale_residual_mmbf16's A: a stage holds 128 rows x 64 K columns
    of f32 as two 128-byte TMA boxes (16 KB apart). Lane l of warp w of the
    warpgroup at row offset h0 (0 or 64) reads, for k16 step k, 8 bytes at
    chunks 4 (k % 2) + t / 2 and + 2 (half t % 2; t = l % 4) of rows r = h0 +
    16w + l / 4 and r + 8, swizzle XOR r % 8, of box k / 2, and rounds each
    pair to bf16 into the registers of wgmma's A fragment: a0 (r, 2t ...),
    a1 (r + 8, 2t ...), a2 (r, 2t + 8 ...), a3 (r + 8, 2t + 8 ...). The
    matrix those registers build is the stage's A rounded to bf16, and each
    8-byte read of a warp puts at most 32 bytes on a 16-byte bank group: two
    wavefronts, no conflict."""
    rng = np.random.RandomState(5)
    a = rng.uniform(-3, 3, (128, 64)).astype(np.float32)
    boxes = [_tma_swizzled(a[:, 32 * b:32 * b + 32]) for b in range(2)]
    want = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    got = np.full((128, 64), np.nan, dtype=np.float32)
    for h0 in (0, 64):
        for warp in range(4):
            for k in range(4):
                reads = {}
                for lane in range(32):
                    t, r = lane & 3, h0 + 16 * warp + (lane >> 2)
                    sw, c, off = r & 7, 4 * (k & 1) + (t >> 1), 8 * (t & 1)
                    lo, hi = ((c ^ sw) << 4) + off, (((c + 2) ^ sw) << 4) + off
                    box = boxes[k >> 1]

                    def pair(row, at):
                        return box[row * 128 + at], box[row * 128 + at + 4]

                    frags = [_pack_bf16(*pair(r, lo)), _pack_bf16(*pair(r + 8, lo)),
                             _pack_bf16(*pair(r, hi)), _pack_bf16(*pair(r + 8, hi))]
                    for reg, (row, col) in enumerate([(r, 2 * t), (r + 8, 2 * t),
                                                      (r, 2 * t + 8), (r + 8, 2 * t + 8)]):
                        got[row, 16 * k + col], got[row, 16 * k + col + 1] = frags[reg]
                    for name, at in (("lo", lo), ("hi", hi)):  # one LDS.64 a (row, chunk) pair
                        for row in (r, r + 8):
                            key = (name, row - r, ((row * 128 + at) % 128) // 16)
                            reads[key] = reads.get(key, 0) + 8
                for (name, dr, unit), nbytes in reads.items():
                    assert nbytes <= 32
    np.testing.assert_array_equal(got, want)


def test_residual_epilogue_addresses_the_tma_tile():
    """The f32 residual tile of a warpgroup: 64 rows x BN columns as BN / 32
    TMA boxes of 64 rows x 128 bytes (8 KB apart), 128-byte swizzle. Lane l
    of warp w holds accumulator d[4j + 2h + e] of row 16w + l / 4 + 8h,
    column 8j + 2 (l % 4) + e; ``scale_add_residual`` reads and writes it at
    box n / 32, ``stage32_offset(row, n % 32)`` (n = 8j + 2 (l % 4)): the
    byte TMA put (row, n) at, and each warp-wide 8-byte access puts at most
    32 bytes on a 16-byte bank group."""
    bn = 128
    tile = np.arange(64 * bn, dtype=np.float32).reshape(64, bn)
    smem = {}
    for b in range(bn // 32):
        for off, v in _tma_swizzled(tile[:, 32 * b:32 * b + 32]).items():
            smem[b * 64 * 128 + off] = v

    def stage32_offset(r, col):  # hopper_gemm.cuh
        return r * 128 + ((((col >> 2) ^ (r & 7))) << 4) + ((col & 3) << 2)

    seen = set()
    for warp in range(4):
        for j in range(bn // 8):
            for h in range(2):
                units = {}
                for lane in range(32):
                    n = 8 * j + 2 * (lane & 3)
                    row = 16 * warp + (lane >> 2) + 8 * h
                    addr = (n >> 5) * 64 * 128 + stage32_offset(row, n & 31)
                    assert (smem[addr], smem[addr + 4]) == (tile[row, n], tile[row, n + 1])
                    seen.update({(row, n), (row, n + 1)})
                    unit = (addr % 128) // 16
                    units[unit] = units.get(unit, 0) + 8
                assert max(units.values()) <= 32
    assert len(seen) == 64 * bn


@pytest.mark.parametrize("m,c", [(1, 32), (37, 64), (130, 96)])
def test_mmbf16_residual_gemms_take_the_plain_versions_on_cpu(m, c):
    """``fc2_scale_residual`` with a bf16 hidden and an f32 output and
    ``proj_scale_residual`` with f32 activations and bf16 GEMMs, on CPU
    tensors: their plain versions, no launch."""
    rng = np.random.RandomState(m * c)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.uniform(-1, 1, shape) * scale).astype(np.float32))

    hid, r1 = t(m, 3 * c).to(torch.bfloat16), t(m, c)
    w2, b2, gamma = t(c, 3 * c, scale=(3 * c) ** -0.5).to(torch.bfloat16), t(c), t(c) + 1
    a, x, wp = t(m, c), t(m, c), t(c, c, scale=c ** -0.5).to(torch.bfloat16)
    K.reset_launches()
    G.reset_launches()
    out = K.fc2_scale_residual(hid, w2, b2, gamma, r1, out_dtype=torch.float32)
    r = G.proj_scale_residual(a, wp, b2, gamma, x, mm_dtype=torch.bfloat16)
    assert not any(K.LAUNCHES.values()) and not any(G.LAUNCHES.values())
    torch.testing.assert_close(out, K.fc2_scale_residual_plain(hid, w2, b2, gamma, r1,
                                                               torch.float32), rtol=0, atol=0)
    torch.testing.assert_close(r, G.proj_scale_residual_plain(a, wp, b2, gamma, x,
                                                              torch.bfloat16), rtol=0, atol=0)
