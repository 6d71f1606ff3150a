"""GCViT's f32 qkv and proj GEMMs on the 3xTF32 engine: arithmetic and plan, on the CPU.

``ln_qkv_f32`` / ``ln_qkv_mmf32`` and ``proj_scale_residual_f32`` /
``_mmf32`` run on the tensor cores as TF32 products of split operands
(``csrc/tf32_gemm.cuh``, kinds kQkv and kResidual; the split of
``ops/kernels/tf32.py``). The kernels need the card
(``test_torch_tf32_qkv_proj_cuda.py`` holds them to their plain versions
there); here:

- the emulated 3xTF32 ``ln_qkv`` (LN, then ``tf32x3_linear``, then the
  split into q, k, v or k, v) against the JAX package's ``ln_dense`` in
  interpret mode, in f32 and in the ``_mmf32`` mode (bf16 x, f32 GEMM);
- the emulated projection and MLP against ``proj_res_ln_mlp`` in interpret
  mode (``VIPTPU_GELU=erf``), at narrow C and ragged M;
- every bf16 value exact in TF32 (``hi`` is the value, ``lo`` zero), so a
  bf16 A's two passes sum what three do;
- the order a lane reads its four bf16 values from the A tile under the
  64-byte swizzle, against ``permute_k``;
- the plan kinds "qkv" and "proj" at every GCViTTiny (M, K, N), and what
  they refuse;
- the blocks' split cache for ``attn.qkv`` and ``attn.proj``, the row slice
  of a pair, and the block passing its four pairs to the wrappers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_gcvit_kernels import _block_params, _u
from vip_cup_2022_tpu.ops.pallas.gcvit_block import ln_dense, proj_res_ln_mlp
from vip_cup_2022_tpu_torch.models import create_model
from vip_cup_2022_tpu_torch.models import gcvit as port_gcvit
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G
from vip_cup_2022_tpu_torch.ops.kernels import tf32

ATOL = 1e-4  # f32 on both sides, sums over K in another order (test_torch_tf32_mlp.py)
BF16_BOUND = 2.0 ** -8  # of max|ref|: JAX's _mmf32 q, k, v written in x's dtype, bf16
F32, BF16 = torch.float32, torch.bfloat16


def _t(a, dtype=F32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _ln(x, g, b, eps):
    """The kernels' two-pass f32 LN of rows."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps) * g + b


def _emulated_qkv(x, g, b, w, wb, eps):
    """LN -> 3xTF32 product + bias -> S (M, C) outputs; w (S C, C)."""
    o = tf32.tf32x3_linear(_ln(x, g, b, eps), w) + wb
    return o.chunk(w.shape[0] // x.shape[1], dim=-1)


@pytest.mark.parametrize("c,split,m,x_dtype", [
    (64, 3, 37, F32), (96, 2, 50, F32), (64, 3, 37, BF16), (64, 2, 21, BF16)])
def test_emulated_ln_qkv_matches_ln_dense(c, split, m, x_dtype):
    """f32 x against ``ln_dense`` in f32; bf16 x (the ``_mmf32`` mode: the
    f32 LN of the widened rows, the f32 GEMM) against ``ln_dense`` with
    ``force_mm_dtype=f32``, whose outputs JAX writes in bf16: within one bf16
    rounding."""
    rng = np.random.RandomState(c + split)
    x = _t(_u(rng, (m, c)), x_dtype)
    g, b = _u(rng, (c,), 0.5, 1.5), _u(rng, (c,), -0.1, 0.1)
    w, wb = _u(rng, (c, split * c)) * c ** -0.5, _u(rng, (split * c,), -0.1, 0.1)
    jx = jnp.asarray(x.float().numpy(), jnp.float32 if x_dtype == F32 else jnp.bfloat16)
    want = ln_dense(jx, g, b, jnp.asarray(w), wb, eps=1e-5, split=split,
                    force_mm_dtype=jnp.float32, interpret=True)
    got = _emulated_qkv(x, _t(g), _t(b), _t(w.T), _t(wb), 1e-5)
    assert len(got) == len(want) == split
    for part, ref in zip(got, want):
        ref = np.asarray(ref, np.float32)
        if x_dtype == F32:
            np.testing.assert_allclose(part.numpy(), ref, atol=ATOL)
        else:
            assert np.abs(part.numpy() - ref).max() <= BF16_BOUND * np.abs(ref).max()
    # the plain version (the f32 product, the kernels' gate) agrees with the emulation
    plain = G.ln_qkv_plain(x, _t(g), _t(b), _t(w.T), _t(wb), 1e-5, mm_dtype=F32)
    for part, ref in zip(got, plain):
        assert ref.dtype == F32
        np.testing.assert_allclose(part.numpy(), ref.numpy(), atol=ATOL)


@pytest.fixture
def erf_gelu(monkeypatch):
    monkeypatch.setenv("VIPTPU_GELU", "erf")


@pytest.mark.parametrize("c,m", [(64, 37), (96, 45)])
def test_emulated_proj_and_mlp_match_proj_res_ln_mlp(erf_gelu, c, m):
    """r1 = x + gamma1 (3xTF32 a Wp^T + bp), then LN2, the 3xTF32 MLP and
    gamma2 onto r1, against the JAX tail kernel in f32."""
    rng = np.random.RandomState(c + 1)
    p = _block_params(c, 3, 2, 4, rng)
    a, x = _u(rng, (m, c)), _u(rng, (m, c))
    want = proj_res_ln_mlp(jnp.asarray(a), jnp.asarray(x), p["wp"], p["bp"], p["gamma1"],
                           p["ln2_g"], p["ln2_b"], p["w1"], p["b1"], p["w2"], p["b2"],
                           p["gamma2"], eps=1e-5, gelu="erf", interpret=True)
    r1 = (tf32.tf32x3_linear(_t(a), _t(p["wp"].T)) + _t(p["bp"])) * _t(p["gamma1"]) + _t(x)
    y = _ln(r1, _t(p["ln2_g"]), _t(p["ln2_b"]), 1e-5)
    h = F.gelu(tf32.tf32x3_linear(y, _t(p["w1"].T)) + _t(p["b1"]), approximate="none")
    got = (tf32.tf32x3_linear(h, _t(p["w2"].T)) + _t(p["b2"])) * _t(p["gamma2"]) + r1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_every_bf16_value_is_exact_in_tf32():
    """All 65,536 bf16 patterns: ``hi`` is the widened value bit for bit
    (NaNs aside; the kernel takes the bits as they are, without a cvt) and
    ``lo`` is zero wherever the value is finite, so a bf16 A's product is
    a_hi w_lo + a_hi w_hi."""
    v = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(BF16).float()
    hi, lo = tf32.tf32_split(v)
    keep = ~torch.isnan(v)
    assert torch.equal(hi.view(torch.int32)[keep], v.view(torch.int32)[keep])
    finite = torch.isfinite(v)
    assert finite.sum() == (1 << 16) - 2 - 254  # two infinities, 254 NaN patterns
    assert not lo[finite].view(torch.int32).any()


def test_two_passes_of_a_bf16_a_equal_the_three_pass_emulation():
    rng = np.random.RandomState(5)
    a = _t(_u(rng, (40, 128)), BF16).float()
    w = _t(_u(rng, (96, 128)) * 128 ** -0.5)
    w_hi, w_lo = tf32.tf32_split(w)
    two = (a.double() @ w_lo.double().T + a.double() @ w_hi.double().T).float()
    assert torch.equal(two, tf32.tf32x3_linear(a, w))


def test_permute_k_is_the_order_a_lane_loads_from_the_bf16_tile():
    """The bf16 A tile (``_mmf32`` modes): rows of 32 bf16 (64 bytes) under
    TMA's 64-byte swizzle (16-byte chunk c of row r at chunk c XOR (r / 2) %
    4). Lane (warp w, lane l) of a warpgroup reads, for half tile p, the 8
    bytes at chunk 2p + t / 2, half t % 2 (t = l % 4) of rows r = 16w + l / 4
    and r + 8, and hands element 2h + e of them to k8 step 2p + e at fragment
    column t + 4h, as the f32 tile's 16-byte chunk 4p + t does: the matrix
    those positions build is permute_k of the tile. The reads of a warp touch
    each 16-byte bank group twice: two wavefronts for its 256 bytes."""
    a = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    row_bytes = 64
    smem = {}  # byte offset -> value (2 bytes each)
    for r in range(64):
        for c in range(32):
            byte = 2 * c
            chunk, within = byte // 16, byte % 16
            smem[r * row_bytes + ((chunk ^ ((r >> 1) & 3)) * 16) + within] = a[r, c]
    logical = torch.full((64, 32), -1.0)
    for warp in range(4):
        for p in range(2):
            banks = {}
            for lane in range(32):
                t, r0 = lane & 3, 16 * warp + (lane >> 2)
                sw = (r0 >> 1) & 3
                assert sw == ((r0 + 8) >> 1) & 3
                off = ((2 * p + (t >> 1)) ^ sw) * 16 + 8 * (t & 1)
                v0 = [smem[r0 * row_bytes + off + 2 * i] for i in range(4)]
                v1 = [smem[(r0 + 8) * row_bytes + off + 2 * i] for i in range(4)]
                unit = ((r0 * row_bytes + off) % 128) // 16
                banks[unit] = banks.get(unit, 0) + 1
                for e in range(2):
                    for row, k, val in ((r0, t, v0[e]), (r0 + 8, t, v1[e]),
                                        (r0, t + 4, v0[2 + e]), (r0 + 8, t + 4, v1[2 + e])):
                        logical[row, 8 * (2 * p + e) + k] = val
            assert max(banks.values()) <= 4  # 4 lanes (32 bytes) a 16-byte unit: two wavefronts
    assert torch.equal(logical, tf32.permute_k(a))


# GCViTTiny's levels at 224: (tokens a side, C)
LEVELS = {"L1": (56, 64), "L2": (28, 128), "L3": (14, 256), "L4": (7, 512)}
QKV_BN = {64: 64, 128: 128, 256: 128, 512: 64}  # column tiles dividing C; L4 promoted


@pytest.mark.parametrize("a_bytes", [4, 2], ids=["f32", "mmf32"])
@pytest.mark.parametrize("level", list(LEVELS))
@pytest.mark.parametrize("batch", [8, 256, 512, 37])
def test_qkv_and_proj_plans_at_every_gcvit_shape(level, batch, a_bytes):
    """Both kinds at each level, local (S = 3) and global (S = 2) qkv: the
    column tile divides C (so an item lies in one of q, k, v), the chunked
    sums past K = 384 with at most 64 columns, the ring at least two stages,
    an A tile of 128 rows x 32 K columns in f32 (128-byte swizzle) or bf16
    (64-byte swizzle), shared memory within the card's, and the bytes as the
    kernel computes them."""
    grid, c = LEVELS[level]
    m = batch * grid * grid
    for kind, n in (("qkv", 3 * c), ("qkv", 2 * c), ("proj", c)):
        p = K.tf32_gemm_plan(kind, c, n, a_bytes)
        assert p["bn"] == QKV_BN[c] and c % p["bn"] == 0 and n % p["bn"] == 0
        assert p["promote"] == (c > K.TF32_PROMOTE_K) and (not p["promote"] or p["bn"] <= 64)
        assert p["bk"] == 32 and c % p["bk"] == 0
        assert 2 <= p["stages"] <= K.MAX_RING
        assert p["swizzle"] == {4: 128, 2: 64}[a_bytes]
        stage = a_bytes * 32 * p["bm"] + 4 * 32 * 2 * p["bn"]  # A tile, W_hi, W_lo
        assert p["stage"] == stage and stage % 1024 == 0  # every tile on a swizzle boundary
        assert p["smem"] == 8 * (2 * p["stages"] + 3) + 1024 + 16 * 2048 + p["stages"] * stage
        assert p["smem"] <= K.SMEM_LIMIT
        items = -(-m // p["bm"]) * (n // p["bn"])
        assert items >= 1 and m < 2 ** 31
    assert K.tf32_gemm_plan("proj", c, c, 2)["stages"] >= K.tf32_gemm_plan("proj", c, c)["stages"]


@pytest.mark.parametrize("kind,k,n,a_bytes", [
    ("qkv", 64, 64, 4),     # not 2 or 3 outputs
    ("qkv", 64, 256, 4),
    ("qkv", 800, 2400, 4),  # past the LN kinds' widest row
    ("qkv", 48, 144, 4),    # K not a multiple of 32
    ("proj", 64, 128, 4),   # N is not K
    ("proj", 64, 64, 1),    # no 1-byte A
    ("gelu", 64, 256, 2),   # the MLP kernels take f32 A only
    ("res", 256, 64, 2),
])
def test_qkv_and_proj_plans_refuse_what_the_kernels_do_not_take(kind, k, n, a_bytes):
    with pytest.raises(ValueError):
        K.tf32_gemm_plan(kind, k, n, a_bytes)


def _narrow_gcvit(dtype=F32):
    from test_torch_gcvit import NARROW

    model, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1,
                            classifier_activation=None, dtype=dtype, seed=0, **NARROW)
    return model.eval()


def _same(a: tf32.Tf32Weight, b: tf32.Tf32Weight) -> bool:
    return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


@pytest.fixture(scope="module")
def narrow_gcvit():
    return _narrow_gcvit()


@pytest.mark.parametrize("name", ["attn.qkv", "attn.proj"])
def test_qkv_and_proj_split_cache_is_made_once_and_remade_when_the_weight_moves(name):
    model = _narrow_gcvit()
    prefix = "levels_0.blocks_0."
    blk = model.get_submodule(prefix[:-1])
    weight = blk.get_submodule(name).weight
    first = blk.tf32_weight(name)
    assert blk.tf32_weight(name) is first and _same(first, tf32.tf32_weight(weight))
    with torch.no_grad():
        weight.mul_(2.0)  # an in-place write moves the version
    second = blk.tf32_weight(name)
    assert second is not first and _same(second, tf32.tf32_weight(weight))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state[f"{prefix}{name}.weight"].mul_(-1.0)
    model.load_state_dict(state)
    third = blk.tf32_weight(name)
    assert third is not second and _same(third, tf32.tf32_weight(blk.get_submodule(name).weight))


def test_qkv_split_of_a_bf16_block_follows_set_f32_weights():
    """A bf16 block's f32 GEMMs (``VIPTPU_GCVIT_MM=f32``) split the f32 values
    its weights were cast from, for qkv and proj as for the MLP."""
    model = _narrow_gcvit(BF16)
    prefix = "levels_0.blocks_1."  # a global-query block: W_qkv is (2C, C)
    blk = model.get_submodule(prefix[:-1])
    assert blk.attn.qkv.weight.shape[0] == 2 * blk.dim
    for scale in (1.5, -2.0):
        values = {f"{prefix}{n}.weight": blk.get_submodule(n).weight.float() * scale
                  for n in blk.INT8_LINEARS}
        blk.set_f32_weights(values, prefix)
        for name in ("attn.qkv", "attn.proj"):
            got = blk.tf32_weight(name)
            assert blk.tf32_weight(name) is got
            assert _same(got, tf32.tf32_weight(values[f"{prefix}{name}.weight"]))


def test_row_slice_of_a_pair_is_the_pair_of_the_row_slice():
    """The split is elementwise and ``permute_k`` moves columns within a row,
    so the k/v rows ``[C:]`` of W_qkv's pair are the pair of W_qkv[C:], bit
    for bit."""
    rng = np.random.RandomState(9)
    c = 96
    w = _t(_u(rng, (3 * c, c)) * 10.0 ** rng.uniform(-3, 3, (3 * c, 1)))
    whole, kv = tf32.tf32_weight(w), tf32.tf32_weight(w[c:])
    assert torch.equal(whole.hi[c:], kv.hi) and torch.equal(whole.lo[c:], kv.lo)


def test_block_passes_its_four_pairs_on_the_card_and_none_on_the_cpu(narrow_gcvit, monkeypatch):
    """Off the CPU (here the meta device, which launches nothing) a fused f32
    block hands ``window_transformer_block`` the cached pairs of qkv, proj,
    fc1 and fc2; on the CPU none (the plain versions do not read them)."""
    seen = []
    monkeypatch.setattr(port_gcvit, "window_transformer_block",
                        lambda x, q, **kw: seen.append(kw) or x)
    blk = narrow_gcvit.levels_0.blocks_0
    c, n = blk.dim, blk.window ** 2
    blk(torch.zeros(1, n, c), None)
    assert not any(k.endswith("_split") for k in seen[-1])
    meta = _narrow_gcvit().levels_0.blocks_0.to("meta")
    meta(torch.zeros(1, n, c, device="meta"), None)
    for key, name in (("wqkv", "attn.qkv"), ("wp", "attn.proj"), ("w1", "mlp.fc1"),
                      ("w2", "mlp.fc2")):
        assert seen[-1][f"{key}_split"] is meta.tf32_weight(name)


def test_wrappers_take_the_pair_and_ignore_it_on_the_cpu():
    rng = np.random.RandomState(4)
    c, m = 64, 19
    x, a = _t(_u(rng, (m, c))), _t(_u(rng, (m, c)))
    g, b = torch.ones(c), torch.zeros(c)
    w, wp = _t(_u(rng, (3 * c, c))), _t(_u(rng, (c, c)))
    wb = torch.zeros(3 * c)
    got = G.ln_qkv(x, g, b, w, wb, 1e-5, w_split=tf32.tf32_weight(w))
    for part, ref in zip(got, G.ln_qkv_plain(x, g, b, w, wb, 1e-5)):
        assert torch.equal(part, ref)
    r1 = G.proj_scale_residual(a, wp, b, g, x, w_split=tf32.tf32_weight(wp))
    assert torch.equal(r1, G.proj_scale_residual_plain(a, wp, b, g, x))
