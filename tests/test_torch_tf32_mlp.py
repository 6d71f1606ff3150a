"""The 3xTF32 f32 MLP kernels' arithmetic and plan, on the CPU.

``ln_fc1_gelu_f32`` and ``fc2_scale_residual_f32`` / ``_mmf32`` run on the
tensor cores as three TF32 products of split operands
(``csrc/tf32_gemm.cuh``; the split of ``ops/kernels/tf32.py``). The kernels
need the card (``test_torch_tf32_mlp_cuda.py`` holds them to their plain
versions there); here:

- the split, bit for bit: ``hi`` has its low 13 bits zero and rounds to
  nearest with ties away from zero (``cvt.rna.tf32.f32``) on hand-picked
  patterns, and ``hi + lo`` recovers v within 2^-21 |v|;
- the K permutation the weights take, against the values a lane of the
  kernel loads from the swizzled tile (an emulation of its addresses);
- the emulated 3xTF32 product against the f64 product at K = 64 ... 3072,
  and the emulated MLP (LN -> fc1 -> GELU -> fc2 -> gamma * + residual)
  against the JAX package's f32 fused kernels in interpret mode
  (``VIPTPU_GELU=erf``);
- the plan at every main-path (M, K, N);
- the blocks' split cache: made once, remade after an in-place write, after
  ``load_state_dict`` and after ``set_f32_weights``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.ops.pallas.convnext_block import (
    fused_convnext_block,
    fused_ln_mlp_residual,
)
from vip_cup_2022_tpu_torch.models import create_model
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import tf32

F32_BOUND = 1e-5  # of max|ref|: the kernels' gate against the plain f32 version
ATOL = 1e-4  # f32 on both sides, sums over K up to 4C in another order (test_torch_f32_fused.py)


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.view(torch.int32)


def _f(bits) -> torch.Tensor:
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(torch.float32)


def test_tf32_round_clears_the_low_13_bits_and_moves_at_most_half_a_step():
    rng = np.random.RandomState(0)
    v = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30, 4096))
                         .astype(np.float32))
    hi = tf32.tf32_round(v)
    assert not (_bits(hi) & 0x1FFF).any()
    step = torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 11)  # a TF32 step at v's exponent
    assert ((hi - v).abs() <= step / 2).all()


@pytest.mark.parametrize("bits,want", [
    (0x3F801000, 0x3F802000),  # 1 + half a step, truncated part even: away (nearest-even stays)
    (0x3F803000, 0x3F804000),  # a tie above an odd step
    (0xBF801000, 0xBF802000),  # negative: away from zero
    (0x3F800FFF, 0x3F800000),  # just below half a step
    (0x3F801001, 0x3F802000),  # just above
    (0x3FFFF000, 0x40000000),  # the carry into the exponent
    (0x7F7FF000, 0x7F800000),  # past the largest TF32: infinity
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x00000FFF, 0x00000000),
    (0x80000000, 0x80000000),  # -0
    (0x7F800000, 0x7F800000),  # infinity stays
])
def test_tf32_round_is_nearest_ties_away(bits, want):
    got = tf32.tf32_round(_f([bits]))
    assert int(_bits(got)[0]) & 0xFFFFFFFF == want


def test_split_recovers_v_within_2_to_the_minus_21():
    rng = np.random.RandomState(1)
    v = torch.from_numpy((rng.standard_normal(1 << 16) * 10.0 ** rng.uniform(-20, 20, 1 << 16))
                         .astype(np.float32))
    hi, lo = tf32.tf32_split(v)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    err = (hi.double() + lo.double() - v.double()).abs()
    assert (err <= 2.0 ** -21 * v.double().abs()).all()


def test_permute_k_is_the_order_a_lane_loads_from_the_swizzled_tile():
    """The kernel's A fragment: lane (warp w, lane l) of a warpgroup reads,
    for half tile p, the 16-byte chunk 4p + l % 4 of rows r = 16w + l / 4 and
    r + 8 under the 128-byte swizzle (chunk XOR r % 8), and hands element 2h
    + e of it to k8 step 2p + e at fragment column l % 4 + 4h. The matrix
    those positions build is permute_k of the tile, the order the weights
    take, so every dot sums the same products."""
    a = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    smem = torch.empty(64 * 32)
    for r in range(64):
        for c in range(32):
            smem[r * 32 + ((c // 4) ^ (r & 7)) * 4 + c % 4] = a[r, c]
    logical = torch.full((64, 32), -1.0)
    for warp in range(4):
        for lane in range(32):
            t, r0 = lane & 3, 16 * warp + (lane >> 2)
            for p in range(2):
                chunk = (4 * p + t) ^ (r0 & 7)
                v0 = smem[r0 * 32 + chunk * 4:][:4]
                v1 = smem[(r0 + 8) * 32 + chunk * 4:][:4]
                for e in range(2):
                    frag = ((r0, t, v0[e]), (r0 + 8, t, v1[e]), (r0, t + 4, v0[2 + e]),
                            (r0 + 8, t + 4, v1[2 + e]))
                    for row, k, val in frag:
                        logical[row, 8 * (2 * p + e) + k] = val
    assert torch.equal(logical, tf32.permute_k(a))
    w = torch.randn(6, 96)
    assert torch.equal(tf32.permute_k(w).sort(1).values, w.sort(1).values)  # within each row
    hi, lo = tf32.tf32_weight(w)
    want_hi, want_lo = tf32.tf32_split(w)
    assert torch.equal(hi, tf32.permute_k(want_hi)) and torch.equal(lo, tf32.permute_k(want_lo))
    assert hi.is_contiguous() and lo.is_contiguous()


@pytest.mark.parametrize("k", [64, 96, 192, 384, 768, 1536, 3072])
def test_tf32x3_product_against_the_f64_product(k):
    """Inputs at the MLP's scale (activations ~U(-1, 1) and LN outputs, weights
    ~U(-1, 1) / sqrt(K)): the three-pass product within a quarter of the
    kernels' gate of max|ref|, where one TF32 pass is far outside it."""
    rng = np.random.RandomState(k)
    a = torch.from_numpy(rng.uniform(-1, 1, (64, k)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (48, k)) / np.sqrt(k)).astype(np.float32))
    ref = a.double() @ w.double().T
    top = ref.abs().max().item()
    err3 = (tf32.tf32x3_linear(a, w).double() - ref).abs().max().item() / top
    err1 = (tf32.tf32_round(a).double() @ tf32.tf32_round(w).double().T - ref).abs().max().item()
    assert err3 <= F32_BOUND / 4
    assert err1 / top > 10 * F32_BOUND


def _emulated_mlp(x, residual, g, b, w1, b1, w2, b2, gamma, eps):
    """LN (two-pass f32) -> 3xTF32 fc1 + b1 -> exact GELU -> 3xTF32 fc2 + b2
    -> x gamma -> + residual, rows (M, C); weights in the nn.Linear layout."""
    mean = x.mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps) * g + b
    h = F.gelu(tf32.tf32x3_linear(y, w1) + b1, approximate="none")
    return (tf32.tf32x3_linear(h, w2) + b2) * gamma + residual


@pytest.fixture
def erf_gelu(monkeypatch):
    monkeypatch.setenv("VIPTPU_GELU", "erf")


@pytest.mark.parametrize("c,rows", [(64, 40), (96, 33)])
def test_emulated_mlp_matches_fused_ln_mlp_residual(erf_gelu, c, rows):
    """The MLP alone against the JAX package's f32 fused LN-MLP kernel."""
    rng = np.random.RandomState(c)
    x, r = (rng.uniform(-1, 1, (1, 1, rows, c)).astype(np.float32) for _ in range(2))
    g, bt = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.uniform(-0.1, 0.1, c).astype(np.float32)
    w1 = (rng.uniform(-1, 1, (c, 4 * c)) / np.sqrt(c)).astype(np.float32)
    w2 = (rng.uniform(-1, 1, (4 * c, c)) / np.sqrt(4 * c)).astype(np.float32)
    b1, b2 = (rng.uniform(-0.1, 0.1, n).astype(np.float32) for n in (4 * c, c))
    ls = rng.uniform(0.5, 1.5, c).astype(np.float32)
    want = fused_ln_mlp_residual(jnp.asarray(x), jnp.asarray(r), g, bt, w1, b1, w2, b2, ls,
                                 eps=1e-6, row_tile=16, gelu="erf", interpret=True)
    t = torch.from_numpy
    got = _emulated_mlp(t(x).view(rows, c), t(r).view(rows, c), t(g), t(bt), t(w1.T.copy()),
                        t(b1), t(w2.T.copy()), t(b2), t(ls), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(rows, c), atol=ATOL)


def test_emulated_mlp_matches_fused_convnext_block(erf_gelu):
    """The whole f32 block at C = 256 (the whole-image kernel): the plain
    depthwise pass, then the emulated MLP on its output."""
    from test_torch_convnext_kernels import _params

    rng = np.random.RandomState(256)
    c, shape = 256, (1, 5, 6)
    x = rng.uniform(-1, 1, (*shape, c)).astype(np.float32)
    args = _params(c, rng)
    want = fused_convnext_block(jnp.asarray(x), *map(jnp.asarray, args), gelu="erf",
                                interpret=True)
    dw, dwb, g, bt, w1, b1, w2, b2, ls = [torch.from_numpy(a) for a in args]
    xt = torch.from_numpy(x)
    d = K.dwconv7x7_nhwc_plain(xt, dw, dwb).view(-1, c)
    got = _emulated_mlp(d, xt.view(-1, c), g, bt, w1.T.contiguous(), b1, w2.T.contiguous(), b2,
                        ls, 1e-6)
    np.testing.assert_allclose(got.numpy().reshape(x.shape), np.asarray(want), atol=ATOL)


# ConvNeXt's stages at 200 px and GCViTTiny's levels at 224: (tokens a side, C, N / C)
MAIN_PATH = {"s1": (99, 96, 4), "s2": (49, 192, 4), "s3": (24, 384, 4), "s4": (12, 768, 4),
             "L1": (56, 64, 3), "L2": (28, 128, 3), "L3": (14, 256, 3), "L4": (7, 512, 3)}


@pytest.mark.parametrize("shape", list(MAIN_PATH))
@pytest.mark.parametrize("batch", [8, 256, 512, 37])
def test_plan_at_every_main_path_shape(shape, batch):
    """Both kinds at each (M, K, N) of the main path, batch 256, the fold
    mode's 512, batch 8 and a ragged one: shared memory within the card's
    232,448 bytes, the K tile (32 f32, four k8 steps) dividing K, the column
    tile a wgmma n dividing N, the chunked sums past K = 384, the ring at
    least two stages, and the bytes as the kernel computes them."""
    grid, c, ratio = MAIN_PATH[shape]
    m, n = batch * grid * grid, ratio * c
    for kind, k, cols in (("gelu", c, n), ("res", n, c)):
        p = K.tf32_gemm_plan(kind, k, cols)
        assert p["smem"] <= K.SMEM_LIMIT == 232_448
        assert k % 8 == 0 and k % p["bk"] == 0 and p["bk"] == 32
        assert cols % p["bn"] == 0 and p["bn"] in K.TF32_WIDTHS and p["bn"] % 8 == 0
        # chunked sums past K = 384, two accumulator tiles of at most 64 columns
        assert p["promote"] == (k > 384) and (not p["promote"] or p["bn"] <= 64)
        assert 2 <= p["stages"] <= K.MAX_RING
        stage = 4 * p["bk"] * (p["bm"] + 2 * p["bn"])  # A tile, W_hi, W_lo
        # barriers (full, empty, two order, held), 1024 of alignment, 16 warps' 2 KB staging
        assert p["smem"] == 8 * (2 * p["stages"] + 3) + 1024 + 16 * 2048 + p["stages"] * stage
        items = -(-m // p["bm"]) * (cols // p["bn"])
        assert items >= 1 and m < 2 ** 31


def test_plan_refuses_what_the_kernels_do_not_take():
    for kind, k, n in (("gelu", 800, 3200), ("gelu", 48, 192), ("res", 96, 48), ("mlp", 96, 384)):
        with pytest.raises(ValueError):
            K.tf32_gemm_plan(kind, k, n)


def _narrow_convnext():
    model, _ = create_model("convnext_tiny_in22k", input_size=(32, 32), nb_classes=1,
                            classifier_activation=None, dtype=torch.float32, seed=0,
                            embed_dim=(32, 64, 96, 128), nb_blocks=(1, 1, 1, 1))
    return model.eval()


def _same(a: tf32.Tf32Weight, b: tf32.Tf32Weight) -> bool:
    return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


def test_split_cache_is_made_once_and_remade_when_the_weight_moves():
    model = _narrow_convnext()
    blk = model.stages_0_blocks_0
    first = blk.tf32_weight("mlp_fc1")
    assert blk.tf32_weight("mlp_fc1") is first  # a hit: the same pair
    assert _same(first, tf32.tf32_weight(blk.mlp_fc1.weight))
    with torch.no_grad():
        blk.mlp_fc1.weight.mul_(2.0)  # an in-place write moves the version
    second = blk.tf32_weight("mlp_fc1")
    assert second is not first and _same(second, tf32.tf32_weight(blk.mlp_fc1.weight))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["stages_0_blocks_0.mlp_fc1.weight"].mul_(-1.0)
    model.load_state_dict(state)
    third = blk.tf32_weight("mlp_fc1")
    assert third is not second and _same(third, tf32.tf32_weight(blk.mlp_fc1.weight))
    assert blk.tf32_weight("mlp_fc2") is blk.tf32_weight("mlp_fc2")


def test_split_cache_of_a_bf16_block_follows_set_f32_weights():
    """A bf16 GCViT block's f32 GEMMs (``VIPTPU_GCVIT_MM=f32``) split the f32
    values its weights were cast from: remade when those are set anew."""
    from test_torch_gcvit import NARROW

    model, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1,
                            classifier_activation=None, dtype=torch.bfloat16, seed=0, **NARROW)
    prefix = "levels_0.blocks_0."
    blk = model.get_submodule(prefix[:-1])

    def values(scale):  # f32 values the bf16 weights could have been cast from
        return {f"{prefix}{n}.weight": blk.get_submodule(n).weight.float() * scale
                for n in blk.INT8_LINEARS}

    first_values = values(1.5)
    blk.set_f32_weights(first_values, prefix)
    first = blk.tf32_weight("mlp.fc1")
    assert blk.tf32_weight("mlp.fc1") is first
    assert _same(first, tf32.tf32_weight(first_values[f"{prefix}mlp.fc1.weight"]))
    second_values = values(-2.0)
    blk.set_f32_weights(second_values, prefix)
    assert _same(blk.tf32_weight("mlp.fc1"),
                 tf32.tf32_weight(second_values[f"{prefix}mlp.fc1.weight"]))


def test_f32_wrappers_take_the_pair_and_ignore_it_on_the_cpu():
    rng = np.random.RandomState(3)
    c, m = 32, 10
    t = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))  # noqa: E731
    x, w1, w2, res = t(m, c), t(4 * c, c), t(c, 4 * c), t(m, c)
    g, b, b1 = torch.ones(c), torch.zeros(c), torch.zeros(4 * c)
    h = K.ln_fc1_gelu(x, g, b, w1, b1, 1e-6, w_split=tf32.tf32_weight(w1))
    assert torch.equal(h, K.ln_fc1_gelu_plain(x, g, b, w1, b1, 1e-6))
    out = K.fc2_scale_residual(h, w2, b, g, res, w_split=tf32.tf32_weight(w2))
    assert torch.equal(out, K.fc2_scale_residual_plain(h, w2, b, g, res))
