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
