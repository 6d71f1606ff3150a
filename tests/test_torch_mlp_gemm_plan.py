"""The tile plan of the two MLP GEMM kernels (``ln_fc1_gelu``,
``fc2_scale_residual``) and their CPU dispatch, without a card.

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

from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K

MAIN_PATH = [(96, 384), (192, 768), (384, 1536), (768, 3072),  # ConvNeXt s1-s4
             (64, 192), (128, 384), (256, 768), (512, 1536)]  # GCViTTiny L1-L4
CARD_TESTS = [(c, r * c) for c in (32, 64, 96, 128, 192, 256, 384, 512, 768) for r in (3, 4)]
SHAPES = sorted(set(MAIN_PATH + CARD_TESTS))


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
    assert K.LAUNCHES == {"dwconv7x7_nhwc": 0, "ln_fc1_gelu": 0, "fc2_scale_residual": 0}
    torch.testing.assert_close(hid, K.ln_fc1_gelu_plain(x, lg, lb, w1, b1, 1e-6), rtol=0, atol=0)
    torch.testing.assert_close(out, K.fc2_scale_residual_plain(hid, w2, b2, gamma, res), rtol=0,
                               atol=0)
