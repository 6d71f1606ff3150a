"""The LN-MLP kernel's plan (``ln_mlp.ln_mlp_plan``, which ``csrc/ln_mlp.cu``
checks before a launch) and the wrappers' CPU dispatch, without a card.

At every width the kernel is built for (hidden 4C), at the
``exp_convnext_s12`` shapes s1-s4 and at the hidden widths the card tests
use, a plan must fit a block's shared memory, keep the f32 accumulators of a
consumer thread within the plan's register budget, tile the channels
exactly with wgmma widths, split the fc2 columns (over two warpgroups of a
row group up to C = 256, over four from C = 384 on, and over two items at
C = 768), and refuse what the kernel cannot take.
"""
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.ops.kernels import ln_mlp as LM
from vip_cup_2022_tpu_torch.tools import exp_convnext_s12

SMEM_LIMIT = 232_448  # a block's opt-in shared memory on sm_90 (kSmemLimit)
STAGES = [(c, n) for (_, _, c, n) in exp_convnext_s12.SHAPES.values()]  # s1-s4
SHAPES = sorted(set([(c, 4 * c) for c in LM.WIDTHS] + STAGES
                    + [(c, 3 * c) for c in LM.WIDTHS if (3 * c) % (128 if c <= 384 else 256) == 0]
                    + [(32, 128), (768, 256), (96, 128 * 9)]))


@pytest.mark.parametrize("c,hidden", SHAPES)
def test_plan_fits_and_tiles_exactly(c, hidden):
    p = LM.ln_mlp_plan(c, hidden)
    assert p["smem"] <= SMEM_LIMIT
    # registers: fc2's and fc1's f32 accumulators of a consumer thread
    assert p["acc_regs"] == p["cw"] // 2 + p["fc1_columns"] // 2 <= LM.ACC_REGS
    # the channels and the hidden chunk exactly, with widths a wgmma takes
    assert p["cw"] in LM.WGMMA_N and p["fc1_columns"] in LM.WGMMA_N
    assert p["row_groups"] * p["group_warpgroups"] == LM.WARPGROUPS
    assert p["cw"] * p["group_warpgroups"] * p["cs"] == c == p["cn"] * p["cs"]
    assert p["hidden_chunk"] == p["fc1_columns"] * p["group_warpgroups"]
    assert hidden % p["hidden_chunk"] == 0 and p["hidden_chunk"] % 64 == 0
    assert p["rows"] == LM.ROWS * p["row_groups"]
    # W2 stages: TMA boxes of at most 256 rows holding whole warpgroup blocks
    assert p["w2_rows"] <= 256 and p["cn"] % p["w2_rows"] == 0 and p["w2_rows"] % p["cw"] == 0
    assert 2 <= p["stages1"] <= LM.MAX_RING and 2 <= p["stages2"] <= LM.MAX_RING


@pytest.mark.parametrize("c,hidden", SHAPES)
def test_plan_splits_the_columns_of_wide_c(c, hidden):
    """Two row groups of two warpgroups up to C = 256 (each warpgroup C / 2
    columns); from C = 384 on one group of four (C / 4 each, 96 at C =
    384), as a 64 x C f32 accumulator over two warpgroups would not fit
    their registers; at C = 768 also two items that each compute fc1."""
    p = LM.ln_mlp_plan(c, hidden)
    grouped = c <= LM.GROUPED
    assert (p["row_groups"], p["group_warpgroups"]) == ((2, 2) if grouped else (1, 4))
    assert p["cs"] == (2 if c == 768 else 1)
    if c >= 384:
        assert p["cw"] < c and p["cw"] == c // p["cs"] // 4


def test_plan_at_the_tool_shapes():
    """s1-s4: 128-row items of two groups at s1 and s2 (64 fc1 columns a
    warpgroup), 64-row items of one group of four at s3 and s4 (32 each);
    hidden chunks of 128 at all four."""
    plans = [LM.ln_mlp_plan(c, n) for c, n in STAGES]
    assert [p["rows"] for p in plans] == [128, 128, 64, 64]
    assert [p["fc1_columns"] for p in plans] == [64, 64, 32, 32]
    assert [p["hidden_chunk"] for p in plans] == [128, 128, 128, 128]
    assert [p["cs"] for p in plans] == [1, 1, 1, 2]


@pytest.mark.parametrize("c,hidden,match", [
    (48, 192, "no kernel instantiation"),
    (1024, 4096, "no kernel instantiation"),
    (32, 96, "multiple of 128"),
    (512, 128 * 3, "multiple of 256"),
    (96, 0, "multiple of 128"),
])
def test_plan_refuses_what_the_kernel_cannot_take(c, hidden, match):
    with pytest.raises(ValueError, match=match):
        LM.ln_mlp_plan(c, hidden)


@pytest.mark.parametrize("name", ["fused_ln_mlp_residual", "lnmlp_batchlane", "lnmlp_chanfirst"])
def test_cpu_tensors_take_the_plain_version(name):
    """On the CPU a wrapper runs its plain version and counts no launch,
    also at a width the kernel has no instantiation for."""
    g = torch.Generator().manual_seed(0)
    c, n = 48, 96
    perm = LM.LAYOUTS[name]  # (B, H, W, C) -> the wrapper's layout
    x, r = (torch.randn((2, 3, 5, c), generator=g).permute(*perm).contiguous() for _ in range(2))
    prm = (torch.ones(c), torch.zeros(c), torch.randn((n, c), generator=g) * 0.1,
           torch.zeros(n), torch.randn((c, n), generator=g) * 0.1, torch.zeros(c),
           torch.ones(c))
    LM.reset_launches()
    got = getattr(LM, name)(x, r, *prm)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert sum(LM.LAUNCHES.values()) == 0


def test_exp_lnmlp_dw_needs_a_card():
    """The device-time tool refuses to time the CPU."""
    from vip_cup_2022_tpu_torch.tools import exp_lnmlp_dw

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            exp_lnmlp_dw.main(["--iters", "1"])
