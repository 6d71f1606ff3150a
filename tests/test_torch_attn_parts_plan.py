"""The plan of the window-attention template's streamed-key mode
(``attn_parts.stripe_plan``), which ``csrc/window_attention.cuh`` checks
before a launch, and the attention-parts wrappers' CPU dispatch of the
phase cuts, without a card.

At every group size (gN = 1 ... 1024 keys) a CTA keeps one (head, stripe
of 16-row tiles) with that stripe's rows of the
bias in shared memory beside a ring of K and V, each tile's keys split over
a few warps; the plan must fit a block's 227 KB, split the row tiles evenly
over the stripes with no stripe empty, keep two ring stages wherever they
fit beside one tile of bias, and leave room in a stage for the splits'
partial sums.
"""
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.ops.kernels import attn_parts as A


def _check(gn):
    plan = A.stripe_plan(gn)
    np_, tiles, stripes, stages = plan["np"], plan["tiles"], plan["stripes"], plan["stages"]
    splits = plan["splits"]
    assert np_ % 16 == 0 and gn <= np_ < gn + 16
    assert 1 <= tiles <= A.MAX_STRIPE_TILES
    assert 1 <= splits <= A.MAX_SPLITS and tiles * splits <= A.MAX_STREAM_WARPS
    assert splits <= np_ // 16  # every split has keys
    assert stripes * tiles * 16 >= gn > (stripes - 1) * tiles * 16  # every stripe has rows
    stage = np_ * 2 * A.HEAD_DIM * 2  # K and V rows of 64 bytes
    bias_tile = np_ // 8 * 32 * 16  # a tile's np / 8 float4 per lane
    assert plan["smem"] == tiles * bias_tile + stages * stage + tiles * splits * 64
    assert plan["smem"] <= A.SMEM_LIMIT
    assert stages == (2 if 2 * stage + bias_tile + A.MAX_STREAM_WARPS * 64 <= A.SMEM_LIMIT
                      else 1)
    assert (splits - 1) * tiles * 32 * 18 * 4 <= stage  # o and l of the splits, 18 f32 a lane
    return plan


@pytest.mark.parametrize("gn", [1, 27, 49, 98, 147, 196, 224, 225, 240, 294, 300, 392, 448,
                                449, 512, 600, 784, 1000, 1024])
def test_stripe_plan_fits_every_streamed_group(gn):
    _check(gn)


def test_stripe_plan_at_the_tools_groups():
    """g = 8 windows of 49 tokens (both exp_attn_parts shapes): 25 row tiles
    in five stripes of five, each tile's 25 key chunks over two warps, 128 KB
    of bias and two 51 KB stages."""
    assert A.stripe_plan(392) == dict(np=400, tiles=5, splits=2, stripes=5, stages=2,
                                      smem=231040)


@pytest.mark.parametrize("gn,stripes,stages", [(49, 1, 2), (98, 1, 2), (294, 3, 2),
                                               (784, 25, 1)])
def test_stripe_plan_at_the_card_tests_edges(gn, stripes, stages):
    """gN 98 and 49 fit one stripe; gN 294 leaves its last stripe partial
    (19 tiles over three of 7); gN 784 keeps one K and V stage beside its
    bias."""
    plan = _check(gn)
    assert (plan["stripes"], plan["stages"]) == (stripes, stages)


@pytest.mark.parametrize("gn", [0, 1025])
def test_stripe_plan_rejects_what_the_kernel_does_not_take(gn):
    with pytest.raises(ValueError):
        A.stripe_plan(gn)


def test_attn_parts_cut_needs_the_card_and_the_streamed_mode():
    q = torch.zeros((1, 392, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        A.attn_parts_cut(q, q, q, torch.zeros((2, 392, 392)), heads=2, n=49, g=8, cut=1)
