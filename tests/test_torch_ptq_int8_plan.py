"""The tile plan of the int8 PTQ site's wgmma + TMA GEMM (``ptq_plan``) and
the CPU dispatch of its two wrappers, without a card.

``ptq_plan`` picks, per site, the column tile (a wgmma n the GEMM is built
for), the ring's depth and whether the int8 weight stays in shared memory;
``csrc/ptq_int8.cuh`` checks the same limits before a launch. At each of
ResNetRS50's and ResNest50's 22 site shapes and at the card tests' edge
shapes the plan
must fit a block's 227 KB of shared memory and keep four A stages beside a
held weight. On CPU tensors ``ptq_int8_quantize``, ``ptq_int8_gemm`` and
``ptq_int8_conv`` run their plain versions and count no launch, and the
site is the quantize pass followed by the GEMM.
"""
import collections

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q

# ResNetRS50's 22 int8 site shapes at 200 px: (H = W, C, N, kernel, stride)
RESNETRS50_SITES = [
    (50, 64, 256, 1, 1), (50, 64, 64, 1, 1), (50, 64, 64, 3, 1), (50, 256, 64, 1, 1),
    (25, 256, 512, 1, 1), (50, 256, 128, 1, 1), (50, 128, 128, 3, 2), (25, 128, 512, 1, 1),
    (25, 512, 128, 1, 1), (25, 128, 128, 3, 1), (13, 512, 1024, 1, 1), (25, 512, 256, 1, 1),
    (25, 256, 256, 3, 2), (13, 256, 1024, 1, 1), (13, 1024, 256, 1, 1), (13, 256, 256, 3, 1),
    (7, 1024, 2048, 1, 1), (13, 1024, 512, 1, 1), (13, 512, 512, 3, 2), (7, 512, 2048, 1, 1),
    (7, 2048, 512, 1, 1), (7, 512, 512, 3, 1),
]
# ResNest50's 22 int8 site shapes at 200 px and the sites of each (68 in all):
# (H = W, C, N, kernel, stride) -> sites. Every site is at stride 1 (the split
# attention pools after its convs, the shortcut before its conv); the 3 x 3
# ones are the split attention's halves, C = hidden / 2
RESNEST50_SITES = {
    (50, 64, 256, 1, 1): 4, (50, 64, 64, 1, 1): 1, (50, 32, 64, 3, 1): 6, (50, 256, 64, 1, 1): 2,
    (25, 256, 512, 1, 1): 1, (50, 256, 128, 1, 1): 1, (50, 64, 128, 3, 1): 2,
    (25, 128, 512, 1, 1): 4, (25, 512, 128, 1, 1): 3, (25, 64, 128, 3, 1): 6,
    (13, 512, 1024, 1, 1): 1, (25, 512, 256, 1, 1): 1, (25, 128, 256, 3, 1): 2,
    (13, 256, 1024, 1, 1): 6, (13, 1024, 256, 1, 1): 5, (13, 128, 256, 3, 1): 10,
    (7, 1024, 2048, 1, 1): 1, (13, 1024, 512, 1, 1): 1, (13, 256, 512, 3, 1): 2,
    (7, 512, 2048, 1, 1): 3, (7, 2048, 512, 1, 1): 2, (7, 256, 512, 3, 1): 4,
}
# (N, K, source) of the card tests' edges
EDGES = [(64, 64, Q.PTQ_ROWS_QUANT), (64, 576, Q.PTQ_GATHER), (128, 864, Q.PTQ_GATHER),
         (96, 288, Q.PTQ_GATHER), (40, 324, Q.PTQ_GATHER), (36, 40, Q.PTQ_GATHER),
         (192, 256, Q.PTQ_ROWS_QUANT), (192, 256, Q.PTQ_ROWS), (64, 520, Q.PTQ_ROWS_QUANT),
         (384, 64, Q.PTQ_ROWS), (40, 96, Q.PTQ_ROWS)]


def _source(h, c, n, kernel, stride):
    """The source ResNetRS50's site takes on the path (bf16 x and output)."""
    k = kernel * kernel * c
    if Q.quantizes_in_gemm(torch.bfloat16, torch.bfloat16, kernel, stride, kernel // 2, k, n):
        return Q.PTQ_ROWS_QUANT
    return Q.PTQ_GATHER if kernel != 1 else Q.PTQ_ROWS


def _check_plan(n, k, src):
    plan = Q.ptq_plan(n, k, src)
    assert plan["smem"] <= K.SMEM_LIMIT
    assert plan["bn"] in Q.PTQ_WIDTHS and plan["bn"] in K.WGMMA_N
    assert plan["bn"] == (64 if n <= 64 else 128)  # N = 64 sites take the narrow tile
    assert 2 <= plan["stages"] <= Q.PTQ_MAX_RING
    if plan["resident"]:
        assert plan["held"] == -(-n // plan["bn"]) * -(-k // 128) * plan["bn"] * 128
        assert plan["held"] <= Q.MAX_TX_BYTES and plan["stages"] >= Q.PTQ_MIN_HELD_STAGES
    else:
        assert plan["held"] == 0
    return plan


@pytest.mark.parametrize("h,c,n,kernel,stride", RESNETRS50_SITES)
def test_ptq_plan_fits_at_every_resnetrs50_site(h, c, n, kernel, stride):
    src = _source(h, c, n, kernel, stride)
    plan = _check_plan(n, kernel * kernel * c, src)
    # the rows sites up to N = 256 quantize in the GEMM, the wider ones after the pass
    assert (src == Q.PTQ_ROWS_QUANT) == (kernel == 1 and n <= 256)
    if src == Q.PTQ_ROWS_QUANT:  # 48 KB stages (+ W's): three, W held where it fits
        assert plan["stages"] == 3 and plan["resident"] == (c <= 256)


@pytest.mark.parametrize("h,c,n,kernel,stride", sorted(RESNEST50_SITES))
def test_ptq_plan_fits_at_every_resnest50_site(h, c, n, kernel, stride):
    """Among them 3 x 3 sites of 32 channels (K = 288, past the epilogue's
    exact-add conversion, K <= 260) and 3 x 3 sites on 25 x 25 and 13 x 13."""
    src = _source(h, c, n, kernel, stride)
    plan = _check_plan(n, kernel * kernel * c, src)
    assert (src == Q.PTQ_ROWS_QUANT) == (kernel == 1 and n <= 256)
    assert (src == Q.PTQ_GATHER) == (kernel == 3)
    if src == Q.PTQ_ROWS_QUANT:
        assert plan["stages"] == 3 and plan["resident"] == (c <= 256)


def test_resnest50_sites_are_the_models():
    """The table above is what full-width ResNest50 at 200 px calls
    ``ptq_int8_conv`` with, site by site, after a one-image calibration."""
    from vip_cup_2022_tpu_torch import quant
    from vip_cup_2022_tpu_torch.models import create_model

    model, _ = create_model("ResNest50", input_size=(200, 200), nb_classes=1)
    x = torch.rand((1, 200, 200, 3), generator=torch.Generator().manual_seed(0))
    scales = quant.calibrate(model, [x])
    quant.quantized(model, scales)
    calls, real = [], Q.ptq_int8_conv

    def record(a, qweight, *args, **kw):
        calls.append((a.shape[1], a.shape[-1], qweight.shape[0], kw["kernel"], kw["stride"]))
        return real(a, qweight, *args, **kw)

    Q.ptq_int8_conv = record
    try:
        with torch.inference_mode():
            model(x)
    finally:
        Q.ptq_int8_conv = real
    assert len(scales) == len(calls) == sum(RESNEST50_SITES.values()) == 68
    assert dict(collections.Counter(calls)) == RESNEST50_SITES


@pytest.mark.parametrize("n,k,src", EDGES)
def test_ptq_plan_fits_at_the_card_tests_edges(n, k, src):
    _check_plan(n, k, src)


@pytest.mark.parametrize("n,k,src", [(0, 64, 0), (42, 64, 0), (64, 0, 0), (64, 64, 3)])
def test_ptq_plan_rejects_what_the_gemm_does_not_take(n, k, src):
    with pytest.raises(ValueError):
        Q.ptq_plan(n, k, src)


@pytest.mark.parametrize("x_dtype,out_dtype,kernel,stride,k,n,want", [
    (torch.bfloat16, torch.bfloat16, 1, 1, 256, 256, True),
    (torch.bfloat16, torch.bfloat16, None, 1, 96, 64, True),     # a Dense site
    (torch.bfloat16, torch.bfloat16, 1, 1, 256, 257 // 4 * 4 + 256, False),  # three tiles
    (torch.bfloat16, torch.float32, 1, 1, 256, 256, False),     # f32 output: after the pass
    (torch.float32, torch.bfloat16, 1, 1, 256, 256, False),     # f32 x: after the pass
    (torch.bfloat16, torch.bfloat16, 1, 1, 36, 64, False),      # K not a multiple of 8
    (torch.bfloat16, torch.bfloat16, 3, 1, 576, 64, False),     # a gathered conv
])
def test_which_sites_quantize_in_the_gemm(x_dtype, out_dtype, kernel, stride, k, n, want):
    assert Q.quantizes_in_gemm(x_dtype, out_dtype, kernel, stride, (kernel or 1) // 2, k,
                               n) == want


@pytest.mark.parametrize("shape,kernel,stride,n", [((2, 9, 9, 32), 3, 2, 40),
                                                   ((3, 5, 7, 64), 1, 1, 64),
                                                   ((2, 7, 96), None, 1, 36)])
def test_ptq_wrappers_take_the_plain_versions_on_cpu(shape, kernel, stride, n):
    rng = np.random.RandomState(len(shape) + n)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    c = shape[-1]
    k = (kernel or 1) ** 2 * c
    qw = Q.pack_weight(torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8)))
    cs = torch.from_numpy(rng.uniform(0, 1e-3, n).astype(np.float32))
    bias = torch.from_numpy(rng.randn(n).astype(np.float32))
    inv = Q.f32_reciprocal(float(x.abs().max()) / 127.0)
    kw = dict(kernel=kernel, stride=stride, padding=(kernel or 1) // 2)
    Q.reset_launches()
    q = Q.ptq_int8_quantize(x, inv)
    got = Q.ptq_int8_gemm(q, qw, cs, bias, out_dtype=torch.bfloat16, **kw)
    site = Q.ptq_int8_conv(x.to(torch.bfloat16), qw, cs, bias, inv, **kw)
    in_gemm = Q.ptq_int8_gemm(x.to(torch.bfloat16), qw, cs, bias, out_dtype=torch.bfloat16,
                              inv_s=inv, **kw)  # the GEMM quantizing x itself
    assert all(v == 0 for v in Q.LAUNCHES.values())
    torch.testing.assert_close(in_gemm, site, rtol=0, atol=0)
    assert q.dtype == torch.int8 and torch.equal(q, Q.ptq_int8_quantize_plain(x, inv))
    torch.testing.assert_close(got, Q.ptq_int8_gemm_plain(q, qw, cs, bias, out_dtype=torch.bfloat16,
                                                          **kw), rtol=0, atol=0)
    ref = Q.ptq_int8_conv_plain(x.to(torch.bfloat16), qw, cs, bias, inv, **kw)
    assert site.dtype == torch.bfloat16
    torch.testing.assert_close(site, ref, rtol=0, atol=0)
    # the site is the quantize pass, then the GEMM
    torch.testing.assert_close(site, Q.ptq_int8_gemm_plain(
        Q.ptq_int8_quantize_plain(x.to(torch.bfloat16), inv), qw, cs, bias,
        out_dtype=torch.bfloat16, **kw), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K13's spike bodies on the same GEMM: ptq_plan with the rows M
# ---------------------------------------------------------------------------
# (M, K, N) of the spike's three shapes and of the card tests' edges
SPIKE_SHAPES = [(625, 384, 1536), (1352, 768, 3072), (4096, 768, 3072)]
SPIKE_EDGES = [(37, 64, 96), (130, 100, 132), (100, 200, 100), (129, 776, 260), (130, 104, 136)]
H100_SMS = 132  # the SMs of an H100 SXM, which the wrappers read from the card


@pytest.mark.parametrize("m,k,n,esize,bn,tall", [
    (625, 384, 1536, 1, 64, False),    # s3_fc1: 60 items of 128 columns would idle half the SMs
    (625, 384, 1536, 2, 64, False),
    (1352, 768, 3072, 1, 128, False),  # s4_fc1: 264 items; 144 tall ones would not fill twice
    (1352, 768, 3072, 2, 128, False),
    (4096, 768, 3072, 1, 128, False),  # big: 384 tall items, short of int8's four rounds
    (4096, 768, 3072, 2, 128, True),   # ... and past bf16's two
])
def test_spike_plan_at_the_spike_shapes(m, k, n, esize, bn, tall):
    plan = Q.ptq_plan(n, k, Q.PTQ_ROWS, esize, m, H100_SMS)
    assert (plan["bn"], plan["tall"], plan["resident"]) == (bn, tall, False)
    assert plan["smem"] <= K.SMEM_LIMIT and 2 <= plan["stages"] <= Q.PTQ_MAX_RING
    # without M (the PTQ sites) the same W streams in tall 128-column items
    assert Q.ptq_plan(n, k, Q.PTQ_ROWS, esize)["tall"]


@pytest.mark.parametrize("m,k,n", SPIKE_SHAPES + SPIKE_EDGES)
@pytest.mark.parametrize("body", ["bf16", "int8 f32 x", "int8 bf16 x", "direct"])
def test_spike_plan_fits_at_every_body_and_edge(m, k, n, body):
    """The source each body's wrapper takes (bf16 rows, x padded to K a
    multiple of 8; int8 rows where K is a multiple of 16, else gathered as
    1 x 1 x K images; bf16 x with a bf16 output quantized in the GEMM where
    N spans two column tiles) and a plan that fits."""
    if body == "bf16":
        src, kk, esize = Q.PTQ_ROWS, -(-k // 8) * 8, 2
    elif body == "int8 bf16 x" and Q.quantizes_in_gemm(torch.bfloat16, torch.bfloat16, None, 1, 0,
                                                       k, n):
        src, kk, esize = Q.PTQ_ROWS_QUANT, k, 1
    else:
        src, kk, esize = (Q.PTQ_ROWS if k % 16 == 0 else Q.PTQ_GATHER), k, 1
    plan = Q.ptq_plan(n, kk, src, esize, m, H100_SMS)
    assert plan["smem"] <= K.SMEM_LIMIT and 2 <= plan["stages"] <= Q.PTQ_MAX_RING
    assert plan["bn"] in Q.PTQ_WIDTHS and not (plan["tall"] and src == Q.PTQ_ROWS_QUANT)
    if plan["resident"]:
        assert plan["held"] == -(-n // plan["bn"]) * -(-kk * esize // 128) * plan["bn"] * 128
        assert plan["held"] <= Q.MAX_TX_BYTES


@pytest.mark.parametrize("sms", [None, 0])
def test_spike_plan_needs_the_sm_count(sms):
    """A plan sized by M needs the card's SM count; the PTQ sites' plans
    (no M) do not."""
    with pytest.raises(ValueError, match="SM count"):
        Q.ptq_plan(1536, 384, Q.PTQ_ROWS, 1, 625, sms)
    assert Q.ptq_plan(1536, 384, Q.PTQ_ROWS, 1, None, sms)["bn"] == 128


def test_spike_plan_follows_the_sm_count():
    """s3_fc1's 60 items of 128 columns fill a card of 60 SMs, not 132."""
    assert Q.ptq_plan(1536, 384, Q.PTQ_ROWS, 1, 625, H100_SMS)["bn"] == 64
    assert Q.ptq_plan(1536, 384, Q.PTQ_ROWS, 1, 625, 60)["bn"] == 128


def test_spike_shapes_quantize_after_the_pass():
    """The spike's N (1536, 3072) spans 12 or 24 column tiles: its int8 body
    quantizes x by the pass, then runs the GEMM on int8 rows; a narrow N
    with a bf16 output quantizes in the GEMM."""
    for _, k, n in SPIKE_SHAPES:
        assert not Q.quantizes_in_gemm(torch.bfloat16, torch.bfloat16, None, 1, 0, k, n)
    assert Q.quantizes_in_gemm(torch.bfloat16, torch.bfloat16, None, 1, 0, 64, 96)


@pytest.mark.parametrize("m,k,n", [(37, 64, 96), (130, 100, 132), (9, 24, 40)])
def test_spike_wrappers_take_the_plain_versions_on_cpu(m, k, n):
    """On CPU tensors the three bodies run their plain versions, with or
    without a packed weight, and count no launch."""
    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, n) * 0.05).astype(np.float32))
    w8 = torch.clamp(w * 16.0, -127, 127).to(torch.int8)
    x8 = torch.clamp(x * 16.0, -127, 127).to(torch.int8)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    sx = float(x.abs().max()) / 127.0
    Q.reset_launches()
    for kw8, kw16 in (({}, {}), (dict(w_packed=Q.pack_weight(w8)),
                                 dict(w_packed=Q.pack_weight(wb)))):
        assert torch.equal(Q.int8_spike_direct(x8, w8, **kw8), Q.int8_spike_direct_plain(x8, w8))
        assert torch.equal(Q.int8_spike_int8(x, w8, sx, **kw8), Q.int8_spike_int8_plain(x, w8, sx))
        assert torch.equal(Q.int8_spike_bf16(xb, wb, **kw16), Q.int8_spike_bf16_plain(xb, wb))
    assert all(v == 0 for v in Q.LAUNCHES.values())


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_pack_weight_is_k_major_and_zero_padded(dtype):
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randint(-127, 128, (100, 36)).astype(np.float32)).to(dtype)
    packed = Q.pack_weight(w)
    assert packed.dtype == dtype and packed.shape == (36, 128)
    assert torch.equal(packed[:, :100], w.t()) and not packed[:, 100:].any()
