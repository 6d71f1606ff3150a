"""The int8 mode's MLP pair on the CPU: ``ln_fc1_rowmax_int8`` (pass 1) and
``mlp_int8_scale_residual`` (pass 2) of
:mod:`vip_cup_2022_tpu_torch.ops.kernels.block_int8`, whose plain versions
the CPU runs, against the three-launch chain they replaced
(``ln_fc1_gelu_int8`` -> ``quantize_rows`` -> ``fc2_scale_residual_int8``):
equal under ``torch.equal`` at narrow widths, ragged row counts, a hidden row
that is all zeros (the 1e-8 abs-max floor) and a hidden code on a .5 tie;
the pair's plan at every shape of the main path. The kernels themselves are
held to these plain versions on the card (tests/test_torch_kernels_cuda.py).
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.ops.kernels import block_int8 as B
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as CK
from vip_cup_2022_tpu_torch.quant import dyn_int8 as Q8

WIDTHS = (32, 64, 96)
ROWS = (1, 77, 130)  # one row, fewer than a 128-row tile, one past it


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _params(c, n, rng, b1_zero=False):
    """LN params, fc1 / fc2 int8 weights and biases, layer scale, from numpy."""
    lg, lb = rng.uniform(0.5, 1.5, c), rng.uniform(-0.1, 0.1, c)
    fc1 = Q8.quantize_linear(_t(rng.uniform(-1, 1, (n, c)).astype(np.float32) * c ** -0.5))
    fc2 = Q8.quantize_linear(_t(rng.uniform(-1, 1, (c, n)).astype(np.float32) * n ** -0.5))
    b1 = np.zeros(n) if b1_zero else rng.uniform(-0.1, 0.1, n)
    b2, gamma = rng.uniform(-0.1, 0.1, c), rng.uniform(0.5, 1.5, c)
    f = lambda a: _t(np.asarray(a, np.float32))  # noqa: E731
    return dict(lg=f(lg), lb=f(lb), fc1=fc1, b1=f(b1), fc2=fc2, b2=f(b2), gamma=f(gamma))


def _chain(x, p, residual, out_dtype, eps=1e-6):
    """The old plain chain: hidden, its codes and scales, output."""
    hid = B.ln_fc1_gelu_int8_plain(x, p["lg"], p["lb"], p["fc1"].q, p["fc1"].s, p["b1"], eps)
    h_q, h_s = B.quantize_rows_plain(hid)
    out = B.fc2_scale_residual_int8_plain(h_q, h_s, p["fc2"].q, p["fc2"].s, p["b2"], p["gamma"],
                                          residual, out_dtype)
    return hid, h_s, out


def _pair(x, p, residual, out_dtype, eps=1e-6):
    x_q, x_s, h_s = B.ln_fc1_rowmax_int8_plain(x, p["lg"], p["lb"], p["fc1"].q, p["fc1"].s,
                                               p["b1"], eps)
    out = B.mlp_int8_scale_residual_plain(x_q, x_s, h_s, p["fc1"].q, p["fc1"].s, p["b1"],
                                          p["fc2"].q, p["fc2"].s, p["b2"], p["gamma"], residual,
                                          out_dtype)
    return (x_q, x_s, h_s), out


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("ratio", [3, 4])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("res", ["bf16", "f32"])
def test_plain_pair_equals_plain_chain(c, ratio, m, res):
    """ConvNeXt's bf16 residual and GCViT's f32 r1, each to bf16: the pair's
    hidden scales equal quantize_rows' of the chain's hidden, its x codes
    and scales dyn_quant_rows' of the LN output, its output the chain's."""
    rng = np.random.RandomState(c * 10 + ratio + m)
    n = ratio * c
    p = _params(c, n, rng)
    x = _t(rng.uniform(-1, 1, (m, c)).astype(np.float32))
    residual = _t(rng.uniform(-1, 1, (m, c)).astype(np.float32))
    residual = residual.to(torch.bfloat16) if res == "bf16" else residual
    hid, h_s, want = _chain(x, p, residual, torch.bfloat16)
    (x_q, x_s, got_s), got = _pair(x, p, residual, torch.bfloat16)
    ln_q, ln_s = Q8.dyn_quant_rows(B._layer_norm(x, p["lg"], p["lb"], 1e-6))
    assert torch.equal(x_q, ln_q) and torch.equal(x_s, ln_s.view(-1))
    assert torch.equal(got_s, h_s)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("c", WIDTHS)
def test_plain_pair_equals_chain_on_an_all_zero_hidden_row(c):
    """A constant x row with a zero LN bias normalises to zeros, its codes
    are 0 and, with b1 = 0, its hidden is 0: the scale takes the 1e-8 floor
    on both paths."""
    rng = np.random.RandomState(c)
    n = 4 * c
    p = _params(c, n, rng, b1_zero=True)
    p["lb"] = torch.zeros(c)
    x = rng.uniform(-1, 1, (5, c)).astype(np.float32)
    x[2] = 0.25
    x = _t(x)
    residual = _t(rng.uniform(-1, 1, (5, c)).astype(np.float32)).to(torch.bfloat16)
    hid, h_s, want = _chain(x, p, residual, torch.bfloat16)
    assert torch.count_nonzero(hid[2]) == 0
    assert h_s[2].item() == np.float32(Q8.MIN_AMAX) * np.float32(Q8.INV_127)
    (_, _, got_s), got = _pair(x, p, residual, torch.bfloat16)
    assert torch.equal(got_s, h_s) and torch.equal(got, want)


def _tie_bias(n, rng):
    """fc1 biases whose GELU is the bias itself (>= 8, where erf rounds to 1)
    and one of which, at the row's abs-max 100, quantizes to k + 0.5 exactly."""
    b1 = rng.uniform(8.0, 90.0, n).astype(np.float32)
    b1[0] = 100.0
    s = np.float32(np.float32(100.0) * np.float32(Q8.INV_127))
    inv = np.float32(1.0) / s
    for k in range(20, 100):
        target = np.float32((k + 0.5) / inv)
        below, above = np.nextafter(target, np.float32(0)), np.nextafter(target, np.float32(200))
        for cand in (below, target, above):
            if np.float32(cand * inv) == np.float32(k + 0.5) and cand >= 8.0:
                b1[1] = cand
                return b1
    raise AssertionError("no bias quantizes onto a .5 tie")


@pytest.mark.parametrize("c", WIDTHS)
def test_plain_pair_equals_chain_with_a_code_on_a_tie(c):
    """Rows whose LN output is 0 have the hidden gelu(b1) = b1 exactly; b1
    puts one of its codes on k + 0.5 (half to even on both paths)."""
    rng = np.random.RandomState(c + 1)
    n = 3 * c
    p = _params(c, n, rng)
    p["lb"] = torch.zeros(c)
    p["b1"] = _t(_tie_bias(n, rng))
    x = rng.uniform(-1, 1, (7, c)).astype(np.float32)
    x[[1, 4]] = -0.5
    x = _t(x)
    residual = _t(rng.uniform(-1, 1, (7, c)).astype(np.float32))
    hid, h_s, want = _chain(x, p, residual, torch.bfloat16)
    v = hid[1] * (torch.tensor(1.0) / h_s[1])
    assert torch.any(v == torch.floor(v) + 0.5)  # the tie is there
    (_, _, got_s), got = _pair(x, p, residual, torch.bfloat16)
    assert torch.equal(got_s, h_s) and torch.equal(got, want)


@pytest.mark.parametrize("c", WIDTHS)
def test_cpu_dispatch_and_blocks_take_the_pair(c, monkeypatch):
    """On CPU tensors the wrappers run their plain versions and count no
    launch; mlp_int8 and the ConvNeXt block go through the pair, equal to
    the same block with the chain in its place."""
    rng = np.random.RandomState(c + 2)
    n = 4 * c
    p = _params(c, n, rng)
    x = _t(rng.uniform(-1, 1, (2, 5, 7, c)).astype(np.float32)).to(torch.bfloat16)
    dw, dwb = _t(rng.uniform(-0.2, 0.2, (7, 7, c)).astype(np.float32)), torch.zeros(c)
    B.reset_launches()
    d = CK.dwconv7x7_nhwc(x, dw, dwb).view(-1, c).float()
    got1 = B.ln_fc1_rowmax_int8(d, p["lg"], p["lb"], p["fc1"].q, p["fc1"].s, p["b1"], 1e-6)
    want1 = B.ln_fc1_rowmax_int8_plain(d, p["lg"], p["lb"], p["fc1"].q, p["fc1"].s, p["b1"], 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got1, want1))
    args = (p["fc1"].q, p["fc1"].s, p["b1"], p["fc2"].q, p["fc2"].s, p["b2"], p["gamma"],
            x.view(-1, c), torch.bfloat16)
    got2 = B.mlp_int8_scale_residual(*got1, *args)
    assert torch.equal(got2, B.mlp_int8_scale_residual_plain(*want1, *args))
    assert all(v == 0 for v in B.LAUNCHES.values())
    block_args = (x, dw, dwb, p["lg"], p["lb"], p["fc1"], p["b1"], p["fc2"], p["b2"], p["gamma"])
    seen = []
    real = B.mlp_int8_scale_residual_plain
    monkeypatch.setattr(B, "mlp_int8_scale_residual_plain",
                        lambda *a: seen.append(1) or real(*a))
    got = B.convnext_block_int8(*block_args)
    assert seen == [1]
    monkeypatch.setattr(B, "mlp_int8", B.mlp_int8_chain)
    assert torch.equal(got, B.convnext_block_int8(*block_args))


# the main path's MLP shapes: ConvNeXt s1-s4 (N = 4C), GCViT L2-L4 (N = 3C)
MAIN_SHAPES = [(96, 384), (192, 768), (384, 1536), (768, 3072), (128, 384), (256, 768),
               (512, 1536)]


@pytest.mark.parametrize("c,n", MAIN_SHAPES)
def test_pair_plan_at_every_main_path_shape(c, n):
    """Pass 2's plan: one column tile up to C = 384 (fc1 once), two at 512,
    three at 768; four consumer warpgroups, three or four of them holding
    output slices of 32, 64 or 96 columns; all of W1 and W2 held in shared
    memory at C <= 128, else streamed through rings of a chunk's K tiles at
    least; within shared memory; pass 1 takes fc1's tiles, 96 columns wide up
    to C = 192."""
    p = B.int8_plan("mlp", c, n)
    kt, nk = -(-c // B.TILE_K), n // B.MLP_CHUNK
    assert p["col_tiles"] == {512: 2, 768: 3}.get(c, 1)
    assert p["ow"] * p["no"] * p["col_tiles"] == c and p["ow"] in (32, 64, 96)
    assert p["no"] in (3, 4) and p["resident"] == (c <= 128)
    if p["resident"]:
        assert p["s1"] == nk * kt and p["s2"] == nk
    else:
        assert kt <= p["s1"] <= B.MLP_MAX_STAGES and 1 <= p["s2"] <= B.MLP_MAX_STAGES // 2
    assert p["x_buffers"] in (1, 2) and p["smem"] <= CK.SMEM_LIMIT
    ln, rowmax = B.int8_plan("ln", c, n), B.int8_plan("rowmax", c, n)
    assert rowmax["bn"] == (96 if c <= 192 else ln["bn"]) and rowmax["smem"] <= CK.SMEM_LIMIT


@pytest.mark.parametrize("c,n,ow,no", [(64, 192, 32, 2), (96, 288, 32, 3), (128, 320, 32, 4)])
def test_pair_plan_takes_a_short_last_chunk(c, n, ow, no):
    """A hidden that 128 does not divide (GCViT's L1: C = 64, N = 192, int8
    where ``VIPTPU_GCVIT_INT8_MIN_C`` <= 64) runs on the pair too: its last
    chunk is short, every W1 K tile and W2 chunk resident, counted whole."""
    p = B.int8_plan("mlp", c, n)
    nk = -(-n // B.MLP_CHUNK)
    assert (p["col_tiles"], p["ow"], p["no"]) == (1, ow, no)
    assert p["resident"] and p["s1"] == nk and p["s2"] == nk
    assert p["smem"] <= CK.SMEM_LIMIT and B.int8_plan("rowmax", c, n)["bn"] in (64, 96, 128)


@pytest.mark.parametrize("c,n", [(32, 128), (160, 640), (64, 200)])
def test_pair_refuses_shapes_without_a_plan(c, n):
    """A width no output column tile is built for (C / R never one of
    ``MLP_COLUMN_TILES``), or a hidden not a multiple of 32: no plan, so
    the wrapper raises on the card."""
    with pytest.raises(ValueError):
        B.int8_plan("mlp", c, n)


def test_exp_int8_mlp_tool_needs_a_card(monkeypatch):
    """The measurement tool's parts are CUDA kernels: without a card it exits."""
    from vip_cup_2022_tpu_torch.tools import exp_int8_mlp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_int8_mlp.main(["--parts", "cuts"])
    assert set(exp_int8_mlp.PARTS) == {"gelu", "scan", "cuts", "widths"}


def test_exp_int8_parity_tool_needs_a_card(monkeypatch):
    """The tool that compares the int8 kernels of two checkouts runs them on
    the card: without one it exits."""
    from vip_cup_2022_tpu_torch.tools import exp_int8_parity

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_int8_parity.main(["--batch", "1"])
    assert {"s1", "s2", "s3", "s4", "L1", "L2", "L3", "L4"} == set(exp_int8_parity.SHAPES)

