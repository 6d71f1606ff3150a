"""The fused blocks' in-kernel int8 mode (``VIPTPU_INT8_KERNELS=1``) of the
port against the JAX package's, on the CPU.

The port's plain versions (:mod:`vip_cup_2022_tpu_torch.ops.kernels.block_int8`)
are held to the JAX Pallas kernels run in interpret mode under the knob, with
``VIPTPU_GELU=erf``, in f32. The scheme's pieces (:mod:`vip_cup_2022_tpu_torch.
quant.dyn_int8`) equal JAX's bit for bit. The kernels' outputs agree within
1e-4 of max|ref| except in rows where a code sits on a .5 rounding tie: the
two packages' LN, conv and erf can differ by an ulp, which moves such a code
by one (that row is then held to 0.03, what one code step moves it by, and a
window's attention spreads a tie in its q / k / v to the whole window).
JAX's whole-image ConvNeXt kernel (K1) takes one activation scale per TPU
grid tile where the port takes one per row, so it is held to JAX's own
0.03, and whole models to JAX's own 0.05 (``tests/test_pallas.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_gcvit import _cfg, _jax_gcvit
from test_torch_gcvit import two_member_workspace  # noqa: F401  (a fixture)
from test_torch_slice import NARROW as NARROW_CONVNEXT, _jax_variables
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.ops.pallas import convnext_block as jcb
from vip_cup_2022_tpu.ops.pallas import gcvit_block as jgb
from vip_cup_2022_tpu_torch.infer import engine
from vip_cup_2022_tpu_torch.models import convnext as port_convnext
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.models import gcvit as port_gcvit
from vip_cup_2022_tpu_torch.ops.kernels import block_int8 as B
from vip_cup_2022_tpu_torch.quant import dyn_int8 as Q8

TIGHT = 1e-4  # of max|ref|: f32 on both sides, the same codes
TIE_BOUND = 0.03  # a row with a code on a .5 tie: one code step's share
TIE_ULPS = 8  # ulps of a pre-rounding value that the two packages' last-ulp differences span
K1_BOUND = 0.03  # JAX's own bound of its int8 ConvNeXt kernels (tests/test_pallas.py)
MODEL_BOUND = 0.05  # JAX's own bound of its int8 GCViT model (tests/test_pallas.py)


@pytest.fixture
def int8_mode(monkeypatch):
    monkeypatch.setenv("VIPTPU_INT8_KERNELS", "1")
    monkeypatch.setenv("VIPTPU_GELU", "erf")
    for knob in ("VIPTPU_GCVIT_INT8_MIN_C", "VIPTPU_BATCHLANE_FOLD",
                 "VIPTPU_CONVNEXT_FUSED_MIN_C", "VIPTPU_NO_FUSED_BLOCK"):
        monkeypatch.delenv(knob, raising=False)


def _u(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _w8(w_kn):
    """An int8 weight from a JAX-layout (K, N) f32 kernel."""
    return Q8.quantize_linear(_t(w_kn.T))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


# ---------------------------------------------------------------------------
# the scheme
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,n,m", [(96, 64, 50), (384, 96, 7)])
def test_scheme_equals_jax_bit_for_bit(k, n, m):
    """``quant_cols``, ``dyn_quant_rows`` and ``dot_i8`` against JAX's
    ``_quant_cols``, ``_dyn_quant_rows`` and ``_dot_i8`` (run op by op, as
    its epilogue is written: XLA's fusion of a jitted ``acc * s + b`` into
    one multiply-add rounds once less) on seeded f32 inputs with an all-zero
    weight column, an all-zero row and a row of .5 ties (amax 127: scale
    1, so 2.5 and -3.5 round half to even)."""
    rng = np.random.RandomState(k + n)
    w = _u(rng, (k, n)) * k ** -0.5
    w[:, 3] = 0.0
    y = _u(rng, (m, k), -3, 3)
    y[1] = 0.0
    y[0, :6] = [127.0, -126.5, 2.5, -3.5, 0.5, 1.5]
    y[0, 6:] = 0.0
    b = _u(rng, (n,), -0.1, 0.1)

    jq, js = jcb._quant_cols(jnp.asarray(w))
    q, s = Q8.quant_cols(_t(w))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))
    assert s[3] == 1.0 and not q[:, 3].any()
    jyq, jys = jgb._dyn_quant_rows(jnp.asarray(y))
    yq, ys = Q8.dyn_quant_rows(_t(y))
    assert np.array_equal(yq.numpy(), np.asarray(jyq)) and np.array_equal(ys.numpy(), np.asarray(jys))
    assert ys[0, 0] == 1.0 and yq[0, :6].tolist() == [127, -126, 2, -4, 0, 2]
    for bias in (None, b):
        want = jgb._dot_i8(jnp.asarray(y), jq, js, None if bias is None else jnp.asarray(bias))
        got = Q8.dot_i8(_t(y), q, s, None if bias is None else _t(bias))
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_the_knob_reads_as_in_jax(monkeypatch):
    """Only ``VIPTPU_INT8_KERNELS=1`` turns the mode on; ``VIPTPU_GCVIT_INT8_MIN_C``
    picks the same GCViT widths as JAX's ``gcvit_int8``."""
    for value in ("1", "0", "true", "yes", "", " 1", "2", None):
        if value is None:
            monkeypatch.delenv("VIPTPU_INT8_KERNELS", raising=False)
        else:
            monkeypatch.setenv("VIPTPU_INT8_KERNELS", value)
        assert Q8.int8_kernels_enabled() == jcb.int8_kernels_enabled() == (value == "1")
        for min_c in (None, "0", "64", "128", "256", "1000"):
            if min_c is None:
                monkeypatch.delenv("VIPTPU_GCVIT_INT8_MIN_C", raising=False)
            else:
                monkeypatch.setenv("VIPTPU_GCVIT_INT8_MIN_C", min_c)
            for c in (32, 64, 96, 128, 256, 512):
                assert Q8.gcvit_int8(c) == jgb.gcvit_int8(c), (value, min_c, c)


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels
# ---------------------------------------------------------------------------
class _Quantized:
    """Records every activation the port quantizes (``dyn_quant_rows``'s
    inputs, as (rows, K)) while active."""

    def __init__(self, monkeypatch):
        self.values = []
        real = Q8.dyn_quant_rows

        def record(y):
            self.values.append(y.detach().float().reshape(-1, y.shape[-1]).clone())
            return real(y)

        monkeypatch.setattr(Q8, "dyn_quant_rows", record)

    def near_tie_rows(self, window: int = 0) -> np.ndarray:
        """Rows holding a value within ``TIE_ULPS`` ulps of a .5 boundary at
        any quantization; with ``window`` the first one's (the qkv input's)
        spread to their window of that many rows."""
        rows = None
        for i, y in enumerate(self.values):
            v = (y * (torch.tensor(1.0) / _row_scales(y))).numpy()
            margin = TIE_ULPS * np.spacing(np.abs(v).astype(np.float32))
            near = (np.abs(v - np.floor(v) - 0.5) <= margin).any(-1)
            if window and i == 0:
                near = np.repeat(near.reshape(-1, window).any(-1), window)
            rows = near if rows is None else rows | near
        return rows


def _row_scales(y):
    amax = y.abs().amax(-1, keepdim=True)
    return torch.clamp(amax, min=Q8.MIN_AMAX) * torch.tensor(Q8.INV_127)


def _assert_close_but_ties(got, want, near):
    """Each row within ``TIGHT`` of max|ref|, or, where a code of its own
    (or of its window) sits on a .5 tie, within ``TIE_BOUND``; at least
    three quarters of the rows within ``TIGHT``."""
    got, want = np.asarray(got), np.asarray(want)
    got, want = got.reshape(near.shape[0], -1), want.reshape(near.shape[0], -1)
    err = np.abs(got - want).max(-1) / np.abs(want).max()
    apart = err > TIGHT
    assert not (apart & ~near).any(), err[~near].max()
    assert (err <= TIE_BOUND).all(), err.max()
    assert apart.mean() <= 0.25, apart.mean()


@pytest.mark.parametrize("c,split,m", [(64, 3, 37), (64, 2, 37), (128, 3, 64), (32, 2, 5)])
def test_ln_qkv_int8_plain_matches_ln_dense(int8_mode, monkeypatch, c, split, m):
    rng = np.random.RandomState(c + split)
    x = _u(rng, (m, c))
    g, b = _u(rng, (c,), 0.5, 1.5), _u(rng, (c,), -0.1, 0.1)
    w, wb = _u(rng, (c, split * c)) * c ** -0.5, _u(rng, (split * c,), -0.1, 0.1)
    want = jgb.ln_dense(jnp.asarray(x), g, b, jnp.asarray(w), wb, eps=1e-5, split=split,
                        int8=True, interpret=True)
    seen = _Quantized(monkeypatch)
    wq = _w8(w)
    got = B.ln_qkv_int8(_t(x), _t(g), _t(b), wq.q, wq.s, _t(wb), 1e-5)
    assert len(got) == split and all(a.shape == (m, c) and a.is_contiguous() for a in got)
    _assert_close_but_ties(torch.cat(got, 1), np.concatenate([np.asarray(r) for r in want], 1),
                           seen.near_tie_rows())


@pytest.mark.parametrize("c,m", [(64, 37), (128, 50)])
def test_proj_ln_mlp_int8_plain_chain_matches_proj_res_ln_mlp(int8_mode, monkeypatch, c, m):
    rng = np.random.RandomState(c)
    h = 3 * c
    wp, bp = _u(rng, (c, c)) * c ** -0.5, _u(rng, (c,), -0.1, 0.1)
    g1, lg, lb = _u(rng, (c,), 0.5, 1.5), _u(rng, (c,), 0.5, 1.5), _u(rng, (c,), -0.1, 0.1)
    w1, b1 = _u(rng, (c, h)) * c ** -0.5, _u(rng, (h,), -0.1, 0.1)
    w2, b2, g2 = _u(rng, (h, c)) * h ** -0.5, _u(rng, (c,), -0.1, 0.1), _u(rng, (c,), 0.5, 1.5)
    a, x = _u(rng, (m, c)), _u(rng, (m, c))
    want = jgb.proj_res_ln_mlp(jnp.asarray(a), jnp.asarray(x), wp, bp, g1, lg, lb, w1, b1, w2,
                               b2, g2, eps=1e-5, gelu="erf", int8=True, interpret=True)
    seen = _Quantized(monkeypatch)
    p8, f1, f2 = _w8(wp), _w8(w1), _w8(w2)
    a_q, a_s = B.quantize_rows(_t(a))
    r1 = B.proj_scale_residual_int8(a_q, a_s, p8.q, p8.s, _t(bp), _t(g1), _t(x))
    assert r1.dtype == torch.float32
    hid = B.ln_fc1_gelu_int8(r1, _t(lg), _t(lb), f1.q, f1.s, _t(b1), 1e-5)
    h_q, h_s = B.quantize_rows(hid)
    got = B.fc2_scale_residual_int8(h_q, h_s, f2.q, f2.s, _t(b2), _t(g2), r1, torch.float32)
    _assert_close_but_ties(got, want, seen.near_tie_rows())


def _block_params(c, s, heads, n, rng):
    h = 3 * c
    return dict(
        ln1_g=_u(rng, (c,), 0.5, 1.5), ln1_b=_u(rng, (c,), -0.1, 0.1),
        wqkv=_u(rng, (c, s * c)) * c ** -0.5, bqkv=_u(rng, (s * c,), -0.1, 0.1),
        bias=_u(rng, (heads, n, n)),
        wp=_u(rng, (c, c)) * c ** -0.5, bp=_u(rng, (c,), -0.1, 0.1),
        ln2_g=_u(rng, (c,), 0.5, 1.5), ln2_b=_u(rng, (c,), -0.1, 0.1),
        w1=_u(rng, (c, h)) * c ** -0.5, b1=_u(rng, (h,), -0.1, 0.1),
        w2=_u(rng, (h, c)) * h ** -0.5, b2=_u(rng, (c,), -0.1, 0.1),
        gamma1=_u(rng, (c,), 0.5, 1.5), gamma2=_u(rng, (c,), 0.5, 1.5),
    )


@pytest.mark.parametrize("n,nwin,heads,global_query", [
    (49, 4, 2, False), (49, 4, 2, True), (9, 4, 1, False), (49, 1, 4, True),
])
def test_window_block_int8_plain_matches_mono_block(int8_mode, monkeypatch, n, nwin, heads,
                                                     global_query):
    """The int8 block (qkv, proj, fc1, fc2 int8; the attention f32) against
    the TPU's whole-block kernel in its int8 mode (K7), hd = 32."""
    rng = np.random.RandomState(n + nwin + heads + 1)
    b, c = 2, heads * 32
    p = _block_params(c, 2 if global_query else 3, heads, n, rng)
    x = _u(rng, (b, nwin * n, c))
    qg = _u(rng, (b, n, c)) if global_query else None
    want = jgb.mono_window_transformer_block(
        jnp.asarray(x), heads=heads, n=n, ln1_g=p["ln1_g"], ln1_b=p["ln1_b"], wqkv=p["wqkv"],
        bqkv=p["bqkv"], bias=p["bias"], wp=p["wp"], bp=p["bp"], ln2_g=p["ln2_g"],
        ln2_b=p["ln2_b"], w1=p["w1"], b1=p["b1"], w2=p["w2"], b2=p["b2"],
        gamma1=p["gamma1"], gamma2=p["gamma2"], scale=32 ** -0.5,
        q_global=None if qg is None else jnp.asarray(qg), group=min(2, nwin), eps=1e-5,
        int8=True, interpret=True)
    seen = _Quantized(monkeypatch)
    got = B.window_transformer_block_int8(
        _t(x), None if qg is None else _t(qg), n=n, ln1_weight=_t(p["ln1_g"]),
        ln1_bias=_t(p["ln1_b"]), qkv=_w8(p["wqkv"]), bqkv=_t(p["bqkv"]), bias=_t(p["bias"]),
        proj=_w8(p["wp"]), bp=_t(p["bp"]), gamma1=_t(p["gamma1"]), ln2_weight=_t(p["ln2_g"]),
        ln2_bias=_t(p["ln2_b"]), fc1=_w8(p["w1"]), b1=_t(p["b1"]), fc2=_w8(p["w2"]),
        b2=_t(p["b2"]), gamma2=_t(p["gamma2"]), eps=1e-5)
    _assert_close_but_ties(got, want, seen.near_tie_rows(window=n))


def _convnext_params(c, rng):
    shapes = [(7, 7, c), (c,), (c,), (c,), (c, 4 * c), (4 * c,), (4 * c, c), (c,)]
    args = [rng.uniform(-0.2, 0.2, s).astype(np.float32) for s in shapes]
    args.append(rng.uniform(0.5, 1.5, (c,)).astype(np.float32))
    return args


def _port_convnext_block(x, args):
    dw, dwb, g, bt, w1, b1, w2, b2, ls = args
    return B.convnext_block_int8(_t(x), _t(dw), _t(dwb), _t(g), _t(bt), _w8(w1), _t(b1), _w8(w2),
                                 _t(b2), _t(ls), eps=1e-6)


@pytest.mark.parametrize("c,shape", [(32, (3, 9, 11)), (96, (2, 9, 11)), (96, (3, 5, 7))])
def test_convnext_block_int8_plain_matches_batchlane(int8_mode, monkeypatch, c, shape):
    """K2's int8 lane fold: one scale per batch column, a token, as the port's
    per row."""
    rng = np.random.RandomState(c)
    x = rng.uniform(-1, 1, (*shape, c)).astype(np.float32)
    args = _convnext_params(c, rng)
    xt = jnp.transpose(jnp.asarray(x), (1, 2, 3, 0))
    want = jnp.transpose(
        jcb.fused_convnext_block_batchlane(xt, *map(jnp.asarray, args), gelu="erf",
                                           interpret=True), (3, 0, 1, 2))
    seen = _Quantized(monkeypatch)
    got = _port_convnext_block(x, args)
    _assert_close_but_ties(got, want, seen.near_tie_rows())


@pytest.mark.parametrize("c,shape,row_tile", [
    (32, (2, 9, 9), None), (256, (2, 9, 9), None), (32, (2, 13, 11), 5), (256, (1, 7, 5), 3),
])
def test_convnext_block_int8_plain_near_fused_convnext_block(int8_mode, c, shape, row_tile):
    """K1 quantizes with one scale per TPU grid tile (the port: per row), so
    the two agree within JAX's own 0.03 of max|ref|."""
    rng = np.random.RandomState(c + shape[1])
    x = rng.uniform(-1, 1, (*shape, c)).astype(np.float32)
    args = _convnext_params(c, rng)
    want = jcb.fused_convnext_block(jnp.asarray(x), *map(jnp.asarray, args), gelu="erf",
                                    row_tile=row_tile, interpret=True)
    assert _rel(_port_convnext_block(x, args), want) <= K1_BOUND


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
GCVIT = dict(depths=(2, 1, 1, 1), dim=16, num_heads=(1, 2, 4, 8))


@pytest.fixture(scope="module")
def gcvit_pair():
    kw = dict(input_size=(224, 224), nb_classes=3, **GCVIT)
    module, tree = _jax_gcvit(seed=5, **kw)
    port, _ = create_model("GCViTTiny", **kw)
    transfer_weights(tree, port, strict=True)
    x = np.random.RandomState(5).uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    return module, tree, port.eval(), x


@pytest.fixture(scope="module")
def convnext_pair():
    kw = dict(input_size=(64, 64), nb_classes=3, **NARROW_CONVNEXT)
    module, tree = _jax_variables(seed=3, **kw)
    port, _ = create_model("convnext_tiny_in22k", **kw)
    transfer_weights(tree, port, strict=True)
    x = np.random.RandomState(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return module, tree, port.eval(), x


def test_narrow_gcvit_int8_matches_jax_fused_model(int8_mode, monkeypatch, gcvit_pair):
    """Every level int8 (``VIPTPU_GCVIT_INT8_MIN_C=0``), both packages on
    the fused block path: within 0.05 of max|ref|, and apart from the f32
    path (the mode ran)."""
    module, tree, port, x = gcvit_pair
    monkeypatch.setenv("VIPTPU_GCVIT_INT8_MIN_C", "0")
    jax_module, _, _ = jax_create_model("GCViTTiny", init=False, fused_block=True,
                                        input_size=(224, 224), nb_classes=3, **GCVIT)
    want = np.asarray(jax.jit(jax_module.apply)(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_t(x)).numpy()
        monkeypatch.delenv("VIPTPU_INT8_KERNELS")
        f32 = port(_t(x)).numpy()
    assert _rel(got, want) <= MODEL_BOUND
    assert _rel(got, f32) > 1e-5


def _record_convnext_paths(monkeypatch):
    """(JAX's fused blocks as (C, int8), the port's blocks as (C, path))."""
    jax_seen, port_seen = [], []
    quant_calls = []
    real_q = jcb._quant_cols
    monkeypatch.setattr(jcb, "_quant_cols", lambda w: quant_calls.append(1) or real_q(w))
    for name, channel_axis in (("fused_convnext_block", -1),
                               ("fused_ln_mlp_residual_batchlane", 2)):
        real = getattr(jcb, name)

        def wrapped(x, *a, _real=real, _axis=channel_axis, **kw):
            before = len(quant_calls)
            out = _real(x, *a, **kw)
            jax_seen.append((x.shape[_axis], len(quant_calls) > before))
            return out

        monkeypatch.setattr(jcb, name, wrapped)
    for name, path in (("convnext_block_int8", "int8"), ("convnext_block", "bf16")):
        real = getattr(port_convnext, name)

        def wrapped(x, *a, _real=real, _path=path, **kw):
            port_seen.append((x.shape[-1], _path))
            return _real(x, *a, **kw)

        monkeypatch.setattr(port_convnext, name, wrapped)
    real_unfused = port_convnext.ConvNeXtBlock._unfused

    def unfused(self, x):
        port_seen.append((x.shape[-1], "unfused"))
        return real_unfused(self, x)

    monkeypatch.setattr(port_convnext.ConvNeXtBlock, "_unfused", unfused)
    return jax_seen, port_seen


@pytest.mark.parametrize("knobs", [
    {}, {"VIPTPU_BATCHLANE_FOLD": "0"}, {"VIPTPU_CONVNEXT_FUSED_MIN_C": "512"},
    {"VIPTPU_CONVNEXT_FUSED_MIN_C": "100000", "VIPTPU_BATCHLANE_FOLD": "0"},
], ids=["default", "fold0", "min_c512", "min_c_all_fold0"])
def test_narrow_convnext_int8_matches_jax_fused_model(int8_mode, monkeypatch, convnext_pair,
                                                      knobs):
    """Both packages on the fused path under the knob and
    ``VIPTPU_BATCHLANE_FOLD`` / ``VIPTPU_CONVNEXT_FUSED_MIN_C``: the same
    blocks run int8, bf16-kernel or unfused (JAX's unfused blocks are the
    ones its fused kernels never see), and the logits agree within 0.05 of
    max|ref|."""
    module, tree, port, x = convnext_pair
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    jax_seen, port_seen = _record_convnext_paths(monkeypatch)
    jax_module, _, _ = jax_create_model("convnext_tiny_in22k", init=False, fused_block=True,
                                        input_size=(64, 64), nb_classes=3, **NARROW_CONVNEXT)
    want = np.asarray(jax.jit(jax_module.apply)(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_t(x)).numpy()
    port_fused = [(c, p == "int8") for c, p in port_seen if p != "unfused"]
    assert port_fused == jax_seen
    widths = [c for c, _ in port_seen]
    assert widths == [32, 64, 256, 512]
    unfused = {c for c, p in port_seen if p == "unfused"}
    assert unfused == set(widths) - {c for c, _ in jax_seen}
    assert _rel(got, want) <= MODEL_BOUND


def test_no_fused_block_under_the_knob_equals_without(int8_mode, monkeypatch, gcvit_pair,
                                                      convnext_pair):
    """``VIPTPU_NO_FUSED_BLOCK=1``: the unfused blocks, the knob or not."""
    monkeypatch.setenv("VIPTPU_NO_FUSED_BLOCK", "1")
    monkeypatch.setenv("VIPTPU_GCVIT_INT8_MIN_C", "0")
    for _, _, port, x in (gcvit_pair, convnext_pair):
        with torch.no_grad():
            got = port(_t(x[:1]))
            monkeypatch.delenv("VIPTPU_INT8_KERNELS")
            want = port(_t(x[:1]))
            monkeypatch.setenv("VIPTPU_INT8_KERNELS", "1")
        assert torch.equal(got, want)


def test_int8_weights_come_from_f32_values_and_follow_reloads(int8_mode, convnext_pair):
    """A bf16 block never quantizes its bf16 cast: without f32 values it
    raises; ``attach`` quantizes from the f32 state; a reload of the block's
    weights drops the cache, as an in-place write does."""
    _, tree, _, _ = convnext_pair
    kw = dict(input_size=(64, 64), nb_classes=3, **NARROW_CONVNEXT)
    f32_model, _ = create_model("convnext_tiny_in22k", **kw)
    transfer_weights(tree, f32_model, strict=True)
    state = {k: v.detach().clone() for k, v in f32_model.state_dict().items()}
    bf16_model, _ = create_model("convnext_tiny_in22k", dtype=torch.bfloat16, **kw)
    transfer_weights(tree, bf16_model, strict=True)
    block = bf16_model.stages_0_blocks_0
    with pytest.raises(ValueError, match="f32"):
        block.int8_weights()
    assert Q8.attach(bf16_model, state) == 4
    want = Q8.quantize_linear(state["stages_0_blocks_0.mlp_fc1.weight"])
    got = block.int8_weights()["mlp_fc1"]
    assert torch.equal(got.q, want.q) and torch.equal(got.s, want.s)
    f32_block = f32_model.stages_0_blocks_0
    before = f32_block.int8_weights()["mlp_fc1"]
    with torch.no_grad():
        f32_block.mlp_fc1.weight.mul_(2.0)
    after = f32_block.int8_weights()["mlp_fc1"]
    assert torch.equal(after.q, before.q) and torch.equal(after.s, 2 * before.s)
    f32_block.load_state_dict({k[len("stages_0_blocks_0."):]: v for k, v in state.items()
                               if k.startswith("stages_0_blocks_0.")})
    reloaded = f32_block.int8_weights()["mlp_fc1"]
    assert torch.equal(reloaded.s, before.s)


# ---------------------------------------------------------------------------
# the engine and the CLI
# ---------------------------------------------------------------------------
def _count_int8_blocks(monkeypatch):
    calls = {"convnext": 0, "gcvit": 0}
    for module, name, key in ((port_convnext, "convnext_block_int8", "convnext"),
                              (port_gcvit, "window_transformer_block_int8", "gcvit")):
        real = getattr(module, name)

        def wrapped(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)
    return calls


def test_cli_under_the_knob_writes_the_plain_int8_decisions(int8_mode, monkeypatch,
                                                            two_member_workspace):
    """``main_torch.py`` with ``VIPTPU_INT8_KERNELS=1`` on the narrow
    ConvNeXt + GCViT manifest: its CSV's raw means equal, bit for bit, the
    port's plain int8 path computed apart (each member rebuilt from its
    checkpoint in f32, its int8 weights quantized from its own parameters
    on first use), and differ from the run without the knob; the int8 block
    ran at ConvNeXt's 4 blocks and at GCViT's 4 of width >= 128 per batch.
    The sequential path (``VIPTPU_FUSED=0``) quantizes its folds too and
    means the members to the same raw values (1e-6: float64 against f32)."""
    import main_torch

    root, input_csv, names, members = two_member_workspace
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    monkeypatch.setenv("VIPTPU_CKPT_DIR", str(root / "ckpts"))
    monkeypatch.setenv("VIPTPU_VERBOSE", "0")
    monkeypatch.setenv("VIPTPU_PLATFORM", "cpu")
    calls = _count_int8_blocks(monkeypatch)
    out = root / "int8_kernels.csv"
    got = main_torch.main(["main_torch.py", str(input_csv), str(out)])
    batches = -(-len(names) // 8)
    assert calls == {"convnext": 4 * batches, "gcvit": 4 * batches}
    lines = out.read_text().splitlines()
    assert lines[0] == "filename,logit" and [ln.split(",")[0] for ln in lines[1:]] == sorted(names)
    assert [float(ln.split(",")[1]) for ln in lines[1:]] == list((got["raw"] > 0.487) * 1.0)

    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    try:
        cfg = _cfg(root, input_csv, "apart.csv")
        fold_models = []
        for base, dim, overrides, tree in ((b, d, o, t) for b, (d, o, t) in members.items()):
            model, _ = create_model(engine.registry_name(base), input_size=dim, **overrides)
            transfer_weights(tree, model, strict=True)
            fold_models.append(([model.eval()], dim))
        fwd = eng.build_fused_ensemble(fold_models)
        imgs = eng._decode_all([str(input_csv.parent / n) for n in _csv_names(input_csv)])
        raw = np.concatenate([fwd(u8).numpy()[:nv] for u8, nv in engine._batches(imgs, 8)])[:, 0]
        order = np.argsort(_csv_names(input_csv), kind="stable")
        assert np.array_equal(got["raw"], raw[order].astype(np.float64))
        calls.update(convnext=0, gcvit=0)
        sequential = eng.predict_soln(_cfg(root, input_csv, "sequential.csv"))
        assert calls == {"convnext": 4 * batches, "gcvit": 4 * batches}
        monkeypatch.delenv("VIPTPU_INT8_KERNELS")
        without = eng.predict_soln_fused(cfg)["raw"]
    finally:
        eng.close()
    assert list(sequential["filename"]) == list(got["filename"])
    np.testing.assert_allclose(sequential["raw"], got["raw"], rtol=0, atol=1e-6)
    assert np.abs(without - got["raw"]).max() > 0


def _csv_names(input_csv):
    return input_csv.read_text().splitlines()[1:]


def test_knob_composes_with_ptq_all(int8_mode, monkeypatch, two_member_workspace):
    """``VIPTPU_INT8=all`` beside the knob: the engine runs, calibrates and
    quantizes the same PTQ sites as without the knob (the fused blocks'
    Linears are no sites), and writes the CSV."""
    root, input_csv, names, _ = two_member_workspace
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    monkeypatch.setenv("VIPTPU_INT8", "all")
    tables = []
    real = engine.EnsembleEngine._calibrate_member

    def record(self, model, dim, calib_u8):
        scales = real(self, model, dim, calib_u8)
        tables.append(sorted(scales))
        return scales

    monkeypatch.setattr(engine.EnsembleEngine, "_calibrate_member", record)
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    try:
        calls = _count_int8_blocks(monkeypatch)
        with_knob = eng.predict_soln_fused(_cfg(root, input_csv, "both.csv"))
        assert calls["convnext"] and calls["gcvit"]
        monkeypatch.delenv("VIPTPU_INT8_KERNELS")
        without = eng.predict_soln_fused(_cfg(root, input_csv, "ptq.csv"))
    finally:
        eng.close()
    assert len(tables) == 4 and tables[:2] == tables[2:] and all(tables)
    assert len((root / "both.csv").read_text().splitlines()) == len(names) + 1
    assert np.isfinite(with_knob["raw"]).all() and np.abs(with_knob["raw"] - without["raw"]).max() > 0


def test_ln_bf16_sq_is_refused(monkeypatch):
    """``VIPTPU_LN_BF16_SQ=1`` squares in bf16 for statistics the port's LN
    does not take: the engine refuses it rather than ignore it."""
    monkeypatch.setenv("VIPTPU_LN_BF16_SQ", "1")
    with pytest.raises(NotImplementedError, match="VIPTPU_LN_BF16_SQ"):
        engine.EnsembleEngine(device="cpu", verbose=0)
    monkeypatch.setenv("VIPTPU_LN_BF16_SQ", "0")
    engine.EnsembleEngine(device="cpu", verbose=0).close()


def test_full_width_ptq_sites_under_the_knob(int8_mode):
    """Full-width ConvNeXt@200 and GCViTTiny@224 under the knob: the PTQ pass
    still finds the JAX pass's 2 and 27 sites on the fused path."""
    from vip_cup_2022_tpu_torch import quant

    for name, size, sites in (("convnext_tiny_in22k", 200, 2), ("GCViTTiny", 224, 27)):
        model, _ = create_model(name, input_size=(size, size), nb_classes=1, fused_block=True)
        model.eval()
        x = torch.rand((2, size, size, 3), generator=torch.Generator().manual_seed(0))
        scales = quant.calibrate(model, [x])
        report = {}
        quant.quantized(model, scales, report=report)
        with torch.no_grad():
            model(x)
        assert len(scales) == len(report["quantized_sites"]) == sites, name
