"""The port's int8 post-training quantization (``quant/ptq.py``) against the
JAX package's, on the CPU: the cases of ``tests/test_quant.py`` as parity.

A torch TinyNet carries the Flax TinyNet's weights (the stem, two
quantizable convs, a depthwise conv, an SE-style gate on pooled features and
a head). Both packages must calibrate the same sites with the same abs-max
(1e-6 relative: the same f32 activations up to summation order), quantize
the same sites and report the same skipped ones, and agree on one site's
output exactly in f32 when they share a scale table (the same integer sums
and the same f32 epilogue; the JAX side run eagerly, as XLA's jit fuses the
epilogue's multiply-add into one rounding). The whole quantized TinyNet
agrees within 1e-5 of max|ref| (f32 sums in another order upstream).
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from flax import linen as fnn
from test_quant import TinyNet

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu import quant as jquant
from vip_cup_2022_tpu.infer.engine import EnsembleEngine as JaxEngine
from vip_cup_2022_tpu_torch import quant
from vip_cup_2022_tpu_torch.infer.engine import NATIVE_SIZE, EnsembleEngine
from vip_cup_2022_tpu_torch.ops.conv import Conv, DepthwiseConv, Linear
from vip_cup_2022_tpu_torch.weights.from_jax import state_dict_from_flax

NET_REL = 1e-5


class _DepthwiseWithBias(DepthwiseConv):
    def __init__(self, dim: int):
        super().__init__(dim, 3, 1, torch.float32)
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return super().forward(x) + self.bias


class TorchTinyNet(nn.Module):
    """``test_quant.TinyNet`` in the port's modules. Flax's SAME padding of
    the stride-2 3 x 3 ``c1`` on an even input is (0, 1): padded explicitly
    before a VALID conv (zeros quantize to zero, so the site is unchanged)."""

    def __init__(self):
        super().__init__()
        self.stem_conv = Conv(3, 32, 3, padding=1)
        self.c1 = Conv(32, 64, 3, stride=2)
        self.dw = _DepthwiseWithBias(64)
        self.se_gate = Conv(64, 64, 1)
        self.c2 = Conv(64, 128, 1)
        self.head_fc = Linear(128, 10, torch.float32)

    def forward(self, x):
        x = torch.relu(self.stem_conv(x))
        x = torch.relu(self.c1(F.pad(x, (0, 0, 0, 1, 0, 1))))
        x = torch.relu(self.dw(x))
        se = self.se_gate(x.mean(dim=(1, 2), keepdim=True))
        x = self.c2(x * torch.sigmoid(se))
        return self.head_fc(x.mean(dim=(1, 2)))


def _tiny(size=16, batch=4, seed=0):
    mod = TinyNet()
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, size, size, 3).astype(np.float32)
    variables = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tree = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))
    for leaf in tree["params"].values():  # biases off their zero init
        leaf["bias"] = rng.uniform(-0.1, 0.1, leaf["bias"].shape).astype(np.float32)
    port = TorchTinyNet()
    port.load_state_dict(state_dict_from_flax(tree, port.state_dict(), strict=True))
    return mod, tree, x, port


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


def _jax_apply(mod, tree):
    return lambda b: mod.apply(tree, b)


def test_tinynet_carries_the_flax_weights(tiny):
    mod, tree, x, port = tiny
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(mod.apply(tree, jnp.asarray(x))), atol=1e-5)


def test_calibration_sites_and_scales_match_jax(tiny):
    mod, tree, x, port = tiny
    want = jquant.calibrate(_jax_apply(mod, tree), [jnp.asarray(x)])
    got = quant.calibrate(port, [torch.from_numpy(x)])
    assert set(got) == set(want) == {"c1", "c2"}
    for site in want:
        assert abs(got[site] - want[site]) <= 1e-6 * want[site]


def test_calibration_over_batches_takes_the_max(tiny):
    mod, tree, x, port = tiny
    batches = [x[:2], x[2:] * 3.0]
    want = jquant.calibrate(_jax_apply(mod, tree), [jnp.asarray(b) for b in batches])
    got = quant.calibrate(port, [torch.from_numpy(b) for b in batches])
    assert set(got) == set(want)
    for site in want:
        assert abs(got[site] - want[site]) <= 1e-6 * want[site]


def test_quantized_tinynet_and_site_report_match_jax(tiny):
    """One shared (JAX) scale table: the whole net within 1e-5 of max|ref|,
    the same quantized and skipped sites in the same order, and the int8
    net within the JAX test's PTQ bound of the float net."""
    mod, tree, x, _ = tiny
    _, _, _, port = _tiny()
    scales = jquant.calibrate(_jax_apply(mod, tree), [jnp.asarray(x)])
    jreport, report = {}, {}
    want = np.asarray(jquant.quantized(_jax_apply(mod, tree), scales, report=jreport)(
        jnp.asarray(x)))
    qport = quant.quantized(port, scales, report=report)
    with torch.inference_mode():
        got = qport(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= NET_REL * np.abs(want).max()
    assert report == jreport
    assert report["quantized_sites"] == ["c1", "c2"]
    assert report["skipped_sites"] == ["stem_conv", "dw", "se_gate", "head_fc"]
    ref = np.asarray(mod.apply(tree, jnp.asarray(x)))
    assert np.abs(got - ref).max() < 0.05 * max(np.abs(ref).max(), 1.0)


def test_quantized_without_a_report_adds_no_hooks():
    """The report's hooks exist only for a caller that passes ``report``:
    the engine's forward runs none."""
    _, _, x, port = _tiny()
    quant.quantized(port, {"c1": 1.0, "c2": 1.0})
    assert all(not m._forward_pre_hooks and not m._forward_hooks for m in port.modules())
    sites = [m for m in port.modules() if isinstance(m, quant.QuantizedSite)]
    assert len(sites) == 2 and all(m._report is None for m in sites)
    with torch.inference_mode():
        assert torch.isfinite(port(torch.from_numpy(x))).all()


class _JaxSites(fnn.Module):
    @fnn.compact
    def __call__(self, x, y):
        return (fnn.Conv(48, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)), name="conv")(x),
                fnn.Conv(40, (1, 1), name="pointwise")(x),
                fnn.Dense(40, name="dense")(y))


class _TorchSites(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv(36, 48, 3, stride=2, padding=1)
        self.pointwise = Conv(36, 40, 1)
        self.dense = Linear(64, 40, torch.float32)

    def forward(self, x, y):
        return self.conv(x), self.pointwise(x), self.dense(y)


def test_single_sites_equal_jax_exactly():
    """A 3 x 3 stride-2 conv (the gathered site), a 1 x 1 conv (rows) and a
    Dense on a 3-d input, with biases, quantized with one shared table:
    equal to the JAX ``_handle_conv`` / ``_handle_dense`` outputs in f32."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 11, 36).astype(np.float32)
    y = rng.randn(3, 5, 64).astype(np.float32)
    mod = _JaxSites()
    tree = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        mod.init(jax.random.PRNGKey(0), x, y)))
    for leaf in tree["params"].values():
        leaf["bias"] = rng.randn(*leaf["bias"].shape).astype(np.float32)
    port = _TorchSites()
    port.load_state_dict(state_dict_from_flax(tree, port.state_dict(), strict=True))
    apply = lambda b: mod.apply(tree, *b)  # noqa: E731
    scales = jquant.calibrate(apply, [(jnp.asarray(x), jnp.asarray(y))])
    assert set(scales) == {"conv", "pointwise", "dense"}
    want = jquant.quantized(apply, scales)((jnp.asarray(x), jnp.asarray(y)))
    quant.quantized(port, scales)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(y))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scales_json_round_trips_between_packages(tmp_path, tiny):
    mod, tree, x, port = tiny
    scales = quant.calibrate(port, [torch.from_numpy(x)])
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    quant.save_scales(str(ours), scales)
    jquant.save_scales(str(theirs), scales)
    assert ours.read_text() == theirs.read_text()
    assert jquant.load_scales(str(ours)) == scales
    assert quant.load_scales(str(theirs)) == jquant.load_scales(str(theirs))


def test_engine_calibrates_and_quantizes_like_jax():
    """``_calibrate_member`` on the first images at the native size and
    ``build_fused_ensemble(quant_scales=...)``: the same table as the JAX
    engine's, and an int8 ensemble close to the float one (the JAX test's
    0.02)."""
    mod, tree, _, port = _tiny(seed=1)
    u8 = np.random.RandomState(0).randint(0, 256, (2, *NATIVE_SIZE, 3), np.uint8)
    want = JaxEngine(verbose=0, compute_dtype=jnp.float32)._calibrate_member(
        mod, tree, NATIVE_SIZE, u8)
    eng = EnsembleEngine(device="cpu", verbose=0)
    scales = eng._calibrate_member(port, NATIVE_SIZE, u8)
    assert set(scales) == set(want) == {"c1", "c2"}
    for site in want:
        assert abs(scales[site] - want[site]) <= 1e-5 * want[site]
    f32 = eng.build_fused_ensemble([([port], NATIVE_SIZE)])(u8).numpy()
    _, _, _, port8 = _tiny(seed=1)
    i8 = eng.build_fused_ensemble([([port8], NATIVE_SIZE)], quant_scales=[scales])(u8).numpy()
    eng.close()
    assert any(isinstance(m, quant.QuantizedSite) for m in port8.modules())
    assert np.abs(f32 - i8).max() < 0.02


# ---------------------------------------------------------------------------
# ResNest50's sites and NFNet's standardized convs
# ---------------------------------------------------------------------------
def _resnest_pair(size, **kw):
    from test_torch_resnest import _pair

    return _pair("ResNest50", 7, input_size=(size, size), nb_classes=1,
                 classifier_activation=None, **kw)


def _resnest_sites_match_jax(size, logits=True, **kw):
    """Both packages calibrate the same sites with the same abs-max, quantize
    them and skip the same others; with ``logits``, their int8 logits agree
    within 1e-3 of max|ref| (f32 sums in another order upstream may move an
    activation across a rounding boundary, and at full width such moves add
    up past that: ``tests/test_torch_resnet_rs.py`` bounds them by site).
    Returns the calibrated sites."""
    module, tree, port = _resnest_pair(size, **kw)
    x = np.random.RandomState(size).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    apply = lambda b: module.apply(tree, b)  # noqa: E731
    jscales = jquant.calibrate(apply, [jnp.asarray(x)])
    scales = quant.calibrate(port, [torch.from_numpy(x)])
    assert set(scales) == set(jscales)
    for site, v in jscales.items():
        assert abs(scales[site] - v) <= 1e-5 * v, site
    jreport, report = {}, {}
    want = np.asarray(jquant.quantized(apply, jscales, report=jreport)(jnp.asarray(x)))
    with torch.inference_mode():
        got = quant.quantized(port, jscales, report=report)(torch.from_numpy(x)).numpy()
    assert report == jreport
    assert not logits or np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    return set(scales)


def test_resnest_sites_match_jax():
    """At a narrow ResNest50 (hidden 64 / 64 / 128 / 128, halves of 32 and
    64): per block ``deep_1``, the split attention's two halves
    (``sa_1_g1`` / ``_g2``) and ``deep_3``, and each stack's shortcut; never
    the stem, ``sa_2`` / ``sa_3`` (one spatial position) or the head."""
    sites = _resnest_sites_match_jax(
        64, num_blocks=(1, 2, 1, 1), out_channels=(256, 256, 512, 512), stem_width=64)
    blocks = ["stack1_block1_", "stack2_block1_", "stack2_block2_", "stack3_block1_",
              "stack4_block1_"]
    want = {b + s for b in blocks for s in ("deep_1_conv", "deep_2_sa_1_g1_conv",
                                            "deep_2_sa_1_g2_conv", "deep_3_conv")}
    want |= {b + "shortcut_conv" for b in blocks if b.endswith("block1_")}
    assert sites == want


@pytest.mark.slow
def test_full_width_resnest50_has_68_sites():
    assert len(_resnest_sites_match_jax(200, logits=False)) == 68


def test_nfnet_calibration_records_no_standardized_conv():
    """NFNet's convs are ``ScaledStdConv``s, whose raw weight is not the one
    they convolve with: calibration must not record one as a plain conv
    site, which would quantize the raw kernel. The JAX pass calibrates them
    (``_handle_stdconv``); the port leaves int8 NFNet to ROADMAP A9b."""
    from test_torch_nfnet import NARROW, _pair
    from vip_cup_2022_tpu_torch.ops.conv import ScaledStdConv

    module, tree, port = _pair("NFNetL0", 3, input_size=(64, 64), nb_classes=1, **NARROW)
    x = np.random.RandomState(4).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    jscales = jquant.calibrate(lambda b: module.apply(tree, b), [jnp.asarray(x)])
    std = {n.replace(".", "/") for n, m in port.named_modules() if isinstance(m, ScaledStdConv)}
    assert jscales and set(jscales) <= std
    assert quant.calibrate(port, [torch.from_numpy(x)]) == {}
    with pytest.raises(NotImplementedError, match="A9b"):
        grouped = Conv(64, 64, 3, padding=1, groups=2)
        quant.quantized(torch.nn.Sequential(grouped), {"0": 1.0})
