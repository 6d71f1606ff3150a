"""The port's EfficientNet family against the JAX package, on the CPU in f32:
``make_divisible``, TF ``SAME`` and torch-mode convs against Flax's
``nn.Conv``, the depthwise conv against ``apply_depthwise_conv``, SE, one
MBConv and one Fused-MBConv block per padding mode, narrow EfficientNetV2T
(torch mode) and EfficientNetV1B4 (TF mode) end to end, every registered
name's parameter tree, and the weight bridge's strict load; under ``-m slow``
both members at full width and their manifest sizes.

Tolerance: max|d| <= 1e-4, the bar the JAX package held against Keras.
"""
import copy

import flax
from flax import linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.models import efficientnet as jeff
from vip_cup_2022_tpu.models import list_models, model_entry as jax_model_entry
from vip_cup_2022_tpu.ops.conv import apply_depthwise_conv
from vip_cup_2022_tpu.ops.conv import make_divisible as jax_make_divisible
from vip_cup_2022_tpu_torch.models import create_model, efficientnet as eff, transfer_weights
from vip_cup_2022_tpu_torch.models.registry import is_model, model_entry
from vip_cup_2022_tpu_torch.ops.act import get_activation
from vip_cup_2022_tpu_torch.ops.conv import Conv, DepthwiseConv, make_divisible
from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D
from vip_cup_2022_tpu_torch.ops.pad import same_padding
from vip_cup_2022_tpu_torch.weights import from_jax
from vip_cup_2022_tpu_torch.weights.from_jax import flax_to_torch

ATOL = 1e-4
# one block a stage, narrow widths (multiples of 8, as make_divisible gives)
NARROW = {
    "EfficientNetV2T": dict(out_channels=(8, 16, 16, 24, 32, 40), depthes=(1,) * 6,
                            first_conv_filter=8, output_conv_filter=64),
    "EfficientNetV1B4": dict(out_channels=(8, 16, 16, 24, 24, 32, 40), depthes=(1,) * 7,
                             first_conv_filter=8, output_conv_filter=64),
}


def _perturb(tree, rng):
    """BN statistics and affine parameters, and conv biases, off their
    init, so every leaf matters."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k == "moving_mean":
            tree[k] = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
        elif k == "moving_variance":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "gamma":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("beta", "bias"):
            tree[k] = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
    return tree


def _tree(variables, seed):
    return _perturb(jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables)),
                    np.random.RandomState(seed))


def _pair(name, seed=0, **kw):
    """(JAX module, perturbed f32 tree, port model holding the same weights)."""
    module, variables, _ = jax_create_model(name, rng=jax.random.PRNGKey(seed), **kw)
    tree = _tree(variables, seed)
    port, _ = create_model(name, **kw)
    transfer_weights(tree, port, strict=True)
    return module, tree, port


def _run(fn, x, **kw):
    with torch.inference_mode():
        out = fn(torch.from_numpy(x), **kw)
    return [o.numpy() for o in out] if isinstance(out, list) else out.numpy()


def _close(got, want, atol=ATOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("divisor", [1, 8])
@pytest.mark.parametrize("limit_round_down", [0.9, 0.0])
def test_make_divisible_equals_jax(divisor, limit_round_down):
    values = list(np.linspace(0.5, 400, 797)) + [13.44, 33.6, 44.8, 67.2, 156.8, 268.8, 1792]
    for v in values:
        assert make_divisible(v, divisor, limit_round_down=limit_round_down) == \
            jax_make_divisible(v, divisor, limit_round_down=limit_round_down), v


@pytest.mark.parametrize("size,k,stride,want", [
    (224, 3, 2, (0, 1)), (56, 5, 2, (1, 2)), (57, 5, 2, (2, 2)), (25, 3, 2, (1, 1)),
    (112, 3, 1, (1, 1)), (7, 5, 1, (2, 2)), (56, 1, 1, (0, 0)), (56, 1, 2, (0, 0)),
])
def test_same_padding_equals_lax(size, k, stride, want):
    assert same_padding(size, k, stride) == want
    assert tuple(jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]) == want


class _JaxConvNb(linen.Module):
    """``efficientnet.py::_conv_nb``, the JAX model's stem / fused conv."""
    filters: int
    kernel: int
    stride: int
    torch_mode: bool

    @linen.compact
    def __call__(self, x):
        return jeff._conv_nb(self, x, self.filters, self.kernel, self.stride, self.torch_mode,
                             "conv", None)


@pytest.mark.parametrize("torch_mode", [False, True], ids=["tf", "torch"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [25, 56, 57, 112])
def test_conv_padding_matches_flax(torch_mode, k, stride, size):
    x = np.random.RandomState(size + k).randn(2, size, size, 8).astype(np.float32)
    mod = _JaxConvNb(16, k, stride, torch_mode)
    tree = _tree(mod.init(jax.random.PRNGKey(k), jnp.asarray(x)), 1)
    conv = Conv(8, 16, k, stride, torch.float32, eff.conv_padding(k, stride, torch_mode),
                bias=False)
    conv.weight.data = torch.tensor(flax_to_torch(tree)["conv.weight"])
    _close(_run(conv, x), np.asarray(mod.apply(tree, jnp.asarray(x))))


class _JaxDepthwise(linen.Module):
    kernel: int
    stride: int
    padding: object

    @linen.compact
    def __call__(self, x):
        return apply_depthwise_conv(self, x, self.kernel, self.stride, self.padding, "dw")


@pytest.mark.parametrize("torch_mode", [False, True], ids=["tf", "torch"])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [25, 56])
def test_depthwise_conv_matches_apply_depthwise_conv(torch_mode, k, stride, size, monkeypatch):
    """The JAX model's depthwise call (``VIPTPU_DW_BLOCKDIAG`` unset, so
    Flax's grouped ``nn.Conv``) against the port's :class:`DepthwiseConv`,
    which runs K9's plain version at stride 1 and cuDNN's grouped conv
    otherwise."""
    monkeypatch.delenv("VIPTPU_DW_BLOCKDIAG", raising=False)
    x = np.random.RandomState(size * k + stride).randn(2, size, size, 24).astype(np.float32)
    pad = ((k // 2, k // 2),) * 2 if torch_mode else "SAME"
    mod = _JaxDepthwise(k, stride, pad)
    tree = _tree(mod.init(jax.random.PRNGKey(k), jnp.asarray(x)), 2)
    port = DepthwiseConv(24, k, k // 2 if torch_mode else "same", torch.float32, stride)
    port.weight.data = torch.tensor(flax_to_torch(tree)["dw.weight"])
    calls = []
    real = D.depthwise_conv_nhwc
    monkeypatch.setattr(D, "depthwise_conv_nhwc",
                        lambda x, kern, padding: calls.append(padding) or real(x, kern,
                                                                                padding=padding))
    D.reset_launches()
    _close(_run(port, x), np.asarray(mod.apply(tree, jnp.asarray(x))))
    # stride 1 goes through K9's wrapper (its plain version on CPU tensors)
    assert calls == ([((k // 2, k // 2), (k // 2, k // 2))] if stride == 1 else [])
    assert D.LAUNCHES["depthwise_conv_nhwc"] == 0


def test_swish_matches_jax():
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    for name in ("swish", "silu"):
        _close(get_activation(name)(torch.from_numpy(x)).numpy(),
               np.asarray(jax.nn.silu(jnp.asarray(x))), 1e-6)


# ---------------------------------------------------------------------------
# blocks and SE
# ---------------------------------------------------------------------------
def _one_block(kind, torch_mode, shortcut):
    """A one-stage, one-block config after a 16-filter stem: the shortcut
    where the block keeps 16 channels at stride 1, else 24 at stride 2."""
    return dict(expands=(4,), out_channels=(16,) if shortcut else (24,), depthes=(1,),
                strides=(1,) if shortcut else (2,), se_ratios=(0.25 if kind == "mb" else 0,),
                kernel_sizes=(5 if kind == "mb" else 3,), first_conv_filter=16,
                output_conv_filter=0, is_torch_mode=torch_mode, input_size=(25, 25))


@pytest.mark.parametrize("kind", ["mb", "fused"])
@pytest.mark.parametrize("torch_mode", [False, True], ids=["tf", "torch"])
@pytest.mark.parametrize("shortcut", [True, False], ids=["shortcut", "no_shortcut"])
def test_block_matches_jax(kind, torch_mode, shortcut):
    """The block's output (``feature_names``) after the stem at 25 x 25: a
    stride-2 block pads asymmetrically in TF mode (the stem too)."""
    module, tree, port = _pair("EfficientNetV2B0", 3, **_one_block(kind, torch_mode, shortcut))
    spec = port.blocks[0]
    assert (spec.fused, spec.se, spec.shortcut) == (kind == "fused", kind == "mb", shortcut)
    x = np.random.RandomState(4).uniform(0, 1, (2, 25, 25, 3)).astype(np.float32)
    names = ("stack_0_block0_output",)
    want = module.apply(tree, jnp.asarray(x), feature_names=names)
    _close(_run(port, x, feature_names=names)[0], np.asarray(want[0]))


def test_squeeze_excite_matches_jax():
    """SE on the JAX model's own activations: its input is swish of the
    depthwise BN's output, its output what ``MB_pw_conv`` receives."""
    module, tree, port = _pair("EfficientNetV2B0", 5, **_one_block("mb", False, False))
    x = np.random.RandomState(6).uniform(0, 1, (2, 25, 25, 3)).astype(np.float32)
    seen = {}

    def record(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and context.module.name == "stack_0_block0_MB_pw_conv":
            seen["se_out"] = np.asarray(args[0])
        return next_fun(*args, **kwargs)

    with linen.intercept_methods(record):
        _, state = module.apply(tree, jnp.asarray(x), capture_intermediates=True, mutable=True)
    dw_bn = np.asarray(state["intermediates"]["stack_0_block0_MB_dw_bn"]["__call__"][0])
    se_in = np.array(jax.nn.silu(jnp.asarray(dw_bn)))
    got = _run(lambda t: eff.squeeze_excite(t, port.stack_0_block0_se_1_conv,
                                            port.stack_0_block0_se_2_conv, port.act), se_in)
    _close(got, seen["se_out"])
    assert port.stack_0_block0_se_1_conv.weight.shape[0] == make_divisible(64 * 0.25 / 4, 1)


# ---------------------------------------------------------------------------
# narrow members end to end, registry, weight bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["EfficientNetV2T", "EfficientNetV1B4"])
@pytest.mark.parametrize("size", [64, 57])
def test_narrow_member_matches_jax(name, size):
    kw = dict(input_size=(size, size), nb_classes=3, classifier_activation="softmax",
              **NARROW[name])
    module, tree, port = _pair(name, 7, **kw)
    x = np.random.RandomState(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(module.apply(tree, jnp.asarray(x)))
    _close(_run(port, x), want)
    feats = _run(port, x, features_only=True)
    _close(feats, np.asarray(module.apply(tree, jnp.asarray(x), features_only=True)))
    assert feats.shape[-1] == 64


def _jax_names():
    return sorted(list_models("EfficientNet*"))


def test_registry_names_equal_jax():
    from vip_cup_2022_tpu_torch.models.registry import _MODELS

    names = _jax_names()
    assert len(names) == 24 and all(is_model(n) for n in names)
    assert sorted(n for n in _MODELS if n.startswith("EfficientNet")) == names


def _flax_shapes(name):
    """{state_dict key: torch-layout shape} of a registered JAX model's tree,
    from an abstract init (no memory for the parameters)."""
    cls, cfg = jax_model_entry(name)
    shapes = jax.eval_shape(cls(cfg).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    out = {}
    for path, leaf, siblings in from_jax._flatten(flax.core.unfreeze(shapes)):
        view = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), leaf.shape,
                                               (0,) * len(leaf.shape))
        key = ".".join(path[1:-1] + (from_jax._leaf_name(path[0], path[-1], siblings),))
        out[key] = tuple(from_jax._to_torch_layout(path[-1], view).shape)
    return out


@pytest.mark.parametrize("name", [n for n in _jax_names() if not n.endswith("_GC")])
def test_every_registered_name_builds_the_jax_tree(name):
    """Each registered config builds a module whose state_dict keys and
    shapes are the JAX tree's, under the weight bridge's layout rules."""
    cls, cfg = model_entry(name)
    with torch.device("meta"):
        port = cls(cfg)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == _flax_shapes(name)


def test_global_context_variant_raises():
    with pytest.raises(NotImplementedError, match="A8b"):
        create_model("EfficientNetV2T_GC", input_size=(64, 64))


def test_strict_load_needs_every_statistic():
    kw = dict(input_size=(64, 64), nb_classes=1, **NARROW["EfficientNetV2T"])
    _, variables, _ = jax_create_model("EfficientNetV2T", **kw)
    tree = _tree(variables, 8)
    broken = copy.deepcopy(tree)
    del broken["batch_stats"]["stack_4_block0_MB_dw_bn"]["moving_variance"]
    port, _ = create_model("EfficientNetV2T", **kw)
    with pytest.raises(ValueError, match="stack_4_block0_MB_dw_bn.running_var: missing"):
        transfer_weights(broken, port, strict=True)
    transfer_weights(tree, port, strict=True)


def test_config_replace_reruns_rescale_stats():
    _, cfg = model_entry("EfficientNetV2S")
    assert cfg.mean == (128 / 255,) * 3
    assert cfg.replace(rescale_mode="torch").mean == eff.IMAGENET_DEFAULT_MEAN
    assert cfg.replace(rescale_mode="raw").std is None


# ---------------------------------------------------------------------------
# full width, at the manifest's sizes
# ---------------------------------------------------------------------------
@pytest.mark.slow
@pytest.mark.parametrize("name,size", [("EfficientNetV2T", 200), ("EfficientNetV1B4", 224)])
def test_full_width_member_matches_jax(name, size):
    kw = dict(input_size=(size, size), nb_classes=1, classifier_activation=None)
    module, tree, port = _pair(name, 9, **kw)
    x = np.random.RandomState(10).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    _close(_run(port, x), np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x))))
