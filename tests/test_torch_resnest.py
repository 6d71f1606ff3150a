"""The port's ResNest (AotNet in its ResNest configuration) against the JAX
package, on the CPU in f32: the three pools at even and odd sides, the split
attention at stride 1 and 2, the blocks (identity shortcut, average-pool
shortcut at an odd side), narrow ResNest50 end to end, every registered
name's parameter tree, the weight bridge's strict load, the options the port
does not take; under ``-m slow`` full-width ResNest50 at its manifest size.

Tolerance: max|d| <= 1e-4, the bar the JAX package held against Keras. Every
BN leaf is drawn off its init, the zero-gamma ``3_bn`` too: at init every
deep branch would add 0 and the check would see half the network.
"""
import copy

from flax import linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_efficientnet import _close, _flax_shapes, _pair, _run, _tree

from vip_cup_2022_tpu.models import aotnet as jaot
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.models import list_models
from vip_cup_2022_tpu.models import model_entry as jax_model_entry
from vip_cup_2022_tpu_torch.models import aotnet, create_model, transfer_weights
from vip_cup_2022_tpu_torch.models.registry import _MODELS, model_entry
from vip_cup_2022_tpu_torch.ops import pool
from vip_cup_2022_tpu_torch.weights.from_jax import flax_to_torch

# one block a stage, narrow widths: hidden 16 / 32 / 32 / 64, radix halves of 8+
NARROW = dict(num_blocks=(1, 1, 1, 1), out_channels=(64, 128, 128, 256), stem_width=16)


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------
def _x(size, c=8, seed=0):
    return np.random.RandomState(seed + size).randn(2, size, size, c).astype(np.float32)


@pytest.mark.parametrize("size,stride", [(50, 2), (25, 2), (13, 2), (7, 2), (8, 2), (13, 3),
                                         (12, 3)])
def test_avg_pool_same_matches_flax(size, stride):
    """SAME average pool with ``count_include_pad=False``: odd sides (25 ->
    13, 13 -> 7 at 200 px) pad at the end at stride 2; stride 3 at 13 pads
    both sides."""
    x = _x(size)
    want = linen.avg_pool(jnp.asarray(x), (stride, stride), strides=(stride, stride),
                          padding="SAME", count_include_pad=False)
    _close(pool.avg_pool_same(torch.from_numpy(x), stride).numpy(), np.asarray(want), 1e-6)


@pytest.mark.parametrize("size", [100, 99, 50, 7])
def test_stem_max_pool_matches_jax(size):
    """The AotNet stem's pool pads zeros, not -inf: a negative edge stays 0."""
    x = _x(size) - 3.0  # mostly negative, so the padded zeros win at the edges
    want = linen.max_pool(jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0))), (3, 3),
                          strides=(2, 2), padding="VALID")
    got = pool.max_pool_3x3_s2_zero_pad(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(want), 0.0)
    assert (got[:, 0] == 0).any()


@pytest.mark.parametrize("size", [50, 25, 13, 8])
def test_split_attention_pool_counts_the_zeros(size):
    x = _x(size)
    want = linen.avg_pool(jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0))), (3, 3),
                          strides=(2, 2), padding="VALID")
    _close(pool.avg_pool_3x3_s2_pad1(torch.from_numpy(x)).numpy(), np.asarray(want), 1e-6)


# ---------------------------------------------------------------------------
# split attention and blocks
# ---------------------------------------------------------------------------
class _JaxSplitAttention(jaot.AotNet):
    """The JAX model's ``_split_attention`` alone, its modules named as in
    block ``stack1_block1_``."""
    filters: int = 16
    stride: int = 1

    @linen.compact
    def __call__(self, x):
        return self._split_attention(x, self.filters, 3, self.stride, 2, "relu",
                                     "stack1_block1_deep_2_sa_", False)


@pytest.mark.parametrize("stride,size", [(1, 13), (2, 13), (2, 12)])
@pytest.mark.parametrize("hidden", [16, 64])
def test_split_attention_matches_jax(stride, size, hidden):
    """Radix 2 on the two channel halves, the f32 radix-summed mean, the f32
    radix softmax, the gated radix sum and, at stride 2, the zero-counting
    pool (``inter`` = 32 at hidden 16, 32 at 64)."""
    mod = _JaxSplitAttention(jax_model_entry("ResNest50")[1], filters=hidden, stride=stride)
    x = _x(size, hidden, 3)
    tree = _tree(mod.init(jax.random.PRNGKey(hidden), jnp.asarray(x)), hidden)
    port, _ = create_model("ResNest50", num_blocks=(1,), out_channels=(4 * hidden,),
                           strides=(stride,), stem_width=16)
    sd = flax_to_torch(tree)
    port.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=False)
    spec = port.blocks[0]
    assert (spec.stride, spec.hidden, spec.radix) == (stride, hidden, 2)
    got = _run(lambda t: port.split_attention(t, spec), x)
    _close(got, np.asarray(mod.apply(tree, jnp.asarray(x))))


@pytest.mark.parametrize("size", [50])
def test_blocks_match_jax(size):
    """Block outputs (``feature_names``): a projection block at stride 1, an
    identity block, and a strided block whose average-pool shortcut meets an
    odd side at 50 px (13 -> 7)."""
    kw = dict(num_blocks=(2, 1), out_channels=(64, 128), strides=(1, 2), stem_width=16,
              input_size=(size, size))
    module, tree, port = _pair("ResNest50", 3, **kw)
    names = ("stack1_block1_output", "stack1_block2_output", "stack2_block1_output")
    assert [(s.stride, s.conv_shortcut) for s in port.blocks] == [(1, True), (1, False),
                                                                   (2, True)]
    x = np.random.RandomState(4).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = module.apply(tree, jnp.asarray(x), feature_names=names)
    for got, w in zip(_run(port, x, feature_names=names), want):
        _close(got, np.asarray(w))


def test_random_init_zero_gamma():
    """``init_weights`` mirrors the JAX init's zero-gamma closing BN: a fresh
    model's deep branches add 0."""
    port, _ = create_model("ResNest50", input_size=(64, 64), **NARROW)
    zero = {n for n, m in port.named_modules() if isinstance(m, aotnet.BatchNorm)
            and not m.weight.any()}
    assert zero == {s.name + "3_bn" for s in port.blocks}
    _, variables, _ = jax_create_model("ResNest50", input_size=(64, 64), **NARROW)
    assert all(not np.asarray(variables["params"][n]["gamma"]).any() for n in zero)


# ---------------------------------------------------------------------------
# the member end to end, registry, weight bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", [64, 57])
def test_narrow_resnest50_matches_jax(size):
    kw = dict(input_size=(size, size), nb_classes=3, classifier_activation="softmax", **NARROW)
    module, tree, port = _pair("ResNest50", 7, **kw)
    x = np.random.RandomState(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    _close(_run(port, x), np.asarray(module.apply(tree, jnp.asarray(x))))
    feats = _run(port, x, features_only=True)
    _close(feats, np.asarray(module.apply(tree, jnp.asarray(x), features_only=True)))
    assert feats.shape[-1] == 256


def test_registry_names_equal_jax():
    names = sorted(list_models("ResNest*"))
    assert names == ["ResNest101", "ResNest200", "ResNest269", "ResNest50"]
    assert sorted(n for n in _MODELS if n.startswith("ResNest")) == names


@pytest.mark.parametrize("name", sorted(list_models("ResNest*")))
def test_every_registered_name_builds_the_jax_tree(name):
    cls, cfg = model_entry(name)
    with torch.device("meta"):
        port = cls(cfg)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == _flax_shapes(name)


def test_strict_load_needs_every_statistic():
    kw = dict(input_size=(64, 64), nb_classes=1, **NARROW)
    _, variables, _ = jax_create_model("ResNest50", **kw)
    tree = _tree(variables, 8)
    broken = copy.deepcopy(tree)
    del broken["batch_stats"]["stack3_block1_deep_2_sa_1_bn"]["moving_mean"]
    port, _ = create_model("ResNest50", **kw)
    with pytest.raises(ValueError, match="stack3_block1_deep_2_sa_1_bn.running_mean: missing"):
        transfer_weights(broken, port, strict=True)
    transfer_weights(tree, port, strict=True)


@pytest.mark.parametrize("override", [dict(stem_type="tiered"), dict(attn_types="bot"),
                                      dict(attn_types=(None, "sa", "sa", "sa")),
                                      dict(shortcut_type="anti_alias"), dict(shortcut_type="conv"),
                                      dict(attn_params={"groups": 1}), dict(preact=True),
                                      dict(se_ratio=0.25), dict(bn_after_attn=True)])
def test_other_aotnet_options_raise(override):
    with pytest.raises(NotImplementedError, match="A14"):
        create_model("ResNest50", input_size=(64, 64), **override)


def test_int8_admits_resnest50(monkeypatch):
    """ResNest50's sites are the JAX pass's: ``VIPTPU_INT8`` may select it,
    beside ResNetRS50 (the JAX package's ``INT8_AUTO`` set on a TPU)."""
    from vip_cup_2022_tpu_torch.infer import engine

    monkeypatch.setenv("VIPTPU_INT8", "ResNetRS50,ResNest50")
    cfg = [("convnext_tiny_in22k-200x200", [], (64, 64), 0), ("ResNest50-200x200", [], (64, 64), 0),
           ("ResNetRS50-200x200", [], (64, 64), 0)]
    assert aotnet.AotNet.int8_sites_match_jax
    assert engine.EnsembleEngine._int8_members(
        cfg, engine.EnsembleEngine._int8_names()) == [False, True, True]


def test_resnet_d_is_not_registered():
    assert "ResNet50D" in list_models("ResNet*D") and "ResNet50D" not in _MODELS


# ---------------------------------------------------------------------------
# full width, at the manifest's size
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_full_width_resnest50_matches_jax():
    kw = dict(input_size=(200, 200), nb_classes=1, classifier_activation=None)
    module, tree, port = _pair("ResNest50", 9, **kw)
    x = np.random.RandomState(10).uniform(0, 1, (2, 200, 200, 3)).astype(np.float32)
    _close(_run(port, x), np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x))))
