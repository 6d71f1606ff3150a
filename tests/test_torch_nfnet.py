"""The port's NFNet family against the JAX package, on the CPU in f32: the
variance-preserving gammas, ``ScaledStdConv`` (groups 1 and > 1, stride 1
and 2, torch and TF ``SAME`` padding) and its once-per-load standardized
weight, ``ZeroInitGain``, ECA at the member's widths and a narrow one, one
block of each kind, narrow ECA_NFNetL0, NFNetL0 and NFNetF0 end to end,
every registered name's parameter tree, the weight bridge (strict load,
rank-3 and grouped kernels, a scalar leaf), and ``VIPTPU_INT8`` naming an
NFNet member; under ``-m slow`` full-width ECA_NFNetL0 at its manifest size.

Tolerance: max|d| <= 1e-4, the bar the JAX package held against Keras. The
trees have every leaf off its init: biases and per-filter gains drawn, and
``ZeroInitGain``'s 0 too, which would hide the F series' deep branches.
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
from test_torch_efficientnet import _close, _flax_shapes, _run

from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.models import list_models
from vip_cup_2022_tpu.models import model_entry as jax_model_entry
from vip_cup_2022_tpu.models import nfnets as jnf
from vip_cup_2022_tpu.ops import NON_LINEAR_GAMMA as JAX_GAMMA
from vip_cup_2022_tpu.ops.conv import ScaledStdConv as JaxScaledStdConv
from vip_cup_2022_tpu_torch.infer import engine
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.models.registry import _MODELS, model_entry
from vip_cup_2022_tpu_torch.ops.act import NON_LINEAR_GAMMA
from vip_cup_2022_tpu_torch.ops.attention import ECA, eca_kernel_size
from vip_cup_2022_tpu_torch.ops.conv import ScaledStdConv, ZeroInitGain
from vip_cup_2022_tpu_torch.weights import from_jax
from vip_cup_2022_tpu_torch.weights.from_jax import flax_to_torch

# narrow widths: hidden 16 / 32 / 64 / 64 in 2 / 4 / 8 / 8 groups of 8, ECA
# k = 3 at 64 and 128, k = 5 at 256
NARROW = dict(num_blocks=(1, 2, 1, 1), out_channels=(64, 128, 256, 256), stem_width=32,
              group_size=8)


def _perturb(tree, rng):
    """Biases, gains (per-filter and ZeroInitGain) off their init; kernels
    stay as drawn."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k == "bias":
            tree[k] = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
        elif k == "gain":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return tree


def _tree(variables, seed):
    return _perturb(jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables)),
                    np.random.RandomState(seed))


def _pair(name, seed=0, **kw):
    module, variables, _ = jax_create_model(name, rng=jax.random.PRNGKey(seed), **kw)
    tree = _tree(variables, seed)
    port, _ = create_model(name, **kw)
    transfer_weights(tree, port, strict=True)
    return module, tree, port


def test_gamma_table_equals_jax():
    assert NON_LINEAR_GAMMA == dict(JAX_GAMMA)
    assert NON_LINEAR_GAMMA["swish"] == 1.7881293296813965


# ---------------------------------------------------------------------------
# ScaledStdConv, ZeroInitGain, ECA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel,padding", [(3, "torch"), (3, "same"), (1, "valid")])
def test_scaled_std_conv_matches_jax(groups, stride, kernel, padding):
    cin, cout, size = 32, 48, 13
    x = np.random.RandomState(groups + stride).randn(2, size, size, cin).astype(np.float32)
    jpad = {"torch": ((1, 1), (1, 1)), "same": "SAME", "valid": "VALID"}[padding]
    mod = JaxScaledStdConv(cout, kernel, stride, jpad, groups=groups, gamma=1.7881293296813965)
    tree = _tree(mod.init(jax.random.PRNGKey(kernel), jnp.asarray(x)), stride)
    port = ScaledStdConv(cin, cout, kernel, stride,
                         {"torch": 1, "same": "same", "valid": 0}[padding], groups,
                         1.7881293296813965)
    port.load_state_dict({k: torch.tensor(v) for k, v in flax_to_torch(tree).items()})
    assert tuple(port.weight.shape) == (cout, cin // groups, kernel, kernel)
    _close(_run(port, x), np.asarray(mod.apply(tree, jnp.asarray(x))))


def test_standardized_weight_once_per_load():
    """The f32 standardized weight is the JAX expression's; in eval mode it
    is computed at the first forward and again only after the parameters
    change (in training, under autograd, at every call:
    ``test_torch_train_nfnet.py``)."""
    port = ScaledStdConv(64, 32, 3, 1, 1, 2, 1.7, torch.float32).eval()
    port.weight.data.normal_(generator=torch.Generator().manual_seed(0))
    port.gain.data.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    k = port.weight.detach().permute(2, 3, 1, 0).numpy()  # HWIO
    mean, var = k.mean(axis=(0, 1, 2)), k.var(axis=(0, 1, 2))
    want = (k - mean) / np.sqrt(np.maximum(var * 9 * 32, 1e-5)) * (port.gain.detach().numpy()
                                                                   * 1.7)
    _close(port.conv_weight().permute(2, 3, 1, 0).numpy(), want, 1e-6)
    first = port.conv_weight()
    assert port.conv_weight() is first
    port.load_state_dict({**port.state_dict(), "gain": torch.ones(32)})
    assert port.conv_weight() is not first
    _close(port.conv_weight().permute(2, 3, 1, 0).numpy(),
           (k - mean) / np.sqrt(np.maximum(var * 9 * 32, 1e-5)) * 1.7, 1e-6)


def test_bf16_standardized_weight_is_the_f32_one_cast():
    port = ScaledStdConv(16, 8, 3, 1, 1, 1, 1.0, torch.bfloat16)
    port.weight.data.normal_(generator=torch.Generator().manual_seed(2))
    assert port.weight.dtype == port.gain.dtype == port.bias.dtype == torch.float32
    assert torch.equal(port.conv_weight(), port.standardized_weight().to(torch.bfloat16))


def test_zero_init_gain():
    g = ZeroInitGain()
    x = torch.randn(2, 3, 3, 4, dtype=torch.bfloat16)
    assert g.gain.shape == () and not g(x).any()
    g.gain.data.fill_(0.5)
    assert torch.equal(g(x), x * 0.5)


class _JaxECA(jnf.NFNet):
    """The JAX model's ``_eca`` alone, its conv named as in a block."""

    @linen.compact
    def __call__(self, x):
        return self._eca(x, "eca_")


@pytest.mark.parametrize("channels,k", [(256, 5), (512, 5), (1536, 5), (64, 3), (24, 3)])
def test_eca_matches_jax(channels, k):
    assert eca_kernel_size(channels) == k
    x = np.random.RandomState(channels).randn(2, 7, 7, channels).astype(np.float32)
    mod = _JaxECA(jax_model_entry("ECA_NFNetL0")[1])
    tree = _tree(mod.init(jax.random.PRNGKey(k), jnp.asarray(x)), k)
    assert tree["params"]["eca_conv1d"]["kernel"].shape == (k, 1, 1)
    port = ECA(channels, torch.float32)
    port.load_state_dict({"weight": torch.tensor(flax_to_torch(tree)["eca_conv1d.weight"])})
    _close(_run(port, x), np.asarray(mod.apply(tree, jnp.asarray(x))))


# ---------------------------------------------------------------------------
# blocks and members
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,stride,out", [("ECA_NFNetL0", 2, 64), ("ECA_NFNetL0", 1, 32),
                                             ("NFNetF0", 2, 64), ("NFNetL0", 1, 64)])
def test_one_block_matches_jax(name, stride, out):
    """One block after the stem (no head conv, so ``features_only`` is the
    block's output through the activation): strided with the average-pool
    shortcut at an odd side (13 -> 7), or at stride 1 projecting (64 -> 32)
    or not (64 -> 64, the identity shortcut); ECA, or SE with ZeroInitGain
    and GELU's gamma in the activation (F series)."""
    kw = dict(num_blocks=(1,), out_channels=(out,), strides=(stride,), stem_width=64,
              group_size=8, num_features_factor=0, input_size=(52, 52))
    module, tree, port = _pair(name, 3, **kw)
    spec = port.blocks[0]
    assert (spec.stride, spec.conv_shortcut) == (stride, stride > 1 or out != 64)
    x = np.random.RandomState(5).uniform(0, 1, (2, 52, 52, 3)).astype(np.float32)
    _close(_run(port, x, features_only=True),
           np.asarray(module.apply(tree, jnp.asarray(x), features_only=True)))


@pytest.mark.parametrize("name,size", [("ECA_NFNetL0", 64), ("ECA_NFNetL0", 57),
                                       ("NFNetL0", 57), ("NFNetF0", 64)])
def test_narrow_member_matches_jax(name, size):
    kw = dict(input_size=(size, size), nb_classes=3, classifier_activation="softmax", **NARROW)
    module, tree, port = _pair(name, 7, **kw)
    x = np.random.RandomState(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    _close(_run(port, x), np.asarray(module.apply(tree, jnp.asarray(x))))


def test_registry_names_equal_jax():
    names = sorted(list_models("*NFNet*"))
    assert len(names) == 12
    assert sorted(n for n in _MODELS if "NFNet" in n) == names


@pytest.mark.parametrize("name", sorted(list_models("*NFNet*")))
def test_every_registered_name_builds_the_jax_tree(name):
    cls, cfg = model_entry(name)
    with torch.device("meta"):
        port = cls(cfg)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == _flax_shapes(name)


def test_init_mirrors_jax():
    """Gains 1, ZeroInitGain 0, biases 0, as the JAX init draws them."""
    port, _ = create_model("NFNetF0", input_size=(64, 64), **NARROW)
    _, variables, _ = jax_create_model("NFNetF0", input_size=(64, 64), **NARROW)
    sd, want = port.state_dict(), flax_to_torch(variables)
    for key, v in want.items():
        if key.endswith((".gain", ".bias")):
            assert torch.equal(sd[key], torch.tensor(v)), key
    assert any(k.endswith("deep_gain.gain") for k in want)


def test_bridge_layouts():
    """Grouped kernels stay HWIO -> OIHW, a depthwise one drops I, a conv1d
    kernel (k, I, O) becomes (O, I, k), a scalar stays a scalar."""
    layout = lambda shape: from_jax._to_torch_layout(  # noqa: E731
        "kernel", np.zeros(shape, np.float32)).shape
    assert layout((3, 3, 64, 384)) == (384, 64, 3, 3)
    assert layout((3, 3, 8, 16)) == (16, 8, 3, 3)
    assert layout((3, 3, 1, 16)) == (3, 3, 16)
    assert layout((5, 1, 1)) == (1, 1, 5)
    k = np.arange(5 * 2 * 3, dtype=np.float32).reshape(5, 2, 3)
    np.testing.assert_array_equal(from_jax._to_torch_layout("kernel", k), k.transpose(2, 1, 0))
    out = flax_to_torch({"params": {"deep_gain": {"gain": np.float32(0.25)}}})
    assert out["deep_gain.gain"].shape == () and out["deep_gain.gain"] == 0.25


def test_strict_load_needs_every_leaf():
    kw = dict(input_size=(64, 64), nb_classes=1, **NARROW)
    _, variables, _ = jax_create_model("ECA_NFNetL0", **kw)
    tree = _tree(variables, 8)
    broken = copy.deepcopy(tree)
    del broken["params"]["stack2_block1_deep_2_conv"]["gain"]
    port, _ = create_model("ECA_NFNetL0", **kw)
    with pytest.raises(ValueError, match="stack2_block1_deep_2_conv.gain: missing"):
        transfer_weights(broken, port, strict=True)
    transfer_weights(tree, port, strict=True)


@pytest.mark.parametrize("env", ["ECA_NFNetL0", "all"])
def test_int8_for_nfnet_raises(monkeypatch, env):
    """int8 NFNet members are ported (grouped standardized sites): the
    knob picks the NFNet by name, and every member with ``all``."""
    monkeypatch.setenv("VIPTPU_INT8", env)
    cfg = [("ResNest50-200x200", [], (64, 64), 0), ("ECA_NFNetL0-200x200", [], (64, 64), 0)]
    assert engine.EnsembleEngine._int8_members(cfg, engine.EnsembleEngine._int8_names()) == [
        env == "all", True]


# ---------------------------------------------------------------------------
# full width, at the manifest's size
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_full_width_eca_nfnetl0_matches_jax():
    kw = dict(input_size=(200, 200), nb_classes=1, classifier_activation=None)
    module, tree, port = _pair("ECA_NFNetL0", 9, **kw)
    x = np.random.RandomState(10).uniform(0, 1, (2, 200, 200, 3)).astype(np.float32)
    _close(_run(port, x), np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x))))
