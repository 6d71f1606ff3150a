"""GCViT's unfused block path in the port against the JAX package, in f32 on
the CPU: the ``WindowAttention`` and ``Mlp`` modules (local and global
query), a narrow GCViT with ``fused_block=False`` at 224 and 200 input, the
port's unfused path against its fused path on the same weights, which LNs
each path sends through the LN function, and the two-member CLI with
``VIPTPU_NO_FUSED_BLOCK=1``, whose CSV must equal the JAX CLI's byte for
byte. max|d| <= 1e-4, the bar the JAX package held against Keras."""
import os
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.ops.attention import WindowAttention as JaxWindowAttention
from vip_cup_2022_tpu.ops.mlp import Mlp as JaxMlp
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.models.gcvit import GCViTConfig, _use_fused_block
from vip_cup_2022_tpu_torch.ops.attention import WindowAttention
from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L
from vip_cup_2022_tpu_torch.ops.mlp import Mlp
from vip_cup_2022_tpu_torch.weights.from_jax import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from test_torch_gcvit import NARROW, _jax_gcvit  # noqa: E402
from test_torch_gcvit import assert_two_member_csvs_equal  # noqa: E402
from test_torch_gcvit import two_member_workspace  # noqa: E402,F401  (a fixture)
from test_torch_slice import NARROW as NARROW_CONVNEXT  # noqa: E402

ATOL = 1e-4


def _u(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _params(module, seed, *args, **kwargs):
    """The Flax module's params, biases ~ U(-0.1, 0.1) and rel-pos tables
    ~ U(-1, 1), so that each leaf matters."""
    variables = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    tree = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))
    rng = np.random.RandomState(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "bias":
                t[k] = _u(rng, v.shape, -0.1, 0.1)
            elif k == "relative_position_bias_table":
                t[k] = _u(rng, v.shape)
    perturb(tree["params"])
    return tree


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ws,heads", [(7, 2), (14, 4), (3, 1)])
@pytest.mark.parametrize("global_query", [False, True])
def test_window_attention_module_matches_flax(ws, heads, global_query):
    """(B * nWin, N, C) tokens of two images with three windows each; the
    global query (B, N, C) is repeated over each image's windows."""
    c, n, b, nwin = 32 * heads, ws * ws, 2, 3
    rng = np.random.RandomState(ws * 10 + heads)
    x = jnp.asarray(_u(rng, (b * nwin, n, c)))
    qg = jnp.asarray(_u(rng, (b, n, c))) if global_query else None
    jax_mod = JaxWindowAttention(window_size=ws, num_heads=heads, global_query=global_query)
    tree = _params(jax_mod, ws, x, q_global=qg)
    want = np.asarray(jax_mod.apply(tree, x, q_global=qg))

    port = WindowAttention(c, heads, ws, global_query, torch.float32)
    port.load_state_dict(state_dict_from_flax(tree, port.state_dict(), strict=True))
    port.gather_bias()
    with torch.inference_mode():
        got = port(torch.tensor(np.asarray(x)), None if qg is None else torch.tensor(np.asarray(qg)))
    assert got.shape == want.shape == (b * nwin, n, c)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("c,ratio", [(64, 3), (32, 2)])
def test_mlp_module_matches_flax(c, ratio):
    rng = np.random.RandomState(c)
    x = jnp.asarray(_u(rng, (5, 7, c), -2, 2))
    jax_mod = JaxMlp(hidden_features=ratio * c, activation="gelu")
    tree = _params(jax_mod, c, x)
    want = np.asarray(jax_mod.apply(tree, x))
    port = Mlp(c, ratio * c)
    assert set(port.state_dict()) == {"fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
    port.load_state_dict(state_dict_from_flax(tree, port.state_dict(), strict=True))
    with torch.inference_mode():
        got = port(torch.tensor(np.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_block_path_follows_the_field_the_environment_and_training(monkeypatch):
    monkeypatch.delenv("VIPTPU_NO_FUSED_BLOCK", raising=False)
    cfg = GCViTConfig(name="GCViTTiny")
    assert _use_fused_block(cfg, training=False)  # the port's auto: fused on every device
    assert not _use_fused_block(cfg, training=True)
    assert not _use_fused_block(cfg.replace(fused_block=False), training=False)
    assert not _use_fused_block(cfg.replace(fused_block=True, attn_drop=0.1), training=False)
    monkeypatch.setenv("VIPTPU_NO_FUSED_BLOCK", "1")
    assert not _use_fused_block(cfg, training=False)
    assert _use_fused_block(cfg.replace(fused_block=True), training=False)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[((224, 224), None, 3), ((200, 200), "sigmoid", 1)],
                ids=["224", "200"])
def narrow_gcvit(request):
    """The JAX model's output on its unfused path and its perturbed weights;
    at 200 the stem grid of 50 is FitWindow-padded to 56 and cropped back."""
    size, activation, nb_classes = request.param
    kw = dict(input_size=size, nb_classes=nb_classes, classifier_activation=activation, **NARROW)
    module, tree = _jax_gcvit(seed=8, fused_block=False, **kw)
    x = np.random.RandomState(9).uniform(0, 1, (2, *size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x)))
    return kw, tree, x, want


def _port(kw, tree, fused_block):
    port, _ = create_model("GCViTTiny", fused_block=fused_block, **kw)
    return transfer_weights(tree, port, strict=True)


def test_narrow_unfused_gcvit_matches_jax(narrow_gcvit):
    kw, tree, x, want = narrow_gcvit
    with torch.inference_mode():
        got = _port(kw, tree, False)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, kw["nb_classes"])
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_port_unfused_path_equals_its_fused_path(narrow_gcvit):
    """One set of weights serves both block paths."""
    kw, tree, x, _ = narrow_gcvit
    unfused, fused = _port(kw, tree, False), _port(kw, tree, True)
    fused.load_state_dict(unfused.state_dict())
    with torch.inference_mode():
        a = unfused(torch.from_numpy(x)).numpy()
        b = fused(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(a, b, atol=ATOL)


@pytest.mark.parametrize("name,size,kw,fused_block,expected", [
    # stem ReduceSize 2, three downsample ReduceSizes 2 each, the head LN 1,
    # plus norm1 and norm2 of each of the 8 blocks when unfused
    ("GCViTTiny", 224, NARROW, True, 9),
    ("GCViTTiny", 224, NARROW, False, 9 + 2 * 8),
    # stem, three downsamples and the head: the blocks' LNs are in their kernels
    ("convnext_tiny_in22k", 64, NARROW_CONVNEXT, None, 5),
    # unfused, each of the 4 blocks' LN too
    ("convnext_tiny_in22k", 64, NARROW_CONVNEXT, False, 5 + 4),
])
def test_every_standalone_layer_norm_runs_the_ln_function(monkeypatch, name, size, kw,
                                                          fused_block, expected):
    """Each LN the model calls goes through ``layernorm.layer_norm``, the
    wrapper that launches the LN kernel on CUDA."""
    calls = []

    def counting(x, weight, bias, eps):
        calls.append(tuple(x.shape))
        return L.layer_norm_plain(x, weight, bias, eps)

    monkeypatch.setattr(L, "layer_norm", counting)
    extra = {} if fused_block is None else {"fused_block": fused_block}
    model, _ = create_model(name, input_size=(size, size), nb_classes=1, **kw, **extra)
    with torch.inference_mode():
        model(torch.rand((1, size, size, 3)))
    assert len(calls) == expected


# ---------------------------------------------------------------------------
# the CLI with two members on the unfused path
# ---------------------------------------------------------------------------
def test_two_member_cli_unfused_csv_equals_jax_byte_for_byte(two_member_workspace, monkeypatch):
    """Both members on their unfused block paths under the knob, as the
    JAX CLI runs them off the TPU: GCViT's and, since the port's ConvNeXt
    honours it too, ConvNeXt's (every block through its unfused form)."""
    from vip_cup_2022_tpu_torch.models.convnext import ConvNeXtBlock

    unfused = []
    original = ConvNeXtBlock._unfused
    monkeypatch.setattr(ConvNeXtBlock, "_unfused",
                        lambda self, x: unfused.append(1) or original(self, x))
    monkeypatch.setenv("VIPTPU_NO_FUSED_BLOCK", "1")
    assert_two_member_csvs_equal(two_member_workspace, monkeypatch)
    assert unfused


def test_unfused_layer_scale_block_runs_in_bf16():
    """With a layer scale the unfused residual turns f32 (γ is an f32
    parameter), as in the JAX package; each Dense and conv casts its input
    back to the compute dtype. The bf16 model runs and stays near f32."""
    kw = dict(input_size=(224, 224), nb_classes=3, classifier_activation=None,
              layer_scale=0.5, fused_block=False, **NARROW)
    ref, _ = create_model("GCViTBase", **kw)
    low, _ = create_model("GCViTBase", dtype=torch.bfloat16, **kw)
    low.load_state_dict(ref.state_dict())
    x = torch.from_numpy(np.random.RandomState(3).uniform(0, 1, (2, 224, 224, 3)).astype(np.float32))
    with torch.inference_mode():
        want, got = ref(x), low(x)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-2


@pytest.mark.slow
def test_full_width_unfused_gcvit_tiny_matches_jax():
    kw = dict(input_size=(224, 224), nb_classes=1000, classifier_activation=None)
    module, tree = _jax_gcvit(seed=3, fused_block=False, **kw)
    x = np.random.RandomState(5).uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(module.apply(tree, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(kw, tree, False)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got, want, atol=ATOL)
