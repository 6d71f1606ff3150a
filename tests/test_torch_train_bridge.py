"""The inverse weight bridge and the checkpoint writer, on the CPU.

``torch_to_flax`` gives, for each of the seven members of
``ckpts/ckpts.json`` at narrow width, the tree the JAX module's init builds
(paths and shapes from ``jax.eval_shape``, nothing compiled), and
``flax_to_torch`` maps it back onto the state dict exactly. The port's
msgpack writer gives ``flax.serialization.to_bytes``'s bytes (chunked
arrays and bf16 included), with the JAX package's ``.md5`` sidecar."""
import hashlib
import os
import subprocess
import sys

import flax
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.utils.checkpoint import load_variables as jax_load_variables
from vip_cup_2022_tpu.utils.checkpoint import save_variables as jax_save_variables
from vip_cup_2022_tpu_torch.models import create_model
from vip_cup_2022_tpu_torch.utils import checkpoint
from vip_cup_2022_tpu_torch.weights.from_jax import flax_to_torch
from vip_cup_2022_tpu_torch.weights.to_flax import flax_paths, torch_to_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_efficientnet as eff_tests  # noqa: E402
import test_torch_nfnet as nf_tests  # noqa: E402
from test_torch_gcvit import NARROW as NARROW_GCVIT  # noqa: E402
from test_torch_resnest import NARROW as NARROW_RESNEST  # noqa: E402
from test_torch_slice import NARROW as NARROW_CONVNEXT  # noqa: E402

MEMBERS = {  # the manifest's seven, narrow, at the sizes of test_torch_ensemble.py
    "convnext_tiny_in22k": (64, NARROW_CONVNEXT),
    "ResNest50": (64, NARROW_RESNEST),
    "GCViTTiny": (224, NARROW_GCVIT),
    "EfficientNetV2T": (64, eff_tests.NARROW["EfficientNetV2T"]),
    "EfficientNetV1B4": (72, eff_tests.NARROW["EfficientNetV1B4"]),
    "ECA_NFNetL0": (72, nf_tests.NARROW),
    "ResNetRS50": (64, {}),
}


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


@pytest.mark.parametrize("name", list(MEMBERS))
def test_torch_to_flax_gives_the_jax_tree_and_round_trips(name):
    size, kw = MEMBERS[name]
    module, _, _ = jax_create_model(name, input_size=(size, size), init=False, **kw)
    want = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    want = flax.core.unfreeze(want)
    port, _ = create_model(name, input_size=(size, size), **kw)
    tree = torch_to_flax(port)
    if not want.get("batch_stats"):
        assert tree.pop("batch_stats") == {}
    assert _shapes(tree) == _shapes(want)
    back = flax_to_torch(tree)
    state = port.state_dict()
    assert back.keys() == state.keys()
    for key, value in state.items():
        np.testing.assert_array_equal(back[key], value.float().numpy(), err_msg=key)
    assert set(flax_paths(port)) == set(state)


def test_torch_to_flax_of_values_maps_gradients_by_key():
    """``values`` (e.g. gradients, by state-dict key) in the Flax layout:
    a Linear's (out, in) becomes (in, out), a depthwise (k, k, C) gains its
    I axis."""
    port, _ = create_model("GCViTTiny", input_size=(224, 224), **NARROW_GCVIT)
    key_lin, key_dw = "levels_0.blocks_0.attn.qkv.weight", "patch_embed.conv_down.conv_0.weight"
    values = {key_lin: torch.arange(96 * 32.0).reshape(96, 32),
              key_dw: torch.ones(3, 3, 32)}
    tree = torch_to_flax(port, values=values)["params"]
    np.testing.assert_array_equal(tree["levels_0"]["blocks_0"]["attn"]["qkv"]["kernel"],
                                  values[key_lin].numpy().T)
    assert tree["patch_embed"]["conv_down"]["conv_0"]["kernel"].shape == (3, 3, 1, 32)
    assert set(tree) == {"levels_0", "patch_embed"}


def _tree():
    rng = np.random.RandomState(0)
    return {
        "params": {"a": {"kernel": rng.randn(3, 4).astype(np.float32),
                         "bias": np.zeros(4, np.float32)},
                   "b": rng.randn(300, 70).astype(np.float32),
                   "scalar": np.float32(2.5), "count": np.asarray(7),
                   "ints": np.arange(70000, dtype=np.int64), "empty": {}},
        "meta": {"step": 3, "neg": -200, "big": 2 ** 40, "f": 0.5, "name": "x" * 40,
                 "flag": True, "none": None, "list": [1, 2.0]},
    }


def test_writer_gives_flax_bytes():
    assert checkpoint.to_bytes(_tree()) == flax.serialization.to_bytes(_tree())
    bits = torch.randn(5, 3).to(torch.bfloat16)
    want = flax.serialization.to_bytes({"w": jnp.asarray(bits.float().numpy(), jnp.bfloat16)})
    assert checkpoint.to_bytes({"w": bits}) == want


def test_writer_chunks_big_arrays_as_flax_does(monkeypatch):
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1000)
    tree = {"w": np.arange(1000, dtype=np.float32).reshape(10, 100)}
    data = checkpoint.to_bytes(tree)
    assert data == flax.serialization.to_bytes(tree)
    np.testing.assert_array_equal(checkpoint.msgpack_restore(data)["w"], tree["w"])


def test_save_variables_is_read_by_both_packages(tmp_path):
    """The same bytes and sidecar as the JAX writer; both loaders read it."""
    ours, theirs = str(tmp_path / "p.msgpack"), str(tmp_path / "j.msgpack")
    digest = checkpoint.save_variables(ours, _tree())
    jax_save_variables(theirs, _tree())
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert open(ours + ".md5").read() == f"{digest}  p.msgpack\n"
    assert digest == hashlib.md5(open(ours, "rb").read()).hexdigest()
    for load in (checkpoint.load_variables, jax_load_variables):
        back = load(ours)
        np.testing.assert_array_equal(back["params"]["b"], _tree()["params"]["b"])
        assert back["meta"]["name"] == "x" * 40 and back["meta"]["list"] == {"0": 1, "1": 2.0}
    assert checkpoint.save_variables(str(tmp_path / "n.msgpack"), {}, checksum=False) is None
    assert not os.path.exists(tmp_path / "n.msgpack.md5")
    with pytest.raises(TypeError, match="cannot hold"):
        checkpoint.to_bytes({"x": object()})


def test_training_modules_import_no_jax():
    code = ("import sys; import vip_cup_2022_tpu_torch.train, vip_cup_2022_tpu_torch.ops.drop, "
            "vip_cup_2022_tpu_torch.weights.to_flax, vip_cup_2022_tpu_torch.utils.checkpoint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'optax', 'msgpack', 'vip_cup_2022_tpu')]; assert not bad, bad")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120)
