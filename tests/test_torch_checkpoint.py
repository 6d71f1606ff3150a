"""The port's numpy-only msgpack checkpoint reader and the Flax -> torch
weight bridge, held to flax.serialization and the JAX package's models."""
import json
import os

import flax.serialization
import jax
import msgpack
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.utils.checkpoint import save_variables
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.utils.checkpoint import load_variables, msgpack_restore, unpackb
from vip_cup_2022_tpu_torch.weights.from_jax import flax_to_torch, state_dict_from_flax

NARROW = dict(input_size=(32, 32), nb_classes=3, nb_blocks=(1, 1, 1, 1),
              embed_dim=(32, 64, 256, 512))


def _assert_tree_equal(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, np.ndarray) or hasattr(want, "dtype"):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(np.asarray(got), want.astype(got.dtype))
    else:
        assert got == want


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129, -40000,
    -2**31 - 1, 1.5, -2.25e300, None, True, False, "", "a" * 31, "b" * 32, "c" * 300,
    "d" * 70000, b"\x00\x01", b"e" * 300, list(range(20)), {"k": [1, {"n": None}]},
    {str(i): i for i in range(17)},
])
def test_unpackb_matches_msgpack(value):
    packed = msgpack.packb(value, use_bin_type=True)
    assert unpackb(packed) == msgpack.unpackb(packed, raw=False)


def test_reader_matches_flax_msgpack_restore():
    rng = np.random.RandomState(0)
    tree = {
        "params": {
            "conv": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
                     "bias": np.zeros((4,), np.float32)},
            "ints": np.arange(6, dtype=np.int32).reshape(2, 3),
            "f64": rng.randn(5),
            "u8": rng.randint(0, 255, (7,)).astype(np.uint8),
            "empty": np.zeros((0, 3), np.float32),
        },
        "scalar": np.float32(2.5),
        "step": 7,
    }
    data = flax.serialization.to_bytes(tree)
    _assert_tree_equal(msgpack_restore(data), flax.serialization.msgpack_restore(data))


def test_reader_widens_bfloat16_exactly():
    x = jax.numpy.asarray(np.random.RandomState(1).randn(4, 5), jax.numpy.bfloat16)
    data = flax.serialization.to_bytes({"w": x})
    got = msgpack_restore(data)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def test_reader_reassembles_chunked_arrays(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    arr = np.random.RandomState(2).randn(10, 7).astype(np.float32)
    data = flax.serialization.msgpack_serialize({"big": arr, "small": arr[:1, :2].copy()})
    out = msgpack_restore(data)
    np.testing.assert_array_equal(out["big"], arr)
    np.testing.assert_array_equal(out["small"], arr[:1, :2])


def test_load_variables_matches_flax_and_checks_md5(tmp_path):
    _, variables, _ = jax_create_model("convnext_tiny_in22k", **NARROW)
    path = str(tmp_path / "fold0.msgpack")
    save_variables(path, variables)
    _assert_tree_equal(load_variables(path), jax.tree_util.tree_map(np.asarray, dict(variables)))

    with open(path + ".md5", "w") as fh:
        fh.write("0" * 32 + "  fold0.msgpack\n")
    with pytest.raises(ValueError, match="checksum mismatch"):
        load_variables(path)
    load_variables(path, verify=False)  # explicit opt-out still reads
    os.remove(path + ".md5")
    load_variables(path)  # no sidecar: nothing to verify


def test_truncated_checkpoint_raises(tmp_path):
    data = flax.serialization.to_bytes({"w": np.ones((4, 4), np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-5])


def _narrow_tree():
    _, variables, _ = jax_create_model("convnext_tiny_in22k", **NARROW)
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))


def test_bridge_layouts():
    tree = _narrow_tree()
    sd = flax_to_torch(tree)
    p = tree["params"]
    np.testing.assert_array_equal(sd["stem_conv.weight"],
                                  np.transpose(p["stem_conv"]["kernel"], (3, 2, 0, 1)))
    dw = p["stages_0_blocks_0"]["conv_dw"]["kernel"]  # (7, 7, 1, C)
    assert sd["stages_0_blocks_0.conv_dw.weight"].shape == (7, 7, 32)
    np.testing.assert_array_equal(sd["stages_0_blocks_0.conv_dw.weight"], dw[:, :, 0, :])
    np.testing.assert_array_equal(sd["stages_0_blocks_0.mlp_fc1.weight"],
                                  p["stages_0_blocks_0"]["mlp_fc1"]["kernel"].T)
    np.testing.assert_array_equal(sd["stages_0_blocks_0.norm.weight"],
                                  p["stages_0_blocks_0"]["norm"]["gamma"])
    np.testing.assert_array_equal(sd["stages_0_blocks_0.gamma"], p["stages_0_blocks_0"]["gamma"])
    module, _ = create_model("convnext_tiny_in22k", **NARROW)
    assert set(sd) == set(module.state_dict())


def test_bridge_raises_on_missing_leaf():
    tree = _narrow_tree()
    del tree["params"]["stages_2_blocks_0"]["mlp_fc2"]["bias"]
    module, _ = create_model("convnext_tiny_in22k", **NARROW)
    with pytest.raises(ValueError, match="stages_2_blocks_0.mlp_fc2.bias: missing"):
        transfer_weights(tree, module)


def test_bridge_raises_on_mismatched_and_unexpected_leaves():
    tree = _narrow_tree()
    tree["params"]["stem_norm"]["beta"] = np.zeros((7,), np.float32)
    tree["params"]["stages_9_blocks_0"] = {"gamma": np.ones((4,), np.float32)}
    module, _ = create_model("convnext_tiny_in22k", **NARROW)
    with pytest.raises(ValueError) as err:
        state_dict_from_flax(tree, module.state_dict())
    assert "stem_norm.bias: checkpoint (7,)" in str(err.value)
    assert "stages_9_blocks_0.gamma: in the checkpoint but not in the model" in str(err.value)


def test_bridge_classifier_swap_keeps_model_head():
    tree = _narrow_tree()  # 3 classes
    module, _ = create_model("convnext_tiny_in22k", **{**NARROW, "nb_classes": 5}, seed=3)
    head = module.head_fc.weight.detach().clone()
    transfer_weights(tree, module)
    assert torch.equal(module.head_fc.weight, head)
    np.testing.assert_array_equal(module.stem_conv.weight.detach().numpy(),
                                  np.transpose(tree["params"]["stem_conv"]["kernel"], (3, 2, 0, 1)))


@pytest.mark.parametrize("fault", ["missing", "mismatched"])
def test_bridge_strict_raises_on_head(fault):
    tree = _narrow_tree()  # 3 classes
    if fault == "missing":
        del tree["params"]["head_fc"]["bias"]
        match = "head_fc.bias: missing"
        kw = NARROW
    else:
        match = "head_fc.weight: checkpoint"
        kw = {**NARROW, "nb_classes": 5}
    module, _ = create_model("convnext_tiny_in22k", **kw)
    with pytest.raises(ValueError, match=match):
        transfer_weights(tree, module, strict=True)


def test_engine_refuses_fold_with_other_head(tmp_path):
    from vip_cup_2022_tpu_torch.infer.engine import EnsembleEngine

    _, variables, _ = jax_create_model("convnext_tiny_in22k", **NARROW)  # 3 classes
    ckpt_dir = tmp_path / "convnext_tiny_in22k-32x32" / "ckpt"
    ckpt_dir.mkdir(parents=True)
    save_variables(str(ckpt_dir / "fold0.msgpack"), variables)
    with open(ckpt_dir / "config.json", "w") as fh:
        json.dump({**NARROW, "input_size": [32, 32], "nb_classes": 1}, fh)
    engine = EnsembleEngine(device="cpu", num_decode_threads=1)
    cfg = [("convnext_tiny_in22k-32x32", [str(ckpt_dir / "fold0.msgpack")], (32, 32), 0)]
    try:
        with pytest.raises(ValueError, match="head_fc"):
            engine.load_members(cfg)
    finally:
        engine.close()
