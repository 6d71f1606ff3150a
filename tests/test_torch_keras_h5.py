"""The port's checkpoint readers and weight mappers (``vip_cup_2022_tpu_torch
/weights``) against the JAX package's on the same inputs: the Keras h5
reader in both layouts, ``savedmodel_dir`` and the SavedModel reader's
error without TensorFlow, every Keras-h5 family mapper, the dispatch
tables, the torch reader and both torch mappers. Each tree must equal the
JAX package's leaf for leaf and bit for bit (same paths, dtypes, shapes
and bytes)."""
import sys
from collections.abc import Mapping

import h5py
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_weights import _synthetic_convnext_state, _synthetic_vit_state
from vip_cup_2022_tpu.weights import keras_h5 as jax_h5
from vip_cup_2022_tpu.weights import savedmodel as jax_sm
from vip_cup_2022_tpu.weights import torch_pt as jax_pt
from vip_cup_2022_tpu_torch import weights as port_weights
from vip_cup_2022_tpu_torch.weights import keras_h5, savedmodel, torch_pt


def flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def assert_trees_equal(got, want, ordered=True):
    """Same nesting, the same leaves (in the same order when ``ordered``),
    each of the same dtype and shape and the same bytes."""
    got, want = flatten(got), flatten(want)
    assert (list(got) == list(want)) if ordered else (sorted(got) == sorted(want))
    for path, w in want.items():
        g = got[path]
        assert type(g) is type(w), path
        g, w = np.asarray(g), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        assert g.tobytes() == w.tobytes(), path


def _arrays(spec, seed):
    """{key: f32 array of the given shape}, drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-1, 1, shape).astype(np.float32) for k, shape in spec.items()}


# ---------------------------------------------------------------------------
# the Keras h5 reader
# ---------------------------------------------------------------------------
H5_WEIGHTS = {"stem_conv/kernel": (3, 3, 3, 4), "stem_bn/gamma": (4,), "stem_bn/moving_mean": (4,),
              "stack_0_MB_dw_/depthwise_kernel": (3, 3, 4, 1), "predictions/kernel": (4, 2)}


def write_keras_h5(path, weights, layout="weights"):
    """``weights`` ({'layer/weight': array}) as a Keras-layout h5: each
    dataset in the group of its key's first component, named '<key>:0' as
    Keras names a weight, with the ``layer_names`` / ``weight_names``
    attributes, at the root (``save_weights``) or under ``model_weights``
    (``model.save``)."""
    root_name = "model_weights/" if layout == "model" else ""
    layers = {}
    for key in weights:
        layers.setdefault(key.split("/")[0], []).append(key)
    with h5py.File(path, "w") as f:
        for layer, keys in layers.items():
            for key in keys:
                f.create_dataset(f"{root_name}{layer}/{key}:0", data=weights[key])
            f[f"{root_name}{layer}"].attrs["weight_names"] = [f"{k}:0".encode() for k in keys]
        (f[root_name] if root_name else f).attrs["layer_names"] = [n.encode() for n in layers]


@pytest.mark.parametrize("layout", ["weights", "model"])
def test_read_keras_h5_equals_jax(tmp_path, layout):
    weights = _arrays(H5_WEIGHTS, 0)
    path = str(tmp_path / f"{layout}.h5")
    write_keras_h5(path, weights, layout)
    with h5py.File(path, "a") as f:  # optimizer state beside the model, a scalar in it
        f.create_dataset("optimizer_weights/Adam/iter:0", data=np.int64(7))
        f.create_dataset(f"{'model_weights/' if layout == 'model' else ''}count/count:0",
                         data=np.int64(3))
    got, want = keras_h5.read_keras_h5(path), jax_h5.read_keras_h5(path)
    assert_trees_equal(got, want)
    assert "stem_conv/stem_conv/kernel" in got and not any(k.startswith("optimizer") for k in got)
    deduped = {keras_h5._dedupe_layer_prefix(k): v for k, v in got.items()}
    assert {k: v for k, v in deduped.items() if k != "count"}.keys() == weights.keys()


@pytest.mark.parametrize("key", ["a/a/kernel", "a/b/kernel", "a/kernel", "kernel",
                                 "levels/gcvit_tiny/levels/0/w", "x/x/x/w"])
def test_dedupe_layer_prefix_equals_jax(key):
    assert keras_h5._dedupe_layer_prefix(key) == jax_h5._dedupe_layer_prefix(key)


def test_savedmodel_dir_equals_jax(tmp_path):
    sm = tmp_path / "sm"
    sm.mkdir()
    (sm / "saved_model.pb").write_bytes(b"")
    cases = [str(sm), str(sm / "saved_model.pb"), "saved_model.pb", str(tmp_path),
             str(tmp_path / "fold0.h5"), str(tmp_path / "missing")]
    got = [savedmodel.savedmodel_dir(c) for c in cases]
    assert got == [jax_sm.savedmodel_dir(c) for c in cases]
    assert got == [str(sm), str(sm), ".", "", "", ""]


def test_read_savedmodel_without_tensorflow_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # import tensorflow -> ImportError
    messages = []
    for module in (savedmodel, jax_sm):
        with pytest.raises(NotImplementedError, match="requires TensorFlow") as err:
            module.read_savedmodel(str(tmp_path))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# every Keras-h5 family mapper, on flat {'layer/weight': array} inputs
# ---------------------------------------------------------------------------
MAPPER_INPUTS = {
    "map_resnet_rs": ("ResNetRS50", {
        "stem_conv_1/kernel": (3, 3, 3, 4), "stem_batch_norm_1/gamma": (4,),
        "stem_batch_norm_1/moving_mean": (4,), "stem_batch_norm_1/moving_variance": (4,),
        "c2_block_0_conv_1/kernel": (1, 1, 4, 4), "c2_block_0_batch_norm_1/beta": (4,),
        "c2_block_0_batch_norm_1/moving_variance": (4,), "c2_block_0_se_reduce/kernel": (1, 1, 4, 2),
        "c2_block_0_se_reduce/bias": (2,), "c2_block_0_se_expand/kernel": (1, 1, 2, 4),
        "c2_block_0_projection_conv/kernel": (1, 1, 4, 8),
        "c2_block_0_projection_batch_norm/moving_mean": (8,), "c3_block_1_conv_2/kernel": (3, 3, 8, 8),
        "predictions/kernel": (8, 2), "predictions/bias": (2,),
        "normalization/mean": (3,), "normalization/count": (), "c2_block_0_unknown/kernel": (2,)}),
    "map_gcvit": ("GCViTTiny", {
        "patch_embed/gcvit_tiny/patch_embed/proj/kernel": (3, 3, 3, 4),
        "patch_embed/gcvit_tiny/patch_embed/conv_down/conv/0/depthwise_kernel": (3, 3, 4, 1),
        "patch_embed/gcvit_tiny/patch_embed/conv_down/conv/2/fc/0/kernel": (4, 2),
        "levels/gcvit_tiny/levels/0/blocks/1/attn/qkv/kernel": (4, 12),
        "levels/gcvit_tiny/levels/0/blocks/1/attn/relative_position_bias_table": (169, 1),
        "levels/gcvit_tiny/levels/0/q_global_gen/to_q_global/0/conv/0/depthwise_kernel":
            (3, 3, 4, 1),
        "levels/gcvit_tiny/levels/1/q_global_gen/to_q_global/1/conv/3/kernel": (1, 1, 8, 8),
        "levels/gcvit_tiny/levels/0/downsample/norm1/gamma": (4,),
        "head/kernel": (8, 2), "GCViT_layer/GCViTTiny/norm/beta": (8,)}),
    "map_kecam": ("EfficientNetV2T", {
        "stem_conv/kernel": (3, 3, 3, 4), "stem_bn/moving_mean": (4,), "stem_bn/gamma": (4,),
        "stack_0_block0_MB_dw_/depthwise_kernel": (3, 3, 4, 1),
        "MixerBlock_0/token_mixing/Dense_0/MixerBlock_0/token_mixing/Dense_0/kernel": (4, 4),
        "attn_mha/query/kernel": (4, 2, 2), "stack1_block1_eca_conv1d/kernel": (3, 1, 1),
        "scalar_gain": (), "predictions/bias": (2,)}),
    "map_efficientdet": ("EfficientDetD0", {
        "biFPN_0_p3_conv/kernel": (1, 1, 4, 4), "p3_p4_bn/moving_mean": (4,),
        "regressor_head/bias": (4,), "classifier_head/kernel": (3, 3, 4, 2),
        "object_head/bias": (1,), "stem_conv/kernel": (3, 3, 3, 4), "stem_bn/moving_variance": (4,),
        "stack_0_block0_MB_dw_/depthwise_kernel": (3, 3, 4, 1)}),
    "map_convnext": ("convnext_tiny", {
        "stem/convnext_tiny/stem/0/kernel": (4, 4, 3, 4), "stem/convnext_tiny/stem/1/gamma": (4,),
        "head/convnext_tiny/head/norm/beta": (8,), "head/convnext_tiny/head/fc/kernel": (8, 2),
        "stages/convnext_tiny/stages/1/downsample/0/gamma": (4,),
        "stages/convnext_tiny/stages/1/downsample/1/kernel": (2, 2, 4, 8),
        "stages/convnext_tiny/stages/0/blocks/0/conv_dw/depthwise_kernel": (7, 7, 4, 1),
        "stages/convnext_tiny/stages/0/blocks/0/conv_dw/bias": (4,),
        "stages/convnext_tiny/stages/0/blocks/0/mlp/fc1/kernel": (4, 16),
        "stages/convnext_tiny/stages/0/blocks/0/mlp/fc2/bias": (4,),
        "stages/convnext_tiny/stages/0/blocks/0/norm/gamma": (4,),
        "stages/convnext_tiny/stages/0/blocks/0/gamma": (4,),
        "stages/convnext_tiny/stages/0/other/kernel": (2,), "other/convnext_tiny/pre/x": (2,)}),
    "map_vit": ("vit_tiny_patch16_224", {
        "patch_embed/vit_tiny/patch_embed/proj/kernel": (4, 4, 3, 8),
        "pre_logits/vit_tiny/pre_logits/fc/kernel": (8, 8), "cls/vit_tiny/cls_token": (1, 1, 8),
        "blocks/vit_tiny/blocks/0/attn/qkv/kernel": (8, 24), "norm/vit_tiny/norm/gamma": (8,),
        "pos/vit_tiny/pos_conv/depthwise_kernel": (3, 3, 8, 1), "head/kernel": (8, 2)}),
    "map_tfimm_flat": ("poolformer_s12", {
        "net/poolformer_s12/network/0/0/layer_scale_1": (4,),
        "net/poolformer_s12/network/0/0/norm1/gamma": (4,),
        "net/poolformer_s12/network/0/0/mlp/fc1/kernel": (1, 1, 4, 16),
        "stem/convmixer_768_32/convmixer_768_32/stem/conv/kernel": (7, 7, 3, 4),
        "net/convmixer_768_32/blocks/0/bn/moving_mean": (4,),
        "net/convmixer_768_32/blocks/0/dw/depthwise_kernel": (9, 9, 4, 1)}),
    "map_timm_resnet": ("resnet_test", {
        "conv1/resnet_test/conv1/kernel": (7, 7, 3, 4),
        "bn1/resnet_test/bn1/moving_mean": (4,),
        "layer1/resnet_test/layer1/0/bn1/moving_variance": (4,),
        "layer1/resnet_test/layer1/0/conv2/kernel": (3, 3, 4, 4),
        "layer1/resnet_test/layer1/0/blur/blur_kernel": (3, 3, 1, 4),
        "fc/resnet_test/fc/kernel": (4, 2), "fc/bias": (2,)}),
}


@pytest.mark.parametrize("mapper", sorted(MAPPER_INPUTS))
def test_keras_mapper_equals_jax(mapper):
    model_name, spec = MAPPER_INPUTS[mapper]
    weights = _arrays(spec, 1)
    got = getattr(keras_h5, mapper)(dict(weights), model_name)
    want = getattr(jax_h5, mapper)(dict(weights), model_name)
    assert_trees_equal(got, want)
    # the depthwise kernels come out (h, w, 1, C), and nothing else moved
    dw = [v for k, v in flatten(got).items() if v.ndim == 4 and v.shape[2] == 1]
    assert all(v.shape[3] > 1 for v in dw)


def test_mapper_tables_equal_jax():
    """Every registered prefix routes to the same family as in the JAX
    package, Keras h5 and torch alike."""
    for port_table, jax_table in ((keras_h5._WEIGHT_MAPPERS, jax_h5._WEIGHT_MAPPERS),
                                  (torch_pt._TORCH_MAPPERS, jax_pt._TORCH_MAPPERS)):
        assert list(port_table) == list(jax_table)
        assert {k: f.__name__ for k, f in port_table.items()} == {
            k: f.__name__ for k, f in jax_table.items()}
    assert len(keras_h5._WEIGHT_MAPPERS) == 64


@pytest.mark.parametrize("model_name", [
    "ResNetRS50", "GCViTTiny", "EfficientNetV2T", "EfficientNetV1B4", "ResNest50", "ECA_NFNetL0",
    "convnext_tiny_in22k", "efficientdet_d0", "vit_base_patch16_224", "poolformer_s12",
    "seresnet50", "resnet50d", "regnety_040", "mobilenetv3_small", "swin_tiny", "NFNetF0"])
def test_apply_weight_mapper_dispatch_equals_jax(model_name):
    """The longest registered prefix of the lower-cased name wins, in both
    packages: the same tree from the same input."""
    weights = _arrays({"stem_conv/kernel": (3, 3, 3, 4), "stem_bn/moving_mean": (4,),
                       "a/gcvit_x/levels/0/w": (2,)}, 2)
    assert_trees_equal(keras_h5.apply_weight_mapper(dict(weights), model_name),
                       jax_h5.apply_weight_mapper(dict(weights), model_name))
    for module in (keras_h5, jax_h5):
        with pytest.raises(KeyError, match="no weight mapper registered"):
            module.apply_weight_mapper(dict(weights), "unknown_net")


def test_explicit_mapper_equals_jax(tmp_path):
    """``mapper=`` picks the family whatever the name ('resnet50' routes to
    kecam by prefix; the timm layout needs ``timm_resnet``), through the
    file route too."""
    model_name, spec = MAPPER_INPUTS["map_timm_resnet"]
    weights = _arrays(spec, 3)
    got = keras_h5.apply_weight_mapper(dict(weights), "resnet_test", mapper="timm_resnet")
    assert_trees_equal(got, jax_h5.apply_weight_mapper(dict(weights), "resnet_test",
                                                       mapper="timm_resnet"))
    assert_trees_equal(got, keras_h5.map_timm_resnet(dict(weights), "resnet_test"))
    path = str(tmp_path / "timm.h5")
    write_keras_h5(path, weights)
    assert_trees_equal(port_weights.convert_keras_h5(path, model_name, mapper="TIMM_RESNET"),
                       jax_h5.convert_keras_h5(path, model_name, mapper="timm_resnet"))


# ---------------------------------------------------------------------------
# timm / PyTorch state dicts
# ---------------------------------------------------------------------------
def _convnext_sd(bare_head: bool):
    sd = _synthetic_convnext_state(depths=(1, 2, 1, 1), dims=(8, 16, 24, 32), classes=5)
    if bare_head:  # the older timm naming: 'norm.*' and 'head.*'
        sd = {{"head.norm.weight": "norm.weight", "head.norm.bias": "norm.bias",
               "head.fc.weight": "head.weight", "head.fc.bias": "head.bias"}.get(k, k): v
              for k, v in sd.items()}
    return sd


@pytest.mark.parametrize("case", ["vit", "convnext", "convnext_bare_head"])
def test_torch_mappers_equal_jax(case):
    if case == "vit":
        sd, name = _synthetic_vit_state(depth=2, dim=16, patch=4, img=16, classes=3), "vit_tiny"
        fn = "map_vit_torch"
    else:
        sd, name = _convnext_sd(case.endswith("bare_head")), "convnext_tiny_in22k"
        fn = "map_convnext_torch"
    weights = jax_pt.read_torch_checkpoint(sd)
    assert_trees_equal(torch_pt.read_torch_checkpoint(sd), weights)
    got = getattr(torch_pt, fn)(dict(weights), name)
    assert_trees_equal(got, getattr(jax_pt, fn)(dict(weights), name))
    assert_trees_equal(torch_pt.convert_torch_weights(sd, name), got)
    assert_trees_equal(port_weights.convert_torch_weights(sd, "x", mapper=name.split("_")[0]), got)
    if case != "vit":
        assert got["params"]["head_fc"]["kernel"].shape == (32, 5)
        assert got["params"]["head_norm"]["gamma"].shape == (32,)


@pytest.mark.parametrize("nesting", [None, "state_dict", "model"])
def test_read_torch_checkpoint_file_equals_jax(tmp_path, nesting):
    sd = _convnext_sd(False)
    path = str(tmp_path / "ckpt.pth")
    torch.save(sd if nesting is None else {nesting: sd, "epoch": 3}, path)
    got = torch_pt.read_torch_checkpoint(path)
    assert_trees_equal(got, jax_pt.read_torch_checkpoint(path))
    assert list(got) == list(sd)
    assert_trees_equal(torch_pt.convert_torch_weights(path, "convnext_tiny_in22k"),
                       jax_pt.convert_torch_weights(path, "convnext_tiny_in22k"))


def test_conv_and_linear_kernel_equal_jax():
    w = _arrays({"w": (8, 3, 5, 5), "d": (6, 1, 7, 7), "l": (4, 9)}, 4)
    for fn in ("conv_kernel", "linear_kernel"):
        for v in (w["w"], w["d"]) if fn == "conv_kernel" else (w["l"],):
            got, want = getattr(torch_pt, fn)(v), getattr(jax_pt, fn)(v)
            assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert torch_pt.conv_kernel(w["d"]).shape == (7, 7, 1, 6)


def test_bf16_state_dict_raises_as_jax_does(tmp_path):
    """numpy has no bfloat16: the JAX package fails in ``v.numpy()``; the
    port fails there too, naming the entry and the fix."""
    sd = {"stem.0.weight": torch.ones(4, 3, 4, 4, dtype=torch.bfloat16)}
    path = str(tmp_path / "bf16.pth")
    torch.save(sd, path)
    with pytest.raises(TypeError):
        jax_pt.read_torch_checkpoint(path)
    with pytest.raises(TypeError, match="stem.0.weight: a bfloat16 tensor .* float32"):
        torch_pt.read_torch_checkpoint(path)
    with pytest.raises(TypeError, match="bfloat16"):
        torch_pt.convert_torch_weights(sd, "convnext_tiny_in22k")


def test_unknown_torch_family_raises_as_jax_does():
    sd = {"fc.weight": torch.ones(2, 3)}
    with pytest.raises(KeyError, match="no torch mapper registered"):
        jax_pt.convert_torch_weights(sd, "resnet50")
    with pytest.raises(KeyError, match="no torch mapper registered"):
        torch_pt.convert_torch_weights(sd, "resnet50")
