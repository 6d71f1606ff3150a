"""The seven ensemble members through the Keras-h5 route (ConvNeXt, GCViT
and ResNetRS50 here, the four kecam-family members in
``test_torch_weight_kecam.py``): for each, narrow
(ResNetRS50 at its depth's widths), a Keras-layout ``.h5`` written from the
JAX model's variables tree (seeded values, see ``from_port``) by the
inverse of its family's mapper, a writer that counts only if the JAX
package's own ``convert_keras_h5`` gives those variables back leaf for
leaf; then the port's conversion equals the JAX
package's bit for bit, and the port's f32 forward from the file, through
``create_model(model_path=...)``, matches the JAX forward within 1e-4.
ConvNeXt also goes through timm-named ``.pth`` state dicts, bare and nested,
with both head namings (the writer ``chip_smoke.timm_convnext_state``)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_keras_h5 import assert_trees_equal, flatten, write_keras_h5
from test_torch_slice import MODEL_ATOL, NARROW
from test_torch_slice import _perturb as _perturb_convnext
from vip_cup_2022_tpu.weights.keras_h5 import convert_keras_h5 as jax_convert_keras_h5
from vip_cup_2022_tpu.weights.torch_pt import convert_torch_weights as jax_convert_torch
from vip_cup_2022_tpu_torch.models import create_model, load_weights
from vip_cup_2022_tpu_torch.weights import convert_keras_h5, convert_torch_weights
from vip_cup_2022_tpu_torch.weights.to_flax import torch_to_flax


# ---------------------------------------------------------------------------
# Keras-layout writers: each the inverse of one family mapper
# ---------------------------------------------------------------------------
def _depthwise(path, value):
    """A Flax depthwise kernel (h, w, 1, C) is Keras's ``depthwise_kernel``
    (h, w, C, 1)."""
    if path[-1] == "kernel" and value.ndim == 4 and value.shape[2] == 1:
        return path[:-1] + ("depthwise_kernel",), np.transpose(value, (0, 1, 3, 2))
    return path, value


def kecam_weights(tree, model_name):
    """Functional-Keras names: '<layer>/<weight>' (``map_kecam``)."""
    out = {}
    for (_, *path), value in flatten(tree).items():
        path, value = _depthwise(tuple(path), value)
        out["/".join(path)] = value
    return out


def resnet_rs_weights(tree, model_name):
    """'c2_block_0_conv_1/kernel', 'c2_block_0_se_reduce/bias',
    'stem_batch_norm_1/moving_mean' (``map_resnet_rs``), and the input
    Normalization layer's weights, which the mapper drops."""
    out = {"normalization/mean": np.zeros(3, np.float32),
           "normalization/variance": np.ones(3, np.float32),
           "normalization/count": np.int64(0)}
    for (_, *path), value in flatten(tree).items():
        layers = [p for p in path[:-1] if p != "se"]
        if layers[-1] == "conv":  # the Flax Conv wrapper's inner nn.Conv
            layers = layers[:-1]
        out[f"{'_'.join(layers)}/{path[-1]}"] = value
    return out


def _unmerge(part):
    """'levels_0' -> ['levels', '0'] (the inverse of ``_merge_numeric``)."""
    m = re.fullmatch(r"(.+)_(\d+)", part)
    return [m.group(1), m.group(2)] if m else [part]


def gcvit_weights(tree, model_name):
    """Subclassed-Keras names '<layer>/<model>/levels/0/blocks/1/...'
    (``map_gcvit``), the FeatExtract pyramid nested again."""
    out = {}
    for (_, *path), value in flatten(tree).items():
        path, value = _depthwise(tuple(path), value)
        parts = []
        for p in path:
            if p.startswith("q_global_gen_"):
                parts += ["q_global_gen"] + _unmerge(p[len("q_global_gen_"):])
            else:
                parts += _unmerge(p)
        out[f"{parts[0]}/{model_name.lower()}/{'/'.join(parts)}"] = value
    return out


def convnext_weights(tree, model_name):
    """tfimm ConvNeXt names '<layer>/<model>/stages/0/blocks/0/mlp/fc1/kernel'
    (``map_convnext``)."""
    out = {}
    for (_, *path), value in flatten(tree).items():
        path, value = _depthwise(tuple(path), value)
        top, leaf = path[0], path[-1]
        if top in ("stem_conv", "stem_norm"):
            keras = ["stem", "0" if top == "stem_conv" else "1", leaf]
        elif top.startswith("head_"):
            keras = ["head", top[len("head_"):], leaf]
        elif "_downsample_" in top:
            j, which = re.fullmatch(r"stages_(\d+)_downsample_(norm|conv)", top).groups()
            keras = ["stages", j, "downsample", "0" if which == "norm" else "1", leaf]
        else:
            j, i = re.fullmatch(r"stages_(\d+)_blocks_(\d+)", top).groups()
            rest = [{"mlp_fc1": "mlp/fc1", "mlp_fc2": "mlp/fc2"}.get(p, p) for p in path[1:]]
            keras = ["stages", j, "blocks", i] + rest
        out[f"{keras[0]}/{model_name.lower()}/{'/'.join(keras)}"] = value
    return out


WRITERS = {"kecam": kecam_weights, "resnet_rs": resnet_rs_weights, "gcvit": gcvit_weights,
           "convnext": convnext_weights}


# ---------------------------------------------------------------------------
# the seven members, narrow, and their JAX side computed once per module
# ---------------------------------------------------------------------------
def from_port(perturb):
    """A tree maker ``make(name, size, overrides, seed)``: the member's Flax
    variables tree with the port's seeded init as its values
    (``torch_to_flax``; the JAX model's tree, path for path and shape for
    shape: tests/test_torch_train_bridge.py, and the JAX forward below
    applies it), then ``perturb(tree, seed)`` as the family's tests perturb
    JAX's init, so that every leaf matters. Drawing on the port spares a
    JAX init compile per member."""
    def make(name, size, overrides, seed):
        port, _ = create_model(name, input_size=(size, size), seed=seed, **overrides)
        tree = torch_to_flax(port)
        if not tree["batch_stats"]:
            del tree["batch_stats"]
        return perturb(tree, seed)
    return make


def _convnext_perturb(tree, seed):
    _perturb_convnext(tree["params"], np.random.RandomState(seed))
    return tree


def _gcvit_perturb(tree, seed):
    """LN params and biases off their init, the rel-pos tables ~ U(-1, 1)
    (as ``test_torch_gcvit._jax_gcvit`` does to JAX's)."""
    rng = np.random.RandomState(seed)
    _perturb_convnext(tree["params"], rng)
    for path, value in flatten(tree["params"]).items():
        if path[-1] == "relative_position_bias_table":
            node = tree["params"]
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = rng.uniform(-1, 1, value.shape).astype(np.float32)
    return tree


def _members():
    import test_torch_efficientnet as eff_tests
    import test_torch_nfnet as nf_tests
    import test_torch_resnet_rs as rs_tests
    from test_torch_gcvit import NARROW as NARROW_GCVIT
    from test_torch_resnest import NARROW as NARROW_RESNEST

    eff = from_port(eff_tests._tree)
    return {  # name: (size, narrow overrides, tree maker, family, h5 layout)
        "convnext_tiny_in22k": (64, NARROW, from_port(_convnext_perturb), "convnext", "weights"),
        "GCViTTiny": (224, NARROW_GCVIT, from_port(_gcvit_perturb), "gcvit", "model"),
        "ResNetRS50": (64, {}, from_port(rs_tests._tree), "resnet_rs", "model"),
        "EfficientNetV2T": (64, eff_tests.NARROW["EfficientNetV2T"], eff, "kecam", "weights"),
        "EfficientNetV1B4": (72, eff_tests.NARROW["EfficientNetV1B4"], eff, "kecam", "model"),
        "ResNest50": (64, NARROW_RESNEST, eff, "kecam", "weights"),
        "ECA_NFNetL0": (72, nf_tests.NARROW, from_port(nf_tests._tree), "kecam", "model"),
    }


MEMBERS = ("convnext_tiny_in22k", "GCViTTiny", "ResNetRS50", "EfficientNetV2T",
           "EfficientNetV1B4", "ResNest50", "ECA_NFNetL0")
KECAM = MEMBERS[3:]  # tests/test_torch_weight_kecam.py


@pytest.fixture(scope="module")
def member_files(tmp_path_factory):
    """name -> (tree, h5 path, overrides, x, JAX logits), each member's JAX
    side made once, on demand."""
    from vip_cup_2022_tpu.models import create_model as jax_create_model

    root, table, cache = tmp_path_factory.mktemp("weight_members"), _members(), {}

    def get(name):
        if name not in cache:
            size, narrow, make, family, layout = table[name]
            head = dict(nb_classes=1, classifier_activation=None, **narrow)
            tree = make(name, size, head, MEMBERS.index(name))
            kw = dict(input_size=(size, size), **head)
            path = str(root / f"{name}.h5")
            write_keras_h5(path, WRITERS[family](tree, name), layout)
            module, _, _ = jax_create_model(name, init=False, **kw)
            x = np.random.RandomState(7).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
            logits = np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x)))
            cache[name] = (tree, path, kw, x, logits)
        return cache[name]

    return get


def check_writer(member_files, name):
    """The writer counts only if JAX's own converter gives the tree back."""
    tree, path, *_ = member_files(name)
    assert_trees_equal(jax_convert_keras_h5(path, name), tree, ordered=False)


def check_conversion(member_files, name):
    tree, path, *_ = member_files(name)
    got = convert_keras_h5(path, name)
    assert_trees_equal(got, jax_convert_keras_h5(path, name))
    assert_trees_equal(load_weights(path, name), got)


def check_forward(member_files, name):
    """The port's member built from the file, f32 on the CPU, against the
    JAX forward of the same variables."""
    _, path, kw, x, want = member_files(name)
    port, _ = create_model(name, model_path=path, **kw)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)


@pytest.mark.parametrize("name", MEMBERS[:3])
def test_writer_is_the_inverse_of_the_jax_mapper(member_files, name):
    check_writer(member_files, name)


@pytest.mark.parametrize("name", MEMBERS[:3])
def test_h5_conversion_equals_jax(member_files, name):
    check_conversion(member_files, name)


@pytest.mark.parametrize("name", MEMBERS[:3])
def test_h5_forward_matches_jax(member_files, name):
    check_forward(member_files, name)


def test_h5_dropped_layer_raises_in_the_port(member_files, tmp_path):
    """``map_resnet_rs`` drops a layer it does not know without a word (a
    renamed SE layer here): the JAX factory warns and keeps the random
    init, the port's bridge raises, naming the leaves."""
    tree, _, kw, _, _ = member_files("ResNetRS50")
    weights = resnet_rs_weights(tree, "ResNetRS50")
    weights = {k.replace("c3_block_1_se_reduce", "c3_block_1_se_squeeze"): v
               for k, v in weights.items()}
    path = str(tmp_path / "renamed.h5")
    write_keras_h5(path, weights)
    with pytest.raises(ValueError, match=r"c3_block_1\.se\.se_reduce\.weight: missing"):
        create_model("ResNetRS50", model_path=path, **kw)


# ---------------------------------------------------------------------------
# ConvNeXt from timm-named .pth state dicts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nesting,bare_head", [(None, False), ("state_dict", False),
                                               (None, True), ("model", True)])
def test_convnext_pth_matches_jax(member_files, tmp_path, nesting, bare_head):
    """The smoke's timm writer, validated by the JAX package's converter;
    the port's conversion of the saved file equals it, and the forward
    from it matches JAX's."""
    from chip_smoke import timm_convnext_state

    tree, _, kw, x, want = member_files("convnext_tiny_in22k")
    sd = timm_convnext_state(tree, bare_head=bare_head)
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32 for v in sd.values())
    assert ("head.weight" in sd) == bare_head and sd["stem.0.weight"].shape == (32, 3, 4, 4)
    path = str(tmp_path / "convnext.pth")
    torch.save(sd if nesting is None else {nesting: sd}, path)
    got = convert_torch_weights(path, "convnext_tiny_in22k")
    assert_trees_equal(got, jax_convert_torch(path, "convnext_tiny_in22k"))
    assert_trees_equal(got, tree, ordered=False)
    port, _ = create_model("convnext_tiny_in22k", model_path=path, **kw)
    with torch.inference_mode():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want, atol=MODEL_ATOL)
