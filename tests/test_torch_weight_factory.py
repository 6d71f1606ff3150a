"""The port's model factory against the JAX package's: ``load_weights``'
dispatch on each checkpoint format, ``create_model(model_path=...,
pretrained=...)``, ``transfer_weights``' first-conv adaptation (1 and 5
input channels), the classifier swap and ``on_mismatch``, and
``create_preprocessing``; then the CLI on a narrow two-member ``.h5``
manifest: ``main_torch.py`` and ``main.py`` write the same CSV byte for
byte, and the same as from the ``.msgpack`` manifest of the same weights."""
import functools
import json
import shutil
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_keras_h5 import assert_trees_equal, write_keras_h5
from test_torch_gcvit import _cfg
from test_torch_slice import NARROW, _member_workspace
from test_torch_weight_members import WRITERS, _convnext_perturb, from_port
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.models import factory as jax_factory
from vip_cup_2022_tpu.utils.checkpoint import save_variables
from vip_cup_2022_tpu_torch.models import (create_model, create_preprocessing, load_weights,
                                           transfer_weights)
from vip_cup_2022_tpu_torch.infer import engine
from vip_cup_2022_tpu_torch.weights.from_jax import flax_to_torch

NAME = "convnext_tiny_in22k"
KW = dict(input_size=(32, 32), nb_classes=3, classifier_activation=None, **NARROW)


@pytest.fixture(scope="module")
def convnext_tree():
    return from_port(_convnext_perturb)(NAME, 32, {k: v for k, v in KW.items()
                                                   if k != "input_size"}, 3)


def jax_shapes(**kw):
    """The JAX model's variables as shapes and dtypes (``jax.eval_shape``
    of its init: a trace, no compile), a destination for
    ``transfer_weights`` where every leaf it keeps is left uncompared."""
    module, _, cfg = jax_create_model(NAME, init=False, **kw)
    return jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, *cfg.input_size, cfg.in_channels)))


def _state_equals(module, flat):
    """The module's state equals ``flat`` (state_dict key -> numpy), bit for bit."""
    state = module.state_dict()
    assert sorted(state) == sorted(flat)
    for k, v in flat.items():
        got = state[k].numpy()
        assert got.shape == v.shape and got.tobytes() == v.astype(got.dtype).tobytes(), k


# ---------------------------------------------------------------------------
# load_weights: one route per format
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["h5", "hdf5", "pth", "pt", "bin", "msgpack", "msgpack_dir",
                                 "saved_model"])
def test_load_weights_dispatch_equals_jax(convnext_tree, tmp_path, monkeypatch, fmt):
    from chip_smoke import timm_convnext_state

    if fmt in ("h5", "hdf5"):
        path = str(tmp_path / f"fold0.{fmt}")
        write_keras_h5(path, WRITERS["convnext"](convnext_tree, NAME), "model")
    elif fmt in ("pth", "pt", "bin"):
        path = str(tmp_path / f"fold0.{fmt}")
        torch.save({"state_dict": timm_convnext_state(convnext_tree)}, path)
    elif fmt == "msgpack":
        path = str(tmp_path / "fold0.msgpack")
        save_variables(path, convnext_tree)
    elif fmt == "msgpack_dir":
        path = str(tmp_path)
        save_variables(str(tmp_path / "variables.msgpack"), convnext_tree)
    else:  # a SavedModel without TensorFlow: the SavedModel route, its clear error
        (tmp_path / "saved_model.pb").write_bytes(b"")
        monkeypatch.setitem(sys.modules, "tensorflow", None)
        for fn in (load_weights, jax_factory.load_weights):
            for p in (str(tmp_path), str(tmp_path / "saved_model.pb")):
                with pytest.raises(NotImplementedError, match="requires TensorFlow"):
                    fn(p, NAME)
        return
    got = load_weights(path, NAME)
    want = jax_factory.load_weights(path, NAME)
    assert_trees_equal(got, want, ordered=False)
    assert_trees_equal(got, convnext_tree, ordered=False)


def test_create_model_from_a_checkpoint(convnext_tree, tmp_path):
    """``model_path`` loads through the bridge (the port's module then holds
    exactly the tree); ``pretrained`` without a path raises JAX's no-egress
    error; a family without a mapper raises."""
    path = str(tmp_path / "fold0.h5")
    write_keras_h5(path, WRITERS["convnext"](convnext_tree, NAME))
    port, cfg = create_model(NAME, model_path=path, **KW)
    _state_equals(port, flax_to_torch(convnext_tree))
    assert not port.training and cfg.nb_classes == 3
    messages = []
    for fn in (create_model, jax_create_model):
        with pytest.raises(NotImplementedError, match="no-egress") as err:
            fn(NAME, pretrained=True, **KW)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    with pytest.raises(KeyError, match="no weight mapper registered"):
        load_weights(path, "UnknownNet")


# ---------------------------------------------------------------------------
# transfer_weights: first conv, classifier swap, on_mismatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("in_channels", [1, 5])
def test_first_conv_adaptation_equals_jax(convnext_tree, tmp_path, in_channels):
    """A 3-channel checkpoint into a 1- or 5-channel model: the stem kernel
    summed, or tiled and rescaled, as the JAX factory does, bit for bit;
    every other leaf copied."""
    kw = dict(KW, in_channels=in_channels)
    jax_out = jax_factory.transfer_weights(convnext_tree, jax_shapes(**kw), on_mismatch="raise")
    stem = np.asarray(jax_out["params"]["stem_conv"]["kernel"])
    assert stem.shape == (4, 4, in_channels, 32)
    want = flax_to_torch(jax_out)
    want["stem_conv.weight"] = np.transpose(stem, (3, 2, 0, 1))  # HWIO -> OIHW
    port, _ = create_model(NAME, **kw)
    _state_equals(transfer_weights(convnext_tree, port), want)
    path = str(tmp_path / "fold0.msgpack")
    save_variables(path, convnext_tree)
    _state_equals(create_model(NAME, model_path=path, **kw)[0], want)
    # the adapted model's own checkpoint loads back strictly, a 1-channel
    # stem (kh, kw, 1, O) included
    save_variables(path, jax_out)
    _state_equals(transfer_weights(load_weights(path), create_model(NAME, **kw)[0], strict=True),
                  want)
    with pytest.raises(ValueError, match="stem_conv.weight: checkpoint"):
        transfer_weights(convnext_tree, create_model(NAME, **kw)[0], adapt_first_conv=False)


def test_classifier_swap(convnext_tree):
    """A 3-class checkpoint into a 1-output member: the head keeps the
    model's init (JAX: its own init), every other leaf is the checkpoint's;
    with ``strict`` (a serving fold) the head must match."""
    kw = dict(KW, nb_classes=1)
    out = jax_factory.transfer_weights(convnext_tree, jax_shapes(**kw), on_mismatch="raise")
    assert out["params"]["head_fc"]["kernel"].shape == (512, 1)  # kept: shapes only here
    want = flax_to_torch({"params": {k: v for k, v in out["params"].items() if k != "head_fc"}})
    port, _ = create_model(NAME, **kw)
    init = {k: v.clone() for k, v in port.state_dict().items()}
    transfer_weights(convnext_tree, port)
    state = port.state_dict()
    for k in state:
        if k.startswith("head_fc."):
            assert torch.equal(state[k], init[k]) and state[k].shape[0] == 1
        else:
            assert state[k].numpy().tobytes() == want[k].tobytes(), k
    with pytest.raises(ValueError, match="head_fc.weight: checkpoint"):
        transfer_weights(convnext_tree, create_model(NAME, **kw)[0], strict=True)


def _partial(tree):
    """The tree with one block's MLP missing and one LN's beta the wrong
    size: leaves the transfer cannot cover."""
    src = jax.tree_util.tree_map(np.asarray, tree)
    del src["params"]["stages_1_blocks_0"]["mlp_fc1"]
    src["params"]["stages_2_downsample_norm"]["beta"] = np.zeros(7, np.float32)
    return src


@functools.lru_cache(maxsize=1)
def jax_destination():
    """A JAX model's init, the destination of the partial transfers."""
    return jax_create_model(NAME, rng=jax.random.PRNGKey(9), **KW)[1]


@pytest.mark.parametrize("mode", ["warn", "silent", "raise", "default"])
def test_on_mismatch_equals_jax(convnext_tree, mode):
    """The port's module holding the JAX destination's variables, then a
    partial checkpoint: ``warn`` and ``silent`` keep the uncovered leaves
    at the destination's values, as the JAX factory does (``warn`` with a
    warning naming them); ``raise`` raises, and so does the port's default
    (the JAX factory's default warns)."""
    src, dst = _partial(convnext_tree), jax_destination()
    port, _ = create_model(NAME, **KW)
    transfer_weights(dst, port, strict=True)
    if mode in ("raise", "default"):
        with pytest.raises(ValueError, match="shape-mismatched"):
            jax_factory.transfer_weights(src, dst, on_mismatch="raise")
        kw = {} if mode == "default" else dict(on_mismatch="raise")
        with pytest.raises(ValueError, match=r"stages_1_blocks_0\.mlp_fc1\.weight: missing"):
            transfer_weights(src, port, **kw)
        return
    want = flax_to_torch(jax_factory.transfer_weights(src, dst, on_mismatch=mode))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        transfer_weights(src, port, on_mismatch=mode)
    messages = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    if mode == "warn":
        assert len(messages) == 1 and "3 uncovered" in messages[0]
        assert "stages_2_downsample_norm.bias: checkpoint (7,)" in messages[0]
    else:
        assert not messages
    _state_equals(port, want)


def test_on_mismatch_rejects_other_modes(convnext_tree):
    port, _ = create_model(NAME, **KW)
    with pytest.raises(ValueError, match="warn\\|raise\\|silent"):
        transfer_weights(convnext_tree, port, on_mismatch="ignore")


@pytest.mark.parametrize("name", ["ResNetRS50", "GCViTTiny", "convnext_tiny_in22k",
                                  "EfficientNetV2T", "ECA_NFNetL0"])
def test_create_preprocessing_equals_jax(name):
    from vip_cup_2022_tpu.models.registry import model_entry as jax_model_entry
    from vip_cup_2022_tpu_torch.models.registry import model_entry

    x = np.random.RandomState(5).uniform(0, 1, (2, 9, 7, 3)).astype(np.float32)
    got = create_preprocessing(model_entry(name)[1])(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_factory.create_preprocessing(jax_model_entry(name)[1])(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the CLI on a .h5 manifest
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def h5_workspace(tmp_path_factory):
    """Narrow ConvNeXt and EfficientNetV2T (the tfimm and kecam layouts),
    each with a ``.msgpack`` fold."""
    import test_torch_efficientnet as eff_tests

    return _member_workspace(
        tmp_path_factory.mktemp("torch_h5_e2e"), "h_", 16,
        [(NAME, "convnext_tiny_in22k-200x200", 64, NARROW, from_port(_convnext_perturb),
          "head_fc"),
         ("EfficientNetV2T", "EfficientNetV2T-200x200", 64, eff_tests.NARROW["EfficientNetV2T"],
          from_port(eff_tests._tree), "predictions")])


def test_h5_manifest_cli_csv_equals_jax_and_msgpack(h5_workspace, monkeypatch):
    """The threshold put between the images (a shift of the first member's
    head bias, as ``test_torch_gcvit.assert_two_member_csvs_equal`` puts
    it), the folds written as ``.msgpack`` and as ``.h5`` (one member per
    layout) in two manifests: ``main.py`` and ``main_torch.py`` on the
    ``.h5`` manifest and ``main_torch.py`` on the ``.msgpack`` one write the
    same CSV, byte for byte, with both decisions in it."""
    root, input_csv, names, members = h5_workspace
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    p1, p2 = (eng.predict_soln_fused(_cfg(root, input_csv, f"m{i}.csv", [i]))["raw"]
              for i in range(2))
    eng.close()
    z1 = np.log(p1 / (1 - p1))
    best, shift = 0.0, None
    for d in np.linspace(-8, 8, 3201):
        r = (1 / (1 + np.exp(-(z1 + d))) + p2) / 2 - 0.487
        if (r > 0).any() and (r < 0).any() and np.abs(r).min() > best:
            best, shift = np.abs(r).min(), d
    assert shift is not None and best > 1e-4
    head = members[next(iter(members))][2]["params"]["head_fc"]
    head["bias"] = (head["bias"] + shift).astype(np.float32)

    h5_root = root / "ckpts_h5"
    for (base, (_, _, tree)), (name, family, layout) in zip(
            members.items(), [(NAME, "convnext", "model"), ("EfficientNetV2T", "kecam", "weights")]):
        save_variables(str(root / "ckpts" / base / "ckpt" / "fold0.msgpack"), tree)
        ckpt = h5_root / base / "ckpt"
        ckpt.mkdir(parents=True)
        shutil.copy(root / "ckpts" / base / "ckpt" / "config.json", ckpt / "config.json")
        write_keras_h5(str(ckpt / "fold0.h5"), WRITERS[family](tree, name), layout)
    shutil.copy(root / "ckpts" / "ckpts.json", h5_root / "ckpts.json")
    assert json.loads((h5_root / "ckpts.json").read_text())[0][0] == "convnext_tiny_in22k-200x200"

    monkeypatch.setenv("VIPTPU_VERBOSE", "0")
    monkeypatch.setenv("VIPTPU_NO_JIT_CACHE", "1")
    import main as jax_cli
    import main_torch

    jax_h5, torch_h5, torch_msgpack = root / "jax_h5.csv", root / "torch_h5.csv", root / "t.csv"
    monkeypatch.setenv("VIPTPU_CKPT_DIR", str(h5_root))
    jax_cli.main(["main.py", str(input_csv), str(jax_h5)])
    monkeypatch.setenv("VIPTPU_PLATFORM", "cpu")
    main_torch.main(["main_torch.py", str(input_csv), str(torch_h5)])
    monkeypatch.setenv("VIPTPU_CKPT_DIR", str(root / "ckpts"))
    main_torch.main(["main_torch.py", str(input_csv), str(torch_msgpack)])
    assert torch_h5.read_bytes() == jax_h5.read_bytes() == torch_msgpack.read_bytes()
    lines = torch_h5.read_text().splitlines()
    assert [ln.split(",")[0] for ln in lines[1:]] == sorted(names)
    assert {ln.split(",")[1] for ln in lines[1:]} == {"0.0", "1.0"}
