"""The port's conv-BN fold (``utils/surgery.py``, ``VIPTPU_FUSE_BN``) against
the JAX package's, on the CPU in f32: on trees of ResNetRS50 (full width,
its widths are its depth's), narrow ResNest50, narrow EfficientNetV2T
(torch mode) and narrow EfficientNetV1B4 (TF mode, BN eps 1e-3) the port
finds JAX's pairs and, with each BN's eps, returns JAX's arrays exactly;
its folded forward (the pooled f32 features, O(1)) equals its unfused
forward within 2e-5 of max(1, max|ref|) on each, V1B4 among them, where the
JAX engine's one default eps would not; a random-init member folds the values it holds to the same
arrays; the ``VIPTPU_FUSE_BN`` forms select as in JAX; int8 weights come
from the folded values; and the CLI with the knob writes the unfolded CSV.
The full-width pair counts the on-card smoke expects are JAX's discovery on
the seven members' trees."""
import functools
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
import test_torch_efficientnet as eff_tests
from test_torch_resnest import NARROW as NARROW_RESNEST
from test_torch_tta import port_cfg
from vip_cup_2022_tpu.infer.engine import EnsembleEngine as JaxEngine
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.utils import surgery as jax_surgery
from vip_cup_2022_tpu_torch.infer import engine
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.utils import surgery
from vip_cup_2022_tpu_torch.weights.from_jax import flax_to_torch
from vip_cup_2022_tpu_torch.weights.to_flax import torch_to_flax

# name -> (narrow overrides, input side)
MEMBERS = {
    "ResNetRS50": ({}, 32),
    "ResNest50": (NARROW_RESNEST, 64),
    "EfficientNetV2T": (eff_tests.NARROW["EfficientNetV2T"], 64),
    "EfficientNetV1B4": (eff_tests.NARROW["EfficientNetV1B4"], 57),
}
FOLD_ATOL = 2e-5


def _shapes(name, size, **kw):
    module, _, _ = jax_create_model(name, init=False, input_size=(size, size), **kw)
    return flax.core.unfreeze(jax.eval_shape(
        module.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)))


def _random_leaves(tree, rng):
    """Numpy values for an abstract tree: kernels ~ N(0, 1 / fan_in), BN
    scales and variances around 1, shifts, means and biases around 0."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_leaves(v, rng)
            continue
        shape = tuple(v.shape)
        if k == "kernel":
            val = rng.standard_normal(shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif k in ("gamma", "moving_variance"):
            val = rng.uniform(0.5, 1.5, shape)
        elif k in ("beta", "bias", "moving_mean"):
            val = rng.uniform(-0.2, 0.2, shape)
        else:
            val = rng.uniform(0.5, 1.5, shape)
        out[k] = val.astype(np.float32)
    return out


def _kw(name):
    return dict(MEMBERS[name][0], nb_classes=0)


@functools.lru_cache(maxsize=None)
def _tree(name):
    return _random_leaves(_shapes(name, MEMBERS[name][1], **_kw(name)), np.random.RandomState(3))


def _port(name, tree):
    port, _ = create_model(name, input_size=(MEMBERS[name][1],) * 2, **_kw(name))
    return transfer_weights(tree, port, strict=True)


def _features(port, name):
    side = MEMBERS[name][1]
    x = np.random.RandomState(5).uniform(0, 1, (2, side, side, 3)).astype(np.float32)
    with torch.inference_mode():
        return port(torch.from_numpy(x)).numpy()


def _flat(tree):
    return dict(jax_surgery.flatten_dict(tree))


@pytest.mark.parametrize("name", list(MEMBERS))
def test_pairs_and_folded_arrays_equal_jax(name):
    tree = _tree(name)
    port = _port(name, tree)
    eps = surgery.bn_eps(port)
    assert len(set(eps.values())) == 1  # one eps a member: JAX's fold can be asked for it
    want_pairs = jax_surgery.discover_conv_bn_pairs(tree)
    assert surgery.discover_conv_bn_pairs(tree) == want_pairs and want_pairs
    assert surgery.discover_conv_bn_pairs(torch_to_flax(port)) == want_pairs
    got, pairs = surgery.fuse_all_conv_bn(tree, eps)
    want, _ = jax_surgery.fuse_all_conv_bn(tree, eps=next(iter(eps.values())))
    assert pairs == want_pairs
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=str(key))


@pytest.mark.parametrize("name", list(MEMBERS))
def test_folded_forward_equals_unfused(name):
    tree = _tree(name)
    port = _port(name, tree)
    ref = _features(port, name)
    folded, _ = surgery.fuse_all_conv_bn(tree, surgery.bn_eps(port))
    got = _features(_port(name, folded), name)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FOLD_ATOL * max(1.0, np.abs(ref).max()))
    if name == "EfficientNetV1B4":
        # the JAX engine's fold, its default eps 1e-5 against V1B4's 1e-3,
        # moves the result: the divergence the port does not copy
        jax_folded, _ = jax_surgery.fuse_all_conv_bn(tree)
        off = _features(_port(name, jax.tree_util.tree_map(np.asarray, jax_folded)), name)
        assert np.abs(off - ref).max() > 10 * FOLD_ATOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", list(MEMBERS))
def test_random_init_member_folds_the_values_it_holds(name):
    """The engine's route for a member without checkpoints: the module's own
    values, folded in place, are the tree route's."""
    tree = _tree(name)
    held = _port(name, tree)
    engine.EnsembleEngine(device="cpu", verbose=0)._fuse_bn_module(held, name)
    folded, _ = surgery.fuse_all_conv_bn(tree, surgery.bn_eps(held))
    want = _port(name, folded).state_dict()
    for key, value in held.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)


# the seven members of ckpts/ckpts.json at full width: JAX's pairs, which
# chip_smoke.py holds the engine's folds to on the card
@pytest.mark.parametrize("name,size", [("convnext_tiny_in22k", 200), ("ResNest50", 200),
                                       ("GCViTTiny", 224), ("EfficientNetV2T", 200),
                                       ("EfficientNetV1B4", 224), ("ECA_NFNetL0", 200),
                                       ("ResNetRS50", 200)])
def test_full_width_pair_counts_are_the_smokes(name, size):
    import chip_smoke

    shapes = _shapes(name, size)
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    pairs = jax_surgery.discover_conv_bn_pairs(zeros)
    assert surgery.discover_conv_bn_pairs(zeros) == pairs
    assert chip_smoke.FUSE_BN_PAIRS[name] == len(pairs)


@pytest.mark.parametrize("env", ["", "1", "all", "TRUE", "ResNest50", "EfficientNetV1B4, ResNest50",
                                 "ResNetRS50,"])
@pytest.mark.parametrize("name", ["ResNest50", "EfficientNetV1B4", "ResNetRS50"])
def test_fuse_bn_env_forms_equal_jax(monkeypatch, env, name):
    monkeypatch.setenv("VIPTPU_FUSE_BN", env)
    assert engine.EnsembleEngine._fuse_bn_member(name) == JaxEngine._fuse_bn_member(name)


@pytest.fixture(scope="module")
def fold_workspace(tmp_path_factory):
    """JPEGs, a narrow ResNest50 checkpoint (perturbed JAX init, sigmoid
    head) and a random-init full-width EfficientNetV1B4 at 40 px."""
    from test_torch_tta import mini_manifest

    root, input_csv, names = mini_manifest(tmp_path_factory.mktemp("torch_fuse_bn"), members=[
        ("ResNest50-200x200", "ResNest50", 64,
         dict(nb_classes=1, classifier_activation="sigmoid", **NARROW_RESNEST), 1)], n_images=9)
    manifest = root / "ckpts" / "ckpts.json"
    manifest.write_text(json.dumps(json.loads(manifest.read_text())
                                   + [["EfficientNetV1B4-224x224", [40, 40], 0]]))
    return root, input_csv, names


def test_cli_fuse_bn_writes_the_unfolded_csv(fold_workspace, monkeypatch):
    """``VIPTPU_FUSE_BN=all`` (a checkpoint member and a random-init one) and
    a name list: the CSV of the unfolded run, raw means within 2e-5."""
    import main_torch

    root, input_csv, names = fold_workspace
    for k, v in dict(VIPTPU_PLATFORM="cpu", VIPTPU_CKPT_DIR=str(root / "ckpts"),
                     VIPTPU_ALLOW_RANDOM_INIT="1", VIPTPU_MAX_BATCH="8",
                     VIPTPU_VERBOSE="0").items():
        monkeypatch.setenv(k, v)
    runs = {}
    for env in ("", "all", "EfficientNetV1B4"):
        monkeypatch.setenv("VIPTPU_FUSE_BN", env)
        out = root / f"fold_{env or 'off'}.csv"
        runs[env] = (main_torch.main(["main_torch.py", str(input_csv), str(out)]),
                     out.read_bytes())
    base, base_csv = runs[""]
    assert list(base["filename"]) == sorted(names)
    for env in ("all", "EfficientNetV1B4"):
        result, csv_bytes = runs[env]
        assert csv_bytes == base_csv
        np.testing.assert_allclose(result["raw"], base["raw"], rtol=0, atol=FOLD_ATOL)


def test_int8_quantizes_the_folded_values(fold_workspace, monkeypatch):
    """With ``VIPTPU_INT8`` too, the f32 source of the int8 weights is the
    folded tree, and calibration runs on the folded fold 0."""
    root, input_csv, _ = fold_workspace
    monkeypatch.setenv("VIPTPU_FUSE_BN", "ResNest50")
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    cfg = port_cfg(root, input_csv, "int8.csv", 1,
                   load=lambda *a: engine.load_manifest(*a, allow_missing=True))
    cfg.ckpt_cfg = cfg.ckpt_cfg[:1]
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    members, f32_weights = eng.load_members(cfg.ckpt_cfg, keep_f32=[True])
    folds, f32 = members[0][0], f32_weights[0][0]
    tree = engine.load_weights(cfg.ckpt_cfg[0][1][0])
    folded, pairs = surgery.fuse_all_conv_bn(tree, surgery.bn_eps(folds[0]))
    want = flax_to_torch(folded)
    assert f32.keys() == want.keys() and pairs
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(f32[key]), value, err_msg=key)
    conv = ".".join(pairs[0][0]) + ".weight"
    assert not np.array_equal(want[conv], flax_to_torch(tree)[conv])
    np.testing.assert_array_equal(folds[0].state_dict()[conv].numpy(), want[conv])
    monkeypatch.setenv("VIPTPU_INT8", "ResNest50")
    out = eng.predict_soln_fused(cfg)
    eng.close()
    assert np.isfinite(out["raw"]).all()
