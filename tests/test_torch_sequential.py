"""The port's sequential per-member path (``VIPTPU_FUSED=0``) against the JAX
package's, on the CPU in f32: at tta=1 both CLIs write the same CSV byte
for byte on a two-member manifest (the second member two folds), the
port's float64 means by filename agree with its fused path within 1e-5,
``ensemble=False`` gives each member's predictions, and at tta=2 a
multiclass two-fold member's ``predict_model`` is held to JAX's within 1e-5
through the engine's mask seam (one key stream from the seed, stepped on
across the folds, no shard fold-in)."""
import copy
import json

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_slice import NARROW, _member_workspace
from test_torch_tta import jax_tta_masks, mini_manifest, port_cfg
from vip_cup_2022_tpu.infer import engine as jax_engine
from vip_cup_2022_tpu.utils.checkpoint import save_variables
from vip_cup_2022_tpu_torch.infer import engine


def _convnext_tree(name, size, overrides, seed):
    import flax
    import jax

    from test_torch_slice import _perturb
    from vip_cup_2022_tpu.models import create_model as jax_create_model

    _, variables, _ = jax_create_model(name, rng=jax.random.PRNGKey(seed),
                                       input_size=(size, size), **overrides)
    tree = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))
    _perturb(tree["params"], np.random.RandomState(seed))
    return tree


@pytest.fixture(scope="module")
def seq_workspace(tmp_path_factory):
    """Two narrow ConvNeXt members under two registry names, each head
    rescaled so its logits spread; the second gets a second fold (the first
    with its head bias moved)."""
    root, input_csv, names, trees = _member_workspace(
        tmp_path_factory.mktemp("torch_sequential"), "q_", 17,
        [("convnext_tiny_in22k", "convnext_tiny_in22k-200x200", 64, NARROW, _convnext_tree,
          "head_fc"),
         ("convnext_small_in22k", "convnext_small_in22k-224x224", 72, NARROW, _convnext_tree,
          "head_fc")])
    ckpt_dir = root / "ckpts" / "convnext_small_in22k-224x224" / "ckpt"
    tree = copy.deepcopy(trees["convnext_small_in22k-224x224"][2])
    tree["params"]["head_fc"]["bias"] = (tree["params"]["head_fc"]["bias"] + 0.5).astype(
        np.float32)
    save_variables(str(ckpt_dir / "fold1.msgpack"), tree)
    return root, input_csv, names, trees


def test_sequential_cli_csv_equals_jax_byte_for_byte(seq_workspace, monkeypatch):
    from test_torch_gcvit import assert_two_member_csvs_equal

    monkeypatch.setenv("VIPTPU_FUSED", "0")
    assert_two_member_csvs_equal(seq_workspace, monkeypatch, head="head_fc")


def test_sequential_means_equal_fused(seq_workspace, monkeypatch):
    root, input_csv, names, _ = seq_workspace
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    fused = eng.predict_soln_fused(port_cfg(root, input_csv, "fused.csv", 1))
    seq = eng.predict_soln(port_cfg(root, input_csv, "seq.csv", 1))
    per_member = eng.predict_soln(port_cfg(root, input_csv, "never.csv", 1), ensemble=False)
    eng.close()
    assert list(seq["filename"]) == list(fused["filename"]) == sorted(names)
    assert seq["raw"].dtype == np.float64
    np.testing.assert_allclose(seq["raw"], fused["raw"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(seq["logit"], (seq["raw"] > 0.487) * 1.0)
    assert (root / "seq.csv").read_bytes() == (root / "fused.csv").read_bytes()
    assert len(per_member) == 2
    order = np.argsort(per_member[0]["filename"])
    assert list(per_member[0]["filename"]) == names  # the CSV's order
    np.testing.assert_allclose(
        (per_member[0]["logit"] + per_member[1]["logit"])[order] / 2, seq["raw"], atol=1e-12)


def test_sequential_duplicate_filenames_mean_once(seq_workspace, monkeypatch, tmp_path):
    """A filename listed twice gives one row, as pandas' groupby does."""
    root, input_csv, names, _ = seq_workspace
    dup = input_csv.parent / "dup.csv"
    dup.write_text("filename\n" + "".join(f"{n}\n" for n in names + names[:3]))
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    cfg = port_cfg(root, dup, "dup_out.csv", 1)
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    out = eng.predict_soln(cfg)
    cfg.test_csv = str(input_csv)
    once = eng.predict_soln(cfg)
    eng.close()
    assert list(out["filename"]) == sorted(names)
    np.testing.assert_allclose(out["raw"], once["raw"], rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def multiclass_member(tmp_path_factory):
    """A two-fold narrow ConvNeXt with a two-class softmax head at 72."""
    root, input_csv, names = mini_manifest(tmp_path_factory.mktemp("torch_seq_tta"), members=[
        ("convnext_tiny_in22k-72x72", "convnext_tiny_in22k", 72,
         dict(nb_classes=2, classifier_activation="softmax", **NARROW), 2)])
    with open(root / "ckpts" / "ckpts.json") as fh:
        (base, dim, _), = json.load(fh)
    entry = engine.load_manifest(str(root / "ckpts"), str(root / "ckpts" / "ckpts.json"))[0]
    return base, entry[1], tuple(dim), [str(input_csv.parent / n) for n in names]


def test_predict_model_tta_equals_jax(multiclass_member, monkeypatch):
    base, ckpts, dim, paths = multiclass_member
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    want = jax_engine.EnsembleEngine(verbose=0).predict_model(base, ckpts, dim, paths, tta=2)
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    eng.tta_masks = jax_tta_masks
    got = eng.predict_model(base, ckpts, dim, paths, tta=2)
    plain = eng.predict_model(base, ckpts, dim, paths, tta=1)
    eng.close()
    assert got.shape == want.shape == (len(paths), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(plain - got).max() > 1e-4  # the copies matter
