"""The port's test-time augmentation and aggregation against the JAX
package, on the CPU in f32: the augment ops fed the masks JAX's
``apply_augment`` draws from its key (flips and gate exact, gray within
1e-6), the reductions of ``agg`` against numpy's, and the fused ensemble at
``tta=2`` on a two-member mini manifest (a 2-fold member and a multiclass
member at another size): the port's raw probabilities, with the masks of
JAX's per-shard keys put through the engine's mask seam, within 1e-5 of
``predict_soln_fused``'s, and the port's map and fold modes within 1e-6 of
each other."""
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_slice import NARROW, _perturb
from vip_cup_2022_tpu.data.augment import apply_augment as jax_apply_augment
from vip_cup_2022_tpu.infer import engine as jax_engine
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.utils.checkpoint import save_variables
from vip_cup_2022_tpu_torch.core.config import Config
from vip_cup_2022_tpu_torch.data import augment
from vip_cup_2022_tpu_torch.data.augment import TTAMasks
from vip_cup_2022_tpu_torch.infer import engine

N_SHARDS = 8  # the JAX mesh in tests/conftest.py


# ---------------------------------------------------------------------------
# the masks of JAX's draws
# ---------------------------------------------------------------------------
def jax_masks(key, b: int) -> TTAMasks:
    """The per-sample decisions ``apply_augment(key, x)`` takes for a batch
    of ``b``: split into gate / flip / gray keys, the flip key into h and v."""
    k_gate, k_flip, k_gray = jax.random.split(key, 3)
    k_h, k_v = jax.random.split(k_flip)
    u = lambda k: np.asarray(jax.random.uniform(k, (b, 1, 1, 1))).reshape(b)  # noqa: E731
    return TTAMasks(*(torch.from_numpy(m) for m in (
        u(k_gate) <= augment.AUGMENT_PROB, u(k_h) < augment.HFLIP_PROB,
        u(k_v) < augment.VFLIP_PROB, u(k_gray) < augment.GRAY_PROB)))


def jax_tta_masks(seed: int, tta: int, batch: int, fused: bool):
    """A stand-in for ``EnsembleEngine.tta_masks`` that reproduces the JAX
    engine's keys: ``PRNGKey(seed)`` split once a step; on the fused path
    each of the mesh's shards folds its index in and draws for its B / 8
    rows, on the sequential path the whole batch draws from ``sub``."""
    rng = jax.random.PRNGKey(seed)
    shards = N_SHARDS if fused else 1
    while True:
        rng, sub = jax.random.split(rng)
        per = [[] for _ in range(tta)]
        for s in range(shards):
            keys = jax.random.split(jax.random.fold_in(sub, s) if fused else sub, tta)
            for t in range(tta):
                per[t].append(jax_masks(keys[t], batch // shards))
        yield [TTAMasks(*(torch.cat(ms) for ms in zip(*per[t]))) for t in range(tta)]


# ---------------------------------------------------------------------------
# the augment ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,b", [(0, 1), (1, 5), (2, 8), (3, 16), (42, 33)])
def test_apply_augment_with_jax_masks_equals_jax(seed, b):
    key = jax.random.PRNGKey(seed)
    x = np.random.RandomState(seed).uniform(0, 1, (b, 9, 7, 3)).astype(np.float32)
    want = np.asarray(jax_apply_augment(key, jnp.asarray(x)))
    masks = jax_masks(key, b)
    got = augment.apply_augment(torch.from_numpy(x), masks).numpy()
    colour = ~(masks.gate & masks.gray).numpy()  # the rows gray does not touch
    np.testing.assert_array_equal(got[colour], want[colour])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the flips alone, exact everywhere
    flipped = augment.flip(torch.from_numpy(x), masks.hflip, masks.vflip).numpy()
    ref = np.where(masks.hflip.numpy()[:, None, None, None], x[:, :, ::-1], x)
    ref = np.where(masks.vflip.numpy()[:, None, None, None], ref[:, ::-1], ref)
    np.testing.assert_array_equal(flipped, ref)


def test_gray_weights_in_the_image_dtype():
    x = torch.rand((4, 5, 6, 3), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    on = torch.tensor([True, False, True, False])
    got = augment.gray(x, on)
    w = torch.tensor(augment.GRAY_W).to(torch.bfloat16)
    want = (x * w).sum(-1, keepdim=True).expand_as(x)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got[on], want[on], rtol=0, atol=0)
    torch.testing.assert_close(got[~on], x[~on], rtol=0, atol=0)


def test_draw_masks_rates_and_seed():
    m = augment.draw_masks(torch.Generator().manual_seed(7), 20000)
    assert all(t.shape == (20000,) and t.dtype == torch.bool for t in m)
    for mask, p in zip(m, (0.8, 0.5, 0.5, 0.3)):
        assert abs(mask.float().mean().item() - p) < 0.015
    again = augment.draw_masks(torch.Generator().manual_seed(7), 20000)
    assert all(torch.equal(a, b) for a, b in zip(m, again))


# ---------------------------------------------------------------------------
# agg
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mean", "median", "max", "min", "sum", "prod", "std", "var"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_agg_fn_equals_numpy(name, n):
    x = np.random.RandomState(n).uniform(0, 1, (n, 6, 2)).astype(np.float32)
    got = engine._agg_fn(name)(torch.from_numpy(x), 0).numpy()
    np.testing.assert_allclose(got, getattr(np, name)(x, axis=0), rtol=1e-6, atol=1e-7)


def test_agg_fn_unknown_raises():
    with pytest.raises(ValueError, match="unsupported agg 'mode'"):
        engine._agg_fn("mode")


# ---------------------------------------------------------------------------
# the fused ensemble at tta=2
# ---------------------------------------------------------------------------
# (manifest dir, registry name, size, overrides, folds)
MEMBERS = [
    ("convnext_tiny_in22k-200x200", "convnext_tiny_in22k", 64,
     dict(nb_classes=1, classifier_activation="sigmoid", **NARROW), 2),
    ("convnext_small_in22k-200x200", "convnext_small_in22k", 72,
     dict(nb_classes=2, classifier_activation="softmax", **NARROW), 1),
]


def mini_manifest(root, members=MEMBERS, n_images=11, seed=21):
    """JPEGs (one odd-sized), an input CSV and a manifest of ``members``,
    each fold a perturbed JAX init written by the JAX package."""
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(seed)
    names = []
    for i in range(n_images - 1):
        names.append(f"t_{n_images - i:03d}.jpg")
        Image.fromarray(rng.randint(0, 255, (200, 200, 3), dtype=np.uint8)).save(
            img_dir / names[-1], quality=92)
    Image.fromarray(rng.randint(0, 255, (150, 230, 3), dtype=np.uint8)).save(
        img_dir / "odd.jpg", quality=92)
    names.append("odd.jpg")
    input_csv = img_dir / "input.csv"
    input_csv.write_text("filename\n" + "".join(f"{n}\n" for n in names))
    manifest = []
    for m, (base, name, size, overrides, folds) in enumerate(members):
        ckpt_dir = root / "ckpts" / base / "ckpt"
        ckpt_dir.mkdir(parents=True)
        for f in range(folds):
            _, variables, _ = jax_create_model(name, rng=jax.random.PRNGKey(10 * m + f),
                                               input_size=(size, size), **overrides)
            tree = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))
            _perturb(tree["params"], np.random.RandomState(10 * m + f))
            save_variables(str(ckpt_dir / f"fold{f}.msgpack"), tree)
        with open(ckpt_dir / "config.json", "w") as fh:
            json.dump({k: list(v) if isinstance(v, tuple) else v for k, v in overrides.items()},
                      fh)
        manifest.append([base, [size, size], 0])
    with open(root / "ckpts" / "ckpts.json", "w") as fh:
        json.dump(manifest, fh)
    return root, input_csv, names


def port_cfg(root, input_csv, out_name, tta, cfg_cls=Config, load=engine.load_manifest):
    cfg = cfg_cls({})
    cfg.test_csv = str(input_csv)
    cfg.infer_path = str(input_csv.parent)
    cfg.output_csv_path = str(root / out_name)
    cfg.debug, cfg.verbose, cfg.tta, cfg.agg, cfg.seed, cfg.thr = 0, 0, tta, "mean", 42, 0.487
    cfg.ckpt_cfg = load(str(root / "ckpts"), str(root / "ckpts" / "ckpts.json"))
    return cfg


@pytest.fixture(scope="module")
def tta_workspace(tmp_path_factory):
    return mini_manifest(tmp_path_factory.mktemp("torch_tta"))


def test_fused_tta_equals_jax_map_and_fold(tta_workspace, monkeypatch):
    """tta=2 through both engines' fused paths, the port's masks from JAX's
    per-shard keys: the raw means within 1e-5 of JAX's; the port's fold mode
    (one forward at 2B) within 1e-6 of its map mode."""
    from vip_cup_2022_tpu.core.config import Config as JaxConfig

    root, input_csv, names = tta_workspace
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "16")  # two rows a shard of the 8-device mesh
    monkeypatch.delenv("VIPTPU_TTA_MODE", raising=False)
    want = jax_engine.EnsembleEngine(verbose=0).predict_soln_fused(
        port_cfg(root, input_csv, "jax.csv", 2, JaxConfig, jax_engine.load_manifest))
    got = {}
    for mode in ("map", "fold"):
        monkeypatch.setenv("VIPTPU_TTA_MODE", mode)
        eng = engine.EnsembleEngine(device="cpu", verbose=0)
        eng.tta_masks = jax_tta_masks
        got[mode] = eng.predict_soln_fused(port_cfg(root, input_csv, f"{mode}.csv", 2))
        eng.close()
    assert list(got["map"]["filename"]) == list(want["filename"]) == sorted(names)
    np.testing.assert_allclose(got["map"]["raw"], want["raw"].values, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["fold"]["raw"], got["map"]["raw"], rtol=0, atol=1e-6)
    # the copies matter: tta=2 moves the means off tta=1's
    monkeypatch.delenv("VIPTPU_TTA_MODE")
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    plain = eng.predict_soln_fused(port_cfg(root, input_csv, "plain.csv", 1))
    eng.close()
    assert np.abs(plain["raw"] - got["map"]["raw"]).max() > 1e-4


def test_default_masks_are_seeded(tta_workspace, monkeypatch):
    """Without a replaced seam the masks come from cfg.seed's generator:
    two runs give the same means, and map equals fold."""
    root, input_csv, _ = tta_workspace
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    runs = []
    for mode in ("map", "map", "fold"):
        monkeypatch.setenv("VIPTPU_TTA_MODE", mode)
        eng = engine.EnsembleEngine(device="cpu", verbose=0)
        runs.append(eng.predict_soln_fused(port_cfg(root, input_csv, "seeded.csv", 2))["raw"])
        eng.close()
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_allclose(runs[2], runs[0], rtol=0, atol=1e-6)


def test_bad_tta_mode_raises(monkeypatch):
    monkeypatch.setenv("VIPTPU_TTA_MODE", "scan")
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    with pytest.raises(ValueError, match="VIPTPU_TTA_MODE='scan' not in map|fold"):
        eng.build_fused_ensemble([], tta=2)
    eng.close()


def test_tta_forward_needs_masks(monkeypatch):
    monkeypatch.delenv("VIPTPU_TTA_MODE", raising=False)
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    fwd = eng.build_fused_ensemble([], tta=2)
    with pytest.raises(ValueError, match="one TTAMasks a replica"):
        fwd(np.zeros((2, 200, 200, 3), np.uint8))
    eng.close()
