"""The port's training data path against the JAX package's, on the CPU:
``utils/files.py``, ``data/train_pipeline.py`` (the crop, resize and
erasing functions, ``TrainLoader``, ``EvalLoader``, the custom-JSON
loaders), ``data/pipeline.py``'s ``BatchLoader`` / ``build_dataset``,
``data/tfds.py`` (``init_dataset``'s JSON route, its TFDS route on
``tests/test_train.py``'s stub of ``tensorflow_datasets``, the batch
post-processing), ``train/history.py``, ``train/token_label.py``, and the
slice as a whole: ``tests/test_torch_train_fit.py``'s tiny model fitted
two epochs from a custom-JSON dataset of JPEGs on disk through the port's
loaders and trainer and through the JAX package's, dropout 0.

Loaders: the same labels, the same ``RandomState`` state after each batch
and the same crop boxes; the same pixels before the uint8 cast and the same
bytes after it (the port's resize sums the matrices' non-zero taps in the
order JAX's ``np.einsum`` accumulates). The fit's history within 1e-4
relative.
"""
import json
import os
import sys
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_train_fit import JaxTiny, _port
from vip_cup_2022_tpu.data import pipeline as jax_pipeline
from vip_cup_2022_tpu.data import tfds as jax_tfds
from vip_cup_2022_tpu.data import train_pipeline as J
from vip_cup_2022_tpu.parallel.mesh import get_mesh
from vip_cup_2022_tpu.train import TrainConfig as JaxTrainConfig
from vip_cup_2022_tpu.train import Trainer as JaxTrainer
from vip_cup_2022_tpu.train import history as jax_history
from vip_cup_2022_tpu.train import token_label as jax_token_label
from vip_cup_2022_tpu.utils import files as jax_files
from vip_cup_2022_tpu_torch.data import pipeline
from vip_cup_2022_tpu_torch.data import tfds
from vip_cup_2022_tpu_torch.data import train_pipeline as P
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer, history, token_label
from vip_cup_2022_tpu_torch.utils import files

CLASSES = 3


def assert_bytes_equal(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def assert_same_state(a: np.random.RandomState, b: np.random.RandomState) -> None:
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and np.array_equal(sa[1], sb[1]) and sa[2:] == sb[2:]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """JPEGs of sides drawn in 40-72, not square, and their custom JSON:
    12 training images and 5 validation images of three classes."""
    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.RandomState(0)
    items = {"train": [], "validation": [], "info": {"num_classes": CLASSES}}
    for split, n in (("train", 12), ("validation", 5)):
        for i in range(n):
            h, w = rng.randint(40, 73, 2)
            img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
            path = str(root / f"{split}{i}.jpg")
            cv2.imwrite(path, img, [int(cv2.IMWRITE_JPEG_QUALITY), 90])
            items[split].append({"image": path, "label": int(i % CLASSES)})
    path = str(root / "data.json")
    with open(path, "w") as fh:
        json.dump(items, fh)
    return path, items


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def test_collect_files_equals_jax(tmp_path):
    for rel in ("a/x.tfrecord", "a/b/y.tfrec", "a/b/z.txt", "c/w.tfrecord", "v.tfrec"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("")
    for arg in (str(tmp_path), [str(tmp_path / "a"), str(tmp_path / "v.tfrec")],
                str(tmp_path / "c" / "w.tfrecord"), str(tmp_path / "none"), None):
        assert files.collect_tfrecord_files(arg) == jax_files.collect_tfrecord_files(arg)
    assert files.collect_files_with_suffix(str(tmp_path), ".txt") == [str(tmp_path / "a/b/z.txt")]
    assert files.collect_files_with_suffix("s3://bucket/k.tfrec", ".tfrec") == [
        "s3://bucket/k.tfrec"]
    for mod in (files, jax_files):  # no boto3 here: listing a bucket raises
        with pytest.raises(NotImplementedError, match="boto3"):
            mod.collect_tfrecord_files("s3://bucket/prefix")


# ---------------------------------------------------------------------------
# the crop, resize and erasing functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_crop_resize_and_erasing_match_jax(seed):
    img = np.random.RandomState(seed).randint(0, 256, (57 + seed, 83 - seed, 3), np.uint8)
    a, b = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(3):
        assert P.random_crop_fraction(a, (57, 83)) == J.random_crop_fraction(b, (57, 83))
        got = P.random_crop_and_resize_image(a, img, (48, 40), scale=(0.08, 1.0))
        want = J.random_crop_and_resize_image(b, img, (48, 40), scale=(0.08, 1.0))
        assert_same_state(a, b)
        np.testing.assert_array_equal(got, want)
        got_e = P.random_erasing_per_pixel(a, got, probability=0.7)
        want_e = J.random_erasing_per_pixel(b, got, probability=0.7)
        assert_same_state(a, b)
        np.testing.assert_array_equal(got_e, want_e)
    for crop, method in ((0.95, "bilinear"), (0.0, "bicubic"), (1.0, "nearest")):
        np.testing.assert_array_equal(P.central_crop_resize(img, (32, 36), crop, method),
                                      J.central_crop_resize(img, (32, 36), crop, method))


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(random_crop_min=0.08, random_erasing_prob=0.5, seed=3),
                                dict(magnitude=-1.0, random_erasing_prob=0.25, seed=4,
                                     drop_remainder=False),
                                dict(random_crop_min=0.5, resize_method="bicubic")])
def test_train_loader_matches_jax(dataset, kw):
    """Two epochs: per batch the labels, the generator's state and the
    bytes."""
    path, items = dataset
    paths = [i["image"] for i in items["train"]]
    labels = [i["label"] for i in items["train"]]
    got_l = P.TrainLoader(paths, labels, CLASSES, 5, (48, 40), num_threads=3, **kw)
    want_l = J.TrainLoader(paths, labels, CLASSES, 5, (48, 40), num_threads=3, **kw)
    assert len(got_l) == len(want_l)
    n = 0
    for _ in range(2):
        for (gx, gy), (wx, wy) in zip(got_l, want_l):
            assert gx.dtype == np.uint8 and gy.dtype == np.float32
            np.testing.assert_array_equal(gy, wy)
            assert_same_state(got_l.rng, want_l.rng)
            assert_bytes_equal(gx, wx)
            n += 1
    assert n == 2 * len(want_l)
    got_l.close()


def test_eval_loader_and_custom_json_match_jax(dataset, tmp_path):
    path, items = dataset
    got_t, got_e, nc = P.loaders_from_custom_json(path, batch_size=2, target_shape=(40, 44),
                                                  random_erasing_prob=0.5)
    want_t, want_e, want_nc = J.loaders_from_custom_json(path, batch_size=2,
                                                         target_shape=(40, 44),
                                                         random_erasing_prob=0.5)
    assert nc == want_nc == CLASSES and len(got_e) == 3
    batches = list(zip(got_e, want_e))
    assert len(batches) == 3 and batches[-1][0][0].shape == (1, 40, 44, 3)
    for (gx, gy), (wx, wy) in batches:
        np.testing.assert_array_equal(gy, wy)
        assert_bytes_equal(gx, wx)
    (gx, gy), (wx, wy) = next(iter(got_t)), next(iter(want_t))
    np.testing.assert_array_equal(gy, wy)
    assert_bytes_equal(gx, wx)
    # a "test" split instead of "validation"
    with open(path) as fh:
        data = json.load(fh)
    data["test"] = data.pop("validation")
    other = str(tmp_path / "test_split.json")
    with open(other, "w") as fh:
        json.dump(data, fh)
    for with_info in (False, True):
        assert (P.recognition_dataset_from_custom_json(other, with_info)
                == J.recognition_dataset_from_custom_json(other, with_info))


def test_batch_loader_and_build_dataset_equal_jax(dataset):
    """Off-size images unified by the host bicubic, the last batch padded
    (or dropped), the shuffled order and labels: byte for byte."""
    _, items = dataset
    paths = [i["image"] for i in items["train"]]
    labels = [i["label"] for i in items["train"]]
    for kw in (dict(), dict(shuffle=1, seed=5), dict(shuffle=1, drop_remainder=True)):
        got, got_y = pipeline.build_dataset(paths, labels, batch_size=5, img_size=(48, 52),
                                            num_threads=2, **kw)
        want, want_y = jax_pipeline.build_dataset(paths, labels, batch_size=5,
                                                  img_size=(48, 52), num_threads=2, **kw)
        np.testing.assert_array_equal(got_y, want_y)
        assert len(got) == len(want)
        pairs = list(zip(got, want))
        assert len(pairs) == len(want)
        for (gx, gn), (wx, wn) in pairs:
            assert gn == wn
            np.testing.assert_array_equal(gx, wx)
        got.close()
    assert isinstance(pipeline.build_dataset(paths), pipeline.BatchLoader)


# ---------------------------------------------------------------------------
# init_dataset
# ---------------------------------------------------------------------------


def test_init_dataset_json_route_matches_jax(dataset):
    path, _ = dataset
    assert (tfds.init_dataset(path, batch_size=5, info_only=True)
            == jax_tfds.init_dataset(path, batch_size=5, info_only=True) == (12, CLASSES, 3, 3))
    got = tfds.init_dataset(path, input_shape=(40, 40), batch_size=5)
    want = jax_tfds.init_dataset(path, input_shape=(40, 40), batch_size=5)
    assert got[2:] == want[2:]
    for g_fn, w_fn in zip(got[:2], want[:2]):
        for (gx, gy), (wx, wy) in zip(g_fn(), w_fn()):
            np.testing.assert_array_equal(gy, wy)
            assert_bytes_equal(gx, wx)


@pytest.fixture
def tfds_stub(monkeypatch):
    """``tests/test_train.py``'s stub of ``tensorflow_datasets`` (skipped
    without TensorFlow, as that test is)."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.RandomState(0)
    n_train, n_test = 10, 6
    imgs = rng.randint(0, 255, (n_train, 40, 44, 3), np.uint8)
    labels = rng.randint(0, CLASSES, (n_train,))
    timgs = rng.randint(0, 255, (n_test, 40, 44, 3), np.uint8)
    tlabels = rng.randint(0, CLASSES, (n_test,))

    def as_ds(images, labels):
        return tf.data.Dataset.from_tensor_slices({"image": images, "label": labels})

    info = types.SimpleNamespace(
        features={"label": types.SimpleNamespace(num_classes=CLASSES),
                  "image": types.SimpleNamespace(shape=(None, None, 3))},
        splits={"train": types.SimpleNamespace(num_examples=n_train)})
    stub = types.SimpleNamespace(load=lambda name, with_info=True, try_gcs=False: (
        {"train": as_ds(imgs, labels), "validation": as_ds(timgs, tlabels)}, info))
    monkeypatch.setitem(sys.modules, "tensorflow_datasets", stub)
    return tlabels


def test_init_dataset_tfds_route_with_stub(tfds_stub, monkeypatch):
    """The JAX test's checks, and the eval batches (no draw) equal to JAX's
    within f32 rounding."""
    assert tfds.init_dataset("fake_ds", batch_size=4, info_only=True) == (10, CLASSES, 3, 3)
    kw = dict(input_shape=(32, 32), batch_size=4, rescale_mode="torch", random_crop_min=0.6,
              magnitude=2, seed=1, drop_remainder=True, use_shuffle=True, buffer_size=8,
              eval_central_crop=0.8)
    train_fn, test_fn, total, ncls, steps = tfds.init_dataset("fake_ds", device="cpu", **kw)
    assert (total, ncls, steps) == (10, CLASSES, 3)
    xb, yb = next(train_fn())
    assert isinstance(xb, torch.Tensor) and xb.shape == (4, 32, 32, 3) and yb.shape == (4, CLASSES)
    np.testing.assert_allclose(yb.sum(-1).numpy(), 1.0, atol=1e-6)
    assert xb.abs().max() < 10  # torch-normalised, not raw 0-255
    assert sum(1 for _ in train_fn()) == 2  # 10 at batch 4, drop_remainder
    got = list(test_fn())
    want = list(jax_tfds.init_dataset("fake_ds", **kw)[1]())
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0][0].numpy(), want[0][0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0][1].numpy(), want[0][1])
    monkeypatch.setitem(sys.modules, "tensorflow_datasets", None)
    with pytest.raises(NotImplementedError, match="custom-JSON"):
        tfds.init_dataset("fake_ds", info_only=True)


def test_post_process_batch():
    """Normalisation by each rescale mode as JAX's, RandAugment and mixup
    on the given device and generator, one-hot labels."""
    rng = np.random.RandomState(2)
    images = rng.uniform(0, 255, (6, 24, 20, 3)).astype(np.float32)
    labels = rng.randint(0, CLASSES, 6)
    for mode in ("tf", "torch", "raw", "raw01", (10.0, 2.0)):
        x, y = tfds.post_process_batch(images, labels, CLASSES, train=False, rescale_mode=mode,
                                       device="cpu")
        mean, std = jax_tfds.init_mean_std_by_rescale_mode(mode)
        np.testing.assert_allclose(x.numpy(), (images - mean) / std, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(y.numpy(), np.eye(CLASSES, dtype=np.float32)[labels])
    with pytest.raises(ValueError, match="rescale_mode"):
        tfds.init_mean_std_by_rescale_mode("bad")
    g = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    a = tfds.post_process_batch(images, labels, CLASSES, train=True, rescale_mode="raw01",
                                magnitude=6, mixup_alpha=0.4, generator=g(), device="cpu")
    b = tfds.post_process_batch(images, labels, CLASSES, train=True, rescale_mode="raw01",
                                magnitude=6, mixup_alpha=0.4, generator=g(), device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not np.allclose(a[0].numpy(), images / 255.0)
    assert a[0].min() >= 0 and a[0].max() <= 1
    np.testing.assert_allclose(a[1].sum(-1).numpy(), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# history and token labels
# ---------------------------------------------------------------------------


def test_history_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    hists = [{"loss": list(1.0 / np.arange(1, 9) + 0.01 * rng.rand(8)), "lr": [0.1] * 8,
              "val_loss": list(rng.rand(8)), "val_acc": list(rng.rand(8)),
              "acc": list(rng.rand(8))},
             {"loss": list(0.1 + 0.01 * rng.rand(30)), "lr": [0.01] * 30,
              "val_loss": list(rng.rand(30)), "val_acc": list(rng.rand(30)),
              "acc": list(rng.rand(30))}]
    paths = []
    for i, h in enumerate(hists):
        paths.append(str(tmp_path / f"h{i}.json"))
        with open(paths[-1], "w") as fh:
            json.dump(h, fh)
    got = history.combine_hist_into_one([paths[0], hists[1]], str(tmp_path / "all.json"))
    assert got == jax_history.combine_hist_into_one([paths[0], hists[1]])
    with open(tmp_path / "all.json") as fh:
        assert json.load(fh) == got
    for kw in (dict(), dict(target_len=3, skip=2, use_recent=10), dict(use_recent=-1)):
        np.testing.assert_allclose(history.curve_fit(got["loss"], **kw),
                                   jax_history.curve_fit(got["loss"], **kw), rtol=1e-6, atol=1e-6)
    pytest.importorskip("matplotlib")
    got["val_acc"][3] = float("nan")
    fig = history.plot_hists([got, paths[1]], names=["all", None], pred_curve=2,
                             save_path=str(tmp_path / "h.png"))
    want = jax_history.plot_hists([got, paths[1]], names=["all", None], pred_curve=2)
    assert os.path.isfile(tmp_path / "h.png") and len(fig.axes) == len(want.axes) == 3
    for ga, wa in zip(fig.axes, want.axes):
        assert len(ga.lines) == len(wa.lines)
        for gl, wl in zip(ga.lines, wa.lines):
            np.testing.assert_allclose(gl.get_ydata(), wl.get_ydata(), rtol=1e-6, atol=1e-6)


def test_token_labels_match_jax():
    rng = np.random.RandomState(4)
    sh = sw = 7
    k, num_classes = 3, 10
    pos = np.stack([rng.choice(num_classes, k, replace=False) for _ in range(sh * sw)])
    score = rng.uniform(0.1, 1, (sh, sw, k)).astype(np.float32)
    tl = np.stack([pos.reshape(sh, sw, k).astype(np.float32), score])
    for kw in (dict(), dict(flip_left_right=True),
               dict(scale_hh=1.3, scale_ww=0.9, crop_hh=0.05, crop_ww=0.1),
               dict(target_num_patches=(5, 9))):
        np.testing.assert_allclose(token_label.token_label_align(tl, num_classes, **kw),
                                   jax_token_label.token_label_align(tl, num_classes, **kw),
                                   rtol=0, atol=1e-5)
    images = [rng.rand(4, 4, 3).astype(np.float32) for _ in range(5)]
    w = rng.rand(3, 6).astype(np.float32)
    np_fn = lambda b: b @ w  # noqa: E731  per-patch class scores (b, 4, 4, 6)
    torch_fn = lambda b: torch.from_numpy(b) @ torch.from_numpy(w)  # noqa: E731
    np.testing.assert_array_equal(token_label.build_token_labels(torch_fn, images, 2, 2),
                                  jax_token_label.build_token_labels(np_fn, images, 2, 2))


# ---------------------------------------------------------------------------
# the slice: a fit from JPEGs on disk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_variables():
    v = JaxTiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    return jax.tree_util.tree_map(np.asarray, dict(v))


def test_fit_from_custom_json_matches_jax(dataset, tiny_variables, tmp_path):
    """Two epochs of two steps from the JPEGs, through each package's
    custom-JSON loaders (crop, flip, erasing) and trainer: the same
    history."""
    path, _ = dataset
    common = dict(epochs=2, steps_per_epoch=2, lr_base=1e-2, optimizer="adamw",
                  loss="categorical", monitor="loss", basic_save_name="t")
    kw = dict(batch_size=4, target_shape=(32, 32), random_erasing_prob=0.25, seed=7)
    train, val, _ = J.loaders_from_custom_json(path, **kw)
    want = JaxTrainer(JaxTiny(), tiny_variables, JaxTrainConfig(
        ckpt_dir=str(tmp_path / "jax"), **common), mesh=get_mesh(devices=jax.devices()[:1])
    ).fit(train, val, verbose=0)
    train, val, _ = P.loaders_from_custom_json(path, **kw)
    tr = Trainer(_port(tiny_variables), TrainConfig(ckpt_dir=str(tmp_path / "port"), **common),
                 device="cpu")
    got = tr.fit(train, val, verbose=0)
    assert got.keys() == want.keys() and len(got["loss"]) == 2
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert os.path.isfile(tmp_path / "port" / "t_latest.msgpack")
