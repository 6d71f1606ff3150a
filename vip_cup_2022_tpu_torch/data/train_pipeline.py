"""Training and evaluation loaders on the host (counterpart of
``vip_cup_2022_tpu/data/train_pipeline.py``, kecam's ``imagenet/data.py``).

- ``random_crop_fraction``: timm's random-resized-crop box, the aspect
  drawn log-uniform, the largest scale capped so the ratio range stays
  feasible;
- ``random_crop_and_resize_image`` and the eval path's
  ``central_crop_resize``;
- ``random_erasing_per_pixel``: rectangles of per-pixel normal noise at
  ImageNet's [0, 255] statistics;
- ``TrainLoader`` (decode, random-resized crop, horizontal flip, erasing)
  and ``EvalLoader`` (central crop and resize), yielding uint8 NHWC batches
  and one-hot f32 labels; the custom-JSON dataset and its two loaders.

The draws stay on the numpy ``RandomState`` and are taken call for call in
the JAX loader's order: the epoch's permutation, then per image the crop
box, ``top`` and ``left``, the flip's uniform and the erasing draws, the
noise included. ``TrainLoader`` takes all of a batch's draws in the calling
thread and then crops, resizes, flips and erases the images on its decode
pool. The JAX package's loader applies no RandAugment and no mixup: the
TFDS route does (``data/tfds.py``), as does the trainer.

The resize is the JAX module's, two passes with ``resize_matrix``, which
the JAX module writes as ``np.einsum`` products (no BLAS: ~165 ms a 224
image on one core). Each output here sums only the matrix row's non-zero
taps, in the order of their source index, one f32 product and one f32 add
each, which is the order the einsum accumulates in: the same bytes at
~2 % of its cost.
"""
from __future__ import annotations

import functools
import json
import math
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..ops.resize import resize_matrix
from .decode import ImageDecoder

# random_erasing_per_pixel's noise: ImageNet's mean and std in [0, 255]
ERASE_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
ERASE_STD = np.array([58.395, 57.120003, 57.375], np.float32)


def random_crop_fraction(rng: np.random.RandomState, size, scale=(0.08, 1.0),
                         ratio=(0.75, 1.3333333), log_distribute=True) -> Tuple[int, int]:
    """The (height, width) of a random crop of an image of ``size``: an
    area share drawn in ``scale`` (its top capped so that ``ratio`` stays
    feasible), an aspect drawn in ``ratio``, log-uniform by default."""
    height, width = float(size[0]), float(size[1])
    area = height * width
    scale_max = min(height * height * ratio[1] / area, width * width / ratio[0] / area, scale[1])
    target_area = rng.uniform(scale[0], scale_max) * area
    ratio_min = max(target_area / (height * height), ratio[0])
    ratio_max = min(width * width / target_area, ratio[1])
    if log_distribute:
        aspect = math.exp(rng.uniform(math.log(ratio_min), math.log(ratio_max)))
    else:
        aspect = rng.uniform(ratio_min, ratio_max)
    ww = int(math.floor(math.sqrt(target_area * aspect)))
    hh = int(math.floor(math.sqrt(target_area / aspect)))
    return hh, ww


@functools.lru_cache(maxsize=256)
def _taps(in_size: int, out_size: int, method: str) -> Tuple[np.ndarray, np.ndarray]:
    """The non-zero taps of each row of ``resize_matrix(in_size, out_size,
    method)``: source indices (out, k) in increasing order and their f32
    weights, rows with fewer taps padded with weight 0."""
    mat = resize_matrix(in_size, out_size, method)
    rows = [np.nonzero(r)[0] for r in mat]
    k = max(len(r) for r in rows)
    idx = np.zeros((out_size, k), np.int64)
    wgt = np.zeros((out_size, k), np.float32)
    for o, r in enumerate(rows):
        idx[o, :len(r)], idx[o, len(r):] = r, r[-1]
        wgt[o, :len(r)] = mat[o, r]
    idx.flags.writeable = wgt.flags.writeable = False
    return idx, wgt


def _resize_axis(x: np.ndarray, out_size: int, axis: int, method: str) -> np.ndarray:
    """One pass of the resize along ``axis`` (0 or 1) of (H, W, C) f32."""
    idx, wgt = _taps(x.shape[axis], out_size, method)
    shape = (-1, 1, 1) if axis == 0 else (1, -1, 1)
    acc = np.zeros(x.shape[:axis] + (out_size,) + x.shape[axis + 1:], np.float32)
    for t in range(idx.shape[1]):
        acc = acc + wgt[:, t].reshape(shape) * np.take(x, idx[:, t], axis=axis)
    return acc


def _host_resize(img: np.ndarray, size, method: str = "bilinear") -> np.ndarray:
    """``img`` (H, W, C) resized to ``size`` in f32, height then width,
    each side only where it changes."""
    h, w = img.shape[:2]
    oh, ow = size
    x = img.astype(np.float32)
    if h != oh:
        x = _resize_axis(x, oh, 0, method)
    if w != ow:
        x = _resize_axis(x, ow, 1, method)
    return x


def random_crop_box(rng: np.random.RandomState, height: int, width: int, scale=(0.08, 1.0),
                    ratio=(0.75, 1.3333333)) -> Tuple[int, int, int, int]:
    """The draws of :func:`random_crop_and_resize_image`: ``(top, left,
    hh, ww)`` of the crop, each side at least 1 and at most the image's
    less one."""
    hh, ww = random_crop_fraction(rng, (height, width), scale, ratio)
    hh, ww = int(np.clip(hh, 1, height - 1)), int(np.clip(ww, 1, width - 1))
    top = rng.randint(0, height - hh) if height > hh else 0
    left = rng.randint(0, width - ww) if width > ww else 0
    return top, left, hh, ww


def random_crop_and_resize_image(rng: np.random.RandomState, image: np.ndarray, target_shape,
                                 scale=(0.08, 1.0), ratio=(0.75, 1.3333333),
                                 method: str = "bilinear") -> np.ndarray:
    """A random crop (:func:`random_crop_box`) resized to ``target_shape``,
    in f32."""
    top, left, hh, ww = random_crop_box(rng, *image.shape[:2], scale, ratio)
    return _host_resize(image[top:top + hh, left:left + ww], target_shape, method)


def central_crop_resize(image: np.ndarray, target_shape, central_crop: float = 1.0,
                        method: str = "bilinear") -> np.ndarray:
    """The eval path: the central square of ``central_crop * min(h, w)``
    (none when ``central_crop`` <= 0) resized to ``target_shape``, in f32."""
    if central_crop > 0:
        h, w = image.shape[:2]
        crop = int(central_crop * min(h, w))
        y, x = (h - crop) // 2, (w - crop) // 2
        image = image[y:y + crop, x:x + crop]
    return _host_resize(image, target_shape, method)


Rect = Tuple[int, int, np.ndarray]  # top, left, the (hh, ww, 3) noise


def erasing_draws(rng: np.random.RandomState, h: int, w: int, num_layers: int = 1,
                  scale=(0.02, 0.33333333), ratio=(0.3, 3.3333333),
                  probability: float = 0.5) -> Optional[List[Rect]]:
    """The draws of :func:`random_erasing_per_pixel` on an (h, w) image:
    None when the gate's uniform exceeds ``probability``, else per layer a
    box and its noise, clipped to [0, 255]."""
    if rng.uniform() > probability:
        return None
    rects = []
    for _ in range(num_layers):
        hh, ww = random_crop_fraction(rng, (h, w), scale=scale, ratio=ratio)
        hh, ww = min(hh, h - 1), min(ww, w - 1)
        top = rng.randint(0, h - hh) if h > hh else 0
        left = rng.randint(0, w - ww) if w > ww else 0
        rects.append((top, left, np.clip(rng.normal(ERASE_MEAN, ERASE_STD, size=(hh, ww, 3)),
                                         0.0, 255.0)))
    return rects


def _erase(image: np.ndarray, rects: List[Rect]) -> np.ndarray:
    out = image.copy()
    for top, left, noise in rects:
        out[top:top + noise.shape[0], left:left + noise.shape[1]] = noise
    return out


def random_erasing_per_pixel(rng: np.random.RandomState, image: np.ndarray, num_layers: int = 1,
                             scale=(0.02, 0.33333333), ratio=(0.3, 3.3333333),
                             probability: float = 0.5) -> np.ndarray:
    """With probability ``probability``, ``num_layers`` random rectangles of
    ``image`` (H, W, C) replaced by noise (:func:`erasing_draws`)."""
    rects = erasing_draws(rng, *image.shape[:2], num_layers, scale, ratio, probability)
    return image if rects is None else _erase(image, rects)


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


class _Draws(NamedTuple):
    """One training image's draws: the crop box (None: a plain resize),
    the flip, the erasing rectangles (None: none)."""
    box: Optional[Tuple[int, int, int, int]]
    flip: bool
    rects: Optional[List[Rect]]


def _one_hot(labels: np.ndarray, nb_classes: int) -> np.ndarray:
    return np.eye(nb_classes, dtype=np.float32)[labels]


class TrainLoader:
    """Labelled training batches: decode, random-resized crop, horizontal
    flip at 0.5, then random erasing when ``random_erasing_prob`` > 0; a
    negative ``magnitude`` turns the crop and the flip off (a plain resize,
    kecam's convention). Iterating draws a new permutation from the
    loader's ``RandomState``; yields ``(uint8 (B, H, W, 3), one-hot f32
    (B, nb_classes))``."""

    def __init__(self, paths: Sequence[str], labels: Sequence[int], nb_classes: int,
                 batch_size: int, target_shape: Tuple[int, int] = (224, 224),
                 random_crop_min: float = 0.08, magnitude: float = 0.0,
                 random_erasing_prob: float = 0.0, resize_method: str = "bilinear",
                 seed: int = 42, num_threads: int = 8, drop_remainder: bool = True):
        self.paths = list(paths)
        self.labels = np.asarray(labels, np.int64)
        self.nb_classes = nb_classes
        self.batch_size = batch_size
        self.target_shape = tuple(target_shape)
        self.random_crop_min = random_crop_min
        self.magnitude = magnitude
        self.random_erasing_prob = random_erasing_prob
        self.resize_method = resize_method
        self.rng = np.random.RandomState(seed)
        self._decoder = ImageDecoder(num_threads=num_threads)
        self.drop_remainder = drop_remainder

    def __len__(self) -> int:
        n = len(self.paths)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def _draw(self, height: int, width: int) -> _Draws:
        """Every draw of one image, in the JAX loader's order."""
        box, flip = None, False
        if self.magnitude >= 0:
            box = random_crop_box(self.rng, height, width, (self.random_crop_min, 1.0))
            flip = self.rng.uniform() < 0.5
        rects = None
        if self.random_erasing_prob > 0:
            rects = erasing_draws(self.rng, *self.target_shape,
                                  probability=self.random_erasing_prob)
        return _Draws(box, flip, rects)

    def _apply(self, img: np.ndarray, d: _Draws) -> np.ndarray:
        if d.box is not None:
            top, left, hh, ww = d.box
            img = img[top:top + hh, left:left + ww]
        img = _host_resize(img, self.target_shape, self.resize_method)
        if d.flip:
            img = img[:, ::-1]
        if d.rects is not None:
            img = _erase(img, d.rects)
        return _to_uint8(img)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.rng.permutation(len(self.paths))
        bs = self.batch_size
        for start in range(0, len(order) - (bs - 1 if self.drop_remainder else 0), bs):
            idx = order[start:start + bs]
            imgs = self._decoder.decode_batch([self.paths[i] for i in idx])
            draws = [self._draw(*im.shape[:2]) for im in imgs]
            batch = np.stack(self._decoder.map(self._apply, imgs, draws))
            yield batch, _one_hot(self.labels[idx], self.nb_classes)

    def close(self) -> None:
        self._decoder.close()


class EvalLoader:
    """Evaluation batches in file order: decode, central crop and resize on
    the decode pool; the last batch may be short. Yields ``(uint8 (B, H, W,
    3), one-hot f32 (B, nb_classes))``."""

    def __init__(self, paths: Sequence[str], labels: Sequence[int], nb_classes: int,
                 batch_size: int, target_shape: Tuple[int, int] = (224, 224),
                 central_crop: float = 0.95, resize_method: str = "bilinear",
                 num_threads: int = 8):
        self.paths = list(paths)
        self.labels = np.asarray(labels, np.int64)
        self.nb_classes = nb_classes
        self.batch_size = batch_size
        self.target_shape = tuple(target_shape)
        self.central_crop = central_crop
        self.resize_method = resize_method
        self._decoder = ImageDecoder(num_threads=num_threads)

    def __len__(self) -> int:
        return -(-len(self.paths) // self.batch_size)

    def _process(self, img: np.ndarray) -> np.ndarray:
        return _to_uint8(central_crop_resize(img, self.target_shape, self.central_crop,
                                             self.resize_method))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        bs = self.batch_size
        for start in range(0, len(self.paths), bs):
            chunk = slice(start, min(start + bs, len(self.paths)))
            futures = self._decoder.submit_batch(self.paths[chunk], postprocess=self._process)
            batch = np.stack([f.result() for f in futures])
            yield batch, _one_hot(self.labels[chunk], self.nb_classes)

    def close(self) -> None:
        self._decoder.close()


def recognition_dataset_from_custom_json(data_path: str, with_info: bool = False):
    """A custom-JSON dataset: ``{"train": [{"image": path, "label": int},
    ...], "validation" or "test": [...], "info": {"num_classes": N}}``.
    Returns ``{"train": (paths, labels), <test key>: (paths, labels)}``,
    with ``with_info`` also the number of training images and of classes."""
    with open(data_path) as ff:
        aa = json.load(ff)
    test_key = "validation" if "validation" in aa else "test"
    train, test, info = aa["train"], aa[test_key], aa["info"]

    def split(items):
        return [ii["image"] for ii in items], [int(ii["label"]) for ii in items]

    dataset = {"train": split(train), test_key: split(test)}
    if with_info:
        return dataset, len(train), info["num_classes"]
    return dataset


def loaders_from_custom_json(data_path: str, batch_size: int = 32, target_shape=(224, 224),
                             **kwargs) -> Tuple[TrainLoader, EvalLoader, int]:
    """``(TrainLoader, EvalLoader, num_classes)`` of a custom-JSON dataset;
    ``kwargs`` go to the ``TrainLoader``."""
    dataset, _, num_classes = recognition_dataset_from_custom_json(data_path, with_info=True)
    test_key = "validation" if "validation" in dataset else "test"
    train_paths, train_labels = dataset["train"]
    test_paths, test_labels = dataset[test_key]
    train = TrainLoader(train_paths, train_labels, num_classes, batch_size, target_shape,
                        **kwargs)
    test = EvalLoader(test_paths, test_labels, num_classes, batch_size, target_shape)
    return train, test, num_classes
