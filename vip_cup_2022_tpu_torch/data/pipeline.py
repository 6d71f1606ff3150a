"""Seeding, the host-side uint8 resize of the inference input path and the
manifest-level batch loader (counterpart of
``vip_cup_2022_tpu/data/pipeline.py``).

:class:`BatchLoader` decodes on a thread pool, unifies off-size images to
the canonical size with TF's bicubic numerics on the host, zero-pads the
last batch and prefetches on a background thread; casts, resizing to a
member's size, normalisation and augmentation are the engine's or the
trainer's, on the device."""
from __future__ import annotations

import os
import queue
import random
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize_matrix
from .decode import ImageDecoder


def seeding(cfg) -> None:
    """Seed numpy, python, the hash seed and torch's global generators."""
    seed = cfg.seed if hasattr(cfg, "seed") else int(cfg)
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)


def _host_resize_uint8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """TF-v2 bicubic resize of one uint8 HWC image on the host (numpy
    matmuls), for images whose decoded size differs from the canonical one;
    the result is rounded back to uint8."""
    h, w = img.shape[:2]
    oh, ow = size
    if (h, w) == (oh, ow):
        return img
    x = img.astype(np.float32)
    if h != oh:
        x = np.einsum("oh,hwc->owc", resize_matrix(h, oh, "bicubic"), x)
    if w != ow:
        x = np.einsum("ow,hwc->hoc", resize_matrix(w, ow, "bicubic"), x)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


class BatchLoader:
    """Uint8 NHWC batches of ``native_size`` (the contract's 200 x 200),
    with ``n_valid``: the last batch is zero-padded to ``batch_size`` (or
    dropped with ``drop_remainder``). A background thread decodes up to
    ``prefetch`` batches ahead. Yields ``(uint8 (batch_size, H, W, 3),
    n_valid)``."""

    def __init__(self, paths: Sequence[str], batch_size: int,
                 native_size: Tuple[int, int] = (200, 200), num_threads: int = 16,
                 prefetch: int = 2, drop_remainder: bool = False):
        self.paths = list(paths)
        self.batch_size = batch_size
        self.native_size = tuple(native_size)
        self.drop_remainder = drop_remainder
        self._decoder = ImageDecoder(num_threads=num_threads)
        self._prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.paths)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def _make_batch(self, chunk: Sequence[str]) -> Tuple[np.ndarray, int]:
        h, w = self.native_size
        out = np.zeros((self.batch_size, h, w, 3), dtype=np.uint8)
        for i, im in enumerate(self._decoder.decode_batch(chunk)):
            out[i] = _host_resize_uint8(im, self.native_size)
        return out, len(chunk)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        chunks = [self.paths[i:i + self.batch_size]
                  for i in range(0, len(self.paths), self.batch_size)]
        if self.drop_remainder and chunks and len(chunks[-1]) < self.batch_size:
            chunks.pop()
        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        stop = object()

        def producer():
            try:
                for chunk in chunks:
                    q.put(self._make_batch(chunk))
            finally:
                q.put(stop)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item

    def close(self) -> None:
        self._decoder.close()


def build_dataset(paths: Sequence[str], labels: Optional[Sequence[int]] = None,
                  batch_size: int = 32, img_size: Tuple[int, int] = (200, 200),
                  shuffle: int = 0, seed: int = 42, drop_remainder: bool = False,
                  num_threads: int = 16):
    """A :class:`BatchLoader` over ``paths`` (shuffled once by a
    ``RandomState(seed)`` permutation when ``shuffle``), with the labels'
    array in the same order when ``labels`` is given."""
    paths = list(paths)
    labels_arr = None if labels is None else np.asarray(labels)
    if shuffle:
        order = np.random.RandomState(seed).permutation(len(paths))
        paths = [paths[i] for i in order]
        if labels_arr is not None:
            labels_arr = labels_arr[order]
    loader = BatchLoader(paths, batch_size=batch_size, native_size=img_size,
                         num_threads=num_threads, drop_remainder=drop_remainder)
    return (loader, labels_arr) if labels is not None else loader
