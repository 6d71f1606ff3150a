"""Seeding and the host-side uint8 resize of the inference input path
(counterparts of ``vip_cup_2022_tpu/data/pipeline.py::seeding`` and
``::_host_resize_uint8``)."""
from __future__ import annotations

import os
import random
from typing import Tuple

import numpy as np
import torch

from ..ops.resize import resize_matrix


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
