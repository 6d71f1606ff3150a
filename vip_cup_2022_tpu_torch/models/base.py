"""Model base config and input normalisation (counterpart of
``vip_cup_2022_tpu/models/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Base config shared by every backbone family. ``dtype`` is the compute
    dtype (``torch.float32`` or ``torch.bfloat16``)."""

    name: str = ""
    url: str = ""
    input_size: Tuple[int, int] = (224, 224)
    in_channels: int = 3
    nb_classes: int = 1000
    mean: Tuple[float, ...] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, ...] = IMAGENET_DEFAULT_STD
    classifier_activation: Optional[str] = "softmax"
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    first_strides: int = 2
    pool: str = "avg"
    dtype: torch.dtype = torch.float32

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _adapt_stats(values, channels: int) -> np.ndarray:
    """Mean/std vectors for a non-RGB channel count: 1 channel averages,
    N channels tile."""
    v = np.asarray(values, dtype=np.float32).reshape(-1)
    if v.size == channels:
        return v
    if channels == 1:
        return v.mean(keepdims=True)
    reps = -(-channels // v.size)
    return np.tile(v, reps)[:channels]


def preprocess_input(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Normalise [0, 1] NHWC input with the model's mean and std in f32, then
    cast to the compute dtype."""
    if cfg.mean is None and cfg.std is None:
        return x
    ch = x.shape[-1]
    mean = torch.from_numpy(_adapt_stats(cfg.mean if cfg.mean is not None else (0.0,), ch))
    std = torch.from_numpy(_adapt_stats(cfg.std if cfg.std is not None else (1.0,), ch))
    y = (x.float() - mean.to(x.device)) / std.to(x.device)
    return y.to(cfg.dtype)
