"""Window tiling for local attention (counterpart of
``vip_cup_2022_tpu/ops/window.py``, NHWC): partition, reverse, GCViT's
centred FitWindow pad and the crop back."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws, ws, C), windows row-major per image."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int, w: int) -> torch.Tensor:
    """(B * nH * nW, ws, ws, C) -> (B, H, W, C)."""
    ws = window_size
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def fit_window_pad(x: torch.Tensor, window_size: int) -> Tuple[torch.Tensor, int, int]:
    """GCViT's FitWindow: zero-pad H and W up to multiples of the window,
    centred (the odd pixel goes to the bottom / right). Returns the padded
    tensor and the original H, W for :func:`crop_from_window`."""
    _, h, w, _ = x.shape
    ph = (window_size - h % window_size) % window_size
    pw = (window_size - w % window_size) % window_size
    if ph or pw:
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return x, h, w


def crop_from_window(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Crop back to the pre-pad spatial size (the top-left h x w, as the JAX
    package's level crops)."""
    return x[:, :h, :w, :]
