"""Relative-position bias of window attention (counterpart of
``vip_cup_2022_tpu/ops/attention.py``'s ``relative_position_index`` and its
dense ``(heads, N, N)`` gather)."""
from __future__ import annotations

import numpy as np
import torch


def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(N, N) index into a ((2wh-1)*(2ww-1))-row bias table (GCViT/Swin scheme)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)  # (N, N, 2)
    xx = (rel[:, :, 0] + wh - 1) * (2 * ww - 1)
    yy = rel[:, :, 1] + ww - 1
    return (xx + yy).astype(np.int32)


def dense_relative_position_bias(table: torch.Tensor, window_size: int) -> torch.Tensor:
    """((2ws-1)^2, heads) table -> (heads, N, N) f32 bias, N = ws*ws."""
    n = window_size * window_size
    idx = torch.from_numpy(relative_position_index(window_size, window_size).reshape(-1).astype(np.int64))
    bias = table.float()[idx.to(table.device)].reshape(n, n, -1)
    return bias.permute(2, 0, 1).contiguous()
