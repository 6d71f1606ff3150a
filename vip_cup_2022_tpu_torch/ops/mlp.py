"""The transformer MLP: fc1 -> exact GELU -> fc2 (counterpart of
``vip_cup_2022_tpu/ops/mlp.py::Mlp``, without its dropout, which inference
does not run). Parameters under the Flax names ``fc1`` and ``fc2``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .act import gelu_exact
from .conv import Linear


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype)
        self.fc2 = Linear(hidden_features, out_features or in_features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(x)))
