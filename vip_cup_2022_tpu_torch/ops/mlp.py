"""The transformer MLP: fc1 -> exact GELU -> dropout -> fc2 -> dropout
(counterpart of ``vip_cup_2022_tpu/ops/mlp.py::Mlp``; the dropouts act in
training only). Parameters under the Flax names ``fc1`` and ``fc2``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .act import gelu_exact
from .conv import Linear
from .drop import Dropout


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 drop_rate: float = 0.0):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype)
        self.fc2 = Linear(hidden_features, out_features or in_features, dtype)
        self.drop1 = Dropout(drop_rate)
        self.drop2 = Dropout(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop2(self.fc2(self.drop1(gelu_exact(self.fc1(x)))))
