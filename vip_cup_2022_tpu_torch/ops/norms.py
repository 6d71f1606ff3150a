"""LayerNorm over the last axis with f32 statistics.

Counterpart of ``vip_cup_2022_tpu/ops/norms.py::LayerNorm`` in its f32
form: the input is promoted to f32, normalised with f32 mean and variance,
scaled and shifted by f32 parameters, and returned in the input's dtype.
The JAX package's bf16 path takes E[x^2] - E[x]^2 statistics instead; the
port keeps the f32 form for every dtype. ``F.layer_norm`` computes it in one
launch (Welford statistics on CUDA, as exact as two passes). It takes no
bf16 input with f32 parameters on CUDA, hence the explicit f32 copy.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class LayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps)
        return y.to(x.dtype)
