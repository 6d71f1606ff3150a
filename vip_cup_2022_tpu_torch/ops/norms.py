"""LayerNorm over the last axis with f32 statistics.

Counterpart of ``vip_cup_2022_tpu/ops/norms.py::LayerNorm`` in its f32
form: the input is read in f32, normalised with two-pass f32 mean and
variance, scaled and shifted by f32 parameters, and returned in the input's
dtype. The JAX package's bf16 path takes E[x^2] - E[x]^2 statistics instead;
the port keeps the two-pass form for every dtype. Every call goes through
:func:`..ops.kernels.layernorm.fused_layernorm`: the LN kernel on CUDA, its
plain version on the CPU, the plain version's gradient backward.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .kernels.layernorm import fused_layernorm


class LayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layernorm(x.contiguous(), self.weight, self.bias, self.eps)
