"""LayerNorm over the last axis with f32 statistics, and BatchNorm in its
inference form.

``LayerNorm`` is the counterpart of ``vip_cup_2022_tpu/ops/norms.py::
LayerNorm`` in its f32 form: the input is read in f32, normalised with
two-pass f32 mean and variance, scaled and shifted by f32 parameters, and
returned in the input's dtype. The JAX package's bf16 path takes
E[x^2] - E[x]^2 statistics instead; the port keeps the two-pass form for
every dtype. Every call goes through
:func:`..ops.kernels.layernorm.fused_layernorm`: the LN kernel on CUDA, its
plain version on the CPU, the plain version's gradient backward.

``BatchNorm`` is ``norms.py::BatchNorm`` with ``training=False``: the moving
statistics normalise the channel axis in f32.
"""
from __future__ import annotations

from typing import Optional

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


class BatchNorm(nn.Module):
    """``(x_f32 - mean) * (rsqrt(var + eps) * gamma) + beta`` over the last
    axis, cast to ``dtype`` (x's dtype when None). gamma / beta are the f32
    ``weight`` / ``bias``; the statistics are the f32 buffers
    ``running_mean`` / ``running_var``, which the weight bridge fills from
    the Flax ``batch_stats`` ``moving_mean`` / ``moving_variance``."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean) * inv + self.bias
        return y.to(self.dtype or x.dtype)
