"""LayerNorm over the last axis with f32 statistics, and BatchNorm.

``LayerNorm`` is the counterpart of ``vip_cup_2022_tpu/ops/norms.py::
LayerNorm`` in its f32 form: the input is read in f32, normalised with
two-pass f32 mean and variance, scaled and shifted by f32 parameters, and
returned in the input's dtype. The JAX package's bf16 path takes
E[x^2] - E[x]^2 statistics instead; the port keeps the two-pass form for
every dtype. Every call goes through
:func:`..ops.kernels.layernorm.fused_layernorm`: the LN kernel on CUDA, its
plain version on the CPU, the plain version's gradient backward.

``BatchNorm`` is ``norms.py::BatchNorm``: in eval mode the moving
statistics normalise the channel axis in f32; in training mode the f32 batch
mean and population variance over every axis but the last do, and the moving
statistics move towards them by the layer's ``momentum``: 0.9, the JAX
package's ``BATCH_NORM_DECAY``, unless the model passes its own (ResNet-RS
passes its config's ``bn_momentum``, 0.0).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .kernels.layernorm import fused_layernorm

BATCH_NORM_DECAY = 0.9  # BatchNorm's default momentum


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
    the Flax ``batch_stats`` ``moving_mean`` / ``moving_variance``, or in
    training mode the batch's, after which ``running = momentum * running +
    (1 - momentum) * batch``: at momentum 0 they are the last training
    batch's."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 momentum: float = BATCH_NORM_DECAY):
        super().__init__()
        self.eps, self.dtype, self.momentum = eps, dtype, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = xf.mean(dim=axes)
            var = xf.var(dim=axes, unbiased=False)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * inv + self.bias
        return y.to(self.dtype or x.dtype)
