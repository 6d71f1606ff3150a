"""Plain convolution and dense layers on NHWC tensors, shared by the model
families (counterparts of Flax's ``nn.Conv`` and ``nn.Dense`` as the JAX
package uses them).

Weights are held in the compute dtype, and each layer casts its input to
it, as Flax's ``dtype=...`` computes; a :class:`Conv` built with ``dtype``
None is Flax's ``dtype=None`` conv, f32 weights and f32 compute whatever the
input (Flax promotes the input with its f32 parameters). Depthwise taps are
(k, k, C), Flax's (k, k, 1, C) without its I axis.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Module):
    """y = x W^T (+ b) with W (out, in) in the compute dtype and b in f32;
    x is cast to W's dtype first, as Flax's ``Dense(dtype=...)`` casts its
    input."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.weight.dtype)
        return F.linear(x.to(self.weight.dtype), self.weight, b)


class Conv(nn.Module):
    """k x k conv on NHWC input with symmetric zero padding ``padding``
    (0 = VALID); weight (O, I, kh, kw) and bias in the compute dtype
    (``dtype``, f32 when None)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = torch.float32, padding: int = 0,
                 bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        wdtype = dtype or torch.float32
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, dtype=wdtype))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=wdtype)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.weight.dtype).permute(0, 3, 1, 2), self.weight, self.bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1).contiguous()


class DepthwiseTaps(nn.Module):
    """A depthwise conv's f32 taps, (k, k, C) as the depthwise kernel reads
    them, and its f32 (C,) bias; the kernel that owns them applies them."""

    def __init__(self, dim: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(kernel, kernel, dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class DepthwiseConv(nn.Module):
    """Stride-1 k x k depthwise conv on NHWC input with symmetric zero
    padding ``padding`` and no bias; taps (k, k, C) in the compute dtype."""

    def __init__(self, dim: int, kernel: int, padding: int, dtype: torch.dtype):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(kernel, kernel, dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        w = self.weight.permute(2, 0, 1).unsqueeze(1)  # (C, 1, k, k)
        y = F.conv2d(x.to(w.dtype).permute(0, 3, 1, 2), w, None, 1, self.padding, groups=c)
        return y.permute(0, 2, 3, 1).contiguous()


def lecun_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """Weights of a :class:`Linear`, :class:`Conv`, :class:`DepthwiseTaps` or
    :class:`DepthwiseConv` normal with variance 1 / fan_in (Flax's
    lecun_normal without its truncation), bias 0."""
    w = module.weight
    depthwise = isinstance(module, (DepthwiseTaps, DepthwiseConv))
    fan_in = math.prod(w.shape[:2] if depthwise else w.shape[1:])
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) * fan_in ** -0.5)
        if getattr(module, "bias", None) is not None:
            module.bias.zero_()
