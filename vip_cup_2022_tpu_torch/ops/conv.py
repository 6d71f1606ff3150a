"""Plain convolution and dense layers on NHWC tensors, shared by the model
families (counterparts of Flax's ``nn.Conv`` and ``nn.Dense`` as the JAX
package uses them).

Each layer computes in its ``dtype`` (the compute dtype): it casts its input
and its weights to it at each call, as Flax's ``dtype=...`` computes with
``param_dtype`` f32 parameters. Serving holds the weights in the compute
dtype, so the casts do nothing; training holds them in f32 (``create_model(...,
param_dtype=torch.float32)``), so the optimizer updates f32 values. A
:class:`Conv` built with ``dtype`` None is Flax's ``dtype=None`` conv, f32
weights and f32 compute whatever the input (Flax promotes the input with its
f32 parameters). Depthwise taps are
(k, k, C), Flax's (k, k, 1, C) without its I axis. A padding is an int (the
same on every side), explicit ``((top, bottom), (left, right))`` pairs or
``"same"`` (TF ``SAME`` at each call's size, :mod:`.pad`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .kernels import depthwise as D
from .pad import PaddingSpec, resolve_padding


def make_divisible(v, divisor: int = 4, min_value=None, limit_round_down: float = 0.9) -> int:
    """Round a channel count to a multiple of ``divisor`` (the mobilenet
    rule, ``vip_cup_2022_tpu/ops/conv.py::make_divisible``): to the nearest
    multiple, at least ``min_value`` (``divisor`` when None), one multiple
    up where that falls below ``limit_round_down`` of ``v``."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < limit_round_down * v:
        new_v += divisor
    return int(new_v)


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
               padding: PaddingSpec, groups: int = 1) -> torch.Tensor:
    """cuDNN's conv of NHWC x: an int padding inside the conv, pairs or
    ``"same"`` (resolved at x's size) by ``F.pad`` before a VALID one."""
    if not isinstance(padding, int):
        (pt, pb), (pl, pr) = resolve_padding(padding, x.shape[1], x.shape[2], w.shape[-1],
                                             stride)
        x, padding = F.pad(x, (0, 0, pl, pr, pt, pb)), 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w, bias, stride, padding, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


class Linear(nn.Module):
    """y = x W^T (+ b) in the compute dtype ``dtype``, with W (out, in) and
    b cast to it, as Flax's ``Dense(dtype=...)`` casts its input and
    parameters."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Conv(nn.Module):
    """k x k conv on NHWC input with zero padding ``padding`` (0 = VALID;
    an int pads inside cuDNN's conv, pairs or ``"same"`` by ``F.pad`` before
    a VALID one) in ``groups`` groups (Flax's ``feature_group_count``);
    weight (O, I / groups, kh, kw) and bias in the compute dtype (``dtype``,
    f32 when None)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = torch.float32, padding: PaddingSpec = 0,
                 bias: bool = True, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.dtype, self.groups = stride, padding, dtype, groups
        wdtype = dtype or torch.float32
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel, kernel, dtype=wdtype))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=wdtype)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.float32
        b = None if self.bias is None else self.bias.to(dt)
        return _conv_nhwc(x.to(dt), self.weight.to(dt), b, self.stride, self.padding,
                          self.groups)


class ScaledStdConv(nn.Module):
    """NFNet's weight-standardized conv (``ScaledStdConv`` of the JAX
    package, ``vip_cup_2022_tpu/ops/conv.py``) on NHWC input: the raw f32
    ``weight`` (the Flax ``kernel``, (O, I / groups, kh, kw)), the f32
    per-filter ``gain`` and f32 ``bias``. The conv's weight is
    ``(w - mean) * rsqrt(max(var * fan_in, eps)) * (gain * gamma)`` in f32,
    the moments over each filter's (I, kh, kw) (population variance),
    ``fan_in`` = I * kh * kw per group, then cast to the compute dtype
    ``dtype``: the values the JAX forward computes on every call, run on
    cuDNN with the bias cast to ``dtype``. In training mode with grad
    enabled they are computed in the graph at every call, so the weight and
    the gain get their gradients; otherwise (eval mode, or no grad) once per
    weight load, kept until a parameter changes or the module's mode does.
    Not a :class:`Conv`: int8 calibration must not take it for a plain conv
    site, whose weight it would quantize raw."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: PaddingSpec = 0, groups: int = 1, gamma: float = 1.0,
                 dtype: torch.dtype = torch.float32, eps: float = 1e-5):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.gamma, self.dtype, self.eps = gamma, dtype, eps
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel, kernel))
        self.gain = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self._key, self._weight = None, None

    def standardized_weight(self) -> torch.Tensor:
        """The f32 standardized, scaled weight (O, I / groups, kh, kw)."""
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        fan_in = float(math.prod(w.shape[1:]))
        scale = torch.rsqrt(torch.clamp(var * fan_in, min=self.eps)) * (
            self.gain * self.gamma).view(-1, 1, 1, 1)
        return (w - mean) * scale

    def train(self, mode: bool = True) -> "ScaledStdConv":
        self._key, self._weight = None, None
        return super().train(mode)

    def conv_weight(self) -> torch.Tensor:
        """The standardized weight in the compute dtype: in the graph in
        training mode with grad enabled, else cached and recomputed only
        when the raw weight or the gain moved or changed."""
        if self.training and torch.is_grad_enabled():
            return self.standardized_weight().to(self.dtype)
        key = tuple((p.data_ptr(), p._version) for p in (self.weight, self.gain))
        if key != self._key:
            with torch.no_grad():
                self._weight = self.standardized_weight().to(self.dtype)
            self._key = key
        return self._weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(x.to(self.dtype), self.conv_weight(), self.bias.to(self.dtype),
                          self.stride, self.padding, self.groups)


class ZeroInitGain(nn.Module):
    """A scalar f32 ``gain`` (zero at init) that scales x in x's dtype
    (``ZeroInitGain`` of the JAX package)."""

    def __init__(self):
        super().__init__()
        self.gain = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gain.to(x.dtype)


class DepthwiseTaps(nn.Module):
    """A depthwise conv's f32 taps, (k, k, C) as the depthwise kernel reads
    them, and its f32 (C,) bias; the kernel that owns them applies them."""

    def __init__(self, dim: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(kernel, kernel, dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class DepthwiseConv(nn.Module):
    """k x k depthwise conv on NHWC input with zero padding ``padding`` and
    no bias (``apply_depthwise_conv`` of the JAX package); taps (k, k, C) in
    the compute dtype, as Flax's ``nn.Conv(dtype=...)`` rounds its kernel.
    At stride 1 it is the depthwise kernel ``depthwise_conv_nhwc`` (K9) on
    the padding resolved at the input's size: on CUDA the kernel, which
    raises for a shape it does not take, on the CPU its plain version. At
    stride > 1 it is cuDNN's grouped conv, as the JAX package leaves strided
    depthwise convs to XLA. In training K9 runs under autograd
    (:func:`..kernels.depthwise.depthwise_conv_fn`)."""

    def __init__(self, dim: int, kernel: int, padding: PaddingSpec, dtype: torch.dtype,
                 stride: int = 1):
        super().__init__()
        self.padding, self.stride, self.dtype = padding, stride, dtype
        self.weight = nn.Parameter(torch.empty(kernel, kernel, dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, k = x.to(self.dtype), self.weight.to(self.dtype), self.weight.shape[0]
        if self.stride == 1:
            return D.depthwise_conv_fn(x, w, padding=resolve_padding(
                self.padding, x.shape[1], x.shape[2], k, 1))
        w = w.permute(2, 0, 1).unsqueeze(1)  # (C, 1, k, k)
        return _conv_nhwc(x, w, None, self.stride, self.padding, groups=x.shape[-1])


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
