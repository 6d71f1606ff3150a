"""LayerNorm over the last axis: a CUDA kernel for Hopper, its plain PyTorch
version, and the autograd function that the port's ``LayerNorm`` calls.

Replaces the TPU kernel of ``vip_cup_2022_tpu/ops/pallas/norms.py``:
``fused_layernorm`` -> ``_pallas_ln2`` (body ``_ln_kernel``), one pass that
reads the input once and writes the normalised output once, with two-pass
f32 statistics over the row; its ``custom_vjp`` takes the gradient of the
reference LN, recomputed from the saved (x, g, b).

- ``layer_norm`` (``csrc/layernorm.cu``): x (M, C) bf16 or f32 with f32
  weight and bias -> the same dtype as x. A segment of lanes owns a row and
  keeps it in registers, so x is read once; narrow rows (C = 64) share a
  warp; a width that is not a multiple of the 16-byte vector (8 bf16, 4
  f32) takes the same kernel on scalar elements. What bounds it on the
  card: memory bandwidth (it moves 2 * M * C * itemsize bytes for ~8 f32
  operations per element).
- :class:`LayerNormFunction`: forward through :func:`layer_norm` (the kernel
  on CUDA, the plain version on the CPU), backward the gradient of
  :func:`layer_norm_plain` at the saved inputs, as the JAX ``custom_vjp``.

Dispatch: the wrapper runs the plain version only for tensors on the CPU.
For CUDA tensors it launches its kernel or raises; it never falls back. It
counts its launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import build
from .convnext_block import _check, _stream

LAUNCHES: Dict[str, int] = {"layer_norm": 0}

MAX_WIDTH = {torch.bfloat16: 2048, torch.float32: 1024}  # 32 lanes x 8 vectors of 16 bytes
_SYMBOL = {torch.bfloat16: "layer_norm_bf16", torch.float32: "layer_norm_f32"}

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, _P]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("layernorm")
    for name in _SYMBOL.values():
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """LN over the last axis: two-pass f32 mean and variance, (x - mean) *
    rsqrt(var + eps) * weight + bias, in x's dtype (``_ln_kernel`` and
    ``_ref_ln`` of the JAX package)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LN over the last axis of x (..., C). CUDA: x bf16 or f32, contiguous,
    1 <= C <= :data:`MAX_WIDTH`, weight and bias f32 (C,) -> x's dtype."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    c = x.shape[-1]
    if x.dtype not in _SYMBOL:
        raise TypeError(f"x has dtype {x.dtype}, the kernel takes bfloat16 or float32")
    if not 1 <= c <= MAX_WIDTH[x.dtype]:
        raise ValueError(f"channel width {c} is not in 1 ... {MAX_WIDTH[x.dtype]} for {x.dtype}")
    _check("x", x, x.dtype, x.shape, x.device)
    _check("weight", weight, torch.float32, (c,), x.device)
    _check("bias", bias, torch.float32, (c,), x.device)
    out = torch.empty_like(x)
    err = getattr(_lib(), _SYMBOL[x.dtype])(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                             out.data_ptr(), x.numel() // c, c, float(eps),
                                             _stream(x.device))
    if err != 0:
        raise RuntimeError(f"layer_norm: CUDA launch failed with cudaError {err}")
    LAUNCHES["layer_norm"] += 1
    return out


class LayerNormFunction(torch.autograd.Function):
    """Forward :func:`layer_norm`; backward the plain LN's gradient,
    recomputed from the saved (x, weight, bias)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return layer_norm(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = layer_norm_plain(*saved, ctx.eps)
        return (*torch.autograd.grad(y, saved, dy), None)


def fused_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LN over the last axis through :class:`LayerNormFunction` (the JAX
    package's ``fused_layernorm``)."""
    return LayerNormFunction.apply(x, weight, bias, eps)
