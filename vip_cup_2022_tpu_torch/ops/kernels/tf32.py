"""The 3xTF32 split of the f32 GEMM kernels (``csrc/tf32_gemm.cuh``).

The tensor cores take f32 only as TF32 (10 bits of mantissa). An f32
product ``a w`` is kept to about 22 bits by splitting each operand as
``hi = rna_tf32(v)``, ``lo = rna_tf32(v - hi)`` and summing three TF32
products, small terms first: ``a_lo w_hi + a_hi w_lo + a_hi w_hi`` (``a_lo
w_lo``, about 2^-22 of ``a w``, is dropped). The kernels split the
activations in registers (``cvt.rna.tf32.f32``); the weights are split
once, here, into two f32 tensors whose K columns are permuted to the
kernels' fragment order (:func:`tf32_weight`), and kept by the blocks
(``quant/dyn_int8.py::Int8Block.tf32_weight``).

:func:`tf32x3_linear` is the plain emulation of the kernels' product: the
three products of the split operands, each exact, summed in f64. The
kernels' plain versions (``ln_fc1_gelu_plain``, ``fc2_scale_residual_plain``,
``ln_qkv_plain``, ``proj_scale_residual_plain``) stay the f32 product itself:
that is the function the TPU kernels compute.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

TF32_DROPPED_BITS = 13  # f32's 23 mantissa bits less TF32's 10
_HALF = 1 << (TF32_DROPPED_BITS - 1)
_MASK = ~((1 << TF32_DROPPED_BITS) - 1)
K_TILE = 32  # f32 of a 128-byte swizzle row: the kernels' K tile


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to TF32, to nearest with ties away from zero (PTX's
    ``cvt.rna.tf32.f32``): half a TF32 step added to the magnitude's bits,
    then the low 13 bits cleared. Infinities stay; NaN is not expected."""
    if v.dtype != torch.float32:
        raise TypeError(f"tf32_round takes f32, got {v.dtype}")
    bits = v.contiguous().view(torch.int32)
    return ((bits + _HALF) & _MASK).view(torch.float32)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): ``hi = tf32_round(v)``, ``lo = tf32_round(v - hi)`` (``v -
    hi`` is exact in f32). ``hi + lo`` is ``v`` within 2^-21 of ``|v|``."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def permute_k(w: torch.Tensor) -> torch.Tensor:
    """(N, K) -> (N, K) in the kernels' fragment order: within each
    32-column tile, logical column ``8 (2p + e) + 4h + t`` holds column ``16p
    + 4t + 2h + e`` (p, e, h in {0, 1}, t in 0..3), so that a thread's TF32 A
    fragment for two k8 steps is one 16-byte chunk of its row."""
    n, k = w.shape
    if k % K_TILE:
        raise ValueError(f"K = {k} is not a multiple of {K_TILE}")
    return w.reshape(n, k // K_TILE, 2, 4, 2, 2).permute(0, 1, 2, 5, 4, 3).reshape(n, k)


class Tf32Weight(NamedTuple):
    """An f32 nn.Linear weight (N, K) split for the 3xTF32 kernels: ``hi`` and
    ``lo`` (N, K) f32, K-permuted (:func:`permute_k`), contiguous."""
    hi: torch.Tensor
    lo: torch.Tensor


@torch.no_grad()
def tf32_weight(w: torch.Tensor) -> Tf32Weight:
    """The kernels' operand pair of an f32 (N, K) weight."""
    if w.dtype != torch.float32 or w.ndim != 2:
        raise TypeError(f"tf32_weight takes an f32 (N, K) weight, got {w.dtype} {tuple(w.shape)}")
    hi, lo = tf32_split(w.detach())
    return Tf32Weight(permute_k(hi).contiguous(), permute_k(lo).contiguous())


def tf32x3_linear(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernels' product of f32 a (M, K) and w (N, K), emulated: ``a_lo
    w_hi^T + a_hi w_lo^T + a_hi w_hi^T`` with each operand split by
    :func:`tf32_split`, in f64 (each TF32 product is exact in f32, and the
    sums of the card's accumulator are f32: this is their exact value),
    rounded to f32."""
    a_hi, a_lo = tf32_split(a.float())
    w_hi, w_lo = tf32_split(w.float())
    d = lambda t: t.double()  # noqa: E731
    out = d(a_lo) @ d(w_hi).T + d(a_hi) @ d(w_lo).T + d(a_hi) @ d(w_hi).T
    return out.float()
