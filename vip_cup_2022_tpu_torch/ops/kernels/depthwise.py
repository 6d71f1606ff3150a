"""Stride-1 depthwise convolution in NHWC: a CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the TPU kernel ``depthwise_conv_nhwc`` (body ``_dw_kernel``) of
``vip_cup_2022_tpu/ops/pallas/depthwise.py``: a k x k tap loop of f32
multiply-adds over an explicitly padded NHWC input, no bias, the output in
x's dtype. The TPU kernel was written for EfficientNet's stride-1 MBConv
depthwise convs; here every stride-1 :class:`..conv.DepthwiseConv` runs it
(EfficientNet's MBConv blocks, GCViT's ReduceSize / FeatExtract branch), and
so does the timing tool :mod:`..tools.exp_dw`.

``depthwise_conv_nhwc`` (``csrc/depthwise.cu``) runs the shared-memory-tiled
template of ``csrc/depthwise.cuh`` that ``dwconv7x7_nhwc`` runs for ConvNeXt,
at k in {3, 5, 7} with no bias, a bf16 output and the given padding: a
persistent CTA keeps one 32-channel slice (the last one a tail where C is
not a multiple of 32), copies each output tile's halo into shared memory by
``cp.async`` (the padding zero-filled), and a thread owns one channel x 4
rows x 8 columns with its k x k taps in registers. :func:`depthwise_plan`
reports the tile plan the launcher takes at an output size. What bounds it
on the card: the bytes at k = 3 and 5, the f32 FMAs at k = 7 (2 k^2 FLOPs
per output element for 4 bytes moved).

Training: :func:`depthwise_conv_fn` (:class:`DepthwiseConvFunction`) runs
:func:`depthwise_conv_nhwc` forward and, backward, the plain version's
gradient in closed form (:func:`depthwise_conv_nhwc_plain_grad`: the
output gradient correlated with the taps into the padded input, and the
taps' gradient summed tap by tap, in f32), which keeps no k^2 copies of
the input as the plain version's autograd would (no backward kernel; the
JAX package trains through XLA's conv).

Dispatch: the wrapper runs the plain version only for tensors on the CPU.
For CUDA tensors it launches its kernel or raises; it never falls back. It
counts its launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from ..pad import Padding
from . import build
from .convnext_block import _check, _check_no_grad, _stream

LAUNCHES: Dict[str, int] = {"depthwise_conv_nhwc": 0}

KERNEL_SIZES = (3, 5, 7)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
PLAN_KEYS = ("strips", "blocks", "tiles_w", "tiles_h", "slices", "copy_bytes")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("depthwise")
    lib.depthwise_conv_nhwc.argtypes = _ARGTYPES
    lib.depthwise_conv_nhwc.restype = ctypes.c_int
    lib.depthwise_conv_nhwc_plan.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.depthwise_conv_nhwc_plan.restype = ctypes.c_int
    return lib


def depthwise_plan(ho: int, wo: int, c: int) -> Dict[str, int]:
    """The tile plan the kernel's launcher takes for a (Ho, Wo) output of C
    channels (``PLAN_KEYS``: column strips of 8 and row blocks of 4 in a
    tile, tiles across and down an image, 32-channel slices, bytes a halo
    copy moves). Asks the built library, so it needs nvcc."""
    out = (_I * len(PLAN_KEYS))()
    if _lib().depthwise_conv_nhwc_plan(ho, wo, c, out) != 0:
        raise ValueError(f"no plan for a {ho} x {wo} x {c} output")
    return dict(zip(PLAN_KEYS, out))


def _taps(kern: torch.Tensor, c: int) -> torch.Tensor:
    """(kh, kw, 1, C) or (kh, kw, C) -> f32 (kh, kw, C)."""
    return kern.reshape(kern.shape[0], kern.shape[1], c).float().contiguous()


def depthwise_conv_nhwc_plain(x: torch.Tensor, kern: torch.Tensor, *,
                              padding: Padding) -> torch.Tensor:
    """The TPU kernel's tap loop: zero-pad, then for each tap an f32
    multiply of the shifted input by the tap's (C,) weights, summed over the
    taps in row-major order; the result in x's dtype."""
    b, h, w, c = x.shape
    wf = _taps(kern, c)
    kh, kw = wf.shape[0], wf.shape[1]
    (pt, pb), (pl, pr) = padding
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            term = xp[:, dy:dy + ho, dx:dx + wo, :].float() * wf[dy, dx]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def depthwise_conv_nhwc(x: torch.Tensor, kern: torch.Tensor, *,
                        padding: Padding) -> torch.Tensor:
    """Stride-1 depthwise conv over NHWC x with taps ``kern`` (kh, kw, 1, C)
    (Flax's layout) or (kh, kw, C) and ``padding`` ((top, bottom), (left,
    right)). CUDA: x bf16 (B, H, W, C), C even, square k in {3, 5, 7} ->
    bf16 (B, Ho, Wo, C); the taps are cast to f32. No backward of its own,
    so it raises where autograd would need one: train through
    :func:`depthwise_conv_fn`."""
    if x.device.type == "cpu":
        return depthwise_conv_nhwc_plain(x, kern, padding=padding)
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    kh, kw = kern.shape[0], kern.shape[1]
    if kh != kw or kh not in KERNEL_SIZES:
        raise ValueError(f"the kernel takes square k x k taps with k in {KERNEL_SIZES}, "
                         f"got {kh} x {kw}")
    if c % 2:
        raise ValueError(f"channel width {c} is not even")
    (pt, pb), (pl, pr) = padding
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    if min(pt, pb, pl, pr) < 0 or ho < 0 or wo < 0:
        raise ValueError(f"padding {padding} with k = {kh} on {h} x {w} gives no output")
    _check("x", x, torch.bfloat16, (b, h, w, c), x.device)
    if kern.device != x.device:
        raise ValueError(f"kern is on {kern.device}, expected {x.device}")
    _check_no_grad("depthwise_conv_nhwc", x, kern)
    taps = _taps(kern, c)
    out = torch.empty((b, ho, wo, c), dtype=torch.bfloat16, device=x.device)
    err = _lib().depthwise_conv_nhwc(x.data_ptr(), taps.data_ptr(), out.data_ptr(), b, h, w, c,
                                     kh, pt, pb, pl, pr, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"depthwise_conv_nhwc: CUDA launch failed with cudaError {err}")
    LAUNCHES["depthwise_conv_nhwc"] += 1
    return out


def depthwise_conv_nhwc_plain_grad(x: torch.Tensor, kern: torch.Tensor, dy: torch.Tensor, *,
                                   padding: Padding):
    """The gradient of :func:`depthwise_conv_nhwc_plain` at (x, kern) for
    the output gradient ``dy``: ``(dx, dkern)``, dx in x's dtype, dkern in
    kern's dtype and shape. Per tap, dy times the tap's (C,) weights is
    added into the padded input's gradient at the tap's shift, and the
    tap's gradient is the sum over (B, Ho, Wo) of dy times the shifted
    input, all in f32; the padding is cropped off at the end."""
    b, h, w, c = x.shape
    wf = _taps(kern, c)
    kh, kw = wf.shape[0], wf.shape[1]
    (pt, pb), (pl, pr) = padding
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    ho, wo = dy.shape[1], dy.shape[2]
    g = dy.float()
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    dw = torch.empty_like(wf)
    for ty in range(kh):
        for tx in range(kw):
            dxp[:, ty:ty + ho, tx:tx + wo, :] += g * wf[ty, tx]
            dw[ty, tx] = (xp[:, ty:ty + ho, tx:tx + wo, :].float() * g).sum(dim=(0, 1, 2))
    dx = dxp[:, pt:pt + h, pl:pl + w, :]
    return dx.to(x.dtype), dw.reshape(kern.shape).to(kern.dtype)


class DepthwiseConvFunction(torch.autograd.Function):
    """Forward :func:`depthwise_conv_nhwc`; backward
    :func:`depthwise_conv_nhwc_plain_grad` at the saved (x, kern)."""

    @staticmethod
    def forward(ctx, x, kern, padding):
        ctx.save_for_backward(x, kern)
        ctx.padding = padding
        return depthwise_conv_nhwc(x, kern, padding=padding)

    @staticmethod
    def backward(ctx, dy):
        x, kern = ctx.saved_tensors
        dx, dkern = depthwise_conv_nhwc_plain_grad(x, kern, dy, padding=ctx.padding)
        return dx, dkern, None


def depthwise_conv_fn(x: torch.Tensor, kern: torch.Tensor, *, padding: Padding) -> torch.Tensor:
    """:func:`depthwise_conv_nhwc` through :class:`DepthwiseConvFunction`,
    differentiable in x and the taps."""
    return DepthwiseConvFunction.apply(x, kern, padding)
