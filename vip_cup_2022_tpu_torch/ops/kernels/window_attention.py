"""Window attention on (B, H, N, D) q/k/v: a CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the TPU kernel ``window_attention`` (body ``_attention_kernel``) of
``vip_cup_2022_tpu/ops/pallas/window_attention.py``, which the JAX
package's ``WindowAttention`` module calls on every block of GCViT's unfused
path: softmax(q k^T * scale + bias) v per (window, head), windows folded
into B, with an f32 softmax normalised before P.V.

``window_attention`` (``csrc/window_attention.cu``, exported as
``window_attention_bhnd``) instantiates the window-attention template of
``csrc/window_attention.cuh`` on contiguous (N, 32) tiles: persistent CTAs
walk the (window, head) items with the next item's K and V in flight, a
warp owns 16 query rows and keeps their scores, softmax and P in registers
(mma.sync, N padded to a 64, 208 or 224 key tile with masked keys),
and a CTA keeps one head, whose bias it holds in shared memory up to 208
keys. What bounds it on the card: at N = 49 the bytes of q, k, v and the
output; at N = 196 the softmax between the two products (~4 N D FLOPs per
token and head are far below the tensor cores' rate).

In f32 (``VIPTPU_DTYPE=float32``) the wrapper launches
``window_attention_bhnd_f32`` (``csrc/window_attention.cu``), the TPU
kernel's f32 mode: its f32 dots cannot run on the tensor cores, so a CTA
of four warps computes one (window, head) with f32 FMAs on the CUDA cores,
q, k and v in shared memory, four query rows a warp at a time, P in f32.

Training: :func:`window_attention_fn` (:class:`WindowAttentionFunction`)
runs :func:`window_attention` forward and, backward, the gradient of
:func:`window_attention_plain` with respect to q, k, v and the bias,
recomputed from the saved inputs, as ``LayerNormFunction`` does for the LN
(no backward kernel; the JAX package trains through the XLA attention).

Dispatch: the wrapper runs the plain version only for tensors on the CPU.
For CUDA tensors it launches its kernel or raises; it never falls back. It
counts its launches in :data:`LAUNCHES`, one count a symbol.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import build
from .convnext_block import _check, _check_no_grad, _stream

# the kernel's symbol for each dtype of q, k, v (the output takes v's)
SYMBOL = {torch.bfloat16: "window_attention_bhnd", torch.float32: "window_attention_bhnd_f32"}
LAUNCHES: Dict[str, int] = {name: 0 for name in SYMBOL.values()}

HEAD_DIM = 32  # the kernel's head width; every GCViT variant has dim / heads = 32
MAX_WINDOW_TOKENS = 224  # keys per window the kernel holds (N <= 224: 14 x 14 fits)

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, _P]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("window_attention")
    for name in SYMBOL.values():
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.window_attention_bhnd_cut.argtypes = _ARGTYPES[:-1] + [ctypes.c_int, _P]
    lib.window_attention_bhnd_cut.restype = ctypes.c_int
    return lib


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax((f32 q * scale) f32 k^T + bias) v on (B, H, N, D), the softmax
    in f32 and normalised before P.V, P cast to v's dtype, P.V accumulated
    in f32 -> (B, H, N, D) in v's dtype (``_attention_kernel``)."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2)) + bias.float()
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Fused softmax(q k^T * scale + bias) v with windows folded into B.
    CUDA: q, k, v (B, H, N, 32) contiguous, all bf16 or all f32, bias f32
    (H, N, N), N <= 224 -> (B, H, N, 32) in q's dtype. No backward of its
    own, so it raises where autograd would need one: train through
    :func:`window_attention_fn`."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, scale)
    b, heads, n = _check_inputs(q, k, v, bias, q.dtype)
    name = SYMBOL[q.dtype]
    _check_no_grad(name, q, k, v, bias)
    out = torch.empty_like(q)
    err = getattr(_lib(), name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                out.data_ptr(), b * heads, heads, n, float(scale),
                                _stream(q.device))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1
    return out


class WindowAttentionFunction(torch.autograd.Function):
    """Forward :func:`window_attention`; backward the plain version's
    gradient, recomputed from the saved (q, k, v, bias)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return window_attention(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, dout):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = window_attention_plain(*saved, ctx.scale)
        return (*torch.autograd.grad(out, saved, dout), None)


def window_attention_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """:func:`window_attention` through :class:`WindowAttentionFunction`,
    differentiable in q, k, v and the bias."""
    return WindowAttentionFunction.apply(q, k, v, bias, scale)


def window_attention_cut(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                         scale: float, cut: int) -> torch.Tensor:
    """The CUDA kernel stopped after one phase, for the phase timings of
    ``tools/exp_window_attention.py``: ``cut`` 1 after the loads, 2 after
    the scores, 3 after the softmax. The output holds checksums of that
    phase, not attention, and the launch is not counted in :data:`LAUNCHES`.
    CUDA tensors only, as :func:`window_attention` takes them."""
    if q.device.type != "cuda":
        raise ValueError("the phase cuts exist only as CUDA kernels")
    b, heads, n = _check_inputs(q, k, v, bias)
    out = torch.empty_like(q)
    err = _lib().window_attention_bhnd_cut(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           bias.data_ptr(), out.data_ptr(), b * heads, heads, n,
                                           float(scale), int(cut), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"window_attention_bhnd_cut {cut}: CUDA launch failed with "
                           f"cudaError {err}")
    return out


def _check_inputs(q, k, v, bias, dtype=torch.bfloat16):
    """(B, H, N) of ``dtype`` q, k, v (B, H, N, 32) and an f32 (H, N, N) bias
    the kernel takes (bf16, or f32 for the f32 kernel); raises on anything
    else."""
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, N, D), got {tuple(q.shape)}")
    if dtype not in SYMBOL:
        raise TypeError(f"q has dtype {dtype}, the kernel takes bfloat16 or float32")
    b, heads, n, d = q.shape
    if d != HEAD_DIM or n > MAX_WINDOW_TOKENS:
        raise ValueError(f"window attention takes head width {HEAD_DIM} and N <= "
                         f"{MAX_WINDOW_TOKENS}; got D = {d}, N = {n}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, dtype, (b, heads, n, d), q.device)
    _check("bias", bias, torch.float32, (heads, n, n), q.device)
    return b, heads, n
