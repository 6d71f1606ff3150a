"""int8 and bf16 tensor-core GEMMs: the CUDA kernels for Hopper and their
plain PyTorch versions.

Replaces the TPU kernel ``_call`` of ``tools/int8_pallas_spike.py`` with its
three bodies, and runs the int8 sites of post-training quantization
(:mod:`...quant.ptq`) that the JAX package leaves to XLA's int8
``conv_general_dilated`` / ``dot_general`` (``quant/ptq.py``). One template
in ``csrc/int8_gemm.cu`` serves all four:

- ``int8_spike_bf16``: bf16 x (M, K) @ bf16 w (K, N), f32 accumulation ->
  bf16 or f32;
- ``int8_spike_int8``: f32 or bf16 x quantized on load with a static scale
  ``sx`` (``clip(round(x * (1 / sx)), -127, 127)``) @ int8 w (K, N), s32
  accumulation, ``f32(acc) * sx`` -> f32 or bf16;
- ``int8_spike_direct``: int8 x @ int8 w (K, N) -> int32;
- ``ptq_int8_conv``: a PTQ site. x (f32 or bf16) is quantized on load with
  the site's calibrated scale; the weights are int8 per output channel,
  ``(N, Kp)`` with K = (kh, kw, c) contiguous and zero-padded to ``Kp``, a
  multiple of 64 (:func:`pack_weight`); the epilogue is
  ``f32(acc) * colscale[n] (+ bias[n])`` in f32, cast to ``out_dtype``. A
  Dense site or a 1 x 1 stride-1 conv reads x as (M, K) rows; any other conv
  gathers its windows from NHWC x inside the kernel (implicit GEMM, zeros in
  the symmetric padding).

Rounding is the JAX package's: the activation scale's reciprocal is the f64
``1 / s`` rounded once to f32 (:func:`f32_reciprocal`), products round half
to even, and the s32 sum is converted to f32 by round to nearest, so kernel,
plain version and JAX agree bit for bit wherever the f32 result is exact.

Dispatch: a wrapper runs the plain version only for tensors on the CPU;
for CUDA tensors it launches its kernel or raises, and never falls back.
The plain versions compute the int8 products in f64, exact at these
magnitudes (|sum| <= 127^2 K < 2^53). Each wrapper counts its launches in
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .convnext_block import _check, _check_no_grad, _stream

LAUNCHES: Dict[str, int] = {"int8_spike_bf16": 0, "int8_spike_int8": 0,
                            "int8_spike_direct": 0, "ptq_int8_conv": 0}

K_ALIGN = 64  # packed weight rows are padded to the kernel's K slice
MAX_ROWS = 65535 * 128  # the grid's row-tile limit

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("int8_gemm")
    argtypes = {
        "int8_spike_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
        "int8_spike_int8": [_P, _I, _P, _P, _I, _I, _I, _I, _F, _F, _P],
        "int8_spike_direct": [_P, _P, _P, _I, _I, _I, _P],
        "ptq_int8_conv": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1


def f32_reciprocal(s: float) -> float:
    """``1 / s`` in f64, rounded once to f32 (how ``x_f32 * (1.0 / s)``
    multiplies in the JAX package)."""
    return float(np.float32(1.0 / s))


def quantize(x: torch.Tensor, inv_s: float) -> torch.Tensor:
    """int8 ``clip(round(x_f32 * inv_s), -127, 127)``, round half to even."""
    inv = torch.tensor(inv_s, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def _to_int32(acc: torch.Tensor) -> torch.Tensor:
    """f64 sums of int8 products -> int32; rounded first, so a library
    algorithm that is exact only to f64 rounding (cuDNN's) still lands on
    the integer."""
    return torch.round(acc).to(torch.int32)


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (.., K) @ int8 (K, N) -> int32, through f64 (exact here)."""
    return _to_int32(a.double() @ b.double())


def _check_rows(m: int, k: int, n: int) -> None:
    if k % 4 or n % 4:
        raise ValueError(f"K = {k} and N = {n} must be multiples of 4")
    if m > MAX_ROWS:
        raise ValueError(f"M = {m} rows is more than the kernel's grid takes ({MAX_ROWS})")


def _check_spike(name: str, x: torch.Tensor, x_dtypes, w: torch.Tensor, w_dtype) -> tuple:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x (M, K) @ w (K, N), got {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if x.dtype not in x_dtypes:
        raise TypeError(f"{name}: x has dtype {x.dtype}, the kernel takes {x_dtypes}")
    _check("x", x, x.dtype, (m, k), x.device)
    _check("w", w, w_dtype, (k, n), x.device)
    _check_rows(m, k, n)
    _check_no_grad(name, x, w)
    return m, k, n


# ---------------------------------------------------------------------------
# the spike's three bodies
# ---------------------------------------------------------------------------
def int8_spike_bf16_plain(x: torch.Tensor, w: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (x.float() @ w.float()).to(out_dtype)


def int8_spike_int8_plain(x: torch.Tensor, w: torch.Tensor, sx: float,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    acc = _exact_matmul(quantize(x, f32_reciprocal(sx)), w)
    return (acc.float() * torch.tensor(sx, dtype=torch.float32, device=x.device)).to(out_dtype)


def int8_spike_direct_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _exact_matmul(x, w)


def int8_spike_bf16(x: torch.Tensor, w: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``_bf16_kernel``: bf16 x (M, K) @ bf16 w (K, N), f32 accumulation,
    -> ``out_dtype`` (bf16 or f32)."""
    if x.device.type == "cpu":
        return int8_spike_bf16_plain(x, w, out_dtype)
    m, k, n = _check_spike("int8_spike_bf16", x, (torch.bfloat16,), w, torch.bfloat16)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes bf16 or f32")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _launched("int8_spike_bf16", _lib().int8_spike_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), int(out_dtype == torch.float32), m, k, n,
        _stream(x.device)))
    return out


def int8_spike_int8(x: torch.Tensor, w: torch.Tensor, sx: float,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``_int8_kernel``: x (f32 or bf16) quantized with the static scale
    ``sx`` on load, @ int8 w (K, N), s32 accumulation, ``f32(acc) * sx`` ->
    ``out_dtype`` (f32 or bf16)."""
    if x.device.type == "cpu":
        return int8_spike_int8_plain(x, w, sx, out_dtype)
    m, k, n = _check_spike("int8_spike_int8", x, (torch.float32, torch.bfloat16), w, torch.int8)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes bf16 or f32")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _launched("int8_spike_int8", _lib().int8_spike_int8(
        x.data_ptr(), int(x.dtype == torch.float32), w.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.float32), m, k, n, f32_reciprocal(sx), float(sx),
        _stream(x.device)))
    return out


def int8_spike_direct(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_int8_direct_kernel``: int8 x (M, K) @ int8 w (K, N) -> int32."""
    if x.device.type == "cpu":
        return int8_spike_direct_plain(x, w)
    m, k, n = _check_spike("int8_spike_direct", x, (torch.int8,), w, torch.int8)
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    _launched("int8_spike_direct", _lib().int8_spike_direct(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, _stream(x.device)))
    return out


# ---------------------------------------------------------------------------
# the PTQ site
# ---------------------------------------------------------------------------
def pack_weight(qw_kn: torch.Tensor) -> torch.Tensor:
    """int8 (K, N) (a Flax HWIO kernel reshaped, or a Dense kernel) -> the
    kernel's (N, Kp) layout, K contiguous and zero-padded to a multiple of
    :data:`K_ALIGN`."""
    k, n = qw_kn.shape
    kp = -(-k // K_ALIGN) * K_ALIGN
    packed = torch.zeros((n, kp), dtype=torch.int8, device=qw_kn.device)
    packed[:, :k] = qw_kn.t()
    return packed


def _conv_out(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def ptq_int8_conv_plain(x: torch.Tensor, qweight: torch.Tensor, colscale: torch.Tensor,
                        bias: Optional[torch.Tensor], inv_s: float, *, kernel: Optional[int],
                        stride: int = 1, padding: int = 0,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The site's function in plain PyTorch: see :func:`ptq_int8_conv`."""
    q = quantize(x, inv_s)
    n = qweight.shape[0]
    if kernel is None:
        acc = _exact_matmul(q, qweight[:, :x.shape[-1]].t())
    else:
        c = x.shape[-1]
        w = qweight[:, :kernel * kernel * c].reshape(n, kernel, kernel, c).permute(0, 3, 1, 2)
        acc = F.conv2d(q.double().permute(0, 3, 1, 2), w.double(), None, stride, padding)
        acc = _to_int32(acc.permute(0, 2, 3, 1))
    y = acc.float() * colscale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype or x.dtype).contiguous()


def ptq_int8_conv(x: torch.Tensor, qweight: torch.Tensor, colscale: torch.Tensor,
                  bias: Optional[torch.Tensor], inv_s: float, *, kernel: Optional[int],
                  stride: int = 1, padding: int = 0,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One int8 PTQ site. ``kernel`` None: a Dense site, x (..., K) ->
    (..., N); else a ``kernel`` x ``kernel`` conv at ``stride`` with
    symmetric zero ``padding`` on NHWC x (B, H, W, C) -> (B, Ho, Wo, N).
    ``qweight`` int8 (N, Kp) from :func:`pack_weight`, ``colscale`` f32 (N,)
    = ``f32(s_x) * s_w``, ``bias`` f32 (N,) or None, ``inv_s`` the f32
    reciprocal of the activation scale; the output is ``out_dtype`` (x's
    dtype when None). CUDA: x f32 or bf16, K and N multiples of 4 (C for a
    gathered conv)."""
    if x.device.type == "cpu":
        return ptq_int8_conv_plain(x, qweight, colscale, bias, inv_s, kernel=kernel,
                                   stride=stride, padding=padding, out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in (torch.float32, torch.bfloat16) or out_dtype not in (torch.float32,
                                                                           torch.bfloat16):
        raise TypeError(f"ptq_int8_conv takes f32 or bf16 x and output, got {x.dtype} -> "
                        f"{out_dtype}")
    n, kp = qweight.shape
    if kernel is None:
        lead, c = x.shape[:-1], x.shape[-1]
        h = w = ho = wo = 1
        gather = False
        k = c
    else:
        if x.ndim != 4:
            raise ValueError(f"a conv site takes NHWC x (B, H, W, C), got {tuple(x.shape)}")
        b, h, w, c = x.shape
        ho, wo = (_conv_out(h, kernel, stride, padding), _conv_out(w, kernel, stride, padding))
        if ho <= 0 or wo <= 0:
            raise ValueError(f"a {kernel} x {kernel} conv at stride {stride}, padding {padding} "
                             f"gives no output on {h} x {w}")
        lead = (b, ho, wo)
        gather = not (kernel == 1 and stride == 1 and padding == 0)
        k = kernel * kernel * c
    m = int(np.prod(lead))
    if kp % K_ALIGN or kp < k:
        raise ValueError(f"qweight (N, Kp) = {tuple(qweight.shape)} is not packed for K = {k}")
    if c % 4:
        raise ValueError(f"the input width {c} is not a multiple of 4")
    _check_rows(m, k, n)
    _check("x", x, x.dtype, tuple(x.shape), x.device)
    _check("qweight", qweight, torch.int8, (n, kp), x.device)
    _check("colscale", colscale, torch.float32, (n,), x.device)
    if bias is not None:
        _check("bias", bias, torch.float32, (n,), x.device)
    _check_no_grad("ptq_int8_conv", x)
    out = torch.empty((*lead, n), dtype=out_dtype, device=x.device)
    _launched("ptq_int8_conv", _lib().ptq_int8_conv(
        x.data_ptr(), int(x.dtype == torch.float32), qweight.data_ptr(), kp, colscale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.float32), m, k, n, inv_s, int(gather), h, w, c,
        kernel or 1, stride, padding, ho, wo, _stream(x.device)))
    return out
