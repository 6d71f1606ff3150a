"""LN -> MLP -> layer scale -> residual in one pass, with the hidden kept on
chip: a CUDA kernel for Hopper in three layouts, and its plain PyTorch
version.

    out = residual + gamma * (fc2(gelu(fc1(LN(x)) + b1)) + b2)

Replaces three TPU kernels of this one function, which differ only in the
TPU layout they were written for:

- ``fused_ln_mlp_residual`` (body ``_lnmlp_kernel``) of
  ``vip_cup_2022_tpu/ops/pallas/convnext_block.py``, on (B, H, W, C) rows;
- ``lnmlp_batchlane`` (``_lnmlp_bl_kernel``) of the experiment tool
  ``tools/exp_convnext_s12.py``, on (H, W, C, B) with the batch on lanes;
- ``lnmlp_chanfirst`` (``_lnmlp_cf_kernel``) of the same tool, on
  (C, H, W, B).

The JAX tool defines the last two inline; the port keeps them here, beside
the first, as wrappers of one CUDA template (``csrc/ln_mlp.cu``): a CTA
stages a tile of 64 rows (32 for C > 384) in shared memory (for the two
strided layouts, loaded along the rows so a warp reads contiguous
addresses), takes a two-pass f32 LayerNorm into bf16, then walks the hidden
in chunks: fc1 chunk on the tensor cores (wmma bf16, f32 accumulation),
+ b1, exact GELU (``erff``), bf16 into shared memory, fc2 accumulated in f32
registers; then (+ b2) x gamma + residual in f32, bf16 out in the input's
layout. The (M, hidden) hidden never reaches device memory, which is what
sets it apart from the two-launch ``ln_fc1_gelu`` + ``fc2_scale_residual``
pair of :mod:`.convnext_block`. What bounds it on the card: 6 M C bytes of
activations against 4 M C hidden bf16 operations (bytes at C = 96,
operations from C = 192 on).

The TPU tiling arguments (``row_tile``, ``tp``, ``lane_tile``) and the GELU
flavour (``gelu``) are not carried over: tiles are the kernel's, and GELU is
exact. Weights follow the port's convention: w1 (hidden, C) and w2
(C, hidden) in bf16; the LN parameters, b1, b2 and gamma in f32. x, residual
and the output are bf16 on the card.

Dispatch: a wrapper runs the plain version only for tensors on the CPU. For
CUDA tensors it launches its kernel or raises; it never falls back. Each
wrapper counts its launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from . import build
from .convnext_block import _check, _check_no_grad, _stream

LAUNCHES: Dict[str, int] = {"fused_ln_mlp_residual": 0, "lnmlp_batchlane": 0,
                            "lnmlp_chanfirst": 0}

WIDTHS = (32, 64, 96, 128, 192, 256, 384, 512, 768)  # C with a kernel instantiation
# each wrapper's layout, as the permutation that takes (B, H, W, C) to it
LAYOUTS = {"fused_ln_mlp_residual": (0, 1, 2, 3), "lnmlp_batchlane": (1, 2, 3, 0),
           "lnmlp_chanfirst": (3, 1, 2, 0)}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_TEN = [_P] * 10  # x, residual, ln_g, ln_b, w1, b1, w2, b2, gamma, out
_SIGNATURES = {
    "ln_mlp_rows": _TEN + [_L, _I, _I, _F, _P],
    "ln_mlp_batchlane": _TEN + [_L, _I, _I, _I, _F, _P],
    "ln_mlp_chanfirst": _TEN + [_L, _I, _I, _F, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ln_mlp")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions: the same function, computed in the inputs' dtype
# ---------------------------------------------------------------------------
def ln_mlp_rows_plain(x: torch.Tensor, residual: torch.Tensor, ln_gamma, ln_beta, w1, b1, w2,
                      b2, ls_gamma, eps: float = 1e-6) -> torch.Tensor:
    """(M, C) rows: two-pass f32 LN, rounded to x's dtype -> Linear(w1
    (hidden, C)) + b1 in f32 -> exact GELU, rounded -> Linear(w2 (C, hidden))
    + b2 in f32 -> x gamma + residual -> x's dtype (``_lnmlp_kernel``)."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps) * ln_gamma.float() + ln_beta.float()).to(dt)
    h = F.linear(y, w1.to(dt)).float() + b1.float()
    h = F.gelu(h, approximate="none").to(dt)
    o = (F.linear(h, w2.to(dt)).float() + b2.float()) * ls_gamma.float()
    return (o + residual.float()).to(dt)


def fused_ln_mlp_residual_plain(dw_out, residual, ln_gamma, ln_beta, w1, b1, w2, b2, ls_gamma,
                                *, eps: float = 1e-6) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C)."""
    c = dw_out.shape[-1]
    out = ln_mlp_rows_plain(dw_out.reshape(-1, c), residual.reshape(-1, c), ln_gamma, ln_beta,
                            w1, b1, w2, b2, ls_gamma, eps)
    return out.view(dw_out.shape)


def lnmlp_batchlane_plain(dw_out, residual, ln_gamma, ln_beta, w1, b1, w2, b2, ls_gamma,
                          *, eps: float = 1e-6) -> torch.Tensor:
    """(H, W, C, B) -> (H, W, C, B); row r = (h W + w) B + b."""
    h, w, c, b = dw_out.shape
    rows = lambda t: t.permute(0, 1, 3, 2).reshape(-1, c)  # noqa: E731
    out = ln_mlp_rows_plain(rows(dw_out), rows(residual), ln_gamma, ln_beta, w1, b1, w2, b2,
                            ls_gamma, eps)
    return out.view(h, w, b, c).permute(0, 1, 3, 2).contiguous()


def lnmlp_chanfirst_plain(dw_out, residual, ln_gamma, ln_beta, w1, b1, w2, b2, ls_gamma,
                          *, eps: float = 1e-6) -> torch.Tensor:
    """(C, H, W, B) -> (C, H, W, B); row r = (h W + w) B + b."""
    c = dw_out.shape[0]
    rows = lambda t: t.reshape(c, -1).t()  # noqa: E731
    out = ln_mlp_rows_plain(rows(dw_out), rows(residual), ln_gamma, ln_beta, w1, b1, w2, b2,
                            ls_gamma, eps)
    return out.t().reshape(dw_out.shape).contiguous()


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on CUDA
# ---------------------------------------------------------------------------
def _checked_args(name: str, x, residual, shape, c, ln_gamma, ln_beta, w1, b1, w2, b2,
                  ls_gamma) -> tuple:
    """Validate what the kernel takes; return (hidden, pointer arguments)."""
    if c not in WIDTHS:
        raise ValueError(f"{name}: channel width {c} has no kernel instantiation "
                         f"(widths {WIDTHS})")
    hidden = w1.shape[0]
    chunk = 128 if c <= 384 else 256  # the kernel's hidden chunk
    if hidden % chunk:
        raise ValueError(f"{name}: hidden width {hidden} is not a multiple of {chunk}")
    dev = x.device
    _check("x", x, torch.bfloat16, shape, dev)
    _check("residual", residual, torch.bfloat16, shape, dev)
    for pname, t in (("ln_gamma", ln_gamma), ("ln_beta", ln_beta), ("b2", b2),
                     ("ls_gamma", ls_gamma)):
        _check(pname, t, torch.float32, (c,), dev)
    _check("w1", w1, torch.bfloat16, (hidden, c), dev)
    _check("b1", b1, torch.float32, (hidden,), dev)
    _check("w2", w2, torch.bfloat16, (c, hidden), dev)
    _check_no_grad(name, x, residual, ln_gamma, ln_beta, w1, b1, w2, b2, ls_gamma)
    ptrs = [t.data_ptr() for t in (x, residual, ln_gamma, ln_beta, w1, b1, w2, b2, ls_gamma)]
    return hidden, ptrs


def _run(symbol: str, counter: str, x: torch.Tensor, ptrs: list, *tail) -> torch.Tensor:
    out = torch.empty_like(x)
    err = getattr(_lib(), symbol)(*ptrs, out.data_ptr(), *tail, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with cudaError {err}")
    LAUNCHES[counter] += 1
    return out


def fused_ln_mlp_residual(dw_out: torch.Tensor, residual: torch.Tensor, ln_gamma, ln_beta, w1,
                          b1, w2, b2, ls_gamma, *, eps: float = 1e-6) -> torch.Tensor:
    """LN -> MLP -> layer scale -> + residual on (B, H, W, C) rows.
    CUDA: dw_out and residual bf16 (B, H, W, C) -> bf16 (B, H, W, C)."""
    if dw_out.device.type == "cpu":
        return fused_ln_mlp_residual_plain(dw_out, residual, ln_gamma, ln_beta, w1, b1, w2, b2,
                                           ls_gamma, eps=eps)
    if dw_out.ndim != 4:
        raise ValueError(f"dw_out must be (B, H, W, C), got {tuple(dw_out.shape)}")
    b, h, w, c = dw_out.shape
    hidden, ptrs = _checked_args("fused_ln_mlp_residual", dw_out, residual, (b, h, w, c), c,
                                 ln_gamma, ln_beta, w1, b1, w2, b2, ls_gamma)
    return _run("ln_mlp_rows", "fused_ln_mlp_residual", dw_out, ptrs, b * h * w, c, hidden,
                float(eps))


def lnmlp_batchlane(dw_out: torch.Tensor, residual: torch.Tensor, ln_gamma, ln_beta, w1, b1,
                    w2, b2, ls_gamma, *, eps: float = 1e-6) -> torch.Tensor:
    """The same function on the batch-lane layout.
    CUDA: dw_out and residual bf16 (H, W, C, B) -> bf16 (H, W, C, B)."""
    if dw_out.device.type == "cpu":
        return lnmlp_batchlane_plain(dw_out, residual, ln_gamma, ln_beta, w1, b1, w2, b2,
                                     ls_gamma, eps=eps)
    if dw_out.ndim != 4:
        raise ValueError(f"dw_out must be (H, W, C, B), got {tuple(dw_out.shape)}")
    h, w, c, b = dw_out.shape
    hidden, ptrs = _checked_args("lnmlp_batchlane", dw_out, residual, (h, w, c, b), c,
                                 ln_gamma, ln_beta, w1, b1, w2, b2, ls_gamma)
    return _run("ln_mlp_batchlane", "lnmlp_batchlane", dw_out, ptrs, h * w * b, c, hidden, b,
                float(eps))


def lnmlp_chanfirst(dw_out: torch.Tensor, residual: torch.Tensor, ln_gamma, ln_beta, w1, b1,
                    w2, b2, ls_gamma, *, eps: float = 1e-6) -> torch.Tensor:
    """The same function on the channel-first layout.
    CUDA: dw_out and residual bf16 (C, H, W, B) -> bf16 (C, H, W, B)."""
    if dw_out.device.type == "cpu":
        return lnmlp_chanfirst_plain(dw_out, residual, ln_gamma, ln_beta, w1, b1, w2, b2,
                                     ls_gamma, eps=eps)
    if dw_out.ndim != 4:
        raise ValueError(f"dw_out must be (C, H, W, B), got {tuple(dw_out.shape)}")
    c, h, w, b = dw_out.shape
    hidden, ptrs = _checked_args("lnmlp_chanfirst", dw_out, residual, (c, h, w, b), c,
                                 ln_gamma, ln_beta, w1, b1, w2, b2, ls_gamma)
    return _run("ln_mlp_chanfirst", "lnmlp_chanfirst", dw_out, ptrs, h * w * b, c, hidden,
                float(eps))
