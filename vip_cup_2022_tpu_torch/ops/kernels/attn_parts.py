"""Grouped window attention with removable parts: a CUDA kernel for Hopper
and its plain PyTorch version.

Replaces the TPU kernel of the experiment tool ``tools/exp_attn_parts.py``
(``build``, bodies ``_kernel`` and ``_copy_kernel``), which prices each part
of the grouped window-attention softmax by timing variants with parts
removed. Per (image, window group of g windows, head), over the group's
gN = g N tokens:

    qs = bf16(f32(q) * hd^-0.5);  s = qs k^T (f32)
    [s += bias];  [s -= rowmax(s)];  [p = exp(s)] else p = s
    P = bf16(p);  o = P v, den = sum(P) (f32);  [o /= den]

The bracketed parts are named by ``parts`` (a subset of ``PARTS``); a
removed part gives a wrong output on purpose, as on the TPU. The
multiplications run in bf16 whatever the input dtype (the tool's
``mm_dtype``), the rest in f32. ``attn_parts_copy`` is the tool's ``empty``
variant, q + v.

``attn_parts`` (``csrc/attn_parts.cu``): one CTA per (image, group, head,
64 query rows) with the group's K and V in shared memory, gN padded to 16
with excluded keys; each warp walks the keys in 16 x 16 score tiles, a first
pass for the row max, a second that recomputes the tile, rounds P to bf16
and accumulates P V and sum(P), on the tensor cores (wmma bf16, f32
accumulation), so no score row is kept. The bias is read from memory: the
tool builds it block-diagonal with -1e9 off the diagonal blocks
(:func:`group_bias`), and no block is skipped, since the variants without
it attend across the whole group. What bounds it on the card: the bytes of
q, k, v and the output (the exps on the SFUs are not in that bound).

Dispatch: a wrapper runs the plain version only for tensors on the CPU. For
CUDA tensors it launches its kernel or raises; it never falls back. Each
wrapper counts its launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterable

import numpy as np
import torch

from . import build
from .convnext_block import _check, _check_no_grad, _stream

LAUNCHES: Dict[str, int] = {"attn_parts": 0, "attn_parts_copy": 0}

PARTS = ("bias", "max", "exp", "div")  # bit i of the kernel's mask is PARTS[i]
HEAD_DIM = 32        # the kernel's head width
MAX_GROUP_TOKENS = 1024  # gN whose K and V tiles the kernel holds in shared memory

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "attn_parts": [_P, _P, _P, _P, _P, _L, _I, _I, _I, ctypes.c_float, _I, _P],
    "attn_parts_copy": [_P, _P, _P, _L, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("attn_parts")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def group_bias(heads: int, n: int, g: int) -> np.ndarray:
    """The tool's (heads, gN, gN) f32 bias: a seeded (heads, N, N) window
    bias tiled over the g x g window pairs, kept on the diagonal blocks,
    -1e9 off them (``tools/exp_attn_parts.py::build``)."""
    rng = np.random.RandomState(0)
    bias = rng.randn(heads, n, n).astype(np.float32) * 0.05
    eye = np.kron(np.eye(g, dtype=np.float32), np.ones((n, n), np.float32))
    return np.tile(bias, (1, g, g)) * eye + (1.0 - eye) * np.float32(-1e9)


def _mask(parts: Iterable[str]) -> int:
    parts = set(parts)
    unknown = parts - set(PARTS)
    if unknown:
        raise ValueError(f"unknown attention parts {sorted(unknown)}; known: {PARTS}")
    return sum(1 << i for i, name in enumerate(PARTS) if name in parts)


def attn_parts_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask_bias: torch.Tensor, *, heads: int, n: int, g: int,
                     parts: Iterable[str]) -> torch.Tensor:
    """(B, nWin*N, C) q, k, v and a (heads, gN, gN) bias -> (B, nWin*N, C)
    in k's dtype, the parts in ``parts`` applied (``_kernel``)."""
    parts = set(parts)
    _mask(parts)
    b, toks, c = k.shape
    gn, hd = g * n, c // heads

    def split(t):  # (B, nWin*N, C) -> (B, nWG, heads, gN, hd) in f32
        return t.reshape(b, toks // gn, gn, heads, hd).transpose(2, 3).float()

    qs = (q.float() * hd ** -0.5).to(torch.bfloat16)
    s = torch.matmul(split(qs), split(k).transpose(-1, -2))
    if "bias" in parts:
        s = s + mask_bias.float()
    if "max" in parts:
        s = s - s.amax(-1, keepdim=True)
    p = (torch.exp(s) if "exp" in parts else s).to(torch.bfloat16).float()
    o = torch.matmul(p, split(v))
    if "div" in parts:
        o = o / p.sum(-1, keepdim=True)
    return o.transpose(2, 3).reshape(b, toks, c).to(k.dtype)


def attn_parts_copy_plain(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q + v (``_copy_kernel``)."""
    return q + v


def attn_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask_bias: torch.Tensor, *,
               heads: int, n: int, g: int, parts: Iterable[str]) -> torch.Tensor:
    """Grouped window attention with the parts in ``parts``.
    CUDA: q, k, v bf16 (B, nWin*N, C) contiguous with C = 32 heads and nWin
    a multiple of g, mask_bias f32 (heads, gN, gN), gN <= 1024 -> bf16
    (B, nWin*N, C)."""
    if q.device.type == "cpu":
        return attn_parts_plain(q, k, v, mask_bias, heads=heads, n=n, g=g, parts=parts)
    mask = _mask(parts)
    if q.ndim != 3:
        raise ValueError(f"q must be (B, nWin*N, C), got {tuple(q.shape)}")
    b, toks, c = q.shape
    gn = g * n
    if c != heads * HEAD_DIM or gn > MAX_GROUP_TOKENS or toks % gn:
        raise ValueError(f"attn_parts takes head width {HEAD_DIM}, gN <= {MAX_GROUP_TOKENS} "
                         f"and whole groups; got C = {c}, heads = {heads}, gN = {gn}, "
                         f"tokens = {toks}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, torch.bfloat16, (b, toks, c), q.device)
    _check("mask_bias", mask_bias, torch.float32, (heads, gn, gn), q.device)
    _check_no_grad("attn_parts", q, k, v, mask_bias)
    out = torch.empty_like(q)
    err = _lib().attn_parts(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(),
                            out.data_ptr(), b * toks // gn, heads, gn, c,
                            float((c // heads) ** -0.5), mask, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"attn_parts: CUDA launch failed with cudaError {err}")
    LAUNCHES["attn_parts"] += 1
    return out


def attn_parts_copy(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q + v. CUDA: q and v bf16 of one shape, contiguous, with a multiple of
    8 elements -> bf16."""
    if q.device.type == "cpu":
        return attn_parts_copy_plain(q, v)
    if q.numel() % 8:
        raise ValueError(f"attn_parts_copy takes a multiple of 8 elements, got {q.numel()}")
    _check("q", q, torch.bfloat16, q.shape, q.device)
    _check("v", v, torch.bfloat16, q.shape, q.device)
    _check_no_grad("attn_parts_copy", q, v)
    out = torch.empty_like(q)
    err = _lib().attn_parts_copy(q.data_ptr(), v.data_ptr(), out.data_ptr(), q.numel(),
                                 _stream(q.device))
    if err != 0:
        raise RuntimeError(f"attn_parts_copy: CUDA launch failed with cudaError {err}")
    LAUNCHES["attn_parts_copy"] += 1
    return out
