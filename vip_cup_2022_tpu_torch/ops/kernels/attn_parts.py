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

``attn_parts`` (``csrc/attn_parts.cu``) instantiates the window-attention
template ``csrc/window_attention.cuh`` with the parts as compile-time flags:
with all four it is K5's function. It runs the template's streamed-key
mode at every gN (the tool's g = 8: gN = 392, more keys than K5's
register-resident kernel holds): a warp keeps 16 query rows and walks the
keys 16 at a time in registers, a first pass for the row max and a second that computes
the scores again, rounds P to bf16 and accumulates P V and sum(P)
(``mma.sync`` bf16, f32 accumulation); persistent CTAs each keep one (head,
stripe of query rows) with that stripe of the bias in shared memory
(:func:`stripe_plan`) and walk the groups with a ``cp.async`` ring of K and
V. The bias is an input: the tool builds it block-diagonal with -1e9 off
the diagonal blocks (:func:`group_bias`), and no block is skipped, since the
variants without it attend across the whole group. What bounds it on the
card: by bytes, q, k, v, the output and the bias once; in practice the
per-score softmax work and the shared-memory reads of both passes.

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
from .convnext_block import SMEM_LIMIT, _check, _check_no_grad, _stream

LAUNCHES: Dict[str, int] = {"attn_parts": 0, "attn_parts_copy": 0}

PARTS = ("bias", "max", "exp", "div")  # bit i of the kernel's mask is PARTS[i]
HEAD_DIM = 32        # the kernel's head width
MAX_GROUP_TOKENS = 1024  # gN whose K and V tiles the kernel holds in shared memory
# the template's streamed-key mode (csrc/window_attention.cuh)
MAX_STRIPE_TILES = 8  # 16-row tiles of a stripe
MAX_SPLITS = 4  # warps a row tile's keys are split over
MAX_STREAM_WARPS = 16  # tiles x splits: the warps a CTA may have
# the warps a CTA aims for: at gN = 392, five tiles with two splits were as
# fast as with three and faster than with one, and four tiles lost with four
# splits against two (PERF.md)
STREAM_WARPS = 10

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "attn_parts": [_P, _P, _P, _P, _P, _L, _I, _I, _I, ctypes.c_float, _I] + [_I] * 4 + [_P],
    "attn_parts_cut": [_P, _P, _P, _P, _P, _L, _I, _I, _I, ctypes.c_float] + [_I] * 5 + [_P],
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


@functools.lru_cache(maxsize=None)
def stripe_plan(gn: int) -> dict:
    """The streamed-key mode's plan for groups of ``gn`` tokens: keys padded
    to ``np`` (a multiple of 16), ``stages`` of the K and V ring (2, or 1
    where two stages leave no room for one tile of bias), ``tiles`` 16-row
    tiles a stripe (at most :data:`MAX_STRIPE_TILES`, as many as fit beside
    the ring, the row tiles split evenly over ``stripes``), ``splits`` warps
    over which each tile's keys are split (one CTA fits an SM, and its warps
    hide each other's latencies: as many as bring it to about
    :data:`STREAM_WARPS`, at most :data:`MAX_SPLITS`, and no more than the
    spent stage can take the partial sums of) and the ``smem`` bytes: each
    tile's bias row block in fragment order (np / 8 float4 per lane), the
    ring (np rows of K and of V, 64 bytes each, per stage) and the splits'
    row maxima (16 f32 a warp)."""
    if not 0 < gn <= MAX_GROUP_TOKENS:
        raise ValueError(f"gN = {gn}: the kernel takes 1 ... {MAX_GROUP_TOKENS} tokens a group")
    np_ = -(-gn // 16) * 16
    stage, bias_tile, red = np_ * 2 * HEAD_DIM * 2, np_ // 8 * 32 * 16, MAX_STREAM_WARPS * 64
    stages = 2 if 2 * stage + bias_tile + red <= SMEM_LIMIT else 1
    row_tiles = np_ // 16
    most = min(MAX_STRIPE_TILES, (SMEM_LIMIT - stages * stage - red) // bias_tile)
    stripes = -(-row_tiles // most)
    tiles = -(-row_tiles // stripes)
    handover = tiles * 32 * 18 * 4  # a split's o and l, 18 f32 a lane, passed on in a stage
    splits = max(1, min(MAX_SPLITS, STREAM_WARPS // tiles, np_ // 16, 1 + stage // handover))
    return dict(np=np_, tiles=tiles, splits=splits, stripes=stripes, stages=stages,
                smem=tiles * bias_tile + stages * stage + tiles * splits * 64)


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
    out, args = _launch_args(q, k, v, mask_bias, heads, n, g)
    err = _lib().attn_parts(*args[:10], mask, *args[10:])
    if err != 0:
        raise RuntimeError(f"attn_parts: CUDA launch failed with cudaError {err}")
    LAUNCHES["attn_parts"] += 1
    return out


def attn_parts_cut(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask_bias: torch.Tensor,
                   *, heads: int, n: int, g: int, cut: int) -> torch.Tensor:
    """:func:`attn_parts` with every part, stopped after one phase for the
    phase timings of
    ``tools/exp_attn_parts.py``: ``cut`` 1 after the loads, 2 after pass 1
    (the row max), 3 after pass 2's softmax without P V. The output holds
    checksums, not attention, and the launch is not counted in
    :data:`LAUNCHES`. CUDA tensors only, as :func:`attn_parts` takes them."""
    if q.device.type != "cuda":
        raise ValueError("the phase cuts exist only as CUDA kernels")
    out, args = _launch_args(q, k, v, mask_bias, heads, n, g)
    err = _lib().attn_parts_cut(*args[:-1], int(cut), args[-1])
    if err != 0:
        raise RuntimeError(f"attn_parts_cut {cut}: CUDA launch failed with cudaError {err}")
    return out


def _launch_args(q, k, v, mask_bias, heads: int, n: int, g: int) -> tuple:
    """The output and the launch's arguments (without the parts mask) for
    tensors the kernel takes; raises on anything else."""
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
    plan = stripe_plan(gn)
    out = torch.empty_like(q)
    return out, (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(), out.data_ptr(),
                 b * toks // gn, heads, gn, c, float((c // heads) ** -0.5), plan["tiles"],
                 plan["splits"], plan["stripes"], plan["stages"], _stream(q.device))


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
