"""GCViT window-block kernels: CUDA for Hopper, with their plain PyTorch versions.

Replaces the four TPU kernels of the JAX package's GCViT block
(``vip_cup_2022_tpu/ops/pallas/gcvit_block.py``):

- ``ln_dense`` (body ``_ln_dense_kernel``): LN1 + the qkv projection, split
  into q/k/v (or k/v in global-query blocks);
- ``grouped_window_attention`` (bodies ``_attn_kernel``,
  ``_attn_kernel_perwin``): softmax(q k^T * hd^-1/2 + rel-pos bias) v per
  window and head, with the per-image global query of ``q_is_global``;
- ``proj_res_ln_mlp`` (body ``_tail_kernel``): proj + gamma1 residual, LN2,
  MLP, gamma2 residual;
- ``mono_window_transformer_block`` (body ``_mono_kernel``): the same three
  stages in one program per image, "identical math to the three-kernel
  pipeline".

One family of five launches covers all four (:func:`window_transformer_block`):

1. ``ln_qkv`` (``csrc/gcvit_block.cu``): two-pass f32 LN of bf16 rows into
   shared memory as bf16, a wgmma product against W_qkv with f32
   accumulation, + bias, written as separate (M, C) q, k, v: the wgmma +
   TMA engine of ``csrc/hopper_gemm.cuh`` that the MLP GEMMs run on, with
   its LN reading bf16 x and a bias-only epilogue, on the plan of
   :func:`.convnext_block.mlp_gemm_plan` (kind "qkv": column tiles divide
   C, so each lies in one output);
2. ``window_attention`` (``csrc/gcvit_block.cu``, the template of
   ``csrc/window_attention.cuh`` on token rows): persistent CTAs walk the
   (window, head) items with the next item's K and V in flight; a warp owns
   16 query rows and keeps their scores, softmax and P in registers, N = 49
   padded to a 64-key tile and 196 to 208; a CTA keeps one head and its
   bias in shared memory;
3. ``proj_scale_residual`` (``csrc/gcvit_block.cu``): r1 = x + gamma1 *
   (a W_p^T + b_p), written in f32 (the TPU kernel never rounds r1): the
   engine's residual GEMM (``fc2_scale_residual``'s kernel) with K = C and
   an f32 output, W_p held in shared memory where four A stages still fit
   beside it (plan kind "proj");
4. ``ln_fc1_gelu`` and 5. ``fc2_scale_residual`` of
   :mod:`.convnext_block` on the f32 r1 (eps 1e-5, f32 residual). All
   three GEMMs of the block run on the wgmma + TMA engine of
   ``csrc/hopper_gemm.cuh``.

What bounds them on the card: the block does few FLOPs per byte at C = 64
and 128 (the qkv and proj GEMMs have K = C), so L1 and L2 are bound by
memory traffic, and the attention by its 49 x 49 x 32 per-head tiles, far
below a tensor-core tile's appetite. What this simple design leaves on the
table: q/k/v, the attention output, the f32 r1 and the (M, 3C) hidden each
make a round trip through device memory, which the TPU's monoblock kept in
VMEM.

Dispatch: a wrapper runs the plain version only for tensors on the CPU. For
CUDA tensors it launches its kernel or raises; it never falls back. Each
wrapper counts its launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from . import convnext_block as CK
from .convnext_block import _check, _check_width, _stream

LAUNCHES: Dict[str, int] = {"ln_qkv": 0, "window_attention": 0, "proj_scale_residual": 0}

HEAD_DIM = 32  # the attention kernel's head width; every GCViT variant has dim / heads = 32
MAX_WINDOW_TOKENS = 224  # keys per window the attention kernel holds (N <= 224: 14 x 14 fits)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ln_qkv": [_P] * 8 + [_I, _I, _I, _F] + [_I] * 5 + [_P],  # + the plan
    "window_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "proj_scale_residual": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],  # + the plan
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("gcvit_block")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, *args) -> None:
    err = getattr(_lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# plain PyTorch versions: the same functions, computed in the inputs' dtype
# ---------------------------------------------------------------------------
def ln_qkv_plain(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor, eps: float) -> Tuple[torch.Tensor, ...]:
    """(M, C) -> LN (two-pass, f32) -> Linear(w (S*C, C), b) -> S (M, C)
    outputs in w's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps) * ln_weight + ln_bias).to(w.dtype)
    o = (F.linear(y, w).float() + b).to(w.dtype)
    return tuple(part.contiguous() for part in o.chunk(w.shape[0] // x.shape[1], dim=-1))


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, n: int, scale: float,
                           q_is_global: bool = False) -> torch.Tensor:
    """softmax(q k^T + bias) v per window and head on (B, nWin*N, C) tokens,
    columns [head][head_dim]; q is scaled in f32 and rounded to k's dtype.
    With ``q_is_global`` q is (B, N, C), one query per image for all its
    windows. Returns (B, nWin*N, C) in v's dtype."""
    b, toks, c = k.shape
    heads = bias.shape[0]
    nwin, hd = toks // n, c // heads

    def split(t):  # (B, nWin*N, C) -> (B, nWin, heads, N, hd)
        return t.reshape(b, -1, n, heads, hd).transpose(2, 3)

    qs = split((q.float() * scale).to(k.dtype))
    s = torch.matmul(qs, split(k).transpose(-1, -2)).float() + bias.float()
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(p, split(v))  # (B, nWin, heads, N, hd)
    return o.transpose(2, 3).reshape(b, nwin * n, c)


def proj_scale_residual_plain(a: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                              gamma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x + gamma * (a wp^T + bp) on (M, C) rows, in f32."""
    return (F.linear(a, wp).float() + bp) * gamma + x.float()


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on CUDA
# ---------------------------------------------------------------------------
def ln_qkv(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
           w: torch.Tensor, b: torch.Tensor, eps: float) -> Tuple[torch.Tensor, ...]:
    """LN over C + Linear C -> S*C on rows, split into S (M, C) outputs (q, k,
    v for S = 3; k, v for S = 2). CUDA: x bf16 (M, C), LN params f32 (C,),
    w bf16 (S*C, C), b f32 (S*C,) -> bf16."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, ln_weight, ln_bias, w, b, eps)
    if x.ndim != 2:
        raise ValueError(f"x must be (M, C), got {tuple(x.shape)}")
    m, c = x.shape
    CK._check_rows(m)
    _check_width(c)
    s = w.shape[0] // c
    if s not in (2, 3) or w.shape[0] != s * c:
        raise ValueError(f"w must be (2C or 3C, C) for C = {c}, got {tuple(w.shape)}")
    _check("x", x, torch.bfloat16, (m, c), x.device)
    _check("ln_weight", ln_weight, torch.float32, (c,), x.device)
    _check("ln_bias", ln_bias, torch.float32, (c,), x.device)
    _check("w", w, torch.bfloat16, (s * c, c), x.device)
    _check("b", b, torch.float32, (s * c,), x.device)
    outs = [torch.empty((m, c), dtype=torch.bfloat16, device=x.device) for _ in range(s)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - s)
    _launch("ln_qkv", x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w.data_ptr(),
            b.data_ptr(), *ptrs, m, c, s, float(eps), *CK._ln_plan_args(c, s * c, "qkv"),
            _stream(x.device))
    return tuple(outs)


def ln_qkv_cut(x, ln_weight, ln_bias, w, b, eps: float, cut: int) -> Tuple[torch.Tensor, ...]:
    """A phase cut of the ``ln_qkv`` kernel on CUDA tensors at GCViTTiny's
    widths (column tiles of 64 and 128): 0 loads, 1 + LN, 2 + products, 3
    the kernel itself, 5 the kernel without its stores
    (``csrc/mlp_gemm_cuts.cu``). Timing only: except at 3 the outputs hold
    nothing meaningful; counted in :data:`LAUNCHES` only at 3."""
    if cut == 3:
        return ln_qkv(x, ln_weight, ln_bias, w, b, eps)
    m, c = x.shape
    s = w.shape[0] // c
    outs = [torch.empty((m, c), dtype=torch.bfloat16, device=x.device) for _ in range(s)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - s)
    lib = CK._cut_lib()
    err = lib.ln_qkv_cut(x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w.data_ptr(),
                         b.data_ptr(), *ptrs, m, c, s, float(eps),
                         *CK._ln_plan_args(c, s * c, "qkv"), cut, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"ln_qkv cut {cut}: CUDA launch failed with cudaError {err}")
    return tuple(outs)


def proj_scale_residual_cut(a, wp, bp, gamma, x, cut: int) -> torch.Tensor:
    """A phase cut of the ``proj_scale_residual`` kernel on CUDA tensors at
    GCViTTiny's widths (column tiles of 64 and 128): 0 loads, 2 + products,
    3 the kernel itself, 5 the kernel without its stores
    (``csrc/mlp_gemm_cuts.cu``). Timing only: except at 3 the output holds
    nothing meaningful; counted in :data:`LAUNCHES` only at 3."""
    if cut == 3:
        return proj_scale_residual(a, wp, bp, gamma, x)
    m, c = a.shape
    out = torch.empty((m, c), dtype=torch.float32, device=a.device)
    err = CK._cut_lib().proj_scale_residual_cut(
        a.data_ptr(), wp.data_ptr(), bp.data_ptr(), gamma.data_ptr(), x.data_ptr(),
        out.data_ptr(), m, c, *CK._proj_plan_args(c), cut, _stream(a.device))
    if err != 0:
        raise RuntimeError(f"proj_scale_residual cut {cut}: CUDA launch failed with cudaError {err}")
    return out


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     n: int, scale: float, q_is_global: bool = False) -> torch.Tensor:
    """Window attention on (B, nWin*N, C) tokens with a (heads, N, N) f32
    rel-pos bias. CUDA: q, k, v bf16 (q (B, N, C) with ``q_is_global``),
    head width 32, N <= 224 -> bf16 (B, nWin*N, C)."""
    if k.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, n, scale, q_is_global)
    if k.ndim != 3:
        raise ValueError(f"k must be (B, nWin*N, C), got {tuple(k.shape)}")
    b, toks, c = k.shape
    heads = bias.shape[0]
    if toks % n or c != heads * HEAD_DIM or n > MAX_WINDOW_TOKENS:
        raise ValueError(f"window attention takes N <= {MAX_WINDOW_TOKENS} dividing the "
                         f"{toks} tokens and C = heads * {HEAD_DIM}; got N = {n}, C = {c}, "
                         f"heads = {heads}")
    _check("k", k, torch.bfloat16, (b, toks, c), k.device)
    _check("v", v, torch.bfloat16, (b, toks, c), k.device)
    _check("q", q, torch.bfloat16, (b, n, c) if q_is_global else (b, toks, c), k.device)
    _check("bias", bias, torch.float32, (heads, n, n), k.device)
    out = torch.empty((b, toks, c), dtype=torch.bfloat16, device=k.device)
    _launch("window_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, toks // n, n, c, heads, float(scale), int(q_is_global),
            _stream(k.device))
    return out


def proj_scale_residual(a: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                        gamma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """r1 = x + gamma * (a wp^T + bp) on rows. CUDA: a and x bf16 (M, C), wp
    bf16 (C, C), bp and gamma f32 (C,) -> f32 (M, C)."""
    if a.device.type == "cpu":
        return proj_scale_residual_plain(a, wp, bp, gamma, x)
    if a.ndim != 2:
        raise ValueError(f"a must be (M, C), got {tuple(a.shape)}")
    m, c = a.shape
    CK._check_rows(m)
    _check_width(c)
    _check("a", a, torch.bfloat16, (m, c), a.device)
    _check("wp", wp, torch.bfloat16, (c, c), a.device)
    _check("bp", bp, torch.float32, (c,), a.device)
    _check("gamma", gamma, torch.float32, (c,), a.device)
    _check("x", x, torch.bfloat16, (m, c), a.device)
    out = torch.empty((m, c), dtype=torch.float32, device=a.device)
    _launch("proj_scale_residual", a.data_ptr(), wp.data_ptr(), bp.data_ptr(), gamma.data_ptr(),
            x.data_ptr(), out.data_ptr(), m, c, *CK._proj_plan_args(c), _stream(a.device))
    return out


def window_transformer_block(x: torch.Tensor, q_global: Optional[torch.Tensor], *, n: int,
                             ln1_weight, ln1_bias, wqkv, bqkv, bias, wp, bp, gamma1,
                             ln2_weight, ln2_bias, w1, b1, w2, b2, gamma2,
                             scale: Optional[float] = None, eps: float = 1e-5) -> torch.Tensor:
    """One GCViT block on window-ordered tokens x (B, nWin*N, C) through the
    five wrappers: r1 = x + gamma1 * proj(attn(LN1 x)) in f32, then
    r1 + gamma2 * fc2(gelu(fc1(LN2 r1))). ``q_global`` (B, N, C) makes it a
    global-query block (W_qkv is then the (2C, C) k/v projection). Weights
    in the nn.Linear layout; ``bias`` the dense (heads, N, N) rel-pos bias."""
    b, toks, c = x.shape
    heads = bias.shape[0]
    scale = scale if scale is not None else (c // heads) ** -0.5
    x2 = x.reshape(b * toks, c)
    parts = ln_qkv(x2, ln1_weight, ln1_bias, wqkv, bqkv, eps)
    if q_global is None:
        q, k, v = (p.view(b, toks, c) for p in parts)
    else:
        q = q_global
        k, v = (p.view(b, toks, c) for p in parts)
    attn = window_attention(q, k, v, bias, n, scale, q_is_global=q_global is not None)
    r1 = proj_scale_residual(attn.view(b * toks, c), wp, bp, gamma1, x2)
    hidden = CK.ln_fc1_gelu(r1, ln2_weight, ln2_bias, w1, b1, eps)
    return CK.fc2_scale_residual(hidden, w2, b2, gamma2, r1).view(b, toks, c)
