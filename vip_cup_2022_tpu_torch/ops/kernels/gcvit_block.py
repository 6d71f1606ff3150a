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

The f32 mode (``VIPTPU_DTYPE=float32``: the TPU kernels' GEMM dtype follows
x's) is the same five launches on f32 kernels: ``ln_qkv_f32`` and
``proj_scale_residual_f32`` on the 3xTF32 wgmma engine of
``csrc/tf32_gemm.cuh`` (kinds kQkv and kResidual with K = C: the f32
product as three TF32 products of split operands, the activations split in
registers, the weights split once into a :class:`.tf32.Tf32Weight` pair that
the caller passes as ``w_split`` or the wrapper makes; plans
:func:`.convnext_block.tf32_gemm_plan` "qkv" and "proj"),
``window_attention_f32`` (``csrc/tf32_attention.cuh``: both products as
3xTF32 ``mma.sync`` m16n8k8, a warp a 16-row query tile of a (window, head)
item with its scores in registers, P handed from the scores' accumulators
to P.V unshuffled, the next item's q, k and v by ``cp.async`` under this
one's math, P.V divided by the row sum after, as the TPU kernel's default
"mxu" softmax does; CTA plan :func:`tf32_attention_plan`), then
:mod:`.convnext_block`'s ``ln_fc1_gelu_f32`` and ``fc2_scale_residual_f32``
(the same engine).

The mixed modes (``VIPTPU_GCVIT_MM``: the TPU kernels' GEMM operands in the
other dtype than the activations, which keep theirs) are the same five
launches, each wrapper told the GEMM dtype ``mm_dtype`` (default the
activations' dtype, as the JAX package's ``force_mm_dtype``) and given its
weights in it:

- ``mm_dtype`` f32 on bf16 activations: ``ln_qkv_mmf32`` (bf16 x, f32 q, k,
  v), ``window_attention_mmf32`` (f32 q, k, v, or a bf16 global query ->
  bf16), ``proj_scale_residual_mmf32`` (bf16 attention output and x -> f32
  r1): the 3xTF32 kernels on a bf16 A tile widened in registers (the
  projection's bf16 A is exact in TF32: two passes); then
  ``ln_fc1_gelu_f32`` and ``fc2_scale_residual_mmf32`` (-> bf16), the
  3xTF32 MLP; the attention is ``window_attention_f32``'s kernel with a
  bf16 output. q, k and v stay f32 between
  the kernels, as in the TPU's monoblock, the route the JAX package takes at
  every GCViTTiny level (its three-kernel pipeline would round them to
  bf16);
- ``mm_dtype`` bf16 on f32 activations: ``ln_qkv_mmbf16`` (f32 q, k, v; at
  C = 32 and 64 each consumer warpgroup's f32 tile staged in shared memory
  and stored by TMA, the next row tile of x prefetched into L2: the
  engine's ``ln_qkv_tma_kernel``, plan kind "qkv_tma"; elsewhere the LN
  kernel's f32 outputs stored from the accumulators),
  ``window_attention_mmbf16`` (f32 in and out, k, v and the scaled q
  rounded to bf16 on load), ``proj_scale_residual_mmbf16`` (the f32
  attention output by TMA into the ring, each lane's fragment rounded to
  bf16 in registers), ``ln_fc1_gelu``, ``fc2_scale_residual_mmbf16`` (->
  f32); the two residual GEMMs on the engine's ``tma_res_kernel``, whose
  f32 residual comes in and output goes out by TMA (plan kinds "proj_tma"
  and "res_tma").

A wrapper picks its kernel by the activations' dtype and ``mm_dtype``.

Dispatch: a wrapper runs the plain version only for tensors on the CPU. For
CUDA tensors it launches its kernel or raises; it never falls back. Each
wrapper counts its launches in :data:`LAUNCHES`, one count a symbol.
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
from .tf32 import Tf32Weight

LAUNCHES: Dict[str, int] = {"ln_qkv": 0, "window_attention": 0, "proj_scale_residual": 0,
                            "ln_qkv_f32": 0, "window_attention_f32": 0,
                            "proj_scale_residual_f32": 0,
                            "ln_qkv_mmf32": 0, "window_attention_mmf32": 0,
                            "proj_scale_residual_mmf32": 0,
                            "ln_qkv_mmbf16": 0, "window_attention_mmbf16": 0,
                            "proj_scale_residual_mmbf16": 0}

HEAD_DIM = 32  # the attention kernel's head width; every GCViT variant has dim / heads = 32
MAX_WINDOW_TOKENS = 224  # keys per window the attention kernel holds (N <= 224: 14 x 14 fits)

# the f32-product attention (csrc/tf32_attention.cuh): a warp a 16-row tile of an item's
# queries, keys in tiles of 8, q, k and v rows of 128 bytes in a two-stage cp.async ring
TF32_ATTN_ROWS, TF32_ATTN_KEYS, TF32_ATTN_ROW_BYTES, TF32_ATTN_STAGES = 16, 8, 128, 2
TF32_ATTN_HELD_TILES = ((64, 8), (200, 25), (224, 28))  # (N up to, key tiles a kernel holds)


def tf32_attention_plan(n: int) -> dict:
    """The CTA of ``window_attention_f32`` / ``_mmf32`` at N tokens a window
    (``csrc/tf32_attention.cuh`` computes the same): ``warps`` (one a
    16-row query tile), ``key_tiles`` of 8 keys, ``held_tiles`` (the
    instantiation's register tiles: 4 f32 of scores a lane each),
    ``stages`` of q, k and v (``stage`` bytes each: rows padded to 16 and
    8, 128 bytes a row) and ``smem`` bytes."""
    if not 1 <= n <= MAX_WINDOW_TOKENS:
        raise ValueError(f"the f32 attention takes 1 <= N <= {MAX_WINDOW_TOKENS}, got {n}")
    warps, key_tiles = -(-n // TF32_ATTN_ROWS), -(-n // TF32_ATTN_KEYS)
    held = next(t for top, t in TF32_ATTN_HELD_TILES if n <= top)
    stage = (warps * TF32_ATTN_ROWS + 2 * key_tiles * TF32_ATTN_KEYS) * TF32_ATTN_ROW_BYTES
    return dict(warps=warps, key_tiles=key_tiles, held_tiles=held, stages=TF32_ATTN_STAGES,
                stage=stage, smem=TF32_ATTN_STAGES * stage)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ln_qkv": [_P] * 8 + [_I, _I, _I, _F] + [_I] * 5 + [_P],  # + the plan
    "window_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "proj_scale_residual": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],  # + the plan
    # the 3xTF32 kernels: the weight as its pair (W_hi, W_lo), + the plan
    "ln_qkv_f32": [_P] * 9 + [_I, _I, _I, _F] + [_I] * 3 + [_P],
    "window_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "proj_scale_residual_f32": [_P] * 7 + [_I] * 5 + [_P],
    "ln_qkv_mmf32": [_P] * 9 + [_I, _I, _I, _F] + [_I] * 3 + [_P],
    "window_attention_mmf32": [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P],
    "proj_scale_residual_mmf32": [_P] * 7 + [_I] * 5 + [_P],
    "ln_qkv_mmbf16": [_P] * 8 + [_I, _I, _I, _F] + [_I] * 6 + [_P],  # + the plan
    "window_attention_mmbf16": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    "window_attention_f32_cut": [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P],  # + the cut
    "proj_scale_residual_mmbf16": [_P] * 6 + [_I] * 5 + [_P],
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


def qkv_dtype(x_dtype: torch.dtype, mm_dtype: torch.dtype) -> torch.dtype:
    """The dtype ``ln_qkv`` writes q, k, v in: bf16 when the activations and
    the GEMMs are bf16, else f32 (the TPU's monoblock keeps its f32 q, k, v
    when either is f32; they reach the attention as f32 or rounded there)."""
    return torch.bfloat16 if x_dtype == mm_dtype == torch.bfloat16 else torch.float32


def mixed_linear(a: torch.Tensor, w: torch.Tensor, mm_dtype: torch.dtype) -> torch.Tensor:
    """a w^T as the mixed modes' kernels (and the TPU's dots) compute it:
    both operands rounded to ``mm_dtype``, exact products, f32 sums."""
    return F.linear(a.to(mm_dtype).float(), w.to(mm_dtype).float())


# ---------------------------------------------------------------------------
# plain PyTorch versions: the same functions, computed in the inputs' dtype
# (the mixed modes: the operands rounded to mm_dtype, the rest in f32)
# ---------------------------------------------------------------------------
def ln_qkv_plain(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor, eps: float,
                 mm_dtype: Optional[torch.dtype] = None,
                 w_split: Optional[Tf32Weight] = None) -> Tuple[torch.Tensor, ...]:
    """(M, C) -> LN (two-pass, f32) -> Linear(w (S*C, C), b) -> S (M, C)
    outputs in :func:`qkv_dtype`; the product in ``mm_dtype`` (default w's):
    in f32 the f32 product (TF32 off), the function the 3xTF32 kernels keep
    to about 22 bits. ``w_split`` (their operand pair) is not read."""
    mm = mm_dtype or w.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * ln_weight + ln_bias
    if mm == x.dtype:
        o = (F.linear(y.to(mm), w.to(mm)).float() + b).to(mm)
    else:
        o = (mixed_linear(y, w, mm) + b).to(qkv_dtype(x.dtype, mm))
    return tuple(part.contiguous() for part in o.chunk(w.shape[0] // x.shape[1], dim=-1))


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, n: int, scale: float,
                           q_is_global: bool = False, mm_dtype: Optional[torch.dtype] = None,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """softmax(q k^T + bias) v per window and head on (B, nWin*N, C) tokens,
    columns [head][head_dim]; q is scaled in f32 and rounded to the product
    dtype ``mm_dtype`` (default k's). With ``q_is_global`` q is (B, N, C),
    one query per image for all its windows. Returns (B, nWin*N, C) in
    ``out_dtype`` (default k's). In a mixed mode (``mm_dtype`` or
    ``out_dtype`` other than k's) k and v are rounded to ``mm_dtype``, P is
    exp(s - max) rounded to it and divided after P.V by the f32 sum of its
    rounded values, as the TPU kernel's "mxu" softmax does."""
    b, toks, c = k.shape
    heads = bias.shape[0]
    nwin, hd = toks // n, c // heads
    mm, out = mm_dtype or k.dtype, out_dtype or k.dtype

    def split(t):  # (B, nWin*N, C) -> (B, nWin, heads, N, hd)
        return t.reshape(b, -1, n, heads, hd).transpose(2, 3)

    qs = split((q.float() * scale).to(mm))
    if mm == out == k.dtype:
        s = torch.matmul(qs, split(k).transpose(-1, -2)).float() + bias.float()
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.matmul(p, split(v))  # (B, nWin, heads, N, hd)
        return o.transpose(2, 3).reshape(b, nwin * n, c)
    s = torch.matmul(qs.float(), split(k.to(mm)).float().transpose(-1, -2)) + bias.float()
    p = torch.exp(s - s.amax(-1, keepdim=True)).to(mm).float()
    o = torch.matmul(p, split(v.to(mm)).float()) / p.sum(-1, keepdim=True)
    return o.transpose(2, 3).reshape(b, nwin * n, c).to(out)


def proj_scale_residual_plain(a: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                              gamma: torch.Tensor, x: torch.Tensor,
                              mm_dtype: Optional[torch.dtype] = None,
                              w_split: Optional[Tf32Weight] = None) -> torch.Tensor:
    """x + gamma * (a wp^T + bp) on (M, C) rows, in f32; the product in
    ``mm_dtype`` (default wp's). ``w_split`` (the 3xTF32 kernels' operand
    pair) is not read."""
    mm = mm_dtype or wp.dtype
    prod = F.linear(a, wp.to(mm)) if mm == a.dtype else mixed_linear(a, wp, mm)
    return (prod.float() + bp) * gamma + x.float()


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on CUDA
# ---------------------------------------------------------------------------
def _dtypes(x: torch.Tensor, mm_dtype: Optional[torch.dtype]) -> Tuple[torch.dtype, torch.dtype]:
    """(the activations' dtype, the GEMMs'): each bf16 or f32 on CUDA."""
    mm = mm_dtype or x.dtype
    for name, dt in (("activations", x.dtype), ("mm_dtype", mm)):
        if dt not in (torch.bfloat16, torch.float32):
            raise TypeError(f"the {name} are {dt}; the kernels take bfloat16 or float32")
    return x.dtype, mm


def ln_qkv(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
           w: torch.Tensor, b: torch.Tensor, eps: float,
           mm_dtype: Optional[torch.dtype] = None,
           w_split: Optional[Tf32Weight] = None) -> Tuple[torch.Tensor, ...]:
    """LN over C + Linear C -> S*C on rows, split into S (M, C) outputs (q, k,
    v for S = 3; k, v for S = 2). CUDA: x (M, C) bf16 or f32, w (S*C, C) in
    ``mm_dtype`` (default x's), LN params f32 (C,), b f32 (S*C,) -> outputs
    in :func:`qkv_dtype`: ``ln_qkv`` (bf16 / bf16), ``ln_qkv_f32`` (f32 /
    f32), ``ln_qkv_mmf32`` (bf16 x, f32 GEMM) or ``ln_qkv_mmbf16`` (f32 x,
    bf16 GEMM). The f32-GEMM kernels read w as ``w_split``
    (``tf32_weight(w)``, kept by the caller), or split w themselves; the
    plain version does not read it."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, ln_weight, ln_bias, w, b, eps, mm_dtype)
    if x.ndim != 2:
        raise ValueError(f"x must be (M, C), got {tuple(x.shape)}")
    m, c = x.shape
    CK._check_rows(m)
    _check_width(c)
    s = w.shape[0] // c
    if s not in (2, 3) or w.shape[0] != s * c:
        raise ValueError(f"w must be (2C or 3C, C) for C = {c}, got {tuple(w.shape)}")
    xdt, mm = _dtypes(x, mm_dtype)
    _check("x", x, xdt, (m, c), x.device)
    _check("ln_weight", ln_weight, torch.float32, (c,), x.device)
    _check("ln_bias", ln_bias, torch.float32, (c,), x.device)
    _check("w", w, mm, (s * c, c), x.device)
    _check("b", b, torch.float32, (s * c,), x.device)
    outs = [torch.empty((m, c), dtype=qkv_dtype(xdt, mm), device=x.device) for _ in range(s)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - s)
    args = (x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w.data_ptr(), b.data_ptr(),
            *ptrs, m, c, s, float(eps))
    if mm == torch.float32:
        hi, lo = CK._tf32_operands("w", w, w_split)
        _launch("ln_qkv_f32" if xdt == torch.float32 else "ln_qkv_mmf32", *args[:3],
                hi.data_ptr(), lo.data_ptr(), *args[4:],
                *CK._tf32_plan_args("qkv", c, s * c, x.element_size()), _stream(x.device))
    elif xdt == torch.bfloat16:
        _launch("ln_qkv", *args, *CK._ln_plan_args(c, s * c, "qkv"), _stream(x.device))
    else:  # f32 outputs stored by TMA (plan kind "qkv_tma")
        _launch("ln_qkv_mmbf16", *args, *CK._qkv_tma_plan_args(c, s * c), _stream(x.device))
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


def ln_qkv_mmbf16_cut(x, ln_weight, ln_bias, w, b, eps: float, cut: int) -> Tuple[torch.Tensor, ...]:
    """A phase cut of ``ln_qkv_mmbf16`` (f32 x, bf16 w -> S f32 outputs) on
    CUDA tensors at GCViTTiny's widths: 0 loads, 1 + LN, 2 + products, 3 the
    kernel itself, 5 the kernel without its stores (``csrc/mlp_gemm_cuts.cu``).
    Timing only: except at 3 the outputs hold nothing meaningful; counted in
    :data:`LAUNCHES` only at 3."""
    if cut == 3:
        return ln_qkv(x, ln_weight, ln_bias, w, b, eps, mm_dtype=torch.bfloat16)
    m, c = x.shape
    s = w.shape[0] // c
    outs = [torch.empty((m, c), dtype=torch.float32, device=x.device) for _ in range(s)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - s)
    err = CK._cut_lib().ln_qkv_mmbf16_cut(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w.data_ptr(), b.data_ptr(),
        *ptrs, m, c, s, float(eps), *CK._qkv_tma_plan_args(c, s * c), cut, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"ln_qkv_mmbf16 cut {cut}: CUDA launch failed with cudaError {err}")
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


def proj_scale_residual_mmbf16_cut(a, wp, bp, gamma, x, cut: int) -> torch.Tensor:
    """A phase cut of ``proj_scale_residual_mmbf16`` (f32 a and x, bf16 wp)
    on CUDA tensors: 0 loads (with the residual tile's), 2 + the A
    fragments' rounding and the products, 3 the kernel itself, 5 the kernel
    without its stores (``csrc/mlp_gemm_cuts.cu``). Timing only: the output
    holds nothing meaningful except at 3; never counted in
    :data:`LAUNCHES`."""
    m, c = a.shape
    out = torch.empty((m, c), dtype=torch.float32, device=a.device)
    err = CK._cut_lib().proj_scale_residual_mmbf16_cut(
        a.data_ptr(), wp.data_ptr(), bp.data_ptr(), gamma.data_ptr(), x.data_ptr(),
        out.data_ptr(), m, c, *CK._tma_res_plan_args("proj_tma", c, c), cut,
        _stream(a.device))
    if err != 0:
        raise RuntimeError(f"proj_scale_residual_mmbf16 cut {cut}: CUDA launch failed with "
                           f"cudaError {err}")
    return out


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     n: int, scale: float, q_is_global: bool = False,
                     mm_dtype: Optional[torch.dtype] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Window attention on (B, nWin*N, C) tokens with a (heads, N, N) f32
    rel-pos bias, the products in ``mm_dtype`` and the output in
    ``out_dtype`` (both default k's). CUDA, head width 32, N <= 224 (q (B,
    N, C) with ``q_is_global``): q, k, v and out bf16 with bf16 products
    (``window_attention``), or f32 with f32 ones (``window_attention_f32``);
    f32 q, k, v and out with bf16 products (``window_attention_mmbf16``);
    f32 q (or a bf16 global query), f32 k, v with f32 products -> bf16
    (``window_attention_mmf32``)."""
    if k.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, n, scale, q_is_global, mm_dtype, out_dtype)
    if k.ndim != 3:
        raise ValueError(f"k must be (B, nWin*N, C), got {tuple(k.shape)}")
    b, toks, c = k.shape
    heads = bias.shape[0]
    if toks % n or c != heads * HEAD_DIM or n > MAX_WINDOW_TOKENS:
        raise ValueError(f"window attention takes N <= {MAX_WINDOW_TOKENS} dividing the "
                         f"{toks} tokens and C = heads * {HEAD_DIM}; got N = {n}, C = {c}, "
                         f"heads = {heads}")
    dt, mm = _dtypes(k, mm_dtype)
    out_dt = out_dtype or dt
    # (k's dtype, the products', the output's) -> the kernel
    name = {(torch.bfloat16,) * 3: "window_attention",
            (torch.float32,) * 3: "window_attention_f32",
            (torch.float32, torch.bfloat16, torch.float32): "window_attention_mmbf16",
            (torch.float32, torch.float32, torch.bfloat16): "window_attention_mmf32",
            }.get((dt, mm, out_dt))
    if name is None:
        raise TypeError(f"no window-attention kernel takes {dt} k and v with {mm} products "
                        f"and a {out_dt} output")
    # the mixed f32 mode takes a global query in the activations' dtype
    q_dt = q.dtype if name == "window_attention_mmf32" and q_is_global else dt
    _check("k", k, dt, (b, toks, c), k.device)
    _check("v", v, dt, (b, toks, c), k.device)
    _check("q", q, q_dt, (b, n, c) if q_is_global else (b, toks, c), k.device)
    _check("bias", bias, torch.float32, (heads, n, n), k.device)
    out = torch.empty((b, toks, c), dtype=out_dt, device=k.device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
            toks // n, n, c, heads, float(scale), int(q_is_global)]
    if name == "window_attention_mmf32":
        args.append(int(q_dt == torch.bfloat16))
    _launch(name, *args, _stream(k.device))
    return out


F32_ATTENTION_CUTS = {"loads": 1, "scores": 2, "softmax": 3}


def window_attention_f32_cut(q, k, v, bias, n: int, scale: float, q_is_global: bool,
                             cut: int) -> torch.Tensor:
    """``window_attention_f32`` (f32 q, k, v on CUDA) stopped after a phase,
    for ``tools/exp_window_attention.py``: 1 after the loads, 2 after the
    scores with the bias and the row max, 3 after the softmax and P's split
    (:data:`F32_ATTENTION_CUTS`). Timing only: the output holds a checksum;
    never counted in :data:`LAUNCHES`."""
    b, toks, c = k.shape
    out = torch.empty((b, toks, c), dtype=torch.float32, device=k.device)
    err = _lib().window_attention_f32_cut(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), b, toks // n,
        n, c, bias.shape[0], float(scale), int(q_is_global), int(cut), _stream(k.device))
    if err != 0:
        raise RuntimeError(f"window_attention_f32 cut {cut}: CUDA launch failed with "
                           f"cudaError {err}")
    return out


def proj_scale_residual(a: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                        gamma: torch.Tensor, x: torch.Tensor,
                        mm_dtype: Optional[torch.dtype] = None,
                        w_split: Optional[Tf32Weight] = None) -> torch.Tensor:
    """r1 = x + gamma * (a wp^T + bp) on rows. CUDA: a and x (M, C) in the
    activations' dtype, wp (C, C) in ``mm_dtype`` (default a's), bp and
    gamma f32 (C,) -> f32 (M, C): ``proj_scale_residual`` (bf16 / bf16),
    ``proj_scale_residual_f32`` (f32 / f32), ``proj_scale_residual_mmf32``
    (bf16 a and x, f32 wp) or ``proj_scale_residual_mmbf16`` (f32 a and x,
    bf16 wp). The f32-GEMM kernels read wp as ``w_split``
    (``tf32_weight(wp)``, kept by the caller), or split wp themselves; the
    plain version does not read it."""
    if a.device.type == "cpu":
        return proj_scale_residual_plain(a, wp, bp, gamma, x, mm_dtype)
    if a.ndim != 2:
        raise ValueError(f"a must be (M, C), got {tuple(a.shape)}")
    m, c = a.shape
    CK._check_rows(m)
    _check_width(c)
    dt, mm = _dtypes(a, mm_dtype)
    _check("a", a, dt, (m, c), a.device)
    _check("wp", wp, mm, (c, c), a.device)
    _check("bp", bp, torch.float32, (c,), a.device)
    _check("gamma", gamma, torch.float32, (c,), a.device)
    _check("x", x, dt, (m, c), a.device)
    out = torch.empty((m, c), dtype=torch.float32, device=a.device)
    args = (a.data_ptr(), wp.data_ptr(), bp.data_ptr(), gamma.data_ptr(), x.data_ptr(),
            out.data_ptr(), m, c)
    if mm == torch.float32:
        hi, lo = CK._tf32_operands("wp", wp, w_split)
        _launch("proj_scale_residual_f32" if dt == torch.float32 else "proj_scale_residual_mmf32",
                args[0], hi.data_ptr(), lo.data_ptr(), *args[2:],
                *CK._tf32_plan_args("proj", c, c, a.element_size()), _stream(a.device))
    elif dt == torch.bfloat16:
        _launch("proj_scale_residual", *args, *CK._proj_plan_args(c), _stream(a.device))
    else:  # the f32 rows by TMA, rounded in registers (plan kind "proj_tma")
        _launch("proj_scale_residual_mmbf16", *args, *CK._tma_res_plan_args("proj_tma", c, c),
                _stream(a.device))
    return out


def window_transformer_block(x: torch.Tensor, q_global: Optional[torch.Tensor], *, n: int,
                             ln1_weight, ln1_bias, wqkv, bqkv, bias, wp, bp, gamma1,
                             ln2_weight, ln2_bias, w1, b1, w2, b2, gamma2,
                             scale: Optional[float] = None, eps: float = 1e-5,
                             mm_dtype: Optional[torch.dtype] = None,
                             wqkv_split=None, wp_split=None, w1_split=None,
                             w2_split=None) -> torch.Tensor:
    """One GCViT block on window-ordered tokens x (B, nWin*N, C) through the
    five wrappers: r1 = x + gamma1 * proj(attn(LN1 x)) in f32, then
    r1 + gamma2 * fc2(gelu(fc1(LN2 r1))) in x's dtype. ``q_global`` (B, N,
    C) makes it a global-query block (W_qkv is then the (2C, C) k/v
    projection). Weights in the nn.Linear layout and in ``mm_dtype``, the
    GEMMs' dtype (default x's; ``VIPTPU_GCVIT_MM``); ``bias`` the dense
    (heads, N, N) rel-pos bias; with f32 GEMMs ``wqkv_split`` /
    ``wp_split`` / ``w1_split`` / ``w2_split`` the four weights' 3xTF32
    pairs where the caller keeps them."""
    b, toks, c = x.shape
    heads = bias.shape[0]
    scale = scale if scale is not None else (c // heads) ** -0.5
    mm = mm_dtype or x.dtype
    x2 = x.reshape(b * toks, c)
    parts = ln_qkv(x2, ln1_weight, ln1_bias, wqkv, bqkv, eps, mm_dtype=mm, w_split=wqkv_split)
    if q_global is None:
        q, k, v = (p.view(b, toks, c) for p in parts)
    else:
        q = q_global
        k, v = (p.view(b, toks, c) for p in parts)
    attn = window_attention(q, k, v, bias, n, scale, q_is_global=q_global is not None,
                            mm_dtype=mm, out_dtype=x.dtype)
    r1 = proj_scale_residual(attn.view(b * toks, c), wp, bp, gamma1, x2, mm_dtype=mm,
                             w_split=wp_split)
    hidden = CK.ln_fc1_gelu(r1, ln2_weight, ln2_bias, w1, b1, eps, mm_dtype=mm, w_split=w1_split)
    return CK.fc2_scale_residual(hidden, w2, b2, gamma2, r1, out_dtype=x.dtype,
                                 w_split=w2_split).view(b, toks, c)
