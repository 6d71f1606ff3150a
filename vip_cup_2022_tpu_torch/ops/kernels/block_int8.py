"""The fused blocks' in-kernel int8 GEMMs: CUDA for Hopper, with their plain
PyTorch versions (``VIPTPU_INT8_KERNELS=1``).

Replaces the int8 mode of the JAX package's fused block kernels
(``vip_cup_2022_tpu/ops/pallas/convnext_block.py``: ``fused_convnext_block``
K1 and ``fused_ln_mlp_residual_batchlane`` K2; ``gcvit_block.py``:
``ln_dense`` K4, ``proj_res_ln_mlp`` K6, ``mono_window_transformer_block``
K7), where the dense GEMMs run s8 x s8 -> s32 with per-output-channel
weight scales and dynamic per-row activation scales
(:mod:`...quant.dyn_int8` has the scheme). Five kernels
(``csrc/block_int8.cu`` on the wgmma + TMA engine of
``csrc/hopper_gemm.cuh``, template ``csrc/block_int8.cuh``):

- ``ln_fc1_gelu_int8``: f32 x (M, C) -> LN -> per-row s8 codes in the A
  tile -> s8 wgmma against fc1's codes (N, C) -> ``f32(acc) * (s_row *
  s_col) + b1`` -> exact GELU -> the f32 hidden (M, N);
- ``ln_qkv_int8``: bf16 x -> the same LN and product against W_qkv's codes
  (S C, C) -> ``+ bias`` -> S bf16 (M, C) outputs;
- ``quantize_rows``: f32 or bf16 rows (M, K) -> s8 codes and one f32 scale a
  row, its abs-max taken over all of K (fc2's hidden, proj's attention
  output);
- ``fc2_scale_residual_int8``: s8 hidden codes and row scales @ fc2's codes
  (C, K) -> ``(f32(acc) * (s_row * s_col) + b2) * gamma + residual`` -> bf16;
- ``proj_scale_residual_int8``: the same with K = C on the attention output
  and a bf16 x residual -> f32 r1.

One ConvNeXt block is :func:`convnext_block_int8` (``dwconv7x7_nhwc`` of
:mod:`.convnext_block` stays as it is), one GCViT block
:func:`window_transformer_block_int8` (the attention, ``window_attention`` of
:mod:`.gcvit_block`, stays bf16, as in the JAX package).

fc2's activation scale is taken over the whole hidden row, which the GEMM
streams by K tiles, so fc1 writes its hidden in f32 (the JAX kernel
quantizes the unrounded GELU output) and ``quantize_rows`` makes its codes:
JAX's codes, at 10 bytes an element of hidden against the bf16 path's 4.
The JAX whole-image kernel (K1) takes one activation scale per TPU grid
tile; the port takes one per row at every site (K2's and GCViT's scheme).

Dispatch: a wrapper runs its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises, and never falls back. Each
wrapper counts its launches in :data:`LAUNCHES`. The plain versions compute
the int8 products in f64, exact at these magnitudes, and the same f32
epilogue step by step, so a kernel given the same codes and scales agrees
with its plain version bit for bit before its output's last rounding.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...quant import dyn_int8 as Q8
from ...quant.dyn_int8 import Int8Weight
from . import build
from . import convnext_block as CK
from . import gcvit_block as G
from .convnext_block import _check, _check_rows, _check_width, _stream

LAUNCHES: Dict[str, int] = {"ln_fc1_gelu_int8": 0, "ln_qkv_int8": 0, "quantize_rows": 0,
                            "fc2_scale_residual_int8": 0, "proj_scale_residual_int8": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ln_fc1_gelu_int8": [_P] * 7 + [_I, _I, _I, _F] + [_I] * 4 + [_P],
    "ln_qkv_int8": [_P] * 9 + [_I, _I, _I, _F] + [_I] * 4 + [_P],
    "quantize_rows": [_P, _P, _P, _I, _I, _I, _P],
    "res_gemm_int8": [_P] * 8 + [_I] * 8 + [_P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("block_int8")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch(entry: str, counter: str, *args) -> None:
    err = getattr(_lib(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{counter}: CUDA launch failed with cudaError {err}")
    LAUNCHES[counter] += 1


# ---------------------------------------------------------------------------
# the per-shape plan (csrc/block_int8.cuh checks it)
# ---------------------------------------------------------------------------
TILE_K = 128  # s8 of K per K tile: one 128-byte swizzle row
STAGING_BYTES = 16 * 2048  # the 16 consumer warps' f32 epilogue staging
ROW_SCALE_BYTES = 2 * CK.BM * 4  # the LN kernel's row scales of two A buffers
MAX_HELD = 2 ** 20 - 1  # an mbarrier's transaction count: the residual GEMM's held W


def int8_plan(kind: str, c: int, n: int) -> dict:
    """Tiles of one launch of the int8 GEMMs. ``kind`` "ln"
    (``ln_fc1_gelu_int8``, x (M, c) -> (M, n)) or "qkv" (``ln_qkv_int8``, n =
    2c or 3c, column tiles dividing c): ``bn`` columns of 128, 96 or 64, W
    ``resident`` in the ring where all of it fits beside two (else one) A
    buffers, else streamed through ``stages`` (two A buffers where four
    stages still fit). "res" (``fc2_scale_residual_int8``, a hidden (M, n) ->
    (M, c)) or "proj" (``proj_scale_residual_int8``, n = c): ``bn`` the
    widest of 128 / 96 / 64 dividing c, W held in shared memory apart from
    the ring (``resident``, ``held`` bytes) where four A stages still fit
    beside it. ``smem`` bytes in all. Independent of M."""
    if c % 32 or n % 32 or c <= 0 or n <= 0:
        raise ValueError(f"widths {c}, {n} are not multiples of 32")
    if kind in ("ln", "qkv"):
        if kind == "qkv" and n not in (2 * c, 3 * c):
            raise ValueError(f"ln_qkv_int8's width {n} is not 2 or 3 x C = {c}")
        if c > 768:
            raise ValueError(f"the int8 LN GEMM takes C <= 768, got {c}")
        kt = -(-c // TILE_K)
        fixed, a_tile = STAGING_BYTES + ROW_SCALE_BYTES, CK.BM * kt * TILE_K
        for bn in (128, 96, 64):
            if n % bn or (kind == "qkv" and c % bn):
                continue
            stage, everything = bn * TILE_K, (n // bn) * kt
            plan = None
            for a in (2, 1):
                if (everything <= CK.MAX_RESIDENT
                        and CK._stages_that_fit(fixed + a * a_tile, stage, everything) == everything):
                    plan = dict(bn=bn, stages=everything, a_buffers=a, resident=True)
                    break
            if plan is None:
                a = 2 if CK._stages_that_fit(fixed + 2 * a_tile, stage, CK.MAX_RING) >= 4 else 1
                stages = CK._stages_that_fit(fixed + a * a_tile, stage, CK.MAX_RING)
                if stages < 2:
                    continue
                plan = dict(bn=bn, stages=stages, a_buffers=a, resident=False)
            plan.update(kind=kind, held=0, smem=CK._barrier_bytes(plan["stages"]) + CK._ALIGN + fixed
                        + plan["a_buffers"] * a_tile + plan["stages"] * stage)
            return plan
        raise ValueError(f"no int8 {kind} plan fits C = {c}, N = {n}")
    if kind in ("res", "proj"):
        if kind == "proj" and n != c:
            raise ValueError(f"proj_scale_residual_int8's K = {n} is not C = {c}")
        bn = next((w for w in (128, 96, 64) if c % w == 0), None)
        if bn is None:
            raise ValueError(f"the int8 residual GEMM takes C a multiple of 64 or 96, got {c}")
        held = (c // bn) * -(-n // TILE_K) * bn * TILE_K
        a_stage = CK.BM * TILE_K
        stages = CK._stages_that_fit(STAGING_BYTES + held, a_stage, CK.MAX_RING)
        resident = held <= MAX_HELD and stages >= 4
        if resident:
            ring = held + stages * a_stage
        else:
            held, stages = 0, CK._stages_that_fit(STAGING_BYTES, (CK.BM + bn) * TILE_K, CK.MAX_RING)
            ring = stages * (CK.BM + bn) * TILE_K
        return dict(kind=kind, bn=bn, stages=stages, a_buffers=0, resident=resident, held=held,
                    smem=CK._barrier_bytes(stages) + CK._ALIGN + STAGING_BYTES + ring)
    raise ValueError(f"kind must be 'ln', 'qkv', 'res' or 'proj', got {kind!r}")


@functools.lru_cache(maxsize=None)
def _ln_plan_args(kind: str, c: int, n: int) -> tuple:
    p = int8_plan(kind, c, n)
    return p["bn"], p["stages"], p["a_buffers"], int(p["resident"])


@functools.lru_cache(maxsize=None)
def _res_plan_args(kind: str, c: int, n: int) -> tuple:
    p = int8_plan(kind, c, n)
    return p["bn"], p["stages"], int(p["resident"])


# ---------------------------------------------------------------------------
# plain PyTorch versions: the same functions in f32, the int8 products exact
# ---------------------------------------------------------------------------
def _layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * weight + bias


def ln_fc1_gelu_int8_plain(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                           w_q: torch.Tensor, w_scale: torch.Tensor, b1: torch.Tensor,
                           eps: float) -> torch.Tensor:
    """(M, C) -> LN (two-pass, f32) -> per-row int8 -> @ w_q (N, C)^T ->
    ``f32(acc) * (s_row * w_scale) + b1`` -> exact GELU: f32 (M, N)."""
    h = Q8.dot_i8(_layer_norm(x, ln_weight, ln_bias, eps), w_q.t(), w_scale, b1)
    return F.gelu(h, approximate="none")


def ln_qkv_int8_plain(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                      w_q: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor,
                      eps: float) -> Tuple[torch.Tensor, ...]:
    """(M, C) -> LN -> per-row int8 -> @ w_q (S C, C)^T, dequantized, + b ->
    S (M, C) outputs (q, k, v or k, v) in x's dtype."""
    o = Q8.dot_i8(_layer_norm(x, ln_weight, ln_bias, eps), w_q.t(), w_scale, b).to(x.dtype)
    return tuple(part.contiguous() for part in o.chunk(w_q.shape[0] // x.shape[1], dim=-1))


def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) -> (codes (M, K) int8, scales (M,) f32), one dynamic abs-max
    scale a row (:func:`...quant.dyn_int8.dyn_quant_rows`)."""
    q, s = Q8.dyn_quant_rows(x)
    return q, s.view(-1)


def fc2_scale_residual_int8_plain(a_q: torch.Tensor, a_scale: torch.Tensor, w_q: torch.Tensor,
                                  w_scale: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                                  residual: torch.Tensor,
                                  out_dtype: torch.dtype) -> torch.Tensor:
    """int8 (M, K) rows with scales (M,) @ w_q (C, K)^T -> ``(f32(acc) *
    (s_row * w_scale) + b2) * gamma + residual`` in f32, cast to
    ``out_dtype``."""
    o = Q8.dequant(Q8.int_matmul(a_q, w_q.t()), a_scale.view(-1, 1), w_scale, b2)
    return (o * gamma + residual.float()).to(out_dtype)


def proj_scale_residual_int8_plain(a_q: torch.Tensor, a_scale: torch.Tensor, wp_q: torch.Tensor,
                                   wp_scale: torch.Tensor, bp: torch.Tensor, gamma: torch.Tensor,
                                   x: torch.Tensor) -> torch.Tensor:
    """r1 = x + gamma * (int8 rows @ wp_q (C, C)^T, dequantized, + bp), f32."""
    return fc2_scale_residual_int8_plain(a_q, a_scale, wp_q, wp_scale, bp, gamma, x,
                                         torch.float32)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on CUDA
# ---------------------------------------------------------------------------
def _check_int8_weight(name: str, w_q: torch.Tensor, w_scale: torch.Tensor, shape, device):
    _check(name, w_q, torch.int8, shape, device)
    _check(f"{name} scales", w_scale, torch.float32, shape[:1], device)


def ln_fc1_gelu_int8(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                     w_q: torch.Tensor, w_scale: torch.Tensor, b1: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """LN + int8 Linear C -> N + exact GELU on rows. CUDA: x f32 (M, C), LN
    params f32 (C,), w_q int8 (N, C), w_scale and b1 f32 (N,) -> f32 (M, N)."""
    if x.device.type == "cpu":
        return ln_fc1_gelu_int8_plain(x, ln_weight, ln_bias, w_q, w_scale, b1, eps)
    if x.ndim != 2:
        raise ValueError(f"x must be (M, C), got {tuple(x.shape)}")
    m, c = x.shape
    n = w_q.shape[0]
    _check_rows(m)
    _check_width(c)
    _check_width(n)
    _check("x", x, torch.float32, (m, c), x.device)
    _check("ln_weight", ln_weight, torch.float32, (c,), x.device)
    _check("ln_bias", ln_bias, torch.float32, (c,), x.device)
    _check_int8_weight("w_q", w_q, w_scale, (n, c), x.device)
    _check("b1", b1, torch.float32, (n,), x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _launch("ln_fc1_gelu_int8", "ln_fc1_gelu_int8", x.data_ptr(), ln_weight.data_ptr(),
            ln_bias.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), b1.data_ptr(), out.data_ptr(),
            m, c, n, float(eps), *_ln_plan_args("ln", c, n), _stream(x.device))
    return out


def ln_qkv_int8(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                w_q: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor,
                eps: float) -> Tuple[torch.Tensor, ...]:
    """LN + int8 Linear C -> S C on rows, split into S (M, C) outputs. CUDA:
    x bf16 (M, C), LN params f32, w_q int8 (S C, C), w_scale and b f32
    (S C,) -> bf16."""
    if x.device.type == "cpu":
        return ln_qkv_int8_plain(x, ln_weight, ln_bias, w_q, w_scale, b, eps)
    if x.ndim != 2:
        raise ValueError(f"x must be (M, C), got {tuple(x.shape)}")
    m, c = x.shape
    _check_rows(m)
    _check_width(c)
    s = w_q.shape[0] // c
    if s not in (2, 3) or w_q.shape[0] != s * c:
        raise ValueError(f"w_q must be (2C or 3C, C) for C = {c}, got {tuple(w_q.shape)}")
    _check("x", x, torch.bfloat16, (m, c), x.device)
    _check("ln_weight", ln_weight, torch.float32, (c,), x.device)
    _check("ln_bias", ln_bias, torch.float32, (c,), x.device)
    _check_int8_weight("w_q", w_q, w_scale, (s * c, c), x.device)
    _check("b", b, torch.float32, (s * c,), x.device)
    outs = [torch.empty((m, c), dtype=torch.bfloat16, device=x.device) for _ in range(s)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - s)
    _launch("ln_qkv_int8", "ln_qkv_int8", x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(),
            w_q.data_ptr(), w_scale.data_ptr(), b.data_ptr(), *ptrs, m, c, s, float(eps),
            *_ln_plan_args("qkv", c, s * c), _stream(x.device))
    return tuple(outs)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 of (M, K) rows. CUDA: x f32 or bf16, K a
    multiple of 32 -> (int8 (M, K), f32 (M,))."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    _check_rows(m)
    _check_width(k)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x has dtype {x.dtype}, the kernel takes float32 or bfloat16")
    _check("x", x, x.dtype, (m, k), x.device)
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m,), dtype=torch.float32, device=x.device)
    _launch("quantize_rows", "quantize_rows", x.data_ptr(), q.data_ptr(), s.data_ptr(), m, k,
            int(x.dtype == torch.float32), _stream(x.device))
    return q, s


def _res_gemm(counter: str, kind: str, a_q, a_scale, w_q, w_scale, bias, gamma, residual,
              out_dtype: torch.dtype) -> torch.Tensor:
    if a_q.ndim != 2:
        raise ValueError(f"a_q must be (M, K), got {tuple(a_q.shape)}")
    m, k = a_q.shape
    c = w_q.shape[0]
    _check_rows(m)
    _check_width(c)
    _check_width(k)
    dev = a_q.device
    _check("a_q", a_q, torch.int8, (m, k), dev)
    _check("a_scale", a_scale, torch.float32, (m,), dev)
    _check_int8_weight("w_q", w_q, w_scale, (c, k), dev)
    _check("bias", bias, torch.float32, (c,), dev)
    _check("gamma", gamma, torch.float32, (c,), dev)
    res_f32 = residual.dtype == torch.float32
    _check("residual", residual, torch.float32 if res_f32 else torch.bfloat16, (m, c), dev)
    if out_dtype not in (torch.bfloat16, torch.float32) or (res_f32 and out_dtype == torch.float32):
        raise TypeError(f"the kernel writes bf16, or f32 beside a bf16 residual; got {out_dtype} "
                        f"with a {residual.dtype} residual")
    out = torch.empty((m, c), dtype=out_dtype, device=dev)
    _launch("res_gemm_int8", counter, a_q.data_ptr(), a_scale.data_ptr(), w_q.data_ptr(),
            w_scale.data_ptr(), bias.data_ptr(), gamma.data_ptr(), residual.data_ptr(),
            out.data_ptr(), m, k, c, int(res_f32), int(out_dtype == torch.float32),
            *_res_plan_args(kind, c, k), _stream(dev))
    return out


def fc2_scale_residual_int8(a_q: torch.Tensor, a_scale: torch.Tensor, w_q: torch.Tensor,
                            w_scale: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                            residual: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """int8 Linear K -> C on quantized rows, (+ b2) x gamma + residual. CUDA:
    a_q int8 (M, K) with scales f32 (M,), w_q int8 (C, K) with scales f32
    (C,), b2 and gamma f32 (C,), residual bf16 or f32 (M, C) -> bf16."""
    if a_q.device.type == "cpu":
        return fc2_scale_residual_int8_plain(a_q, a_scale, w_q, w_scale, b2, gamma, residual,
                                             out_dtype)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"fc2_scale_residual_int8 writes bf16 on CUDA, not {out_dtype}")
    return _res_gemm("fc2_scale_residual_int8", "res", a_q, a_scale, w_q, w_scale, b2, gamma,
                     residual, out_dtype)


def proj_scale_residual_int8(a_q: torch.Tensor, a_scale: torch.Tensor, wp_q: torch.Tensor,
                             wp_scale: torch.Tensor, bp: torch.Tensor, gamma: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """r1 = x + gamma * (int8 proj of quantized rows + bp). CUDA: a_q int8
    (M, C) with scales f32 (M,), wp_q int8 (C, C) with scales, bp and gamma
    f32 (C,), x bf16 (M, C) -> f32 (M, C)."""
    if a_q.device.type == "cpu":
        return proj_scale_residual_int8_plain(a_q, a_scale, wp_q, wp_scale, bp, gamma, x)
    if wp_q.shape[0] != a_q.shape[-1]:
        raise ValueError(f"wp_q must be (C, C) for C = {a_q.shape[-1]}, got {tuple(wp_q.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x has dtype {x.dtype}, the kernel takes bfloat16")
    return _res_gemm("proj_scale_residual_int8", "proj", a_q, a_scale, wp_q, wp_scale, bp, gamma,
                     x, torch.float32)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
def convnext_block_int8(x: torch.Tensor, dw_kernel, dw_bias, ln_weight, ln_bias,
                        fc1: Int8Weight, b1, fc2: Int8Weight, b2, gamma,
                        eps: float = 1e-6) -> torch.Tensor:
    """Whole ConvNeXt block on NHWC x with int8 MLP GEMMs:
    x + gamma * fc2(gelu(fc1(LN(dw7x7(x) + dw_bias)))), the hidden quantized
    per row over its 4C columns."""
    b, h, w, c = x.shape
    m = b * h * w
    d = CK.dwconv7x7_nhwc(x, dw_kernel, dw_bias)
    hid = ln_fc1_gelu_int8(d.view(m, c), ln_weight, ln_bias, fc1.q, fc1.s, b1, eps)
    h_q, h_s = quantize_rows(hid)
    out = fc2_scale_residual_int8(h_q, h_s, fc2.q, fc2.s, b2, gamma, x.reshape(m, c), x.dtype)
    return out.view(b, h, w, c)


def window_transformer_block_int8(x: torch.Tensor, q_global: Optional[torch.Tensor], *, n: int,
                                  ln1_weight, ln1_bias, qkv: Int8Weight, bqkv, bias,
                                  proj: Int8Weight, bp, gamma1, ln2_weight, ln2_bias,
                                  fc1: Int8Weight, b1, fc2: Int8Weight, b2, gamma2,
                                  scale: Optional[float] = None,
                                  eps: float = 1e-5) -> torch.Tensor:
    """One GCViT block (:func:`.gcvit_block.window_transformer_block`) with
    its qkv, proj, fc1 and fc2 GEMMs int8; the attention stays in the
    compute dtype, and r1 in f32."""
    b, toks, c = x.shape
    heads = bias.shape[0]
    scale = scale if scale is not None else (c // heads) ** -0.5
    x2 = x.reshape(b * toks, c)
    parts = [p.view(b, toks, c) for p in ln_qkv_int8(x2, ln1_weight, ln1_bias, qkv.q, qkv.s,
                                                     bqkv, eps)]
    q, k, v = parts if q_global is None else (q_global, *parts)
    attn = G.window_attention(q, k, v, bias, n, scale, q_is_global=q_global is not None)
    a_q, a_s = quantize_rows(attn.view(b * toks, c))
    r1 = proj_scale_residual_int8(a_q, a_s, proj.q, proj.s, bp, gamma1, x2)
    hid = ln_fc1_gelu_int8(r1, ln2_weight, ln2_bias, fc1.q, fc1.s, b1, eps)
    h_q, h_s = quantize_rows(hid)
    return fc2_scale_residual_int8(h_q, h_s, fc2.q, fc2.s, b2, gamma2, r1,
                                   x.dtype).view(b, toks, c)
