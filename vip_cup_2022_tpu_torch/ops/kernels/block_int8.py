"""The fused blocks' in-kernel int8 GEMMs: CUDA for Hopper, with their plain
PyTorch versions (``VIPTPU_INT8_KERNELS=1``).

Replaces the int8 mode of the JAX package's fused block kernels
(``vip_cup_2022_tpu/ops/pallas/convnext_block.py``: ``fused_convnext_block``
K1 and ``fused_ln_mlp_residual_batchlane`` K2; ``gcvit_block.py``:
``ln_dense`` K4, ``proj_res_ln_mlp`` K6, ``mono_window_transformer_block``
K7), where the dense GEMMs run s8 x s8 -> s32 with per-output-channel
weight scales and dynamic per-row activation scales
(:mod:`...quant.dyn_int8` has the scheme). Seven kernels
(``csrc/block_int8.cu`` on the wgmma + TMA engine of
``csrc/hopper_gemm.cuh``, template ``csrc/block_int8.cuh``):

- the MLP pair, which keeps the hidden on chip:
  ``ln_fc1_rowmax_int8`` (pass 1): f32 x (M, C) -> LN -> per-row s8 codes
  (written out with their scales) -> s8 wgmma against fc1's codes (N, C) ->
  ``f32(acc) * (s_row * s_col) + b1`` -> each row's abs-max of the exact
  GELU (evaluated at the row's largest value, where the GELU is
  nondecreasing, and below 0 only where it could matter:
  :func:`gelu_mono_check` holds the kernels' GELU to both facts) -> the
  hidden's row scale; no hidden written.
  ``mlp_int8_scale_residual`` (pass 2): fc1 again from x's codes (exact s32
  sums, so the same hidden), the same GELU, codes with pass 1's scale
  straight into a shared-memory A tile, fc2 over the whole hidden ->
  ``(f32(acc) * (s_h * s_col) + b2) * gamma + residual`` -> bf16;
- ``ln_qkv_int8``: bf16 x -> the same LN and product against W_qkv's codes
  (S C, C) -> ``+ bias`` -> S bf16 (M, C) outputs;
- ``quantize_rows``: f32 or bf16 rows (M, K) -> s8 codes and one f32 scale a
  row, its abs-max taken over all of K (proj's attention output);
- ``proj_scale_residual_int8``: the attention output's codes @ W_p's ->
  ``(+ bp) * gamma1 + x`` -> f32 r1;
- ``ln_fc1_gelu_int8`` (-> the f32 hidden) and ``fc2_scale_residual_int8``
  (s8 hidden codes and row scales @ fc2's codes -> bf16): with
  ``quantize_rows`` between them, the MLP chain the pair replaced
  (:func:`mlp_int8_chain`). Nothing on the model path calls them; they stay
  as the pair's yardstick, which the pair equals bit for bit.

One ConvNeXt block is :func:`convnext_block_int8` (``dwconv7x7_nhwc`` of
:mod:`.convnext_block` stays as it is), one GCViT block
:func:`window_transformer_block_int8` (the attention, ``window_attention`` of
:mod:`.gcvit_block`, stays in the compute dtype, or ``VIPTPU_GCVIT_MM``'s,
as in the JAX package); both run their MLP through :func:`mlp_int8`.

In an f32 block (``VIPTPU_DTYPE=float32``) the same kernels take f32
activations and write f32, each such launch counted under its own name:
``ln_qkv_int8_f32`` (f32 x -> f32 q, k, v), ``proj_scale_residual_int8_f32``
(the f32 residual x -> f32 r1), ``mlp_int8_scale_residual_f32`` (the f32
residual -> f32) and the yardstick's ``fc2_scale_residual_int8_f32``;
``quantize_rows`` and ``ln_fc1_rowmax_int8`` read f32 in every mode. A bf16
GCViT block under ``VIPTPU_GCVIT_MM=f32`` keeps its q, k, v in f32, as the
TPU's monoblock does: ``ln_qkv_int8_mmf32`` (bf16 x -> f32).

fc2's activation scale is taken over the whole hidden row. The JAX kernels
keep that row in VMEM; an SM cannot hold 64 rows of it at the wide stages,
so pass 1 finds each row's scale and pass 2 recomputes the hidden, exactly,
to quantize it: JAX's codes, at about 10 bytes a row and channel of x
against the old chain's 10 bytes a hidden element. The JAX whole-image
kernel (K1) takes one activation scale per TPU grid tile; the port takes one
per row at every site (K2's and GCViT's scheme).

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
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...quant import dyn_int8 as Q8
from ...quant.dyn_int8 import Int8Weight
from . import build
from . import convnext_block as CK
from . import gcvit_block as G
from .convnext_block import _check, _check_rows, _check_width, _stream

LAUNCHES: Dict[str, int] = {"ln_fc1_gelu_int8": 0, "ln_qkv_int8": 0, "quantize_rows": 0,
                            "fc2_scale_residual_int8": 0, "proj_scale_residual_int8": 0,
                            "ln_fc1_rowmax_int8": 0, "mlp_int8_scale_residual": 0,
                            "ln_qkv_int8_f32": 0, "ln_qkv_int8_mmf32": 0,
                            "fc2_scale_residual_int8_f32": 0, "proj_scale_residual_int8_f32": 0,
                            "mlp_int8_scale_residual_f32": 0}


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ln_fc1_gelu_int8": [_P] * 7 + [_I, _I, _I, _F] + [_I] * 4 + [_P],
    "ln_qkv_int8": [_P] * 9 + [_I, _I, _I, _F] + [_I] * 6 + [_P],
    "quantize_rows": [_P, _P, _P, _I, _I, _I, _P],
    "res_gemm_int8": [_P] * 8 + [_I] * 8 + [_P],
    "ln_fc1_rowmax_int8": [_P] * 9 + [_I, _I, _I, _F] + [_I] * 4 + [_P],
    "mlp_int8_scale_residual": [_P] * 12 + [_I] * 10 + [_P],
    "gelu_bits_check": [_P, _P],
    "gelu_mono_check": [_P, _P],
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
# mlp_int8_scale_residual: 64-row tiles, 128-column hidden chunks, four
# consumer warpgroups making 32 columns of each; an output column tile of
# C / R columns -> (columns of each output warpgroup, output warpgroups)
MLP_ROWS, MLP_CHUNK = 64, 128
MLP_W1_STAGE = MLP_CHUNK * TILE_K  # a chunk's W1 rows x one K tile
MLP_COLUMN_TILES = {64: (32, 2), 96: (32, 3), 128: (32, 4), 192: (64, 3), 256: (64, 4),
                    384: (96, 4)}
MLP_MAX_STAGES = 16  # W1's ring (K tiles); W2's takes half as many chunks


def _mlp_smem(c: int, r: int, no: int, s1: int, s2: int, xb: int) -> int:
    """``csrc/block_int8.cuh``'s ``mlp_smem_bytes``: barriers, alignment, the
    output warpgroups' staging, two A tiles, ``xb`` x tiles, W1's and W2's
    rings."""
    kt = -(-c // TILE_K)
    return (8 * (2 * s1 + 2 * s2 + 2 * xb) + CK._ALIGN + no * 4 * 2048 + 2 * MLP_ROWS * TILE_K
            + xb * kt * MLP_ROWS * TILE_K + s1 * MLP_W1_STAGE + s2 * (c // r) * TILE_K)


def _mlp_plan(c: int, n: int) -> dict:
    """``mlp_int8_scale_residual``'s tiles (:func:`int8_plan` "mlp")."""
    kt, nk = -(-c // TILE_K), -(-n // MLP_CHUNK)
    for r in range(1, c // 32 + 1):
        if c % r or c // r not in MLP_COLUMN_TILES:
            continue
        ow, no = MLP_COLUMN_TILES[c // r]

        def plan(s1, s2, xb, resident):
            smem = _mlp_smem(c, r, no, s1, s2, xb)
            return None if smem > CK.SMEM_LIMIT else dict(
                kind="mlp", col_tiles=r, ow=ow, no=no, s1=s1, s2=s2, x_buffers=xb,
                resident=resident, smem=smem)

        for xb in (2, 1):  # all of W1 and W2 held, loaded once
            if r == 1 and plan(nk * kt, nk, xb, True):
                return plan(nk * kt, nk, xb, True)
        for xb, s2 in ((2, 2), (1, 2), (2, 1), (1, 1)):  # two W2 stages first, then x tiles
            s1 = kt
            if not plan(s1, s2, xb, False):
                continue
            while True:  # deeper rings where room is left: W1 a K tile, W2 a chunk, in turn
                grown = s1 < MLP_MAX_STAGES and plan(s1 + 1, s2, xb, False) is not None
                s1 += grown
                more = s2 < MLP_MAX_STAGES // 2 and plan(s1, s2 + 1, xb, False) is not None
                s2 += more
                if not (grown or more):
                    return plan(s1, s2, xb, False)
    raise ValueError(f"no mlp_int8_scale_residual plan fits C = {c}, N = {n}")


def _ln_plan(kind: str, c: int, n: int, widths: Sequence[int]) -> dict:
    """The LN GEMMs' tiles (:func:`int8_plan` "ln", "rowmax", "qkv"), the
    first of ``widths`` that divides n (and c for "qkv") and fits."""
    if kind == "qkv" and n not in (2 * c, 3 * c):
        raise ValueError(f"ln_qkv_int8's width {n} is not 2 or 3 x C = {c}")
    if c > 768:
        raise ValueError(f"the int8 LN GEMM takes C <= 768, got {c}")
    kt = -(-c // TILE_K)
    fixed, a_tile = STAGING_BYTES + ROW_SCALE_BYTES, CK.BM * kt * TILE_K
    for bn in widths:
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


def int8_plan(kind: str, c: int, n: int) -> dict:
    """Tiles of one launch of the int8 GEMMs. ``kind`` "ln"
    (``ln_fc1_gelu_int8``, x (M, c) -> (M, n)), "rowmax" (``ln_fc1_rowmax_int8``,
    the same kernel) or "qkv" (``ln_qkv_int8``, n = 2c or 3c, column tiles
    dividing c): ``bn`` columns of 128, 96 or 64 (the first that divides n:
    96 first for "rowmax" up to c = 192, where its short epilogue runs faster
    on narrower items, PERF.md PR 22), W ``resident`` in the ring where all
    of it fits beside two (else one) A buffers, else streamed through
    ``stages`` (two A buffers where four stages still fit). "res"
    (``fc2_scale_residual_int8``, a hidden (M, n) -> (M, c)) or "proj"
    (``proj_scale_residual_int8``, n = c): ``bn`` the widest of 128 / 96 / 64
    dividing c, W held in shared memory apart from the ring (``resident``,
    ``held`` bytes) where four A stages still fit beside it. "mlp"
    (``mlp_int8_scale_residual``, x's codes (M, c), hidden n in chunks of
    128, the last one shorter where 128 does not divide n): the fewest
    output column tiles ``col_tiles`` (fc1 is computed once for each) whose
    ``ow`` columns for each of ``no`` output warpgroups are a width the
    kernel is built for and whose rings fit: all of W1 and W2
    ``resident`` (loaded once: ``s1`` every K tile of W1, ``s2`` every chunk
    of W2) where they fit beside two x tiles or one (``x_buffers``), else
    streamed, preferring two W2 stages, then two x tiles, W1's ring a
    chunk's K tiles and both rings deepened in turn while room is left.
    ``smem`` bytes in all. Independent of M."""
    if c % 32 or n % 32 or c <= 0 or n <= 0:
        raise ValueError(f"widths {c}, {n} are not multiples of 32")
    if kind == "mlp":
        return _mlp_plan(c, n)
    if kind in ("ln", "rowmax", "qkv"):
        narrow_first = kind == "rowmax" and c <= 192
        return _ln_plan(kind, c, n, (96, 128, 64) if narrow_first else (128, 96, 64))
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
    raise ValueError(f"kind must be 'ln', 'rowmax', 'qkv', 'res', 'proj' or 'mlp', got {kind!r}")


@functools.lru_cache(maxsize=None)
def _ln_plan_args(kind: str, c: int, n: int) -> tuple:
    p = int8_plan(kind, c, n)
    return p["bn"], p["stages"], p["a_buffers"], int(p["resident"])


@functools.lru_cache(maxsize=None)
def _res_plan_args(kind: str, c: int, n: int) -> tuple:
    p = int8_plan(kind, c, n)
    return p["bn"], p["stages"], int(p["resident"])


@functools.lru_cache(maxsize=None)
def _mlp_plan_args(c: int, n: int) -> tuple:
    p = int8_plan("mlp", c, n)
    return p["col_tiles"], p["s1"], p["s2"], p["x_buffers"], int(p["resident"])


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
                      w_q: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor, eps: float,
                      out_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, ...]:
    """(M, C) -> LN -> per-row int8 -> @ w_q (S C, C)^T, dequantized, + b ->
    S (M, C) outputs (q, k, v or k, v) in ``out_dtype`` (default x's)."""
    o = Q8.dot_i8(_layer_norm(x, ln_weight, ln_bias, eps), w_q.t(), w_scale,
                  b).to(out_dtype or x.dtype)
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


def _fc1_gelu(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              b1: torch.Tensor) -> torch.Tensor:
    """The hidden from x's codes and row scales (M,): ``f32(acc) * (s_x *
    w_scale) + b1`` -> exact GELU, f32 (M, N)."""
    h = Q8.dequant(Q8.int_matmul(x_q, w_q.t()), x_scale.view(-1, 1), w_scale, b1)
    return F.gelu(h, approximate="none")


def ln_fc1_rowmax_int8_plain(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                             w_q: torch.Tensor, w_scale: torch.Tensor, b1: torch.Tensor,
                             eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1 of the MLP pair: (M, C) -> LN -> per-row int8 (codes (M, C),
    scales (M,)) -> :func:`ln_fc1_gelu_int8_plain`'s hidden -> its row scales
    (M,), as :func:`quantize_rows_plain` takes them."""
    x_q, x_s = Q8.dyn_quant_rows(_layer_norm(x, ln_weight, ln_bias, eps))
    _, h_s = Q8.dyn_quant_rows(_fc1_gelu(x_q, x_s, w_q, w_scale, b1))  # the chain's quantize
    return x_q, x_s.view(-1), h_s.view(-1)


def mlp_int8_scale_residual_plain(x_q: torch.Tensor, x_scale: torch.Tensor, h_scale: torch.Tensor,
                                  w1_q: torch.Tensor, w1_scale: torch.Tensor, b1: torch.Tensor,
                                  w2_q: torch.Tensor, w2_scale: torch.Tensor, b2: torch.Tensor,
                                  gamma: torch.Tensor, residual: torch.Tensor,
                                  out_dtype: torch.dtype) -> torch.Tensor:
    """Pass 2 of the MLP pair: the hidden from x's codes again, its codes
    with pass 1's row scales ``h_scale``, then
    :func:`fc2_scale_residual_int8_plain`."""
    h_q = Q8.quant_rows_with(_fc1_gelu(x_q, x_scale, w1_q, w1_scale, b1), h_scale.view(-1, 1))
    return fc2_scale_residual_int8_plain(h_q, h_scale, w2_q, w2_scale, b2, gamma, residual,
                                         out_dtype)


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


def _check_ln_fc1(x, ln_weight, ln_bias, w_q, w_scale, b1) -> Tuple[int, int, int]:
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
    return m, c, n


def _f32_out(name: str, out_dtype: torch.dtype, residual: torch.Tensor) -> bool:
    """Whether a residual kernel writes f32: bf16 beside any residual, f32
    beside an f32 one (an f32 block's)."""
    if out_dtype == torch.bfloat16:
        return False
    if out_dtype == torch.float32 and residual.dtype == torch.float32:
        return True
    raise TypeError(f"{name} writes bf16, or f32 beside an f32 residual; got {out_dtype} with a "
                    f"{residual.dtype} residual")


def ln_fc1_gelu_int8(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                     w_q: torch.Tensor, w_scale: torch.Tensor, b1: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """LN + int8 Linear C -> N + exact GELU on rows. CUDA: x f32 (M, C), LN
    params f32 (C,), w_q int8 (N, C), w_scale and b1 f32 (N,) -> f32 (M, N).
    The MLP pair's yardstick (:func:`mlp_int8_chain`): the model path calls
    :func:`ln_fc1_rowmax_int8` instead."""
    if x.device.type == "cpu":
        return ln_fc1_gelu_int8_plain(x, ln_weight, ln_bias, w_q, w_scale, b1, eps)
    m, c, n = _check_ln_fc1(x, ln_weight, ln_bias, w_q, w_scale, b1)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _launch("ln_fc1_gelu_int8", "ln_fc1_gelu_int8", x.data_ptr(), ln_weight.data_ptr(),
            ln_bias.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), b1.data_ptr(), out.data_ptr(),
            m, c, n, float(eps), *_ln_plan_args("ln", c, n), _stream(x.device))
    return out


def ln_fc1_rowmax_int8(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                       w_q: torch.Tensor, w_scale: torch.Tensor, b1: torch.Tensor,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1 of the MLP pair: LN + int8 Linear C -> N + exact GELU, keeping
    only each row's abs-max of the hidden. CUDA: x f32 (M, C), LN params f32
    (C,), w_q int8 (N, C), w_scale and b1 f32 (N,) -> (x's codes int8 (M, C),
    their scales f32 (M,), the hidden's row scales f32 (M,))."""
    if x.device.type == "cpu":
        return ln_fc1_rowmax_int8_plain(x, ln_weight, ln_bias, w_q, w_scale, b1, eps)
    m, c, n = _check_ln_fc1(x, ln_weight, ln_bias, w_q, w_scale, b1)
    x_q = torch.empty((m, c), dtype=torch.int8, device=x.device)
    x_s = torch.empty((m,), dtype=torch.float32, device=x.device)
    h_s = torch.empty((m,), dtype=torch.float32, device=x.device)
    _launch("ln_fc1_rowmax_int8", "ln_fc1_rowmax_int8", x.data_ptr(), ln_weight.data_ptr(),
            ln_bias.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), b1.data_ptr(), x_q.data_ptr(),
            x_s.data_ptr(), h_s.data_ptr(), m, c, n, float(eps), *_ln_plan_args("rowmax", c, n),
            _stream(x.device))
    return x_q, x_s, h_s


def mlp_int8_scale_residual(x_q: torch.Tensor, x_scale: torch.Tensor, h_scale: torch.Tensor,
                            w1_q: torch.Tensor, w1_scale: torch.Tensor, b1: torch.Tensor,
                            w2_q: torch.Tensor, w2_scale: torch.Tensor, b2: torch.Tensor,
                            gamma: torch.Tensor, residual: torch.Tensor,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """Pass 2 of the MLP pair: fc1 from x's codes, GELU, the hidden's codes
    with pass 1's scales, fc2, ``(+ b2) * gamma + residual``; the hidden stays
    on chip. CUDA: x_q int8 (M, C) with scales f32 (M,), h_scale f32 (M,),
    w1_q int8 (N, C) and w2_q int8 (C, N) with their scales, b1 f32 (N,), b2
    and gamma f32 (C,), residual bf16 or f32 (M, C) -> bf16, or an f32
    residual -> f32 (``mlp_int8_scale_residual_f32``); N a multiple of 32 (a
    last hidden chunk short of 128 reads TMA's zero fill); C / R one of
    ``MLP_COLUMN_TILES`` (:func:`int8_plan` "mlp")."""
    if x_q.device.type == "cpu":
        return mlp_int8_scale_residual_plain(x_q, x_scale, h_scale, w1_q, w1_scale, b1, w2_q,
                                             w2_scale, b2, gamma, residual, out_dtype)
    out_f32 = _f32_out("mlp_int8_scale_residual", out_dtype, residual)
    if x_q.ndim != 2:
        raise ValueError(f"x_q must be (M, C), got {tuple(x_q.shape)}")
    m, c = x_q.shape
    n = w1_q.shape[0]
    _check_rows(m)
    _check_width(c)
    _check_width(n)
    dev = x_q.device
    _check("x_q", x_q, torch.int8, (m, c), dev)
    _check("x_scale", x_scale, torch.float32, (m,), dev)
    _check("h_scale", h_scale, torch.float32, (m,), dev)
    _check_int8_weight("w1_q", w1_q, w1_scale, (n, c), dev)
    _check("b1", b1, torch.float32, (n,), dev)
    _check_int8_weight("w2_q", w2_q, w2_scale, (c, n), dev)
    _check("b2", b2, torch.float32, (c,), dev)
    _check("gamma", gamma, torch.float32, (c,), dev)
    res_f32 = residual.dtype == torch.float32
    _check("residual", residual, torch.float32 if res_f32 else torch.bfloat16, (m, c), dev)
    plan = _mlp_plan_args(c, n)
    out = torch.empty((m, c), dtype=out_dtype, device=dev)
    _launch("mlp_int8_scale_residual",
            "mlp_int8_scale_residual_f32" if out_f32 else "mlp_int8_scale_residual",
            x_q.data_ptr(), x_scale.data_ptr(), h_scale.data_ptr(), w1_q.data_ptr(),
            w1_scale.data_ptr(), b1.data_ptr(), w2_q.data_ptr(), w2_scale.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), residual.data_ptr(), out.data_ptr(), m, c, n,
            int(res_f32), int(out_f32), *plan, _stream(dev))
    return out


def gelu_bits_check(device: torch.device) -> Tuple[int, Optional[int]]:
    """The pair's GELU against ``ln_fc1_gelu_int8``'s over all 2^32 f32
    inputs on the card: (inputs whose bits differ, NaN against NaN counting
    as equal; the smallest such input's bits or None). Not a launch of the
    model path, so not counted."""
    counts = torch.tensor([0, -1], dtype=torch.int64, device=device)  # [1]: all ones
    err = _lib().gelu_bits_check(counts.data_ptr(), _stream(device))
    if err != 0:
        raise RuntimeError(f"gelu_bits_check: CUDA launch failed with cudaError {err}")
    bad, first = counts.tolist()
    return bad, (first & 0xFFFFFFFF) if bad else None


def gelu_mono_check(device: torch.device) -> Dict[str, int]:
    """The two facts about the kernels' GELU that ``ln_fc1_rowmax_int8``
    leans on, over all 2^32 f32 inputs on the card: how many inputs break
    each (``below_zero``: x >= 0 with GELU < 0; ``descents``: x >= 0 whose
    next float's GELU is smaller; ``over_peak``: x < 0 with GELU > 0 or
    |GELU| over the kernel's bound 0.169971228), all 0 for the kernel to be
    exact; and ``at_peak``, the inputs whose |GELU| is the bound (> 0: it is
    reached). Not a launch of the model path, so not counted."""
    counts = torch.zeros(4, dtype=torch.int64, device=device)
    err = _lib().gelu_mono_check(counts.data_ptr(), _stream(device))
    if err != 0:
        raise RuntimeError(f"gelu_mono_check: CUDA launch failed with cudaError {err}")
    return dict(zip(("below_zero", "descents", "over_peak", "at_peak"), counts.tolist()))


def ln_qkv_int8(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                w_q: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor,
                eps: float, out_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, ...]:
    """LN + int8 Linear C -> S C on rows, split into S (M, C) outputs in
    ``out_dtype`` (default x's). CUDA: x (M, C) bf16 or f32, LN params f32,
    w_q int8 (S C, C), w_scale and b f32 (S C,): bf16 x -> bf16
    (``ln_qkv_int8``) or f32 (``ln_qkv_int8_mmf32``, the monoblock's q, k, v
    under ``VIPTPU_GCVIT_MM=f32``); f32 x -> f32 (``ln_qkv_int8_f32``)."""
    if x.device.type == "cpu":
        return ln_qkv_int8_plain(x, ln_weight, ln_bias, w_q, w_scale, b, eps, out_dtype)
    out_dt = out_dtype or x.dtype
    counter = {(torch.bfloat16, torch.bfloat16): "ln_qkv_int8",
               (torch.bfloat16, torch.float32): "ln_qkv_int8_mmf32",
               (torch.float32, torch.float32): "ln_qkv_int8_f32"}.get((x.dtype, out_dt))
    if counter is None:
        raise TypeError(f"ln_qkv_int8 takes bf16 x to bf16 or f32, or f32 x to f32; got {x.dtype} "
                        f"x to {out_dt}")
    if x.ndim != 2:
        raise ValueError(f"x must be (M, C), got {tuple(x.shape)}")
    m, c = x.shape
    _check_rows(m)
    _check_width(c)
    s = w_q.shape[0] // c
    if s not in (2, 3) or w_q.shape[0] != s * c:
        raise ValueError(f"w_q must be (2C or 3C, C) for C = {c}, got {tuple(w_q.shape)}")
    _check("x", x, x.dtype, (m, c), x.device)
    _check("ln_weight", ln_weight, torch.float32, (c,), x.device)
    _check("ln_bias", ln_bias, torch.float32, (c,), x.device)
    _check_int8_weight("w_q", w_q, w_scale, (s * c, c), x.device)
    _check("b", b, torch.float32, (s * c,), x.device)
    outs = [torch.empty((m, c), dtype=out_dt, device=x.device) for _ in range(s)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - s)
    _launch("ln_qkv_int8", counter, x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(),
            w_q.data_ptr(), w_scale.data_ptr(), b.data_ptr(), *ptrs, m, c, s, float(eps),
            int(x.dtype == torch.float32), int(out_dt == torch.float32),
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
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel writes bf16 or f32, not {out_dtype}")
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
    (C,), b2 and gamma f32 (C,), residual bf16 or f32 (M, C) -> bf16, or an
    f32 residual -> f32 (``fc2_scale_residual_int8_f32``). The MLP pair's
    yardstick (:func:`mlp_int8_chain`): the model path calls
    :func:`mlp_int8_scale_residual` instead."""
    if a_q.device.type == "cpu":
        return fc2_scale_residual_int8_plain(a_q, a_scale, w_q, w_scale, b2, gamma, residual,
                                             out_dtype)
    f32 = _f32_out("fc2_scale_residual_int8", out_dtype, residual)
    return _res_gemm("fc2_scale_residual_int8_f32" if f32 else "fc2_scale_residual_int8", "res",
                     a_q, a_scale, w_q, w_scale, b2, gamma, residual, out_dtype)


def proj_scale_residual_int8(a_q: torch.Tensor, a_scale: torch.Tensor, wp_q: torch.Tensor,
                             wp_scale: torch.Tensor, bp: torch.Tensor, gamma: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """r1 = x + gamma * (int8 proj of quantized rows + bp). CUDA: a_q int8
    (M, C) with scales f32 (M,), wp_q int8 (C, C) with scales, bp and gamma
    f32 (C,), x bf16 (M, C) -> f32 (M, C), or f32 x (an f32 block's,
    ``proj_scale_residual_int8_f32``)."""
    if a_q.device.type == "cpu":
        return proj_scale_residual_int8_plain(a_q, a_scale, wp_q, wp_scale, bp, gamma, x)
    if wp_q.shape[0] != a_q.shape[-1]:
        raise ValueError(f"wp_q must be (C, C) for C = {a_q.shape[-1]}, got {tuple(wp_q.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x has dtype {x.dtype}, the kernel takes bfloat16 or float32")
    f32 = x.dtype == torch.float32
    return _res_gemm("proj_scale_residual_int8_f32" if f32 else "proj_scale_residual_int8", "proj",
                     a_q, a_scale, wp_q, wp_scale, bp, gamma, x, torch.float32)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
def mlp_int8_chain(x: torch.Tensor, ln_weight, ln_bias, fc1: Int8Weight, b1, fc2: Int8Weight, b2,
                   gamma, residual: torch.Tensor, out_dtype: torch.dtype,
                   eps: float) -> torch.Tensor:
    """The MLP as three launches, the hidden through device memory:
    ``ln_fc1_gelu_int8`` -> ``quantize_rows`` -> ``fc2_scale_residual_int8``.
    The pair's yardstick, equal to :func:`mlp_int8` bit for bit; the model
    path does not call it."""
    hid = ln_fc1_gelu_int8(x, ln_weight, ln_bias, fc1.q, fc1.s, b1, eps)
    h_q, h_s = quantize_rows(hid)
    return fc2_scale_residual_int8(h_q, h_s, fc2.q, fc2.s, b2, gamma, residual, out_dtype)


def mlp_int8(x: torch.Tensor, ln_weight, ln_bias, fc1: Int8Weight, b1, fc2: Int8Weight, b2, gamma,
             residual: torch.Tensor, out_dtype: torch.dtype, eps: float) -> torch.Tensor:
    """A block's MLP with its residual on rows (M, C): gamma * fc2(gelu(fc1(
    LN(x)))) + residual, the hidden quantized per row over its N columns,
    by the pair ``ln_fc1_rowmax_int8`` -> ``mlp_int8_scale_residual``."""
    x_q, x_s, h_s = ln_fc1_rowmax_int8(x, ln_weight, ln_bias, fc1.q, fc1.s, b1, eps)
    return mlp_int8_scale_residual(x_q, x_s, h_s, fc1.q, fc1.s, b1, fc2.q, fc2.s, b2, gamma,
                                   residual, out_dtype)


def convnext_block_int8(x: torch.Tensor, dw_kernel, dw_bias, ln_weight, ln_bias,
                        fc1: Int8Weight, b1, fc2: Int8Weight, b2, gamma,
                        eps: float = 1e-6) -> torch.Tensor:
    """Whole ConvNeXt block on NHWC x with int8 MLP GEMMs:
    x + gamma * fc2(gelu(fc1(LN(dw7x7(x) + dw_bias)))), the hidden quantized
    per row over its 4C columns."""
    b, h, w, c = x.shape
    m = b * h * w
    d = CK.dwconv7x7_nhwc(x, dw_kernel, dw_bias)
    out = mlp_int8(d.view(m, c), ln_weight, ln_bias, fc1, b1, fc2, b2, gamma, x.reshape(m, c),
                   x.dtype, eps)
    return out.view(b, h, w, c)


def window_transformer_block_int8(x: torch.Tensor, q_global: Optional[torch.Tensor], *, n: int,
                                  ln1_weight, ln1_bias, qkv: Int8Weight, bqkv, bias,
                                  proj: Int8Weight, bp, gamma1, ln2_weight, ln2_bias,
                                  fc1: Int8Weight, b1, fc2: Int8Weight, b2, gamma2,
                                  scale: Optional[float] = None, eps: float = 1e-5,
                                  mm_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One GCViT block (:func:`.gcvit_block.window_transformer_block`) with
    its qkv, proj, fc1 and fc2 GEMMs int8; the attention's products stay in
    ``mm_dtype`` (default x's: the compute dtype, or ``VIPTPU_GCVIT_MM``'s),
    r1 in f32, and the output in x's dtype."""
    b, toks, c = x.shape
    heads = bias.shape[0]
    scale = scale if scale is not None else (c // heads) ** -0.5
    mm = mm_dtype or x.dtype
    x2 = x.reshape(b * toks, c)
    parts = [p.view(b, toks, c) for p in ln_qkv_int8(x2, ln1_weight, ln1_bias, qkv.q, qkv.s,
                                                     bqkv, eps, G.qkv_dtype(x.dtype, mm))]
    q, k, v = parts if q_global is None else (q_global, *parts)
    attn = G.window_attention(q, k, v, bias, n, scale, q_is_global=q_global is not None,
                              mm_dtype=mm, out_dtype=x.dtype)
    a_q, a_s = quantize_rows(attn.view(b * toks, c))
    r1 = proj_scale_residual_int8(a_q, a_s, proj.q, proj.s, bp, gamma1, x2)
    return mlp_int8(r1, ln2_weight, ln2_bias, fc1, b1, fc2, b2, gamma2, r1, x.dtype,
                    eps).view(b, toks, c)
