"""int8 and bf16 tensor-core GEMMs: the CUDA kernels for Hopper and their
plain PyTorch versions.

Replaces the TPU kernel ``_call`` of ``tools/int8_pallas_spike.py`` with its
three bodies, and runs the int8 sites of post-training quantization
(:mod:`...quant.ptq`) that the JAX package leaves to XLA's int8
``conv_general_dilated`` / ``dot_general`` (``quant/ptq.py``). All of them
run on one wgmma + TMA GEMM, ``csrc/ptq_int8.cuh`` on the engine of
``csrc/hopper_gemm.cuh`` (entry points in ``csrc/int8_gemm.cu``), with the
tiles of :func:`ptq_plan`:

- ``int8_spike_bf16``: bf16 x (M, K) @ bf16 w (K, N), f32 accumulation ->
  bf16 or f32;
- ``int8_spike_int8``: f32 or bf16 x quantized with a static scale ``sx``
  (``clip(round(x * (1 / sx)), -127, 127)``) @ int8 w (K, N), s32
  accumulation, ``f32(acc) * sx`` -> f32 or bf16: the PTQ site's quantize
  pass and GEMM with ``colscale = sx`` and no bias (two launches; one where
  the GEMM quantizes bf16 rows itself, :func:`quantizes_in_gemm`);
- ``int8_spike_direct``: int8 x @ int8 w (K, N) -> int32, the GEMM with its
  s32 sums stored as they are;
- ``ptq_int8_conv``: a PTQ site. ``ptq_int8_quantize`` quantizes x (f32
  or bf16) once with the site's calibrated scale into an int8 copy in x's
  layout; then ``ptq_int8_gemm`` (counted as ``ptq_int8_conv``) multiplies
  it with the int8
  per-output-channel weights, ``(N, Kp)`` with K = (kh, kw, c) contiguous and
  zero-padded to ``Kp``, a multiple of 64 (:func:`pack_weight`), by int8
  wgmma with s32 sums; the epilogue is ``f32(acc) * colscale[n] (+
  bias[n])`` in f32, cast to ``out_dtype``. A Dense site or an unpadded 1 x 1
  stride-1 ungrouped conv reads the int8 x as (M, K) rows by TMA; any other
  conv (and a rows site whose K is not a multiple of 16) gathers its windows
  from the NHWC int8 x inside the kernel (implicit GEMM, zeros in the
  padding, which is a symmetric int or ``((top, bottom), (left, right))``
  pairs, as XLA's TF ``SAME`` pads), in ``groups`` groups: the output columns
  of group g read its input channels [g C / G, (g + 1) C / G) with K = kh kw
  C / G, XLA's ``feature_group_count`` (NFNet's grouped 3 x 3 convs).
  A bf16 rows site whose output spans one or two column tiles skips the
  pass: the GEMM reads its bf16 rows and quantizes them itself
  (:func:`quantizes_in_gemm`). The tiles come from :func:`ptq_plan`.

Rounding is the JAX package's: the activation scale's reciprocal is the f64
``1 / s`` rounded once to f32 (:func:`f32_reciprocal`), products round half
to even, and the s32 sum is converted to f32 by round to nearest, so kernel,
plain version and JAX agree bit for bit wherever the f32 result is exact.

The GEMM reads an int8 weight as (N, Kp), K contiguous (:func:`pack_weight`);
the spike's wrappers take w as (K, N) and pack it on the card at each call
unless a ``w_packed`` from :func:`pack_weight` is passed (packed once, as a
model packs its weights at load).

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
from .convnext_block import (SMEM_LIMIT, _ALIGN, _barrier_bytes, _check, _check_no_grad,
                             _stages_that_fit, _stream)

LAUNCHES: Dict[str, int] = {"int8_spike_bf16": 0, "int8_spike_int8": 0,
                            "int8_spike_direct": 0, "ptq_int8_quantize": 0, "ptq_int8_conv": 0}

K_ALIGN = 64  # packed weight rows are padded to the kernel's K slice
MAX_KERNEL = 8  # a gathered row's taps are a 64-bit mask (csrc/ptq_int8.cuh: RowWindow)
MAX_ROWS = 65535 * 128  # the grid's row-tile limit

# the PTQ GEMM's tiles (csrc/ptq_int8.cuh checks the same limits)
PTQ_WIDTHS = (64, 128)  # column tiles (wgmma n) the GEMM is built for
PTQ_TILE_K = 128  # int8 of K a stage: one 128-byte swizzle row
PTQ_BM = 128  # rows of a work item: 64 for each warpgroup of a consumer pair
PTQ_STAGING = 16 * 2048  # the 16 consumer warps' f32 epilogue staging
PTQ_GEOMETRY = 2 * 2 * PTQ_BM * 16  # two tables of a (tall) item's gathered rows' windows
PTQ_MIN_HELD_STAGES = 3  # W stays in shared memory only where this many stages still fit
PTQ_MAX_RING = 8
# where the GEMM's A comes from (csrc/ptq_int8.cuh: Source)
PTQ_ROWS, PTQ_GATHER, PTQ_ROWS_QUANT = 0, 1, 2
PTQ_QUANT_MAX_COLUMN_TILES = 2  # a bf16 rows site this narrow is quantized in the GEMM
MAX_TX_BYTES = (1 << 20) - 1  # what one mbarrier's transaction count takes

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ptq_int8_conv: a, w, ldw, colscale, bias, out, out_f32, M, K, N, src, inv_s, the geometry
# (H, W, C, KW, stride, pad_h, pad_w, groups, Ho, Wo), the plan (bn, stages, resident, tall),
# stream
GEOMETRY_ARGS = 10
_PTQ_ARGS = [_P, _P, _I, _P, _P, _P, _I] + [_I] * 4 + [_F] + [_I] * GEOMETRY_ARGS + [_I] * 4 + [_P]
# the spike's small GEMMs (ptq_plan with m): how many times over 256-row
# items must fill the card's SMs before they pay (measured at the spike's
# shapes on the H100: bf16 operands stream twice W's bytes per K and gain
# from tall items sooner)
TALL_FILL = {1: 4, 2: 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("int8_gemm")
    argtypes = {
        # x, w, ldw, out, out_f32, M, K, N, the plan, stream
        "int8_spike_bf16": [_P, _P, _I, _P] + [_I] * 4 + [_I] * 4 + [_P],
        # a, w, ldw, out, M, K, N, src, the geometry, the plan, stream
        "int8_spike_direct": [_P, _P, _I, _P] + [_I] * 4 + [_I] * GEOMETRY_ARGS + [_I] * 4 + [_P],
        "ptq_int8_quantize": [_P, _I, _P, ctypes.c_longlong, _F, _P],
        "ptq_int8_conv": _PTQ_ARGS,
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _cut_lib() -> ctypes.CDLL:
    lib = build.load("ptq_int8_cuts")
    lib.ptq_int8_conv_cut.argtypes = _PTQ_ARGS[:6] + _PTQ_ARGS[7:-1] + [_I, _P]  # + the cut
    lib.ptq_int8_conv_cut.restype = ctypes.c_int
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


def _spike_weight(name: str, w: torch.Tensor, w_packed: Optional[torch.Tensor], k: int,
                  n: int) -> torch.Tensor:
    """The (N, Kp) K-major weight: ``w_packed`` checked, or ``w`` packed now."""
    if w_packed is None:
        return pack_weight(w)
    if (w_packed.ndim != 2 or w_packed.shape[0] != n or w_packed.shape[1] < k
            or w_packed.shape[1] % K_ALIGN):
        raise ValueError(f"{name}: w_packed {tuple(w_packed.shape)} is not pack_weight's (N, Kp) "
                         f"for K = {k}, N = {n}")
    _check("w_packed", w_packed, w.dtype, tuple(w_packed.shape), w.device)
    return w_packed


def int8_spike_bf16(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16,
                    *, w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``_bf16_kernel``: bf16 x (M, K) @ bf16 w (K, N), f32 accumulation,
    -> ``out_dtype`` (bf16 or f32). ``w_packed``: w packed by
    :func:`pack_weight` beforehand. CUDA: x whose K is not a multiple of 8
    (TMA's 16-byte row stride) is zero-padded to one on the card first."""
    if x.device.type == "cpu":
        return int8_spike_bf16_plain(x, w, out_dtype)
    m, k, n = _check_spike("int8_spike_bf16", x, (torch.bfloat16,), w, torch.bfloat16)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes bf16 or f32")
    wk = _spike_weight("int8_spike_bf16", w, w_packed, k, n)
    if k % 8:  # the packed weight's zeros past K meet the padding
        x = F.pad(x, (0, 8 - k % 8))
    kx = x.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _launched("int8_spike_bf16", _lib().int8_spike_bf16(
        x.data_ptr(), wk.data_ptr(), wk.shape[1], out.data_ptr(), int(out_dtype == torch.float32),
        m, kx, n, *_ptq_plan_args(n, kx, PTQ_ROWS, 2, m, _sm_count(x.device)),
        _stream(x.device)))
    return out


def int8_spike_int8(x: torch.Tensor, w: torch.Tensor, sx: float,
                    out_dtype: torch.dtype = torch.float32, *,
                    w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``_int8_kernel``: x (f32 or bf16) quantized with the static scale
    ``sx``, @ int8 w (K, N), s32 accumulation, ``f32(acc) * sx`` ->
    ``out_dtype`` (f32 or bf16). CUDA: ``ptq_int8_quantize`` (counted there)
    then the PTQ GEMM with ``colscale = sx`` and no bias, or the GEMM alone
    on bf16 rows where it quantizes them itself (:func:`quantizes_in_gemm`);
    ``w_packed``: w packed by :func:`pack_weight` beforehand."""
    if x.device.type == "cpu":
        return int8_spike_int8_plain(x, w, sx, out_dtype)
    m, k, n = _check_spike("int8_spike_int8", x, (torch.float32, torch.bfloat16), w, torch.int8)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes bf16 or f32")
    qw = _spike_weight("int8_spike_int8", w, w_packed, k, n)
    site = _site_of((m, k), tuple(qw.shape), None, 1, NO_PADDING, 1)
    inv = f32_reciprocal(sx)
    if quantizes_in_gemm(x.dtype, out_dtype, None, 1, 0, k, n):
        a, src = x, PTQ_ROWS_QUANT
    else:
        a, src = _quantize(x, inv), PTQ_GATHER if site["gather"] else PTQ_ROWS
    colscale = torch.full((n,), float(sx), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _launched("int8_spike_int8", _lib().ptq_int8_conv(
        a.data_ptr(), qw.data_ptr(), site["kp"], colscale.data_ptr(), None, out.data_ptr(),
        int(out_dtype == torch.float32), m, k, n, src, inv, *site["geometry"],
        *_ptq_plan_args(n, k, src, 1, m, _sm_count(x.device)), _stream(x.device)))
    return out


def int8_spike_direct(x: torch.Tensor, w: torch.Tensor, *,
                      w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``_int8_direct_kernel``: int8 x (M, K) @ int8 w (K, N) -> int32.
    ``w_packed``: w packed by :func:`pack_weight` beforehand."""
    if x.device.type == "cpu":
        return int8_spike_direct_plain(x, w)
    m, k, n = _check_spike("int8_spike_direct", x, (torch.int8,), w, torch.int8)
    qw = _spike_weight("int8_spike_direct", w, w_packed, k, n)
    site = _site_of((m, k), tuple(qw.shape), None, 1, NO_PADDING, 1)
    src = PTQ_GATHER if site["gather"] else PTQ_ROWS
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    _launched("int8_spike_direct", _lib().int8_spike_direct(
        x.data_ptr(), qw.data_ptr(), site["kp"], out.data_ptr(), m, k, n, src,
        *site["geometry"], *_ptq_plan_args(n, k, src, 1, m, _sm_count(x.device)),
        _stream(x.device)))
    return out


# ---------------------------------------------------------------------------
# the PTQ site
# ---------------------------------------------------------------------------
def pack_weight(qw_kn: torch.Tensor) -> torch.Tensor:
    """int8 (or bf16) (K, N) (a Flax HWIO kernel reshaped, or a Dense
    kernel) -> the kernel's (N, Kp) layout, K contiguous and zero-padded to
    a multiple of :data:`K_ALIGN`."""
    k, n = qw_kn.shape
    kp = -(-k // K_ALIGN) * K_ALIGN
    packed = torch.zeros((n, kp), dtype=qw_kn.dtype, device=qw_kn.device)
    packed[:, :k] = qw_kn.t()
    return packed


NO_PADDING = ((0, 0), (0, 0))


def padding_pairs(padding) -> tuple:
    """``((top, bottom), (left, right))`` of a symmetric int or of pairs."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (pt, pb), (pl, pr) = padding
    return (int(pt), int(pb)), (int(pl), int(pr))


def _conv_out(size: int, kernel: int, stride: int, pads: tuple) -> int:
    return (size + pads[0] + pads[1] - kernel) // stride + 1


def ptq_int8_conv_plain(x: torch.Tensor, qweight: torch.Tensor, colscale: torch.Tensor,
                        bias: Optional[torch.Tensor], inv_s: float, *, kernel: Optional[int],
                        stride: int = 1, padding=0, groups: int = 1,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The site's function in plain PyTorch: see :func:`ptq_int8_conv`."""
    return ptq_int8_gemm_plain(quantize(x, inv_s), qweight, colscale, bias, kernel=kernel,
                               stride=stride, padding=padding, groups=groups,
                               out_dtype=out_dtype or x.dtype)


def ptq_int8_gemm_plain(q: torch.Tensor, qweight: torch.Tensor, colscale: torch.Tensor,
                        bias: Optional[torch.Tensor], *, kernel: Optional[int], stride: int = 1,
                        padding=0, groups: int = 1,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The site's GEMM on x quantized beforehand (int8 q in x's shape), in
    plain PyTorch: see :func:`ptq_int8_gemm`."""
    n = qweight.shape[0]
    if kernel is None:
        acc = _exact_matmul(q, qweight[:, :q.shape[-1]].t())
    else:
        cg = q.shape[-1] // groups
        w = qweight[:, :kernel * kernel * cg].reshape(n, kernel, kernel, cg).permute(0, 3, 1, 2)
        (pt, pb), (pl, pr) = padding_pairs(padding)
        xq = F.pad(q.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
        acc = F.conv2d(xq, w.double(), None, stride, 0, groups=groups)
        acc = _to_int32(acc.permute(0, 2, 3, 1))
    y = acc.float() * colscale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype).contiguous()


def ptq_plan(n: int, k: int, src: int, esize: int = 1, m: Optional[int] = None,
             sms: Optional[int] = None, group_n: Optional[int] = None) -> dict:
    """The PTQ GEMM's tiles for an (M, k) @ (k, n) site whose A comes from
    ``src`` (:data:`PTQ_ROWS`: int8 rows by TMA; :data:`PTQ_GATHER`: int8
    NHWC by cp.async, with its row tables; :data:`PTQ_ROWS_QUANT`: bf16 rows
    by TMA, two 16 KB boxes a stage, quantized by the consumers): ``bn``
    columns a work item (64 where n <= 64, else 128), ``stages`` of the ring,
    ``resident`` (all of W, ``held`` bytes, loaded once into shared memory
    where :data:`PTQ_MIN_HELD_STAGES` stages still fit beside it; the ring
    then carries A alone), ``tall`` (where W streams through the ring at bn
    = 128 from int8 A: 256-row items whose halves the two consumer pairs
    multiply against each stage's one W tile, half W's traffic) and
    ``smem`` bytes. ``esize`` 2: bf16 operands (the spike's bf16 body; 64
    of K a 128-byte tile), rows only. Without ``m`` (the PTQ sites, whose M
    is tens of thousands of rows) the plan is independent of M: the launcher
    sizes the persistent grid. With ``m`` (the spike's bodies, M of 625 ...
    4096) a streaming W's tiles follow the items the card gets, and ``sms``,
    the card's SM count, is required: 64 columns where 128 would give fewer
    items than ``sms``, 256-row items only where they still fill the SMs
    :data:`TALL_FILL` times over. ``group_n``: a grouped conv's output
    columns a group, which its column tiles must not straddle (128 where it
    is a multiple of 128, else 64; ``k`` is then a group's K)."""
    if (n <= 0 or k <= 0 or n % 4 or src not in (PTQ_ROWS, PTQ_GATHER, PTQ_ROWS_QUANT)
            or esize not in (1, 2) or (esize == 2 and src != PTQ_ROWS)):
        raise ValueError(f"the PTQ GEMM takes N a positive multiple of 4, K > 0 and a source "
                         f"0-2 (bf16: rows), got {n}, {k}, {src}, {esize} bytes")
    if m is not None and not (sms or 0) > 0:
        raise ValueError(f"a plan for M = {m} rows needs the card's SM count, got {sms}")
    bn = PTQ_WIDTHS[0] if n <= PTQ_WIDTHS[0] else PTQ_WIDTHS[1]
    if group_n is not None:
        if group_n % PTQ_WIDTHS[0] or n % group_n or src != PTQ_GATHER or m is not None:
            raise ValueError(f"a grouped site gathers whole {PTQ_WIDTHS[0]}-column tiles a group, "
                             f"got {n} columns in groups of {group_n}, source {src}")
        bn = PTQ_WIDTHS[1] if group_n % PTQ_WIDTHS[1] == 0 else PTQ_WIDTHS[0]
    fixed = PTQ_STAGING + (PTQ_GEOMETRY if src == PTQ_GATHER else 0)
    a_stage = PTQ_BM * PTQ_TILE_K * (3 if src == PTQ_ROWS_QUANT else 1)  # + the bf16 boxes
    w_tile = bn * PTQ_TILE_K
    held = -(-n // bn) * -(-k * esize // PTQ_TILE_K) * w_tile
    held_stages = _stages_that_fit(fixed + held, a_stage, PTQ_MAX_RING)
    resident = held <= MAX_TX_BYTES and held_stages >= PTQ_MIN_HELD_STAGES
    tall = not resident and bn == PTQ_WIDTHS[1] and src != PTQ_ROWS_QUANT
    if m is not None and not resident:
        n_cols, bm = -(-n // PTQ_WIDTHS[1]), PTQ_BM
        if -(-m // bm) * n_cols < sms:
            bn, tall = PTQ_WIDTHS[0], False
        else:
            tall = tall and -(-m // (2 * bm)) * n_cols >= TALL_FILL[esize] * sms
        w_tile = bn * PTQ_TILE_K
    if resident:
        stages, ring = held_stages, held + held_stages * a_stage
    else:
        a_stage *= 2 if tall else 1
        stages = _stages_that_fit(fixed, a_stage + w_tile, PTQ_MAX_RING)
        held, ring = 0, stages * (a_stage + w_tile)
    return dict(bn=bn, stages=stages, resident=resident, held=held, src=src, tall=tall,
                smem=_barrier_bytes(stages) + _ALIGN + fixed + ring)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` is on (the spike's plans size their
    items by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _ptq_plan_args(n: int, k: int, src: int, esize: int = 1, m: Optional[int] = None,
                   sms: Optional[int] = None, group_n: Optional[int] = None) -> tuple:
    p = ptq_plan(n, k, src, esize, m, sms, group_n)
    return p["bn"], p["stages"], int(p["resident"]), int(p["tall"])


def quantizes_in_gemm(x_dtype: torch.dtype, out_dtype: torch.dtype, kernel: Optional[int],
                      stride: int, padding, k: int, n: int, groups: int = 1) -> bool:
    """Whether a site skips the quantize pass: a bf16 rows site (a Dense site
    or an unpadded, ungrouped 1 x 1 stride-1 conv) with a bf16 output, K a
    multiple of 8 (TMA's 16-byte row stride) and N within
    :data:`PTQ_QUANT_MAX_COLUMN_TILES` column tiles (wider, each column tile
    would quantize A again)."""
    rows = kernel is None or (kernel == 1 and stride == 1 and groups == 1
                              and padding_pairs(padding) == NO_PADDING)
    bn = PTQ_WIDTHS[0] if n <= PTQ_WIDTHS[0] else PTQ_WIDTHS[1]
    return (rows and x_dtype == torch.bfloat16 and out_dtype == torch.bfloat16 and k % 8 == 0
            and -(-n // bn) <= PTQ_QUANT_MAX_COLUMN_TILES)


def ptq_int8_quantize_plain(x: torch.Tensor, inv_s: float) -> torch.Tensor:
    """The quantize pass in plain PyTorch: :func:`quantize`."""
    return quantize(x, inv_s)


def ptq_int8_quantize(x: torch.Tensor, inv_s: float) -> torch.Tensor:
    """int8 ``clip(round(x_f32 * inv_s), -127, 127)`` in x's shape, the first
    launch of a PTQ site. CUDA: x f32 or bf16, contiguous, its size a
    multiple of 4."""
    if x.device.type == "cpu":
        return ptq_int8_quantize_plain(x, inv_s)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ptq_int8_quantize takes f32 or bf16 x, got {x.dtype}")
    if x.numel() % 4:
        raise ValueError(f"x has {x.numel()} values, not a multiple of 4")
    _check("x", x, x.dtype, tuple(x.shape), x.device)
    return _quantize(x, inv_s)


def _quantize(x: torch.Tensor, inv_s: float) -> torch.Tensor:
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    _launched("ptq_int8_quantize", _lib().ptq_int8_quantize(
        x.data_ptr(), int(x.dtype == torch.float32), q.data_ptr(), x.numel(), inv_s,
        _stream(x.device)))
    return q


def _site(x: torch.Tensor, qweight: torch.Tensor, kernel: Optional[int], stride: int,
          padding, groups: int = 1) -> dict:
    """A site's GEMM: its output's leading shape, M, K, N, Kp, and the gather
    geometry (a rows site whose K is not a multiple of 16, which TMA cannot
    stride, is gathered as M images of 1 x 1 x K). Cached by shape: a model
    calls each site with the same shapes every batch."""
    return _site_of(tuple(x.shape), tuple(qweight.shape), kernel, stride,
                    padding_pairs(padding), groups)


@functools.lru_cache(maxsize=1024)
def _site_of(x_shape: tuple, w_shape: tuple, kernel: Optional[int], stride: int,
             pads: tuple, groups: int) -> dict:
    n, kp = w_shape
    if kernel is None:
        lead, c = x_shape[:-1], x_shape[-1]
        b, h, w, kw, ho, wo = int(np.prod(lead)), 1, 1, 1, 1, 1
        gather = False
    else:
        if len(x_shape) != 4:
            raise ValueError(f"a conv site takes NHWC x (B, H, W, C), got {x_shape}")
        b, h, w, c = x_shape
        ho, wo = _conv_out(h, kernel, stride, pads[0]), _conv_out(w, kernel, stride, pads[1])
        if ho <= 0 or wo <= 0:
            raise ValueError(f"a {kernel} x {kernel} conv at stride {stride}, padding {pads} "
                             f"gives no output on {h} x {w}")
        lead, kw = (b, ho, wo), kernel
        gather = not (kernel == 1 and stride == 1 and groups == 1 and pads == NO_PADDING)
    if groups < 1 or c % groups or n % groups:
        raise ValueError(f"{groups} groups do not divide the input width {c} and the output "
                         f"width {n}")
    cg = c // groups
    k = kw * kw * cg
    m = int(np.prod(lead))
    if not gather and k % 16:
        b, h, w, ho, wo, gather = m, 1, 1, 1, 1, True
    pt, pl = (pads[0][0], pads[1][0]) if gather else (0, 0)
    return dict(lead=lead, m=m, k=k, n=n, kp=kp, c=c, cg=cg, groups=groups, gather=gather,
                group_n=n // groups,
                geometry=(h, w, c, kw, stride if gather else 1, pt, pl, groups, ho, wo))


def ptq_int8_conv(x: torch.Tensor, qweight: torch.Tensor, colscale: torch.Tensor,
                  bias: Optional[torch.Tensor], inv_s: float, *, kernel: Optional[int],
                  stride: int = 1, padding=0, groups: int = 1,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One int8 PTQ site. ``kernel`` None: a Dense site, x (..., K) ->
    (..., N); else a ``kernel`` x ``kernel`` conv at ``stride`` with zero
    ``padding`` (an int on every side, or ``((top, bottom), (left, right))``)
    in ``groups`` groups on NHWC x (B, H, W, C) -> (B, Ho, Wo, N).
    ``qweight`` int8 (N, Kp) from :func:`pack_weight` (K = kernel^2 C /
    groups a row), ``colscale`` f32 (N,) = ``f32(s_x) * s_w``, ``bias`` f32
    (N,) or None, ``inv_s`` the f32 reciprocal of the activation scale; the
    output is ``out_dtype`` (x's dtype when None). CUDA: x f32 or bf16, K and
    N multiples of 4 (C / groups for a gathered conv), N / groups a multiple
    of 64 for a grouped conv; :func:`ptq_int8_quantize`, then
    :func:`ptq_int8_gemm`, or the GEMM alone where it quantizes x itself
    (:func:`quantizes_in_gemm`)."""
    if x.device.type == "cpu":
        return ptq_int8_conv_plain(x, qweight, colscale, bias, inv_s, kernel=kernel,
                                   stride=stride, padding=padding, groups=groups,
                                   out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in (torch.float32, torch.bfloat16) or out_dtype not in (torch.float32,
                                                                           torch.bfloat16):
        raise TypeError(f"ptq_int8_conv takes f32 or bf16 x and output, got {x.dtype} -> "
                        f"{out_dtype}")
    site = _check_site(x, qweight, colscale, bias, kernel, stride, padding, groups)
    _check("x", x, x.dtype, tuple(x.shape), x.device)
    _check_no_grad("ptq_int8_conv", x)
    if quantizes_in_gemm(x.dtype, out_dtype, kernel, stride, padding, site["k"], site["n"],
                         groups):
        return _gemm(x, qweight, colscale, bias, site, PTQ_ROWS_QUANT, out_dtype, inv_s, 3)
    q = _quantize(x, inv_s)
    return _gemm(q, qweight, colscale, bias, site, PTQ_GATHER if site["gather"] else PTQ_ROWS,
                 out_dtype, None, 3)


def _check_site(x: torch.Tensor, qweight: torch.Tensor, colscale: torch.Tensor,
                bias: Optional[torch.Tensor], kernel: Optional[int], stride: int,
                padding, groups: int = 1) -> dict:
    site = _site(x, qweight, kernel, stride, padding, groups)
    m, k, n, kp = site["m"], site["k"], site["n"], site["kp"]
    if (kernel or 1) > MAX_KERNEL:
        raise ValueError(f"a {kernel} x {kernel} conv has more taps than the gather's mask holds "
                         f"(at most {MAX_KERNEL} x {MAX_KERNEL})")
    if kp % K_ALIGN or kp < k:
        raise ValueError(f"qweight (N, Kp) = {tuple(qweight.shape)} is not packed for K = {k}")
    if site["cg"] % 4:
        raise ValueError(f"the input width of a group {site['cg']} is not a multiple of 4")
    if groups > 1 and site["group_n"] % PTQ_WIDTHS[0]:
        raise ValueError(f"a group's {site['group_n']} output columns are not a multiple of the "
                         f"kernel's {PTQ_WIDTHS[0]}-column tile")
    _check_rows(m, k, n)
    _check("qweight", qweight, torch.int8, (n, kp), x.device)
    _check("colscale", colscale, torch.float32, (n,), x.device)
    if bias is not None:
        _check("bias", bias, torch.float32, (n,), x.device)
    return site


def ptq_int8_gemm(a: torch.Tensor, qweight: torch.Tensor, colscale: torch.Tensor,
                  bias: Optional[torch.Tensor], *, kernel: Optional[int], stride: int = 1,
                  padding=0, groups: int = 1, out_dtype: torch.dtype = torch.float32,
                  inv_s: Optional[float] = None, cut: int = 3) -> torch.Tensor:
    """The site's GEMM, :func:`ptq_int8_conv`'s launch after the quantize
    pass: int8 wgmma with s32 sums, ``f32(acc) * colscale (+ bias)`` ->
    ``out_dtype``. ``a`` is x quantized beforehand (int8 in x's shape) or,
    for a site that :func:`quantizes_in_gemm`, the bf16 x itself with its
    ``inv_s``. ``cut`` other than 3 runs a phase cut of the kernel for
    timing, with a bf16 output (``csrc/ptq_int8_cuts.cu``): 0 the loads of A
    and W, 2 + the products, 5 the kernel without its stores; its output then
    holds nothing meaningful, and only cut 3 counts in :data:`LAUNCHES`."""
    if a.device.type == "cpu":
        q = a if inv_s is None else quantize(a, inv_s)
        return ptq_int8_gemm_plain(q, qweight, colscale, bias, kernel=kernel, stride=stride,
                                   padding=padding, groups=groups, out_dtype=out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ptq_int8_gemm writes f32 or bf16, got {out_dtype}")
    site = _check_site(a, qweight, colscale, bias, kernel, stride, padding, groups)
    if inv_s is None:
        _check("a", a, torch.int8, tuple(a.shape), a.device)
        src = PTQ_GATHER if site["gather"] else PTQ_ROWS
    else:
        if not quantizes_in_gemm(a.dtype, out_dtype, kernel, stride, padding, site["k"],
                                 site["n"], groups):
            raise ValueError("this site does not quantize in the GEMM (quantizes_in_gemm): pass "
                             "x quantized by ptq_int8_quantize")
        _check("a", a, torch.bfloat16, tuple(a.shape), a.device)
        src = PTQ_ROWS_QUANT
    return _gemm(a, qweight, colscale, bias, site, src, out_dtype, inv_s, cut)


def _gemm(a: torch.Tensor, qweight: torch.Tensor, colscale: torch.Tensor,
          bias: Optional[torch.Tensor], site: dict, src: int, out_dtype: torch.dtype,
          inv_s: Optional[float], cut: int) -> torch.Tensor:
    out = torch.empty((*site["lead"], site["n"]), dtype=out_dtype if cut == 3 else torch.bfloat16,
                      device=a.device)
    args = (a.data_ptr(), qweight.data_ptr(), site["kp"], colscale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), site["m"], site["k"],
            site["n"], src, float(inv_s or 0.0), *site["geometry"],
            *_ptq_plan_args(site["n"], site["k"], src,
                            group_n=site["group_n"] if site["groups"] > 1 else None))
    stream = _stream(a.device)
    if cut == 3:
        _launched("ptq_int8_conv", _lib().ptq_int8_conv(
            *args[:6], int(out_dtype == torch.float32), *args[6:], stream))
        return out
    err = _cut_lib().ptq_int8_conv_cut(*args, cut, stream)
    if err != 0:
        raise RuntimeError(f"ptq_int8_conv cut {cut}: CUDA launch failed with cudaError {err}")
    return out
