"""ConvNeXt block kernels: CUDA for Hopper, with their plain PyTorch versions.

Replaces the two TPU kernels of the JAX package's ConvNeXt block
(``vip_cup_2022_tpu/ops/pallas/convnext_block.py``):

- ``fused_convnext_block`` (body ``_kernel``), which runs the C >= 256
  stages: dw7x7 + bias -> LN -> Linear C->4C -> GELU -> Linear 4C->C
  -> x gamma -> + x, in one VMEM pass;
- ``fused_ln_mlp_residual_batchlane`` (body ``_lnmlp_batchlane_kernel``),
  reached through ``fused_convnext_block_batchlane``, which runs the same
  block for the C < 256 stages in a batch-on-lanes (H, W, C, B) layout with
  the depthwise half as an XLA conv.

The two differ only in TPU layout, so one channels-last family of three
kernels (``csrc/convnext_block.cu``) covers every stage:

1. ``dwconv7x7_nhwc``: depthwise 7x7 + bias, bf16 in, f32 out (the LN reads
   the unrounded depthwise sum, as ``_kernel`` does), on the shared-memory
   tiled template of ``csrc/depthwise.cuh``: a persistent CTA copies each
   output tile's halo (32 channels) into shared memory by ``cp.async``,
   the next tile's copy overlapping this one's f32 FMAs;
2. ``ln_fc1_gelu``: two-pass f32 LN of a 128-row tile from registers into
   shared memory as bf16, a wgmma product against fc1 with f32
   accumulation, + b1, exact GELU (erf within 1 ulp of f32), bf16 hidden;
3. ``fc2_scale_residual``: a wgmma product of the hidden against fc2, then
   (+ b2) x gamma + residual, bf16 out.

The last two also run the MLP half of every GCViT window block
(:mod:`.gcvit_block`): LN eps 1e-5, N = 3C, and an f32 residual, the
unrounded attention residual r1, for which ``fc2_scale_residual`` launches
its f32-residual instantiation. Both are ``csrc/hopper_gemm.cuh``'s engine:
TMA loads into an mbarrier ring, ``wgmma`` products, persistent CTAs and two
pairs of consumer warpgroups in ping-pong, so that one pair's GELU or
residual epilogue overlaps the other's products. :func:`mlp_gemm_plan` picks each
shape's tiles, ring depth, A buffers and whether fc1 stays resident in
shared memory (also for the GCViT block's ``ln_qkv`` on the same engine,
kind "qkv"); the launcher checks the plan.

What bounds them on the card: at s1/s2 (99x99x96, 49x49x192) the block does
few FLOPs per byte (K = 96 or 192), so the depthwise pass and the memory
traffic dominate; at s3/s4 (24x24x384, 12x12x768) the two GEMMs' products.
What this design leaves on the table: the (M, 4C) hidden makes one round
trip through device memory, which the TPU kernel keeps on chip (at s1 and
batch 256 that is 2.5 M rows x 384 x 2 B = 1.9 GB written and read once
per block); the depthwise output also makes a f32 round trip.

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

LAUNCHES: Dict[str, int] = {"dwconv7x7_nhwc": 0, "ln_fc1_gelu": 0, "fc2_scale_residual": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LN_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I]  # + plan
_RES_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]  # + plan
_SIGNATURES = {
    "dwconv7x7_nhwc": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ln_fc1_gelu": _LN_ARGS + [_P],
    "fc2_scale_residual": _RES_ARGS + [_P],
    "fc2_scale_residual_f32res": _RES_ARGS + [_P],
}
_CUT_SIGNATURES = {  # csrc/mlp_gemm_cuts.cu: + the cut (and fc2's residual type)
    "ln_fc1_gelu_cut": _LN_ARGS + [_I, _P],
    "fc2_scale_residual_cut": _RES_ARGS + [_I, _I, _P],
    "ln_qkv_cut": [_P] * 8 + [_I, _I, _I, _F] + [_I] * 6 + [_P],  # gcvit_block.ln_qkv_cut
    # gcvit_block.proj_scale_residual_cut
    "proj_scale_residual_cut": [_P] * 6 + [_I] * 6 + [_P],
}
_DW_CUT_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]  # csrc/dwconv_cuts.cu

# ---------------------------------------------------------------------------
# the MLP GEMMs' per-shape plan (csrc/hopper_gemm.cuh checks it)
# ---------------------------------------------------------------------------
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
_ALIGN = 1024  # the 128-byte swizzle repeats every 1024 bytes; buffers start aligned
_BK = 64  # bf16 per K tile: one 128-byte swizzle row
BM = 128  # rows of a work item: 64 for each warpgroup of a consumer pair
WIDTHS = (128, 96, 64, 32)  # column tiles (wgmma n) the kernels are built for, widest first
SPLIT_WIDTHS = (128,)  # ln_fc1_gelu's column-split 64-row tiles: 64 columns a warpgroup
# output staging of the 16 consumer warps: 16 rows x 32 columns each, bf16 for
# ln_fc1_gelu, f32 for fc2_scale_residual (its residual is added after it)
EPILOGUE_BYTES = {"ln": 16 * 1024, "res": 32 * 1024}
MAX_RING = 8  # stages of a streamed ring
MAX_RESIDENT = 64  # K tiles of a resident fc1
WGMMA_N = tuple(range(8, 257, 8))  # the n a bf16 wgmma takes


def _barrier_bytes(stages: int) -> int:
    """A full and an empty mbarrier a stage, one order barrier for each of
    the two consumer pairs, and one for a weight held apart from the ring."""
    return 8 * (2 * stages + 3)


def _stages_that_fit(fixed: int, stage: int, most: int) -> int:
    """Most ring stages (<= ``most``) beside ``fixed`` bytes, with their
    mbarriers and the alignment slack."""
    return min(most, (SMEM_LIMIT - _ALIGN - _barrier_bytes(0) - fixed) // (stage + 16))


def _ln_tiles(c: int, n: int, kind: str = "ln") -> dict:
    """The LN GEMM's tiles (``ln_fc1_gelu``, or ``ln_qkv`` for ``kind``
    "qkv"): the weight resident in the ring where it fits beside two 128-row
    A tiles (else one); else streamed through 128-row tiles, with two A
    buffers where that leaves four stages; where one A tile leaves fewer than
    four, 64-row tiles split by columns between a pair's two warpgroups. The
    widest chunk dividing n (for "qkv" dividing c, so that a chunk lies in one
    of the q, k, v outputs) that works."""
    cpad, fixed = -(-c // _BK) * _BK, EPILOGUE_BYTES["ln"]
    for bn in (w for w in WIDTHS if n % w == 0 and (kind != "qkv" or c % w == 0)):
        stage, everything = bn * 2 * _BK, (n // bn) * (cpad // _BK)
        options = []
        for bm in (BM, BM // 2) if bn in SPLIT_WIDTHS else (BM,):
            a_tile = bm * cpad * 2
            if bm == BM and everything <= MAX_RESIDENT:
                options += [(bm, a, everything, True) for a in (2, 1)]
            a = 2 if _stages_that_fit(fixed + 2 * a_tile, stage, MAX_RING) >= 4 else 1
            options.append((bm, a, _stages_that_fit(fixed + a * a_tile, stage, MAX_RING), False))
        for bm, a_buffers, stages, resident in options:
            fits = _stages_that_fit(fixed + a_buffers * bm * cpad * 2, stage, stages) == stages
            last_resort = bm == options[-1][0] and stages >= 2
            if fits and (resident or stages >= 4 or last_resort):
                smem = (_barrier_bytes(stages) + _ALIGN + fixed + a_buffers * bm * cpad * 2
                        + stages * stage)
                return dict(bm=bm, bn=bn, stages=stages, a_buffers=a_buffers, resident=resident,
                            split_n=bm < BM, smem=smem)
    raise ValueError(f"no {kind} plan fits C = {c}, N = {n} in shared memory")


def mlp_gemm_plan(kind: str, c: int, n: int) -> dict:
    """Tiles of one launch on ``csrc/hopper_gemm.cuh``'s engine. ``kind``
    "ln": ``ln_fc1_gelu`` on x (M, c) -> (M, n); "qkv": ``ln_qkv``
    (:mod:`.gcvit_block`) on x (M, c) -> n = 2c or 3c columns, split into
    (M, c) outputs; "res": ``fc2_scale_residual`` on a hidden (M, n) ->
    (M, c); "proj": ``proj_scale_residual`` (:mod:`.gcvit_block`), the same
    kernel with n = K = c and an f32 output. Keys: ``bm`` rows a work item
    (64 for each warpgroup of a consumer pair), ``bn`` its columns (a wgmma
    n dividing the output width), ``stages`` of the TMA ring, ``a_buffers``
    (LN A tiles: two let the next tile's LN overlap this one's products),
    ``resident`` (the weight loaded once and kept: fc1 and W_qkv in the
    ring; for "proj" W_p apart from it, ``held`` bytes, where four A stages
    still fit beside it), ``split_n`` (64-row LN tiles whose columns the
    pair's two warpgroups split), ``swizzle`` bytes, ``ctas_per_sm`` and
    ``smem`` bytes. Independent of M: the launcher sizes the persistent
    grid."""
    if c % 32 or n % 32 or c <= 0 or n <= 0:
        raise ValueError(f"widths {c}, {n} are not multiples of 32")
    plan = dict(kind=kind, swizzle=128, ctas_per_sm=1)
    if kind == "ln":
        plan.update(_ln_tiles(c, n))
    elif kind == "qkv":
        if n not in (2 * c, 3 * c):
            raise ValueError(f"ln_qkv's width {n} is not 2 or 3 x C = {c}")
        plan.update(_ln_tiles(c, n, kind))
    elif kind in ("res", "proj"):
        if kind == "proj" and n != c:
            raise ValueError(f"proj_scale_residual's K = {n} is not C = {c}")
        bn = next(w for w in WIDTHS if c % w == 0)
        stage = (BM + bn) * 2 * _BK
        stages = _stages_that_fit(EPILOGUE_BYTES["res"], stage, MAX_RING)
        held = (c // bn) * -(-n // _BK) * bn * 2 * _BK  # all of W, a tile per (columns, K tile)
        a_stage = BM * 2 * _BK
        resident = (kind == "proj"
                    and _stages_that_fit(EPILOGUE_BYTES["res"] + held, a_stage, MAX_RING) >= 4)
        if resident:
            stages = _stages_that_fit(EPILOGUE_BYTES["res"] + held, a_stage, MAX_RING)
            ring = held + stages * a_stage
        else:
            held, ring = 0, stages * stage
        plan.update(bm=BM, bn=bn, stages=stages, a_buffers=0, resident=resident, split_n=False,
                    held=held)
        plan["smem"] = _barrier_bytes(stages) + _ALIGN + EPILOGUE_BYTES["res"] + ring
    else:
        raise ValueError(f"kind must be 'ln', 'qkv', 'res' or 'proj', got {kind!r}")
    return plan


@functools.lru_cache(maxsize=None)
def _ln_plan_args(c: int, n: int, kind: str = "ln") -> tuple:
    p = mlp_gemm_plan(kind, c, n)
    return p["bn"], p["stages"], p["a_buffers"], int(p["resident"]), int(p["split_n"])


@functools.lru_cache(maxsize=None)
def _res_plan_args(c: int, n: int) -> tuple:
    p = mlp_gemm_plan("res", c, n)
    return p["bn"], p["stages"]


@functools.lru_cache(maxsize=None)
def _proj_plan_args(c: int) -> tuple:
    p = mlp_gemm_plan("proj", c, c)
    return p["bn"], p["stages"], int(p["resident"])


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("convnext_block")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _cut_lib() -> ctypes.CDLL:
    lib = build.load("mlp_gemm_cuts")
    for name, argtypes in _CUT_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _dw_cut_lib() -> ctypes.CDLL:
    lib = build.load("dwconv_cuts")
    lib.dwconv7x7_nhwc_cut.argtypes = _DW_CUT_SIGNATURE
    lib.dwconv7x7_nhwc_cut.restype = ctypes.c_int
    return lib


def _launch(name: str, *args, counter: str = "") -> None:
    err = getattr(_lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[counter or name] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernels load 16 bytes at a time)")


def _check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """A kernel without a backward must not cut an autograd graph silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel; run it under torch.no_grad() or "
            "torch.inference_mode(), or train through its autograd function where it has one")


def _check_width(c: int) -> None:
    if c % 32:
        raise ValueError(f"channel width {c} is not a multiple of 32")


# the engine's launchers take the row count as a 32-bit int (and TMA's row
# coordinates are 32-bit); addresses are 64-bit, so the row count is the limit
MAX_ROWS = 2 ** 31 - 1


def _check_rows(m: int) -> None:
    if m > MAX_ROWS:
        raise ValueError(f"M = {m} rows is more than the GEMM engine takes ({MAX_ROWS})")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# plain PyTorch versions: the same functions, computed in the inputs' dtype
# ---------------------------------------------------------------------------
def dwconv7x7_nhwc_plain(x: torch.Tensor, dw_kernel: torch.Tensor,
                         dw_bias: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) x (7, 7, C) taps + (C,) bias -> (B, H, W, C) f32."""
    c = x.shape[-1]
    w = dw_kernel.float().permute(2, 0, 1).unsqueeze(1)  # (C, 1, 7, 7)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w, dw_bias.float(), padding=3, groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


def ln_fc1_gelu_plain(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor, eps: float) -> torch.Tensor:
    """(M, C) f32 -> LN (two-pass, f32) -> Linear(w1 (N, C), b1) -> exact GELU,
    in w1's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps) * ln_weight + ln_bias).to(w1.dtype)
    h = F.linear(y, w1).float() + b1
    return F.gelu(h, approximate="none").to(w1.dtype)


def fc2_scale_residual_plain(hidden: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                             gamma: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """(M, N) hidden -> Linear(w2 (C, N), b2) -> x gamma -> + residual, in the
    hidden's dtype."""
    o = F.linear(hidden, w2).float() + b2
    return (o * gamma + residual.float()).to(hidden.dtype)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on CUDA
# ---------------------------------------------------------------------------
def dwconv7x7_nhwc(x: torch.Tensor, dw_kernel: torch.Tensor,
                   dw_bias: torch.Tensor) -> torch.Tensor:
    """Depthwise 7x7 (stride 1, zero padding 3) + bias on NHWC input.
    CUDA: x bf16 (B, H, W, C), taps f32 (7, 7, C), bias f32 (C,) -> f32."""
    if x.device.type == "cpu":
        return dwconv7x7_nhwc_plain(x, dw_kernel, dw_bias)
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    _check_width(c)
    _check("x", x, torch.bfloat16, (b, h, w, c), x.device)
    _check("dw_kernel", dw_kernel, torch.float32, (7, 7, c), x.device)
    _check("dw_bias", dw_bias, torch.float32, (c,), x.device)
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=x.device)
    _launch("dwconv7x7_nhwc", x.data_ptr(), dw_kernel.data_ptr(), dw_bias.data_ptr(),
            out.data_ptr(), b, h, w, c, _stream(x.device))
    return out


def ln_fc1_gelu(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                w1: torch.Tensor, b1: torch.Tensor, eps: float) -> torch.Tensor:
    """LN over C + Linear C->N + exact GELU on rows. CUDA: x f32 (M, C), LN
    params f32 (C,), w1 bf16 (N, C), b1 f32 (N,) -> bf16 (M, N)."""
    if x.device.type == "cpu":
        return ln_fc1_gelu_plain(x, ln_weight, ln_bias, w1, b1, eps)
    if x.ndim != 2:
        raise ValueError(f"x must be (M, C), got {tuple(x.shape)}")
    m, c = x.shape
    n = w1.shape[0]
    _check_rows(m)
    _check_width(c)
    _check_width(n)
    _check("x", x, torch.float32, (m, c), x.device)
    _check("ln_weight", ln_weight, torch.float32, (c,), x.device)
    _check("ln_bias", ln_bias, torch.float32, (c,), x.device)
    _check("w1", w1, torch.bfloat16, (n, c), x.device)
    _check("b1", b1, torch.float32, (n,), x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _launch("ln_fc1_gelu", x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), out.data_ptr(), m, c, n, float(eps), *_ln_plan_args(c, n),
            _stream(x.device))
    return out


def fc2_scale_residual(hidden: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       gamma: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """Linear N->C, (+ b2) x gamma + residual on rows. CUDA: hidden bf16
    (M, N), w2 bf16 (C, N), b2 and gamma f32 (C,), residual bf16 or f32
    (M, C) -> bf16."""
    if hidden.device.type == "cpu":
        return fc2_scale_residual_plain(hidden, w2, b2, gamma, residual)
    if hidden.ndim != 2:
        raise ValueError(f"hidden must be (M, N), got {tuple(hidden.shape)}")
    m, n = hidden.shape
    c = w2.shape[0]
    _check_rows(m)
    _check_width(c)
    _check_width(n)
    _check("hidden", hidden, torch.bfloat16, (m, n), hidden.device)
    _check("w2", w2, torch.bfloat16, (c, n), hidden.device)
    _check("b2", b2, torch.float32, (c,), hidden.device)
    _check("gamma", gamma, torch.float32, (c,), hidden.device)
    f32_residual = residual.dtype == torch.float32
    _check("residual", residual, torch.float32 if f32_residual else torch.bfloat16, (m, c),
           hidden.device)
    out = torch.empty((m, c), dtype=torch.bfloat16, device=hidden.device)
    _launch("fc2_scale_residual_f32res" if f32_residual else "fc2_scale_residual",
            hidden.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
            residual.data_ptr(), out.data_ptr(), m, n, c, *_res_plan_args(c, n),
            _stream(hidden.device), counter="fc2_scale_residual")
    return out



def ln_fc1_gelu_cut(x, ln_weight, ln_bias, w1, b1, eps: float, cut: int) -> torch.Tensor:
    """A phase cut of the ``ln_fc1_gelu`` kernel on CUDA tensors, at the main
    path's widths: 0 loads, 1 + LN, 2 + products, 3 the kernel itself, 4
    products + raw stores, 5 the kernel without its stores
    (``csrc/mlp_gemm_cuts.cu``). Timing only: except at 3 and 4 its output
    holds nothing meaningful; counted in :data:`LAUNCHES` only at 3."""
    if cut == 3:
        return ln_fc1_gelu(x, ln_weight, ln_bias, w1, b1, eps)
    m, c = x.shape
    n = w1.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _cut_lib().ln_fc1_gelu_cut(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        out.data_ptr(), m, c, n, float(eps), *_ln_plan_args(c, n), cut, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"ln_fc1_gelu cut {cut}: CUDA launch failed with cudaError {err}")
    return out


def dwconv7x7_nhwc_cut(x, dw_kernel, dw_bias, cut: int) -> torch.Tensor:
    """A phase cut of the ``dwconv7x7_nhwc`` kernel on CUDA tensors: 0 the
    halo copies into shared memory, 1 + the FMAs without stores, 2 the
    kernel itself, 3 cut 1 with the halo values made in registers (no
    shared-memory reads; ``csrc/dwconv_cuts.cu``). Timing only: except at 2
    its output holds nothing meaningful; counted in :data:`LAUNCHES` only
    at 2."""
    if cut == 2:
        return dwconv7x7_nhwc(x, dw_kernel, dw_bias)
    b, h, w, c = x.shape
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=x.device)
    err = _dw_cut_lib().dwconv7x7_nhwc_cut(x.data_ptr(), dw_kernel.data_ptr(), dw_bias.data_ptr(),
                                           out.data_ptr(), b, h, w, c, cut, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"dwconv7x7_nhwc cut {cut}: CUDA launch failed with cudaError {err}")
    return out


def fc2_scale_residual_cut(hidden, w2, b2, gamma, residual, cut: int) -> torch.Tensor:
    """A phase cut of ``fc2_scale_residual``, numbered as in
    :func:`ln_fc1_gelu_cut` (1, the LN, is 0 here)."""
    if cut == 3:
        return fc2_scale_residual(hidden, w2, b2, gamma, residual)
    m, n = hidden.shape
    c = w2.shape[0]
    out = torch.empty((m, c), dtype=torch.bfloat16, device=hidden.device)
    err = _cut_lib().fc2_scale_residual_cut(
        hidden.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), residual.data_ptr(),
        out.data_ptr(), m, n, c, *_res_plan_args(c, n), int(residual.dtype == torch.float32),
        cut, _stream(hidden.device))
    if err != 0:
        raise RuntimeError(f"fc2_scale_residual cut {cut}: CUDA launch failed with cudaError {err}")
    return out


def convnext_block(x: torch.Tensor, dw_kernel, dw_bias, ln_weight, ln_bias, w1, b1,
                   w2, b2, gamma, eps: float = 1e-6) -> torch.Tensor:
    """Whole ConvNeXt block on NHWC x through the three wrappers:
    x + gamma * fc2(gelu(fc1(LN(dw7x7(x) + dw_bias))))."""
    b, h, w, c = x.shape
    d = dwconv7x7_nhwc(x, dw_kernel, dw_bias)
    hid = ln_fc1_gelu(d.view(b * h * w, c), ln_weight, ln_bias, w1, b1, eps)
    out = fc2_scale_residual(hid, w2, b2, gamma, x.reshape(b * h * w, c))
    return out.view(b, h, w, c)
