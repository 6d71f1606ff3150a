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

The f32 mode (``VIPTPU_DTYPE=float32``, in which the TPU kernels take f32
activations and cast W1 and W2 to them) is three more kernels on f32 rows:
``dwconv7x7_nhwc_f32`` (the same depthwise template with f32 halo tiles),
``ln_fc1_gelu_f32`` and ``fc2_scale_residual_f32`` (``csrc/tf32_gemm.cuh``:
3xTF32 wgmma on the engine above, the activations split in registers, the
weights split once into a :class:`.tf32.Tf32Weight` pair that the caller
passes as ``w_split`` or the wrapper makes; :func:`tf32_gemm_plan` picks the
column tile and ring depth; also for GCViT's ``ln_qkv_f32`` and
``proj_scale_residual_f32`` and their ``_mmf32`` modes, kinds "qkv" and
"proj"). A wrapper picks its kernel by dtype: the depthwise by x's, the two
GEMMs by the weight's (``ln_fc1_gelu`` takes f32 x in a bf16 block too: the
depthwise sum, GCViT's r1).

GCViT's MLP half in the mixed modes of ``VIPTPU_GCVIT_MM`` (:mod:`.gcvit_block`)
adds two fc2 kernels, picked by ``out_dtype``: ``fc2_scale_residual_mmbf16``
(bf16 hidden and W2 -> f32, an f32 block with bf16 GEMMs: the engine's
``tma_res_kernel``, the f32 residual in and the output out by TMA, plan
kind "res_tma") and
``fc2_scale_residual_mmf32`` (f32 hidden and W2 -> bf16, a bf16 block with
f32 GEMMs: the 3xTF32 kernel with a bf16 output); ``ln_fc1_gelu`` takes the
GEMM dtype as ``mm_dtype``.

The 3xTF32 kernels' phase cuts (``csrc/f32_mlp_cuts.cu``, :func:`tf32_mlp_cut`)
are for ``tools/exp_f32_mlp.py``: off the model path, uncounted.

Dispatch: a wrapper runs the plain version only for tensors on the CPU. For
CUDA tensors it launches its kernel or raises; it never falls back. Each
wrapper counts its launches in :data:`LAUNCHES`, one count a symbol.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import build
from .tf32 import Tf32Weight, tf32_weight

LAUNCHES: Dict[str, int] = {"dwconv7x7_nhwc": 0, "ln_fc1_gelu": 0, "fc2_scale_residual": 0,
                            "dwconv7x7_nhwc_f32": 0, "ln_fc1_gelu_f32": 0,
                            "fc2_scale_residual_f32": 0, "fc2_scale_residual_mmbf16": 0,
                            "fc2_scale_residual_mmf32": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LN_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I]  # + plan
_RES_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]  # + plan
_SIGNATURES = {
    "dwconv7x7_nhwc": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ln_fc1_gelu": _LN_ARGS + [_P],
    "fc2_scale_residual": _RES_ARGS + [_P],
    "fc2_scale_residual_f32res": _RES_ARGS + [_P],
    "dwconv7x7_nhwc_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ln_fc1_gelu_f32": [_P] * 7 + [_I, _I, _I, _F, _I, _I, _I, _P],  # + plan
    "fc2_scale_residual_f32": [_P] * 7 + [_I] * 6 + [_P],  # + plan
    "fc2_scale_residual_mmbf16": _RES_ARGS + [_I, _P],  # + resident
    "fc2_scale_residual_mmf32": [_P] * 7 + [_I] * 6 + [_P],  # + plan
}
_CUT_SIGNATURES = {  # csrc/mlp_gemm_cuts.cu: + the cut (and fc2's residual type)
    "ln_fc1_gelu_cut": _LN_ARGS + [_I, _P],
    "fc2_scale_residual_cut": _RES_ARGS + [_I, _I, _P],
    "fc2_scale_residual_mmbf16_cut": _RES_ARGS + [_I, _I, _P],  # + resident, cut
    # gcvit_block.ln_qkv_cut and ln_qkv_mmbf16_cut
    "ln_qkv_cut": [_P] * 8 + [_I, _I, _I, _F] + [_I] * 6 + [_P],
    "ln_qkv_mmbf16_cut": [_P] * 8 + [_I, _I, _I, _F] + [_I] * 7 + [_P],
    # gcvit_block.proj_scale_residual_cut and _mmbf16_cut
    "proj_scale_residual_cut": [_P] * 6 + [_I] * 6 + [_P],
    "proj_scale_residual_mmbf16_cut": [_P] * 6 + [_I] * 6 + [_P],
}
_DW_CUT_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]  # csrc/dwconv_cuts.cu
_F32_CUT_SIGNATURES = {  # csrc/f32_mlp_cuts.cu
    # kind (0 gelu, 1 residual, 2 qkv), cut, passes, then as the kernels (+ bf16 output)
    "tf32_mlp_cut": [_I, _I, _I] + [_P] * 9 + [_I, _I, _I, _F] + [_I] * 4 + [_P],
}

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
# the f32 residual GEMMs of VIPTPU_GCVIT_MM=bf16 (hopper_gemm.cuh: tma_res_kernel): each
# consumer warpgroup's f32 residual tile holds its 64 rows, in TMA boxes of 32 columns
RES_TILE_ROWS = 64
# column tiles in the order the plan tries them: fc2 (K = 3C) the widest, whose items re-read
# the hidden from L2 half as often as 64-column ones; proj (K = C, f32 A) 64 columns, whose
# 40 KB stages leave five of them where 128 columns leave four (PERF.md)
TMA_RES_WIDTHS = {"res_tma": (128, 64, 96, 32), "proj_tma": (64, 96, 32)}
# the column tiles the kernels are built for (f32 A: no 128, hopper_gemm.cuh's launch_tma_res)
TMA_RES_BUILT = {"res_tma": (32, 64, 96, 128), "proj_tma": (32, 64, 96)}
MIN_TMA_RES_STAGES = 4  # ring stages the plan wants beside a held weight or at a width
# ln_qkv_mmbf16 (hopper_gemm.cuh: ln_qkv_tma_kernel) where W_qkv is resident: each of the
# four consumer warpgroups stages its f32 output tile (64 rows x bn) in shared memory of its
# own for the TMA store, 64-column items keeping the four tiles (64 KB) beside the A tiles
QKV_TMA_WIDTHS = (64, 32)
CONSUMER_WARPGROUPS = 4
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


def _tma_res_tiles(kind: str, c: int, k: int) -> dict:
    """The f32 residual GEMMs' tiles (``tma_res_kernel``): 128-row items of
    ``bn`` columns (the first of the kind's :data:`TMA_RES_WIDTHS` dividing
    c that leaves :data:`MIN_TMA_RES_STAGES` ring stages, else the first
    that leaves two). A ring stage holds an A tile of 64 K columns (bf16
    hidden: 16 KB; f32 attention output for "proj_tma": two 32-column
    boxes, 32 KB) and, streamed, the W tile; or one consumer
    warpgroup's f32 residual tile (64 rows x bn: ``tile`` bytes), whichever
    is larger: an item takes its K tiles, then the two residual tiles,
    through the ring. The weight is held in shared memory apart from the
    ring where :data:`MIN_TMA_RES_STAGES` stages still fit beside it."""
    a_tile = BM * _BK * (4 if kind == "proj_tma" else 2)
    options = []
    for w in [w for w in TMA_RES_WIDTHS[kind] if c % w == 0]:
        if w not in TMA_RES_BUILT[kind]:
            raise ValueError(f"column tile {w} is not built")
        tile, w_tile = RES_TILE_ROWS * w * 4, w * 2 * _BK
        held, stage = (c // w) * -(-k // _BK) * w_tile, max(a_tile, tile)
        stages = _stages_that_fit(held, stage, MAX_RING)
        resident = stages >= MIN_TMA_RES_STAGES
        if not resident:
            held, stage = 0, max(a_tile + w_tile, tile)
            stages = _stages_that_fit(0, stage, MAX_RING)
        if stages >= 2:
            options.append(dict(bm=BM, bn=w, stages=stages, a_buffers=0, resident=resident,
                                split_n=False, held=held, stage=stage, tile=tile,
                                smem=_barrier_bytes(stages) + _ALIGN + held + stages * stage))
    if not options:
        raise ValueError(f"no {kind} plan fits C = {c}, K = {k} in shared memory")
    return next((p for p in options if p["stages"] >= MIN_TMA_RES_STAGES), options[0])


def _qkv_tma_tiles(c: int, n: int) -> dict:
    """``ln_qkv_mmbf16``'s tiles on ``ln_qkv_tma_kernel``: LN tiles of 128
    rows, W_qkv resident in the ring beside two A tiles (else one) and the
    four consumer warpgroups' f32 output tiles (64 rows x ``bn``, ``tile``
    bytes each) in room of their own, ``bn`` the first of
    :data:`QKV_TMA_WIDTHS` dividing c. Where W_qkv does not fit (C >= 192)
    no plan: ``ln_qkv_mmbf16`` runs on the LN kernel there
    (:func:`_qkv_tma_plan_args`)."""
    cpad = -(-c // _BK) * _BK
    for bn in (w for w in QKV_TMA_WIDTHS if c % w == 0):
        stages, tile = (n // bn) * (cpad // _BK), RES_TILE_ROWS * bn * 4
        if stages > MAX_RESIDENT:
            continue
        for a in (2, 1):
            fixed = CONSUMER_WARPGROUPS * tile + a * BM * cpad * 2
            if _stages_that_fit(fixed, bn * 2 * _BK, stages) == stages:
                return dict(bm=BM, bn=bn, stages=stages, a_buffers=a, resident=True,
                            split_n=False, tile=tile,
                            smem=_barrier_bytes(stages) + _ALIGN + fixed + stages * bn * 2 * _BK)
    raise ValueError(f"no qkv_tma plan fits C = {c}, N = {n} in shared memory")


def mlp_gemm_plan(kind: str, c: int, n: int) -> dict:
    """Tiles of one launch on ``csrc/hopper_gemm.cuh``'s engine. ``kind``
    "ln": ``ln_fc1_gelu`` on x (M, c) -> (M, n); "qkv": ``ln_qkv``
    (:mod:`.gcvit_block`) on x (M, c) -> n = 2c or 3c columns, split into
    (M, c) outputs; "res": ``fc2_scale_residual`` on a hidden (M, n) ->
    (M, c); "proj": ``proj_scale_residual`` (:mod:`.gcvit_block`), the same
    kernel with n = K = c and an f32 output; "res_tma":
    ``fc2_scale_residual_mmbf16`` on a bf16 hidden (M, n) -> f32 (M, c)
    beside an f32 residual, and "proj_tma": ``proj_scale_residual_mmbf16``
    on the f32 attention output, n = K = c (both ``tma_res_kernel``: the
    residual in and the output out by TMA, :func:`_tma_res_tiles`); "qkv_tma":
    ``ln_qkv_mmbf16`` on f32 x (M, c) -> n = 2c or 3c f32 columns, split into
    (M, c) outputs, each stored by TMA from an f32 tile of its warpgroup
    (``ln_qkv_tma_kernel``, :func:`_qkv_tma_tiles`). Keys: ``bm`` rows a work item
    (64 for each warpgroup of a consumer pair), ``bn`` its columns (a wgmma
    n dividing the output width), ``stages`` of the TMA ring, ``a_buffers``
    (LN A tiles: two let the next tile's LN overlap this one's products),
    ``resident`` (the weight loaded once and kept: fc1 and W_qkv in the
    ring; for "proj" W_p apart from it, ``held`` bytes, where four A stages
    still fit beside it), ``split_n`` (64-row LN tiles whose columns the
    pair's two warpgroups split), ``swizzle`` bytes, ``ctas_per_sm`` and
    ``smem`` bytes. Independent of M: the launcher sizes the persistent
    grid. The "_tma" kinds add ``tile`` (a warpgroup's f32 residual or
    output tile) bytes, "res_tma" and "proj_tma" also ``stage``."""
    if c % 32 or n % 32 or c <= 0 or n <= 0:
        raise ValueError(f"widths {c}, {n} are not multiples of 32")
    plan = dict(kind=kind, swizzle=128, ctas_per_sm=1)
    if kind == "ln":
        plan.update(_ln_tiles(c, n))
    elif kind == "qkv":
        if n not in (2 * c, 3 * c):
            raise ValueError(f"ln_qkv's width {n} is not 2 or 3 x C = {c}")
        plan.update(_ln_tiles(c, n, kind))
    elif kind == "qkv_tma":
        if n not in (2 * c, 3 * c):
            raise ValueError(f"ln_qkv_mmbf16's width {n} is not 2 or 3 x C = {c}")
        plan.update(_qkv_tma_tiles(c, n))
    elif kind in ("res_tma", "proj_tma"):
        if kind == "proj_tma" and n != c:
            raise ValueError(f"proj_scale_residual_mmbf16's K = {n} is not C = {c}")
        plan.update(_tma_res_tiles(kind, c, n))
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
        raise ValueError("kind must be 'ln', 'qkv', 'qkv_tma', 'res', 'proj', 'res_tma' or "
                         f"'proj_tma', got {kind!r}")
    return plan


# ---------------------------------------------------------------------------
# the f32 GEMMs' plan (csrc/tf32_gemm.cuh checks it)
# ---------------------------------------------------------------------------
TF32_BK = 32  # f32 per K tile: one 128-byte swizzle row
TF32_WIDTHS = (128, 96, 64, 32)  # column tiles (wgmma n) the 3xTF32 kernels are built for
TF32_MAX_LN_K = 768  # the LN kind's widest row: a warp holds it in registers for its statistics
# Above this depth the kernels sum each two K tiles apart and add them to the accumulator by
# FADD (csrc/tf32_gemm.cuh: kPromote): the tensor cores' f32 accumulation rounds toward zero,
# an error that grows with K (on the card, per the first 3xTF32 runs at b256: 4.2e-6 of
# max|ref| at K = 384, 1.5e-5 at 3072 against the 1e-5 gate). The second accumulator tile
# costs registers: column tiles of at most 64.
TF32_PROMOTE_K = 384
TF32_PROMOTE_WIDTHS = (64, 32)
TF32_KINDS = ("gelu", "res", "qkv", "proj")


def tf32_gemm_plan(kind: str, k: int, n: int, a_bytes: int = 4) -> dict:
    """Tiles of one launch of ``csrc/tf32_gemm.cuh``: ``kind`` "gelu"
    (``ln_fc1_gelu_f32`` on x (M, k) -> the (M, n) hidden), "res"
    (``fc2_scale_residual_f32`` / ``_mmf32`` on a hidden (M, k) -> (M, n)),
    "qkv" (``ln_qkv_f32`` / ``_mmf32`` of :mod:`.gcvit_block` on x (M, k = C)
    -> n = 2C or 3C columns split into (M, C) outputs: column tiles dividing
    C, so that each lies in one output) or "proj"
    (``proj_scale_residual_f32`` / ``_mmf32``: the "res" kernel with n = k =
    C). ``a_bytes``: A's element, 4 (f32) or 2 (bf16 x or attention output,
    the "qkv" and "proj" ``_mmf32`` modes: a 64-byte A row a K tile). Keys:
    ``bm`` rows a work item (64 for each warpgroup of a consumer pair),
    ``bn`` its columns (the widest of :data:`TF32_WIDTHS`, or with
    ``promote`` of :data:`TF32_PROMOTE_WIDTHS`, dividing n, for "qkv"
    dividing C), ``bk`` K columns a tile, ``promote`` (K >
    :data:`TF32_PROMOTE_K`: K summed in chunks of two tiles, each added to
    the accumulator rounded to nearest), ``stages`` of the TMA ring (each
    stage an A tile and the W_hi and W_lo tiles: ``stage`` bytes), ``swizzle``
    (A's; W's is 128), ``ctas_per_sm`` and ``smem`` bytes (barriers,
    alignment, the 16 consumer warps' 2 KB f32 staging, the ring).
    Independent of M: the launcher sizes the persistent grid."""
    if kind not in TF32_KINDS:
        raise ValueError(f"kind must be one of {TF32_KINDS}, got {kind!r}")
    if a_bytes not in (4, 2) or (a_bytes == 2 and kind not in ("qkv", "proj")):
        raise ValueError(f"the {kind!r} kernels take no {a_bytes}-byte A")
    if k <= 0 or n <= 0 or k % TF32_BK or n % 32:
        raise ValueError(f"K = {k} must be a multiple of {TF32_BK} and N = {n} of 32")
    if kind in ("gelu", "qkv") and k > TF32_MAX_LN_K:
        raise ValueError(f"the LN kinds take K <= {TF32_MAX_LN_K}, got {k}")
    if kind == "qkv" and n not in (2 * k, 3 * k):
        raise ValueError(f"ln_qkv's width {n} is not 2 or 3 x C = {k}")
    if kind == "proj" and n != k:
        raise ValueError(f"proj_scale_residual's N = {n} is not K = C = {k}")
    promote = k > TF32_PROMOTE_K
    tile_of = k if kind == "qkv" else n  # the width a column tile divides
    bn = next((w for w in (TF32_PROMOTE_WIDTHS if promote else TF32_WIDTHS) if tile_of % w == 0),
              None)
    if bn is None:
        raise ValueError(f"no column tile divides {tile_of}")
    stage = BM * a_bytes * TF32_BK + 2 * bn * 4 * TF32_BK
    stages = _stages_that_fit(EPILOGUE_BYTES["res"], stage, MAX_RING)
    smem = _barrier_bytes(stages) + _ALIGN + EPILOGUE_BYTES["res"] + stages * stage
    return dict(kind=kind, bm=BM, bn=bn, bk=TF32_BK, promote=promote, stages=stages,
                stage=stage, smem=smem, swizzle=128 if a_bytes == 4 else 64, ctas_per_sm=1)


@functools.lru_cache(maxsize=None)
def _tf32_plan_args(kind: str, k: int, n: int, a_bytes: int = 4) -> tuple:
    p = tf32_gemm_plan(kind, k, n, a_bytes)
    return p["bn"], p["stages"], int(p["promote"])


@functools.lru_cache(maxsize=None)
def _ln_plan_args(c: int, n: int, kind: str = "ln") -> tuple:
    p = mlp_gemm_plan(kind, c, n)
    return p["bn"], p["stages"], p["a_buffers"], int(p["resident"]), int(p["split_n"])


@functools.lru_cache(maxsize=None)
def _qkv_tma_plan_args(c: int, n: int) -> tuple:
    """``ln_qkv_mmbf16``'s launch arguments: (1, the "qkv_tma" plan) on
    ``ln_qkv_tma_kernel`` where W_qkv stays resident beside the four f32
    tiles with the column tile the LN kernel's "qkv" plan takes (C = 32,
    64: GCViTTiny's L1); else (0, the "qkv" plan) on the LN kernel, its f32
    outputs stored from the accumulators. Where the tiles' room narrows the
    items (L2: 64 columns against 128) or W_qkv streams (L3, L4), the LN
    kernel was the faster (PERF.md PR 29)."""
    ln = _ln_plan_args(c, n, "qkv")
    try:
        p = mlp_gemm_plan("qkv_tma", c, n)
    except ValueError:
        return (0, *ln)
    return (1, p["bn"], p["stages"], p["a_buffers"], 1, 0) if p["bn"] == ln[0] else (0, *ln)


@functools.lru_cache(maxsize=None)
def _res_plan_args(c: int, n: int) -> tuple:
    p = mlp_gemm_plan("res", c, n)
    return p["bn"], p["stages"]


@functools.lru_cache(maxsize=None)
def _tma_res_plan_args(kind: str, c: int, k: int) -> tuple:
    p = mlp_gemm_plan(kind, c, k)
    return p["bn"], p["stages"], int(p["resident"])


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


@functools.lru_cache(maxsize=None)
def _f32_cut_lib() -> ctypes.CDLL:
    lib = build.load("f32_mlp_cuts")
    for name, argtypes in _F32_CUT_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
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


def _tf32_operands(name: str, w: torch.Tensor, w_split: Optional[Tf32Weight]) -> Tf32Weight:
    """The 3xTF32 kernels' weight pair: ``w_split`` as the caller keeps it
    (checked against w's shape and device), else made from w here."""
    if w_split is None:
        return tf32_weight(w)
    for part, t in zip(("hi", "lo"), w_split):
        _check(f"{name} {part}", t, torch.float32, w.shape, w.device)
    return w_split


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
                      w1: torch.Tensor, b1: torch.Tensor, eps: float,
                      mm_dtype: Optional[torch.dtype] = None,
                      w_split: Optional[Tf32Weight] = None) -> torch.Tensor:
    """(M, C) f32 -> LN (two-pass, f32) -> Linear(w1 (N, C), b1) -> exact GELU,
    in ``mm_dtype`` (default w1's). In bf16 the product is the kernel's: bf16
    operands, exact products, f32 sums; the bias and the GELU in f32, then
    one rounding. In f32 it is the f32 product (TF32 off), the function the
    3xTF32 kernel keeps to about 22 bits; ``w_split``, the kernel's operand
    pair, is not read."""
    mm = mm_dtype or w1.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps) * ln_weight + ln_bias).to(mm)
    h = F.linear(y.float(), w1.to(mm).float()) + b1
    return F.gelu(h, approximate="none").to(mm)


def fc2_scale_residual_plain(hidden: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                             gamma: torch.Tensor, residual: torch.Tensor,
                             out_dtype: Optional[torch.dtype] = None,
                             w_split: Optional[Tf32Weight] = None) -> torch.Tensor:
    """(M, N) hidden -> Linear(w2 (C, N), b2) -> x gamma -> + residual, in
    ``out_dtype`` (default the hidden's). Another output dtype than the
    hidden's (a mixed mode) takes the product of the hidden and w2 in f32.
    ``w_split`` (the 3xTF32 kernel's operand pair) is not read."""
    out = out_dtype or hidden.dtype
    if out == hidden.dtype:
        o = F.linear(hidden, w2).float() + b2
    else:
        o = F.linear(hidden.float(), w2.to(hidden.dtype).float()) + b2
    return (o * gamma + residual.float()).to(out)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on CUDA
# ---------------------------------------------------------------------------
def dwconv7x7_nhwc(x: torch.Tensor, dw_kernel: torch.Tensor,
                   dw_bias: torch.Tensor) -> torch.Tensor:
    """Depthwise 7x7 (stride 1, zero padding 3) + bias on NHWC input.
    CUDA: x bf16 or f32 (B, H, W, C) (``dwconv7x7_nhwc`` or
    ``dwconv7x7_nhwc_f32``), taps f32 (7, 7, C), bias f32 (C,) -> f32."""
    if x.device.type == "cpu":
        return dwconv7x7_nhwc_plain(x, dw_kernel, dw_bias)
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    _check_width(c)
    f32 = x.dtype == torch.float32
    _check("x", x, torch.float32 if f32 else torch.bfloat16, (b, h, w, c), x.device)
    _check("dw_kernel", dw_kernel, torch.float32, (7, 7, c), x.device)
    _check("dw_bias", dw_bias, torch.float32, (c,), x.device)
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=x.device)
    _launch("dwconv7x7_nhwc_f32" if f32 else "dwconv7x7_nhwc", x.data_ptr(), dw_kernel.data_ptr(),
            dw_bias.data_ptr(), out.data_ptr(), b, h, w, c, _stream(x.device))
    return out


def ln_fc1_gelu(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                w1: torch.Tensor, b1: torch.Tensor, eps: float,
                mm_dtype: Optional[torch.dtype] = None,
                w_split: Optional[Tf32Weight] = None) -> torch.Tensor:
    """LN over C + Linear C->N + exact GELU on rows. CUDA: x f32 (M, C), LN
    params f32 (C,), w1 (N, C) in ``mm_dtype`` (bf16 or f32, default w1's),
    b1 f32 (N,) -> (M, N) in ``mm_dtype`` (``ln_fc1_gelu`` or
    ``ln_fc1_gelu_f32``: the mode is the GEMM's, since x is f32 in bf16
    blocks too). The f32 kernel reads w1 as ``w_split`` (``tf32_weight(w1)``,
    kept by the caller), or splits w1 itself."""
    if x.device.type == "cpu":
        return ln_fc1_gelu_plain(x, ln_weight, ln_bias, w1, b1, eps, mm_dtype)
    if mm_dtype is not None and w1.dtype != mm_dtype:
        raise TypeError(f"w1 has dtype {w1.dtype}, the GEMM's is {mm_dtype}")
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
    f32 = w1.dtype == torch.float32
    _check("w1", w1, torch.float32 if f32 else torch.bfloat16, (n, c), x.device)
    _check("b1", b1, torch.float32, (n,), x.device)
    out = torch.empty((m, n), dtype=w1.dtype, device=x.device)
    if f32:
        hi, lo = _tf32_operands("w1", w1, w_split)
        _launch("ln_fc1_gelu_f32", x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(),
                hi.data_ptr(), lo.data_ptr(), b1.data_ptr(), out.data_ptr(), m, c, n, float(eps),
                *_tf32_plan_args("gelu", c, n), _stream(x.device))
        return out
    _launch("ln_fc1_gelu", x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), out.data_ptr(), m, c, n, float(eps), *_ln_plan_args(c, n),
            _stream(x.device))
    return out


def fc2_scale_residual(hidden: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       gamma: torch.Tensor, residual: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None,
                       w_split: Optional[Tf32Weight] = None) -> torch.Tensor:
    """Linear N->C, (+ b2) x gamma + residual on rows, the output in
    ``out_dtype`` (default the hidden's). CUDA: hidden and w2 (C, N) bf16,
    b2 and gamma f32 (C,), residual bf16 or f32 (M, C) -> bf16; hidden, w2
    and the residual f32 -> f32 (``fc2_scale_residual_f32``); the mixed
    modes, beside an f32 residual: bf16 hidden and w2 -> f32
    (``fc2_scale_residual_mmbf16``), f32 hidden and w2 -> bf16
    (``fc2_scale_residual_mmf32``). The two f32-GEMM kernels read w2 as
    ``w_split`` (``tf32_weight(w2)``, kept by the caller), or split w2
    themselves."""
    if hidden.device.type == "cpu":
        return fc2_scale_residual_plain(hidden, w2, b2, gamma, residual, out_dtype)
    if hidden.ndim != 2:
        raise ValueError(f"hidden must be (M, N), got {tuple(hidden.shape)}")
    m, n = hidden.shape
    c = w2.shape[0]
    _check_rows(m)
    _check_width(c)
    _check_width(n)
    mm = hidden.dtype
    out_dt = out_dtype or mm
    if mm not in (torch.bfloat16, torch.float32) or out_dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"no fc2 kernel takes a {mm} hidden to a {out_dt} output")
    mixed = out_dt != mm
    f32_residual = residual.dtype == torch.float32
    for name, t, dt, shape in (("hidden", hidden, mm, (m, n)), ("w2", w2, mm, (c, n)),
                               ("b2", b2, torch.float32, (c,)),
                               ("gamma", gamma, torch.float32, (c,)),
                               ("residual", residual,
                                torch.float32 if mm == torch.float32 or mixed or f32_residual
                                else torch.bfloat16, (m, c))):
        _check(name, t, dt, shape, hidden.device)
    out = torch.empty((m, c), dtype=out_dt, device=hidden.device)
    args = (hidden.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
            residual.data_ptr(), out.data_ptr(), m, n, c)
    if mm == torch.float32:
        hi, lo = _tf32_operands("w2", w2, w_split)
        _launch("fc2_scale_residual_mmf32" if mixed else "fc2_scale_residual_f32",
                hidden.data_ptr(), hi.data_ptr(), lo.data_ptr(), *args[2:],
                *_tf32_plan_args("res", n, c), _stream(hidden.device))
    elif mixed:
        _launch("fc2_scale_residual_mmbf16", *args, *_tma_res_plan_args("res_tma", c, n),
                _stream(hidden.device))
    else:
        _launch("fc2_scale_residual_f32res" if f32_residual else "fc2_scale_residual", *args,
                *_res_plan_args(c, n), _stream(hidden.device), counter="fc2_scale_residual")
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


def fc2_scale_residual_mmbf16_cut(hidden, w2, b2, gamma, residual, cut: int) -> torch.Tensor:
    """A phase cut of ``fc2_scale_residual_mmbf16`` (bf16 hidden and w2, f32
    residual -> f32) on CUDA tensors: 0 loads (with the residual tile's),
    2 + products, 3 the kernel itself, 5 the kernel without its stores
    (``csrc/mlp_gemm_cuts.cu``). Timing only: the output holds nothing
    meaningful except at 3; never counted in :data:`LAUNCHES`."""
    m, n = hidden.shape
    c = w2.shape[0]
    out = torch.empty((m, c), dtype=torch.float32, device=hidden.device)
    args = (hidden.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
            residual.data_ptr(), out.data_ptr(), m, n, c)
    err = _cut_lib().fc2_scale_residual_mmbf16_cut(
        *args, *_tma_res_plan_args("res_tma", c, n), cut, _stream(hidden.device))
    if err != 0:
        raise RuntimeError(f"fc2_scale_residual_mmbf16 cut {cut}: CUDA launch failed with "
                           f"cudaError {err}")
    return out


# phase cuts of the 3xTF32 kernels (csrc/tf32_gemm.cuh's kCut; kPasses 1 issues
# a_hi w_hi alone), numbered as the engine's
# (the kernel itself, cut 3, is the wrapper's launch)
TF32_CUTS = {"loads": (0, 3), "products_1pass": (2, 1), "products": (2, 3), "no_stores": (5, 3)}


_TF32_CUT_KIND = {"gelu": 0, "res": 1, "proj": 1, "qkv": 2}  # the cut launcher's kinds


def tf32_mlp_cut(kind: str, cut: str, a, w_split: Tf32Weight, bias, *, ln_weight=None,
                 ln_bias=None, eps: float = 0.0, gamma=None, residual=None,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A phase cut (:data:`TF32_CUTS`) of ``ln_fc1_gelu_f32`` (``kind``
    "gelu": a = x), ``fc2_scale_residual_f32`` / ``_mmf32`` ("res": a = the
    hidden, ``out_dtype`` f32 or bf16), ``ln_qkv_f32`` ("qkv": a = x, w_split
    the (S C, C) pair) or ``proj_scale_residual_f32`` ("proj": a = the
    attention output, the residual x) on f32 CUDA tensors, on the model's
    plan (``csrc/f32_mlp_cuts.cu``). Timing only: its output holds nothing
    meaningful; never counted in :data:`LAUNCHES`."""
    which, passes = TF32_CUTS[cut]
    m, k = a.shape
    n = w_split.hi.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _f32_cut_lib().tf32_mlp_cut(
        _TF32_CUT_KIND[kind], which, passes, a.data_ptr(), ptr(ln_weight), ptr(ln_bias),
        w_split.hi.data_ptr(), w_split.lo.data_ptr(), bias.data_ptr(), ptr(gamma), ptr(residual),
        out.data_ptr(), m, k, n, float(eps), *_tf32_plan_args(kind, k, n),
        int(out_dtype == torch.bfloat16), _stream(a.device))
    if err != 0:
        raise RuntimeError(f"tf32 {kind} cut {cut}: CUDA launch failed with cudaError {err}")
    return out


def convnext_block(x: torch.Tensor, dw_kernel, dw_bias, ln_weight, ln_bias, w1, b1,
                   w2, b2, gamma, eps: float = 1e-6, w1_split: Optional[Tf32Weight] = None,
                   w2_split: Optional[Tf32Weight] = None) -> torch.Tensor:
    """Whole ConvNeXt block on NHWC x through the three wrappers:
    x + gamma * fc2(gelu(fc1(LN(dw7x7(x) + dw_bias)))); in f32 the GEMMs'
    weight pairs ``w1_split`` / ``w2_split`` where the caller keeps them."""
    b, h, w, c = x.shape
    d = dwconv7x7_nhwc(x, dw_kernel, dw_bias)
    hid = ln_fc1_gelu(d.view(b * h * w, c), ln_weight, ln_bias, w1, b1, eps, w_split=w1_split)
    out = fc2_scale_residual(hid, w2, b2, gamma, x.reshape(b * h * w, c), w_split=w2_split)
    return out.view(b, h, w, c)
