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
the first, as wrappers of one CUDA template (``csrc/ln_mlp.cu``) on the
wgmma + TMA engine of ``csrc/hopper_gemm.cuh``: a persistent CTA of four
consumer warpgroups walks tiles of 128 rows at C <= 256 (two independent
groups of two warpgroups, 64 rows each, multiplying the same weight stages)
or of 64 rows (the four together); two producer threads stream W1 and W2 by
TMA through two mbarrier rings; the consumers copy the x tile into a
swizzled shared-memory tile (for the two strided layouts along the rows, so
a warp reads contiguous addresses, then transposed), take a two-pass f32
LayerNorm into bf16 in place, then walk the hidden in chunks of 128: fc1
chunk by wgmma, + b1 and exact GELU (erf within 1 ulp of f32) in registers,
bf16 into one of two hidden tiles in shared memory, fc2 accumulated by wgmma
in f32 registers over all the chunks; then (+ b2) x gamma + residual in
f32, bf16 out in the input's layout. The (M, hidden) hidden never reaches
device memory, which is what sets it apart from the two-launch
``ln_fc1_gelu`` + ``fc2_scale_residual`` pair of :mod:`.convnext_block`.
:func:`ln_mlp_plan` picks each width's plan. What bounds it on the card:
4 M C hidden bf16 operations against 6 M C bytes of activations (both near
0.4 ms at ConvNeXt's s1-s4 and batch 256), then the GELU of every hidden
element on the CUDA cores and the weights' stream from L2 (16 C^2 bytes per
tile at hidden = 4 C).

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
_PLAN = [_I] * 3  # column splits, W1 and W2 ring depths
_SIGNATURES = {
    "ln_mlp_rows": _TEN + [_L, _I, _I, _F] + _PLAN + [_P],
    "ln_mlp_batchlane": _TEN + [_L, _I, _I, _I, _F] + _PLAN + [_P],
    "ln_mlp_chanfirst": _TEN + [_L, _I, _I, _F] + _PLAN + [_P],
}

# ---------------------------------------------------------------------------
# the kernel's plan (csrc/ln_mlp.cu checks it)
# ---------------------------------------------------------------------------
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
WARPGROUPS = 4  # consumer warpgroups of a CTA; a fifth, the producer, issues the TMA loads
GROUPED = 256  # widest C run by two row groups of two warpgroups
ROWS = 64  # rows of a group's tile: one wgmma M
FC1_COLUMNS = (64, 32)  # fc1 columns a consumer warpgroup multiplies per chunk: 64 where
# its accumulators stay within ACC_REGS (two row groups, C <= 192), else 32
MAX_RING = 8  # stages of a ring
ACC_REGS = 80  # f32 accumulator registers a consumer thread may hold (fc1 + fc2)
WGMMA_N = tuple(range(8, 257, 8))  # the n a bf16 wgmma takes
_BK = 64  # bf16 of a K tile: one 128-byte swizzle row
_ALIGN = 1024
_TMA_BOX = 256  # rows of one TMA box at most


def _w2_rows(cn: int) -> int:
    """Rows of a W2 stage: CN, or above a TMA box a divisor of CN holding
    whole warpgroup column blocks."""
    return cn if cn <= _TMA_BOX else _TMA_BOX if cn % _TMA_BOX == 0 else cn // 2


def _smem(c: int, groups: int, cn: int, hn: int, stages1: int, stages2: int) -> int:
    a_tile = ROWS * (-(-c // _BK) * _BK) * 2
    hidden_tiles = 2 * ROWS * hn * 2
    return (16 * (stages1 + stages2) + _ALIGN + groups * (a_tile + hidden_tiles)
            + stages1 * hn * 2 * _BK + stages2 * _w2_rows(cn) * 2 * _BK)


def ln_mlp_plan(c: int, hidden: int) -> dict:
    """Tiles of one launch of ``csrc/ln_mlp.cu`` at C = ``c`` and ``hidden``
    (independent of M and of the layout). Keys: ``row_groups`` (2 at C <=
    ``GROUPED``: two independent groups of two warpgroups, each with its own
    64 rows, multiplying the same weight stages; else 1 group of four),
    ``group_warpgroups``, ``rows`` of an item, ``fc1_columns`` a warpgroup
    multiplies per chunk (64 where its accumulators stay within ``ACC_REGS``
    in two groups, else 32), ``hidden_chunk`` (that x the group's
    warpgroups: 128, or 64 at C = 256), ``cs`` column splits (an item
    computes CN = C / cs output columns and fc1 whole: 2 at C = 768, whose
    64 x 768 f32 accumulator would not fit the register file), ``cn``,
    ``cw`` fc2 columns a consumer warpgroup (a wgmma n), ``w2_rows`` rows of
    a W2 stage, ``stages1`` / ``stages2`` the W1 / W2 ring depths,
    ``acc_regs`` f32 accumulator registers a consumer thread holds (fc2's
    cw / 2 + fc1's fc1_columns / 2, within ``ACC_REGS``) and ``smem``
    bytes. Raises for a width or hidden the kernel does not take."""
    if c not in WIDTHS:
        raise ValueError(f"channel width {c} has no kernel instantiation (widths {WIDTHS})")
    chunk = 128 if c <= 384 else 256  # hidden multiple the wrappers have always required
    if hidden <= 0 or hidden % chunk:
        raise ValueError(f"hidden width {hidden} is not a multiple of {chunk}")
    groups = 2 if c <= GROUPED else 1
    wg = WARPGROUPS // groups
    cs = 2 if c == 768 else 1
    cn = c // cs
    hw = next(n for n in FC1_COLUMNS
              if (groups == 2 or n == 32) and cn // wg // 2 + n // 2 <= ACC_REGS)
    hn = hw * wg
    r2 = _w2_rows(cn)
    kt1, per_chunk2 = -(-c // _BK), (hn // _BK) * (cn // r2)
    s1 = s2 = 2  # both rings from 2, each grown while it holds less of a chunk's tiles
    while True:
        for _, ring in sorted(((s1 / kt1, 1), (s2 / per_chunk2, 2))):
            n1, n2 = (s1 + 1, s2) if ring == 1 else (s1, s2 + 1)
            if max(n1, n2) <= MAX_RING and _smem(c, groups, cn, hn, n1, n2) <= SMEM_LIMIT:
                s1, s2 = n1, n2
                break
        else:
            break
    return dict(row_groups=groups, group_warpgroups=wg, rows=ROWS * groups, fc1_columns=hw,
                hidden_chunk=hn, cs=cs, cn=cn, cw=cn // wg, w2_rows=r2, stages1=s1, stages2=s2,
                acc_regs=cn // wg // 2 + hw // 2, smem=_smem(c, groups, cn, hn, s1, s2))


@functools.lru_cache(maxsize=None)
def _plan_args(c: int, hidden: int) -> tuple:
    p = ln_mlp_plan(c, hidden)
    return p["cs"], p["stages1"], p["stages2"]


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


@functools.lru_cache(maxsize=None)
def _cut_lib() -> ctypes.CDLL:
    lib = build.load("ln_mlp_cuts")
    lib.ln_mlp_rows_cut.argtypes = _SIGNATURES["ln_mlp_rows"][:-1] + [_I, _P]
    lib.ln_mlp_rows_cut.restype = ctypes.c_int
    return lib


CUTS = ("loads", "ln", "products", "gelu")  # csrc/ln_mlp_cuts.cu's cuts 0-3; 4 is the kernel


def ln_mlp_rows_cut(x: torch.Tensor, residual: torch.Tensor, ln_gamma, ln_beta, w1, b1, w2, b2,
                    ls_gamma, cut: str, *, eps: float = 1e-6) -> torch.Tensor:
    """A phase cut of the rows-layout kernel on (M, C) bf16 rows, for timing
    (``csrc/ln_mlp_cuts.cu``): "loads" (the weights' stream and the x tile's
    copy), "ln" (+ the LN), "products" (+ fc1 and fc2), "gelu" (+ b1 and the
    GELU); none stores its output, which is left uninitialised. Counts no
    launch."""
    m, c = x.shape
    hidden, ptrs = _checked_args("ln_mlp_rows_cut", x, residual, (m, c), c, ln_gamma, ln_beta, w1,
                                 b1, w2, b2, ls_gamma)
    out = torch.empty_like(x)
    err = _cut_lib().ln_mlp_rows_cut(*ptrs, out.data_ptr(), m, c, hidden, float(eps),
                                     *_plan_args(c, hidden), CUTS.index(cut), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"ln_mlp_rows_cut ({cut}): CUDA launch failed with cudaError {err}")
    return out


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
    hidden = w1.shape[0]
    try:
        ln_mlp_plan(c, hidden)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
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
    """``tail``: M, C, hidden[, B], eps; the plan follows them."""
    out = torch.empty_like(x)
    c, hidden = tail[1], tail[2]
    err = getattr(_lib(), symbol)(*ptrs, out.data_ptr(), *tail, *_plan_args(c, hidden),
                                  _stream(x.device))
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
