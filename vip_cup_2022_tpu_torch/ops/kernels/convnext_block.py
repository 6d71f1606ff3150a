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
   the unrounded depthwise sum, as ``_kernel`` does);
2. ``ln_fc1_gelu``: two-pass f32 LN of a row tile into shared memory as
   bf16, a wmma bf16 GEMM against fc1 with f32 accumulation, + b1, exact
   GELU (``erff``), bf16 hidden;
3. ``fc2_scale_residual``: a wmma bf16 GEMM of the hidden against fc2, then
   (+ b2) x gamma + residual, bf16 out.

The last two also run the MLP half of every GCViT window block
(:mod:`.gcvit_block`): LN eps 1e-5, N = 3C, and an f32 residual, the
unrounded attention residual r1, for which ``fc2_scale_residual`` launches
its f32-residual instantiation. Their GEMM mainloops are templates in
``csrc/block_gemm.cuh``, shared with the GCViT kernels.

What bounds them on the card: at s1/s2 (99x99x96, 49x49x192) the block does
few FLOPs per byte (K = 96 or 192), so the depthwise pass and the memory
traffic dominate; at s3/s4 (24x24x384, 12x12x768) the two GEMMs dominate.
What this simple design leaves on the table: the (M, 4C) hidden makes one
round trip through device memory, which the TPU kernel keeps on chip (at s1
and batch 256 that is 2.5 M rows x 384 x 2 B = 1.9 GB written and read once
per block); the depthwise output also makes a f32 round trip; the GEMMs use
warp-level wmma fed by a three-stage cp.async ring, not warpgroup wgmma fed
by TMA, and the depthwise pass reads its 7x7 halo through L1 rather than a
shared-memory tile.

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

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dwconv7x7_nhwc": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ln_fc1_gelu": [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P],
    "fc2_scale_residual": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "fc2_scale_residual_f32res": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


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
            "torch.inference_mode() (training through it is ROADMAP item A14)")


def _check_width(c: int) -> None:
    if c % 32:
        raise ValueError(f"channel width {c} is not a multiple of 32")


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
    _check_width(c)
    _check_width(n)
    _check("x", x, torch.float32, (m, c), x.device)
    _check("ln_weight", ln_weight, torch.float32, (c,), x.device)
    _check("ln_bias", ln_bias, torch.float32, (c,), x.device)
    _check("w1", w1, torch.bfloat16, (n, c), x.device)
    _check("b1", b1, torch.float32, (n,), x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _launch("ln_fc1_gelu", x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), out.data_ptr(), m, c, n, float(eps), _stream(x.device))
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
            residual.data_ptr(), out.data_ptr(), m, n, c, _stream(hidden.device),
            counter="fc2_scale_residual")
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
