#!/usr/bin/env python3
"""Phase cuts of ConvNeXt's depthwise kernel at the main path's shapes, on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_dwconv [--iters 10] [--batch 256]
        [--shapes s1 s2 s3 s4]

Per ConvNeXt stage at 200 px (s1-s4: 99/49/24/12 grids, C 96-768), the
``dwconv7x7_nhwc`` kernel (``csrc/depthwise.cuh``'s tiled template: bf16 x,
f32 7 x 7 taps and bias, f32 out) timed whole and as the compile-time cuts of
``csrc/dwconv_cuts.cu``:

  loads       the halo copies into shared memory (cp.async), nothing read
              back, computed or written
  fmas        + the shared-memory reads and the f32 FMAs, nothing stored
  whole       + the stores: the kernel itself
  regs        fmas with the halo values made in registers: the FMAs without
              their shared-memory reads (what those reads cost)

beside cuDNN's depthwise conv of the same channels-last bf16 input
(``F.conv2d(groups=C)``, bf16 out, TF32 off) and the kernel's bound: its bytes
(bf16 x read once, f32 out written once) over 3.35 TB/s or its FMAs over 67
TFLOP/s of f32 (NVIDIA's H100 SXM data sheet), whichever is larger. Each with
CUDA events over ``--iters`` launches after a warm-up, in the order listed,
then reversed (the two readings averaged). The whole kernel is first checked
against its plain version in f32 on the first two images (1e-5 of max|ref|).
No counterpart in the JAX package. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.kernels import convnext_block as K
from .bench_util import card_line, cuda_ms

# name: grid, C, blocks per forward (convnext_tiny at 200 x 200)
SHAPES = {"s1": (99, 96, 3), "s2": (49, 192, 3), "s3": (24, 384, 9), "s4": (12, 768, 3)}
CUTS = {"loads": 0, "fmas": 1, "whole": 2, "regs": 3}
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


def bound_ms(m: int, c: int) -> float:
    """bf16 in, f32 out and the taps and bias read once, or 49 FMAs an
    element at the f32 peak."""
    nbytes = m * c * (2 + 4) + 50 * c * 4
    return max(nbytes / HBM_BYTES_PER_S, 2 * 49 * m * c / F32_OPS_PER_S) * 1e3


def run(batch: int = 256, iters: int = 10, shapes: Sequence[str] = tuple(SHAPES)) -> List[dict]:
    """Time every shape; one result dict per shape (ms per launch)."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    results = []
    for name in shapes:
        grid, c, blocks = SHAPES[name]
        x = u((batch, grid, grid, c)).to(torch.bfloat16)
        dw, dwb = u((7, 7, c), -0.2, 0.2), u((c,), -0.1, 0.1)
        got = K.dwconv7x7_nhwc(x[:2], dw, dwb)
        ref = K.dwconv7x7_nhwc_plain(x[:2].float(), dw, dwb)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        xc = x.permute(0, 3, 1, 2)  # channels-last in memory
        wc, bc = dw.permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16), dwb.to(torch.bfloat16)
        fns = {cut: (lambda k=k: K.dwconv7x7_nhwc_cut(x, dw, dwb, k)) for cut, k in CUTS.items()}
        fns["cudnn"] = lambda: F.conv2d(xc, wc, bc, padding=3, groups=c)
        readings = {cut: [] for cut in fns}
        for cut in list(fns) + list(fns)[::-1]:
            readings[cut].append(cuda_ms(fns[cut], iters))
        ms = {cut: sum(r) / len(r) for cut, r in readings.items()}
        m = batch * grid * grid
        bound = bound_ms(m, c)
        print(f"[{name} ({batch},{grid},{grid},{c})] dwconv7x7_nhwc: whole vs plain "
              f"max|d|/max|ref| {err:.2e}; " + ", ".join(f"{cut} {t:.4f}" for cut, t in ms.items())
              + f" ms; bound {bound:.4f} ms; whole/bound {ms['whole'] / bound:.2f}, "
                f"whole/cuDNN {ms['whole'] / ms['cudnn']:.2f} [{card_line()}]", flush=True)
        results.append(dict(name=name, m=m, c=c, blocks=blocks, rel_err=err, ms=ms, bound=bound))
        del x, got, ref, xc, fns
        torch.cuda.empty_cache()
    return results


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--shapes", nargs="+", choices=list(SHAPES), default=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("exp_dwconv: no CUDA device is available; the cuts are CUDA kernels")
    print(f"device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    return run(args.batch, args.iters, args.shapes)


if __name__ == "__main__":
    main()
