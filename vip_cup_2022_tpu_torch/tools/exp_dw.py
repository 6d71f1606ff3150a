#!/usr/bin/env python3
"""Depthwise-conv timing on the EfficientNet hot shapes, on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_dw [--iters 20] [--shapes TAG ...]

Counterpart of ``tools/exp_dw.py``. Per shape, three variants on the same
bf16 NHWC input, each timed with CUDA events over ``--iters`` launches after
a warm-up, in the order kernel, plain, cudnn, cudnn, plain, kernel (each
variant's two readings averaged):

  kernel  the ``depthwise_conv_nhwc`` CUDA kernel (``ops/kernels/depthwise.py``)
  plain   its plain PyTorch version, the TPU kernel's f32 tap loop
  cudnn   cuDNN's depthwise conv, ``F.conv2d(groups=C)`` on channels-last bf16

then the kernel's max|d| against the plain version computed in f32 on the
first two images, and each variant's effective GB/s (the bf16 input read
once and the output written once). The TPU-only block-diagonal variant of
the JAX tool is not carried over. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.kernels import depthwise as D

# (tag, B, H, W, C, k): EfficientNetV1B4's stride-1 depthwise shapes at 224 x 224
# input, and ConvNeXt's s1 7 x 7 (the JAX tool's SHAPES)
SHAPES = [
    ("s1_56x192_k3", 256, 56, 56, 192, 3),
    ("s2_28x336_k5", 256, 28, 28, 336, 5),
    ("s3_14x672_k3", 256, 14, 14, 672, 3),
    ("s4_14x960_k5", 256, 14, 14, 960, 5),
    ("s5_7x1632_k5", 256, 7, 7, 1632, 5),
    ("cnx_99x96_k7", 256, 99, 99, 96, 7),
]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean ms of ``fn`` over ``iters`` launches after ``warmup``, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(b: int, h: int, w: int, c: int, k: int):
    """bf16 x ~ U(0, 1) from seed 0 and f32 taps (k, k, 1, C) ~ U(-0.5, 0.5)
    from seed 1 on the card, as the JAX tool draws them."""
    x = torch.rand((b, h, w, c), generator=torch.Generator(device="cuda").manual_seed(0),
                   device="cuda").to(torch.bfloat16)
    kern = torch.rand((k, k, 1, c), generator=torch.Generator(device="cuda").manual_seed(1),
                      device="cuda") - 0.5
    return x, kern


def run(shapes: Optional[Sequence[str]] = None, iters: int = 20) -> List[dict]:
    """Time every selected shape; one result dict per shape."""
    results = []
    for tag, b, h, w, c, k in SHAPES:
        if shapes and tag not in shapes:
            continue
        x, kern = inputs(b, h, w, c, k)
        pad = (k // 2, k // 2)
        w_cudnn = kern.reshape(k, k, c).permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16)
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last in memory
        fns = {
            "kernel": lambda: D.depthwise_conv_nhwc(x, kern, padding=(pad, pad)),
            "plain": lambda: D.depthwise_conv_nhwc_plain(x, kern, padding=(pad, pad)),
            "cudnn": lambda: F.conv2d(x_nchw, w_cudnn, padding=k // 2, groups=c),
        }
        got = D.depthwise_conv_nhwc(x[:2], kern, padding=(pad, pad)).float()
        ref = D.depthwise_conv_nhwc_plain(x[:2].float(), kern, padding=(pad, pad))
        err = (got - ref).abs().max().item()
        order = ["kernel", "plain", "cudnn", "cudnn", "plain", "kernel"]
        readings = {name: [] for name in fns}
        for name in order:
            readings[name].append(cuda_ms(fns[name], iters))
        ms = {name: sum(r) / len(r) for name, r in readings.items()}
        gb = 2 * b * h * w * c * x.element_size() / 1e9
        print(f"[{tag}] ({b},{h},{w},{c}) k{k}  in+out {gb:.3f} GB  kernel max|d|={err:.2e} "
              f"(max|ref| {ref.abs().max().item():.2e})", flush=True)
        for name, t in ms.items():
            print(f"      {tag}:{name:8s} {t:.4f} ms  -> {gb / (t / 1e3):.0f} GB/s eff", flush=True)
        results.append(dict(tag=tag, shape=(b, h, w, c), k=k, max_abs_err=err,
                            max_abs_ref=ref.abs().max().item(), ms=ms["kernel"],
                            plain_ms=ms["plain"], cudnn_ms=ms["cudnn"]))
        del x, kern, fns, got, ref
        torch.cuda.empty_cache()
    return results


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("exp_dw: no CUDA device is available; the kernel has no CPU timing")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(f"device={torch.cuda.get_device_name(0)} [{smi.splitlines()[0] if smi else 'nvidia-smi: n/a'}]",
          flush=True)
    return run(args.shapes, args.iters)


if __name__ == "__main__":
    main()
