#!/usr/bin/env python3
"""Depthwise-conv timing on the EfficientNet hot shapes, on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_dw [--iters 20] [--shapes TAG ...]

Counterpart of ``tools/exp_dw.py``. Per shape, three variants on the same
bf16 NHWC input, in the order kernel, plain, cudnn, cudnn, plain, kernel
(each variant's two readings averaged): the kernel and cuDNN by device time
(``bench_util.device_ms``: ``--iters`` launches captured in a CUDA graph and
replayed) and by CUDA events around ``--iters`` launches, the plain version
by events alone:

  kernel  the ``depthwise_conv_nhwc`` CUDA kernel (``ops/kernels/depthwise.py``)
  plain   its plain PyTorch version, the TPU kernel's f32 tap loop
  cudnn   cuDNN's depthwise conv, ``F.conv2d(groups=C)`` on channels-last bf16

then the kernel's max|d| against the plain version computed in f32 on the
first two images, each variant's effective GB/s (the bf16 input read once
and the output written once) and the kernel's tile plan
(``depthwise.depthwise_plan``). The TPU-only block-diagonal variant of the
JAX tool is not carried over. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.kernels import depthwise as D
from .bench_util import card_line, cuda_ms, device_ms

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
        events = {name: [] for name in fns}
        for name in order:
            events[name].append(cuda_ms(fns[name], iters))
            if name != "plain":
                readings[name].append(device_ms(fns[name], calls=iters))
        ms = {name: sum(r) / len(r) for name, r in readings.items() if r}
        ev = {name: sum(r) / len(r) for name, r in events.items()}
        gb = 2 * b * h * w * c * x.element_size() / 1e9
        plan = D.depthwise_plan(h, w, c)
        print(f"[{tag}] ({b},{h},{w},{c}) k{k}  in+out {gb:.3f} GB  kernel max|d|={err:.2e} "
              f"(max|ref| {ref.abs().max().item():.2e})  plan {plan}", flush=True)
        for name, t in ev.items():
            dev = f"{ms[name]:.4f} ms device -> {gb / (ms[name] / 1e3):.0f} GB/s eff, " \
                if name in ms else ""
            print(f"      {tag}:{name:8s} {dev}{t:.4f} ms events", flush=True)
        results.append(dict(tag=tag, shape=(b, h, w, c), k=k, max_abs_err=err,
                            max_abs_ref=ref.abs().max().item(), ms=ms["kernel"],
                            plain_ms=ev["plain"], cudnn_ms=ms["cudnn"],
                            ms_events=ev["kernel"], cudnn_ms_events=ev["cudnn"], plan=plan))
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
    print(f"device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    return run(args.shapes, args.iters)


if __name__ == "__main__":
    main()
