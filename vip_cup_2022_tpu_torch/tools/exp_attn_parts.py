#!/usr/bin/env python3
"""Price each part of the grouped window-attention softmax, on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_attn_parts [l1|l2] [--batch 256] [--iters 64]

Counterpart of ``tools/exp_attn_parts.py``, with its shapes (l1: 64 windows
of 49 tokens, C 64, 2 heads; l2: 16 windows, C 128, 4 heads; groups of
g = 8 windows) and its variants, each a part removed from the
``attn_parts`` kernel (``ops/kernels/attn_parts.py``; numerically wrong on
purpose, timing only):

  full       bias, row max, exp and divide
  no_max     without the row-max subtraction
  no_bias    without the bias add (exp of raw scores over the whole group)
  no_exp     without exp (scores straight to P V)
  gemm_only  q k^T straight to P V
  empty      the copy kernel, q + v (the launch floor)

Each variant is first held to its plain version in f32 on the first two
images (max|d| / max|ref| <= 1e-2, or the tool raises), then timed by CUDA
events over ``--iters`` launches after a warm-up. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import torch

from ..ops.kernels import attn_parts as A
from .bench_util import card_line, cuda_ms

SHAPES = {  # nwin, n, c, heads, g
    "l1": (64, 49, 64, 2, 8),   # 56 x 56, window 7
    "l2": (16, 49, 128, 4, 8),  # 28 x 28, window 7
}
VARIANTS = {
    "full": {"bias", "max", "exp", "div"},
    "no_max": {"bias", "exp", "div"},
    "no_bias": {"max", "exp", "div"},
    "no_exp": {"bias", "max", "div"},
    "gemm_only": set(),
    "empty": None,  # the copy kernel
}
EQUIV_BOUND = 1e-2


def inputs(b: int, nwin: int, n: int, c: int, heads: int, g: int) -> dict:
    """bf16 q, k, v ~ N(0, 1) (B, nWin*N, C) from seed 0 on the card and the
    tool's f32 group bias."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, nwin * n, c), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    mb = torch.from_numpy(A.group_bias(heads, n, g)).cuda()
    return dict(q=q, k=k, v=v, mb=mb)


def call(name: str, t: dict, heads: int, n: int, g: int, plain: bool = False):
    """The variant ``name`` on the tensors of ``t``, as a thunk."""
    parts = VARIANTS[name]
    if parts is None:
        fn = A.attn_parts_copy_plain if plain else A.attn_parts_copy
        return lambda: fn(t["q"], t["v"])
    fn = A.attn_parts_plain if plain else A.attn_parts
    return lambda: fn(t["q"], t["k"], t["v"], t["mb"], heads=heads, n=n, g=g, parts=parts)


def run(shape: str, batch: int, iters: int) -> Dict[str, dict]:
    nwin, n, c, heads, g = SHAPES[shape]
    print(f"{shape}: (B={batch}, toks={nwin * n}, C={c}, heads={heads}, g={g})", flush=True)
    t = inputs(batch, nwin, n, c, heads, g)
    small = {k: t[k][:2].contiguous() for k in ("q", "k", "v")}
    small32 = {k: small[k].float() for k in small}
    small["mb"] = small32["mb"] = t["mb"]
    results = {}
    with torch.inference_mode():
        for name in VARIANTS:
            got = call(name, small, heads, n, g)().float()
            want = call(name, small32, heads, n, g, plain=True)()
            err = ((got - want).abs().max() / want.abs().max()).item()
            if not err <= EQUIV_BOUND:
                raise AssertionError(f"{name} disagrees with its plain version: "
                                     f"{err:.3e} > {EQUIV_BOUND:g}")
            ms = cuda_ms(call(name, t, heads, n, g), iters)
            print(f"  {name:11s} {ms:8.4f} ms   (max|d|/max|ref| {err:.2e})", flush=True)
            results[name] = dict(ms=ms, rel_err=err)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shape", nargs="?", default="l1", choices=sorted(SHAPES))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("exp_attn_parts: no CUDA device is available; the kernel has no CPU timing")
    print(f"device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    return run(args.shape, args.batch, args.iters)


if __name__ == "__main__":
    main()
