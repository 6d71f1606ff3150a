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
images (max|d| / max|ref| <= 1e-2, or the tool raises), then timed over
``--iters`` launches after a warm-up by device time (a CUDA graph of the
launches replayed, ``bench_util.device_ms``) with the CUDA-event time
beside; the ``full`` variant also beside its library call, SDPA with the
group bias as a float mask, and stopped after each phase (``CUTS``: the
loads, pass 1's row max, pass 2's softmax without P V). Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.kernels import attn_parts as A
from .bench_util import both_ms, card_line, device_ms

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
# the streamed-key mode's phase cuts (A.attn_parts_cut): the kernel stopped after
CUTS = {"loads": 1, "max pass": 2, "softmax": 3}


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
            ms, ms_events = both_ms(call(name, t, heads, n, g), iters)
            print(f"  {name:11s} {ms:8.4f} ms device, {ms_events:8.4f} ms events   "
                  f"(max|d|/max|ref| {err:.2e})", flush=True)
            results[name] = dict(ms=ms, ms_events=ms_events, rel_err=err)
        lib, lib_events = both_ms(sdpa(t, heads, n, g), iters)
        results["full"].update(library_ms=lib, library_ms_events=lib_events)
        print(f"  {'sdpa':11s} {lib:8.4f} ms device, {lib_events:8.4f} ms events   (the full "
              f"variant's library call; full/sdpa {results['full']['ms'] / lib:.2f})", flush=True)
        cuts = {name: device_ms(lambda c=c: A.attn_parts_cut(
            t["q"], t["k"], t["v"], t["mb"], heads=heads, n=n, g=g, cut=c), iters)
                for name, c in CUTS.items()}
        results["full"]["cuts"] = cuts
        print("  full's phases (device ms): " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in cuts.items()) + f", whole "
            f"{results['full']['ms']:.4f}", flush=True)
    return results


def sdpa(t: dict, heads: int, n: int, g: int):
    """The ``full`` variant's library call as a thunk: SDPA over each
    (image, group, head) with the group bias as a float mask, on head-major
    copies of q, k, v made here (outside the thunk)."""
    b, toks, c = t["q"].shape
    gn, hd = g * n, c // heads

    def heads_view(a):
        return a.view(b, toks // gn, gn, heads, hd).transpose(2, 3).reshape(-1, heads, gn, hd)

    qh, kh, vh = (heads_view(t[k]).contiguous() for k in ("q", "k", "v"))
    mask = t["mb"].to(torch.bfloat16)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=hd ** -0.5)


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
