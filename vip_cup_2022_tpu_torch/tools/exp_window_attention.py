#!/usr/bin/env python3
"""Phase cuts of the window-attention kernel at GCViTTiny's levels, on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_window_attention [--iters 20] [--batch 256]

Per GCViTTiny@224 level (L1-L4: 56/28/14/7 grids, 2/4/8/16 heads, windows
7/7/14/7), on bf16 (B*nWin, heads, N, 32) q, k, v and an f32 (heads, N, N)
bias, the ``window_attention_bhnd`` kernel (``csrc/window_attention.cuh``)
timed whole and stopped after each of its phases:

  loads    K and V through the cp.async ring, the head's bias into shared
           memory, q into registers
  scores   + q k^T on the tensor cores, the scale and the bias
  softmax  + row max, exps, sums and P packed to bf16
  whole    + P V and the output: the kernel itself

beside SDPA on the same tiles with the bias as a float mask, each with CUDA
events over ``--iters`` launches after a warm-up, in the order cuts, whole,
SDPA, then reversed (the two readings averaged). A cut writes a checksum of
its last phase, so nothing before it is compiled away; the difference
between two cuts is what a phase adds where it is not hidden behind the
others. The whole kernel is first checked against its plain version in f32
on the first windows. No counterpart in the JAX package. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.kernels import window_attention as WA
from .bench_util import card_line, cuda_ms

# GCViTTiny@224 levels: grid, C, heads, window, local blocks, global-query blocks
LEVELS = ((56, 64, 2, 7, 2, 1), (28, 128, 4, 7, 2, 2), (14, 256, 8, 14, 10, 9),
          (7, 512, 16, 7, 3, 2))
CUTS = {"loads": 1, "scores": 2, "softmax": 3}


def run(batch: int = 256, iters: int = 20) -> List[dict]:
    """Time every level; one result dict per level (ms per launch)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 32 ** -0.5
    results = []
    for grid, _, heads, ws, n_local, n_global in LEVELS:
        n, nwin = ws * ws, (grid // ws) ** 2
        q, k, v = ((torch.rand((batch * nwin, heads, n, 32), generator=gen, device="cuda") * 2 - 1)
                   .to(torch.bfloat16) for _ in range(3))
        bias = torch.rand((heads, n, n), generator=gen, device="cuda") * 2 - 1
        head = slice(0, 2 * heads)
        got = WA.window_attention(q[head], k[head], v[head], bias, scale).float()
        ref = WA.window_attention_plain(q[head].float(), k[head].float(), v[head].float(), bias,
                                        scale)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        mask = bias.to(torch.bfloat16)
        fns = {name: (lambda c=c: WA.window_attention_cut(q, k, v, bias, scale, c))
               for name, c in CUTS.items()}
        fns["whole"] = lambda: WA.window_attention(q, k, v, bias, scale)
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                             scale=scale)
        order = list(fns) + list(fns)[::-1]
        readings = {name: [] for name in fns}
        for name in order:
            readings[name].append(cuda_ms(fns[name], iters))
        ms = {name: sum(r) / len(r) for name, r in readings.items()}
        label = f"L{grid}x{grid} ({batch * nwin},{heads},{n},32)"
        print(f"[{label}] whole vs plain max|d|/max|ref| {err:.2e}; "
              + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items())
              + f"; whole/sdpa {ms['whole'] / ms['sdpa']:.2f}", flush=True)
        results.append(dict(grid=grid, heads=heads, n=n, batch=batch, rel_err=err,
                            blocks=n_local + n_global, ms=ms))
        del q, k, v, bias, mask, fns
        torch.cuda.empty_cache()
    per_forward = {name: sum(r["blocks"] * r["ms"][name] for r in results)
                   for name in results[0]["ms"]}
    print("[per GCViTTiny forward, 31 blocks] "
          + ", ".join(f"{name} {t:.3f} ms" for name, t in per_forward.items()), flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("exp_window_attention: no CUDA device is available; the cuts are CUDA kernels")
    print(f"device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    return run(args.batch, args.iters)


if __name__ == "__main__":
    main()
