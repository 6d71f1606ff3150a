#!/usr/bin/env python3
"""Phase cuts of the window-attention kernel at GCViTTiny's levels, on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_window_attention [--iters 20] [--batch 256]
        [--kernels bf16 f32]
    python3 vip_cup_2022_tpu_torch/tools/exp_window_attention.py --root DIR --kernels f32

``--kernels bf16`` (the default): per GCViTTiny@224 level (L1-L4: 56/28/14/7
grids, 2/4/8/16 heads, windows 7/7/14/7), on bf16 (B*nWin, heads, N, 32) q,
k, v and an f32 (heads, N, N) bias, the ``window_attention_bhnd`` kernel
(``csrc/window_attention.cuh``) timed whole and stopped after each of its
phases:

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
on the first windows.

``--kernels f32``: GCViT's fused-block attention on (B, nWin*N, C) token
rows in its f32 products, ``window_attention_f32`` (f32 q, k, v -> f32;
``VIPTPU_DTYPE=float32``) and ``window_attention_mmf32`` (f32 q, k, v ->
bf16, a global query in bf16; ``VIPTPU_GCVIT_MM=f32`` on bf16), each with
a local and a global query at L1-L4, by device time
(``bench_util.device_ms``), beside SDPA in f32 on the same tiles (the bias
a float mask, the global query repeated over the windows beforehand) and
the bound (q, k, v and the output read or written once and the bias once,
over 3.35 TB/s; or the two products, 4 N^2 32 an item and head, at 165
TFLOP/s, 3xTF32 on the H100's 495), each checked first against its plain
version on the first two images; then per GCViTTiny batch-256 forward
(each level's local and global-query blocks); ``window_attention_f32``
also stopped after its phases where the checkout has the cuts: loads (q, k,
v by cp.async), scores (+ the 3xTF32 q k^T, the bias, the row max),
softmax (+ exp, the row sums, P's split). ``--root DIR`` imports the
package from DIR, a checkout of another commit (run this file by its path,
so that nothing is imported before the root is chosen): two builds are
timed by the same code, one process each, in one chip call.

No counterpart in the JAX package. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
WA = G = None  # the kernel modules of the checkout timed (:func:`_load`)
cuda_ms = device_ms = card_line = None

# GCViTTiny@224 levels: grid, C, heads, window, local blocks, global-query blocks
LEVELS = ((56, 64, 2, 7, 2, 1), (28, 128, 4, 7, 2, 2), (14, 256, 8, 14, 10, 9),
          (7, 512, 16, 7, 3, 2))
CUTS = {"loads": 1, "scores": 2, "softmax": 3}
HBM_BYTES_PER_S, F32_TC_OPS_PER_S = 3.35e12, 495e12 / 3
F32_MODES = {"window_attention_f32": torch.float32, "window_attention_mmf32": torch.bfloat16}


def _load(root: str) -> None:
    """Import the kernel modules and the timers from checkout ``root``."""
    global WA, G, cuda_ms, device_ms, card_line
    if root not in sys.path[:1]:
        sys.path.insert(0, root)
    from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block, window_attention
    from vip_cup_2022_tpu_torch.tools import bench_util

    WA, G = window_attention, gcvit_block
    cuda_ms, device_ms, card_line = bench_util.cuda_ms, bench_util.device_ms, bench_util.card_line


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


def f32_bound_ms(b: int, nwin: int, n: int, c: int, heads: int, out_bytes: int,
                 q_rows: int, q_bytes: int) -> float:
    """The f32 attention's bound in ms: k and v (f32), q (``q_rows`` rows of
    ``q_bytes``-byte values) and the bias read once, the output written
    once; or the two products at 165 TFLOP/s (3xTF32)."""
    m = b * nwin * n
    nbytes = m * c * (8 + out_bytes) + q_rows * c * q_bytes + heads * n * n * 4
    return max(nbytes / HBM_BYTES_PER_S, 4 * m * n * c / F32_TC_OPS_PER_S) * 1e3


def run_f32(batch: int = 256, iters: int = 20) -> dict:
    """The f32-product attention kernels at L1-L4, local and global query,
    by device time; returns per level and per forward ms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    scale = 32 ** -0.5
    f32 = torch.float32

    def u(shape):
        return torch.rand(shape, generator=gen, device="cuda") * 2 - 1

    timer = lambda fn: device_ms(fn, calls=iters)  # noqa: E731
    per_level, forward = {}, {}
    for grid, c, heads, ws, n_local, n_global in LEVELS:
        n, nwin = ws * ws, (grid // ws) ** 2
        toks = nwin * n
        k, v, q = u((batch, toks, c)), u((batch, toks, c)), u((batch, toks, c))
        qg = u((batch, n, c))
        bias = u((heads, n, n))
        hv = lambda t: t.reshape(-1, n, heads, 32).transpose(1, 2)  # noqa: E731
        level = per_level[f"L{grid}"] = {}
        for kernel, out_dt in F32_MODES.items():
            for query, count in (("local", n_local), ("global", n_global)):
                glob = query == "global"
                qq = (qg.to(out_dt) if glob else q)  # the mixed mode's global query is bf16
                call = lambda qq=qq, glob=glob, out_dt=out_dt: G.window_attention(  # noqa: E731
                    qq, k, v, bias, n, scale, glob, mm_dtype=f32, out_dtype=out_dt)
                few = slice(0, 2)
                got = G.window_attention(qq[few], k[few], v[few], bias, n, scale, glob,
                                         mm_dtype=f32, out_dtype=out_dt).float()
                ref = G.window_attention_plain(qq[few], k[few], v[few], bias, n, scale, glob,
                                               f32, out_dt).float()
                err = ((got - ref).abs().max() / ref.abs().max()).item()
                q_lib = qg.float().repeat_interleave(nwin, 1) if glob else q
                fns = {"whole": call,
                       "sdpa": lambda q_lib=q_lib: F.scaled_dot_product_attention(
                           hv(q_lib), hv(k), hv(v), attn_mask=bias, scale=scale)}
                cut = getattr(G, "window_attention_f32_cut", None)
                if cut is not None and kernel == "window_attention_f32":
                    fns.update({name: (lambda qq=qq, glob=glob, c_=c_: cut(
                        qq, k, v, bias, n, scale, glob, c_))
                        for name, c_ in G.F32_ATTENTION_CUTS.items()})
                readings = {name: [] for name in fns}
                for name in list(fns) + list(fns)[::-1]:
                    readings[name].append(timer(fns[name]))
                ms = {name: sum(r) / len(r) for name, r in readings.items()}
                bound = f32_bound_ms(batch, nwin, n, c, heads, torch.empty((), dtype=out_dt)
                                     .element_size(), batch * (n if glob else toks),
                                     qq.element_size())
                level[f"{kernel} {query}"] = dict(ms=ms, bound=bound, rel_err=err, blocks=count)
                acc = forward.setdefault(kernel, {})
                for name, t in list(ms.items()) + [("bound", bound)]:
                    acc[name] = acc.get(name, 0.0) + t * count
                print(f"[f32 L{grid} ({batch},{toks},{c}) w{ws}] {kernel} {query}: whole vs plain "
                      f"max|d|/max|ref| {err:.2e}; device "
                      + ", ".join(f"{name} {t:.4f}" for name, t in ms.items())
                      + f" ms; bound {bound:.4f} ms; whole/bound "
                      f"{ms['whole'] / bound:.2f}, whole/sdpa {ms['whole'] / ms['sdpa']:.2f}; "
                      f"{count} blocks [{card_line()}]", flush=True)
        del k, v, q, qg, bias
        torch.cuda.empty_cache()
    for kernel, acc in forward.items():
        print(f"[f32] {kernel} per GCViTTiny batch-{batch} forward (31 blocks), device ms: "
              + ", ".join(f"{name} {t:.4f}" for name, t in acc.items())
              + f" [{card_line()}]", flush=True)
    return dict(levels=per_level, forward=forward)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """The bf16 kernel's per-level results, then the f32 arm's as one dict
    (``kernels="f32"``, ``levels``, ``forward``) where it ran."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--kernels", nargs="+", choices=["bf16", "f32"], default=["bf16"])
    ap.add_argument("--root", default=CHECKOUT, help="checkout whose package is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("exp_window_attention: no CUDA device is available; the cuts are CUDA kernels")
    root = os.path.abspath(args.root)
    _load(root)
    print(f"root={root} device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    results = run(args.batch, args.iters) if "bf16" in args.kernels else []
    if "f32" in args.kernels:
        results.append(dict(kernels="f32", **run_f32(args.batch, args.iters)))
    return results


if __name__ == "__main__":
    main()
