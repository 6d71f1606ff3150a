#!/usr/bin/env python3
"""Phase cuts of the kernels on the wgmma + TMA engine at the main path's shapes, on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_mlp_gemm [--iters 10] [--batch 256]
        [--shapes s1 s2 ... L4]

Per shape (ConvNeXt's stages s1-s4 at 200 px: 99/49/24/12 grids, C 96-768,
N = 4C, bf16 residual; GCViTTiny@224's levels L1-L4: 56/28/14/7 grids, C
64-512, N = 3C, f32 residual), ``ln_fc1_gelu`` and ``fc2_scale_residual``
(``csrc/hopper_gemm.cuh``), and at L1-L4 also GCViT's ``ln_qkv`` (bf16 x,
S = 3: q, k, v) and ``proj_scale_residual`` (K = C, f32 output) on the
same engine, timed whole and as the compile-time cuts of
``csrc/mlp_gemm_cuts.cu``:

  loads       the TMA loads of the weights (and of the hidden for fc2, of
              the attention output for proj) and the 16-byte reads of x,
              nothing computed or written
  ln          + the LN and the A tile writes (ln_fc1_gelu and ln_qkv)
  products    + the wgmma products
  whole       + the epilogue: the kernel itself
  raw_stores  products + the accumulators stored as bf16 (no bias, GELU,
              gamma or residual; the MLP GEMMs only)
  no_stores   whole without its stores

beside cuBLAS's product of the same bf16 operands alone (``F.linear``, TF32
off) and the kernel's bound (its bytes over 3.35 TB/s or its operations over
989 TFLOP/s, whichever is larger; NVIDIA's H100 SXM data sheet). Each with
CUDA events over ``--iters`` launches after a warm-up, in the order listed,
then reversed (the two readings averaged). The whole kernels are first
checked against their plain versions in f32. The difference between two
cuts is what a phase adds where it is not hidden behind the others. No
counterpart in the JAX package. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.kernels import convnext_block as K
from ..ops.kernels import gcvit_block as G
from .bench_util import card_line, cuda_ms

# name: grid, C, N / C, residual dtype, blocks per forward
SHAPES = {"s1": (99, 96, 4, torch.bfloat16, 3), "s2": (49, 192, 4, torch.bfloat16, 3),
          "s3": (24, 384, 4, torch.bfloat16, 9), "s4": (12, 768, 4, torch.bfloat16, 3),
          "L1": (56, 64, 3, torch.float32, 3), "L2": (28, 128, 3, torch.float32, 4),
          "L3": (14, 256, 3, torch.float32, 19), "L4": (7, 512, 3, torch.float32, 5)}
LN_CUTS = {"loads": 0, "ln": 1, "products": 2, "whole": 3, "raw_stores": 4, "no_stores": 5}
FC2_CUTS = {"loads": 0, "products": 2, "whole": 3, "raw_stores": 4, "no_stores": 5}
QKV_CUTS = {"loads": 0, "ln": 1, "products": 2, "whole": 3, "no_stores": 5}
PROJ_CUTS = {"loads": 0, "products": 2, "whole": 3, "no_stores": 5}
HBM_BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12


def bounds_ms(m: int, c: int, n: int, res_bytes: int) -> tuple:
    """(ln_fc1_gelu, fc2_scale_residual) bounds in ms: inputs read once,
    outputs written once, or the products at the bf16 peak."""
    ops = 2 * m * c * n / BF16_OPS_PER_S * 1e3
    ln = (m * c * 4 + n * c * 2 + (n + 2 * c) * 4 + m * n * 2) / HBM_BYTES_PER_S * 1e3
    fc2 = (m * n * 2 + n * c * 2 + 2 * c * 4 + m * c * (res_bytes + 2)) / HBM_BYTES_PER_S * 1e3
    return max(ln, ops), max(fc2, ops)


def qkv_bound_ms(m: int, c: int, s: int = 3) -> float:
    """``ln_qkv``'s bound in ms: bf16 x and W read once, S bf16 (M, C)
    outputs written once, or the products at the bf16 peak."""
    nbytes = (s + 1) * m * c * 2 + s * c * c * 2 + (2 + s) * c * 4
    return max(nbytes / HBM_BYTES_PER_S, 2 * m * c * s * c / BF16_OPS_PER_S) * 1e3


def proj_bound_ms(m: int, c: int) -> float:
    """``proj_scale_residual``'s bound in ms: bf16 attn and x and W_p read
    once, the f32 r1 written once, or the products at the bf16 peak."""
    nbytes = m * c * (2 + 2 + 4) + c * c * 2 + 2 * c * 4
    return max(nbytes / HBM_BYTES_PER_S, 2 * m * c * c / BF16_OPS_PER_S) * 1e3


def _timed(fns: dict, iters: int) -> dict:
    readings = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        readings[name].append(cuda_ms(fns[name], iters))
    return {name: sum(r) / len(r) for name, r in readings.items()}


def run(batch: int = 256, iters: int = 10, shapes: Sequence[str] = tuple(SHAPES)) -> List[dict]:
    """Time every shape; one result dict per shape (ms per launch)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    results = []
    for name in shapes:
        grid, c, ratio, res_dtype, blocks = SHAPES[name]
        m, n = batch * grid * grid, ratio * c
        x, lg, lb = u((m, c)), u((c,), 0.5, 1.5), u((c,), -0.1, 0.1)
        w1, b1 = (u((n, c)) * c ** -0.5).to(torch.bfloat16), u((n,), -0.1, 0.1)
        w2, b2, gm = (u((c, n)) * n ** -0.5).to(torch.bfloat16), u((c,), -0.1, 0.1), u((c,), 0.5,
                                                                                       1.5)
        res = u((m, c)).to(res_dtype)
        hid = K.ln_fc1_gelu(x, lg, lb, w1, b1, 1e-6)
        out = K.fc2_scale_residual(hid, w2, b2, gm, res)
        rows = slice(0, 4096)
        errs = []
        for got, ref in (
                (hid[rows], K.ln_fc1_gelu_plain(x[rows], lg, lb, w1.float(), b1, 1e-6)),
                (out[rows], K.fc2_scale_residual_plain(hid[rows].float(), w2.float(), b2, gm,
                                                       res[rows].float()))):
            errs.append(((got.float() - ref).abs().max() / ref.abs().max()).item())
        y = x.to(torch.bfloat16)  # an LN output's stand-in for cuBLAS's product alone
        ln_fns = {cut: (lambda k=k: K.ln_fc1_gelu_cut(x, lg, lb, w1, b1, 1e-6, k))
                  for cut, k in LN_CUTS.items()}
        ln_fns["cublas"] = lambda: F.linear(y, w1)
        fc2_fns = {cut: (lambda k=k: K.fc2_scale_residual_cut(hid, w2, b2, gm, res, k))
                   for cut, k in FC2_CUTS.items()}
        fc2_fns["cublas"] = lambda: F.linear(hid, w2)
        ln_ms, fc2_ms = _timed(ln_fns, iters), _timed(fc2_fns, iters)
        b_ln, b_fc2 = bounds_ms(m, c, n, res.element_size())
        timed = [("ln_fc1_gelu", ln_ms, b_ln, errs[0]),
                 ("fc2_scale_residual", fc2_ms, b_fc2, errs[1])]
        extra = {}
        if name.startswith("L"):  # GCViT's ln_qkv on the same engine
            xq = u((m, c)).to(torch.bfloat16)
            wq, bq = (u((3 * c, c)) * c ** -0.5).to(torch.bfloat16), u((3 * c,), -0.1, 0.1)
            got = torch.cat(G.ln_qkv(xq, lg, lb, wq, bq, 1e-5), 1)[rows]
            ref = torch.cat(G.ln_qkv_plain(xq[rows], lg, lb, wq.float(), bq, 1e-5), 1)
            errs.append(((got.float() - ref).abs().max() / ref.abs().max()).item())
            yq = xq  # an LN output's stand-in for cuBLAS's product alone
            qkv_fns = {cut: (lambda k=k: G.ln_qkv_cut(xq, lg, lb, wq, bq, 1e-5, k))
                       for cut, k in QKV_CUTS.items()}
            qkv_fns["cublas"] = lambda: F.linear(yq, wq)
            extra["ln_qkv"] = _timed(qkv_fns, iters)
            extra["bound_ln_qkv"] = qkv_bound_ms(m, c)
            timed.append(("ln_qkv", extra["ln_qkv"], extra["bound_ln_qkv"], errs[2]))
            # proj_scale_residual: the attention output and the block input, K = C
            wp, bp = (u((c, c)) * c ** -0.5).to(torch.bfloat16), u((c,), -0.1, 0.1)
            xr = u((m, c)).to(torch.bfloat16)
            got = G.proj_scale_residual(xq, wp, bp, gm, xr)[rows]
            ref = G.proj_scale_residual_plain(xq[rows].float(), wp.float(), bp, gm,
                                              xr[rows].float())
            errs.append(((got - ref).abs().max() / ref.abs().max()).item())
            proj_fns = {cut: (lambda k=k: G.proj_scale_residual_cut(xq, wp, bp, gm, xr, k))
                        for cut, k in PROJ_CUTS.items()}
            proj_fns["cublas"] = lambda: F.linear(xq, wp)
            extra["proj_scale_residual"] = _timed(proj_fns, iters)
            extra["bound_proj_scale_residual"] = proj_bound_ms(m, c)
            timed.append(("proj_scale_residual", extra["proj_scale_residual"],
                          extra["bound_proj_scale_residual"], errs[3]))
            del xq, xr, wq, wp, got, ref, qkv_fns, proj_fns
        for kernel, ms, bound, err in timed:
            print(f"[{name} ({m},{c})->{n}] {kernel}: whole vs plain max|d|/max|ref| {err:.2e}; "
                  + ", ".join(f"{cut} {t:.4f}" for cut, t in ms.items())
                  + f" ms; bound {bound:.4f} ms; whole/bound {ms['whole'] / bound:.2f}, "
                    f"whole/cuBLAS {ms['whole'] / ms['cublas']:.2f} [{card_line()}]", flush=True)
        bound = dict(ln_fc1_gelu=b_ln, fc2_scale_residual=b_fc2)
        if extra:
            bound["ln_qkv"] = extra.pop("bound_ln_qkv")
            bound["proj_scale_residual"] = extra.pop("bound_proj_scale_residual")
        results.append(dict(name=name, m=m, c=c, n=n, blocks=blocks, rel_err=errs,
                            ln_fc1_gelu=ln_ms, fc2_scale_residual=fc2_ms, bound=bound, **extra))
        del x, w1, w2, res, hid, out, y, ln_fns, fc2_fns
        torch.cuda.empty_cache()
    return results


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--shapes", nargs="+", choices=list(SHAPES), default=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("exp_mlp_gemm: no CUDA device is available; the cuts are CUDA kernels")
    print(f"device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    return run(args.batch, args.iters, args.shapes)


if __name__ == "__main__":
    main()
