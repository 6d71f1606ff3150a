#!/usr/bin/env python3
"""Phase cuts of ``ptq_int8_conv`` (the int8 PTQ site) at ResNetRS50's sites, on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_ptq_int8 [--iters 10] [--batch 256]
        [--sites c2_1x1 c2_3x3 ... c5_3x3]

Per site (one 1 x 1 and one 3 x 3 conv of each of ResNetRS50's four stages at
200 px, bf16 x and output as on the model's path), the site's launches
(``csrc/ptq_int8.cuh``: the quantize pass, then the wgmma + TMA GEMM; or,
where the site quantizes in the GEMM, the GEMM alone) timed whole and as the
compile-time cuts of ``csrc/ptq_int8_cuts.cu``:

  loads      the GEMM's loads of A (TMA rows or the cp.async gather of x
             quantized beforehand, or TMA of the bf16 rows) and of W,
             nothing computed
  quantize   the quantize pass alone (where the site quantizes in the
             GEMM: the pass it no longer runs)
  +quantize  the site's quantize pass, then the loads cut
  +products  the site's quantize pass, then the GEMM up to its wgmma
             products (and its quantizing, where it quantizes)
  whole      the site itself
  gemm       the whole GEMM alone (on x quantized beforehand, where the
             site has a pass)
  no_stores  the site's pass and the GEMM without its stores

beside cuDNN's bf16 conv of the same site (a yardstick: it computes the bf16
conv, not the int8 site) and the site's bound (its bytes, x and the output
and W read or written once, over 3.35 TB/s, or its products over 1,979 int8
TOP/s, whichever is larger; NVIDIA's H100 SXM data sheet). Each with CUDA
events over ``--iters`` launches after a warm-up, in the order listed, then
reversed (the two readings averaged). The site is first checked against its
plain version (within 1e-6 of max|ref|). The difference between two cuts is
what a phase adds where it is not hidden behind the others. No counterpart
in the JAX package. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.kernels import int8_gemm as Q
from .bench_util import card_line, cuda_ms

# name: (H = W, C, N, kernel, stride), ResNetRS50@200's sites
SITES = {"c2_1x1": (50, 64, 256, 1, 1), "c2_3x3": (50, 64, 64, 3, 1),
         "c3_1x1": (25, 128, 512, 1, 1), "c3_3x3": (25, 128, 128, 3, 1),
         "c4_1x1": (13, 256, 1024, 1, 1), "c4_3x3": (13, 256, 256, 3, 1),
         "c5_1x1": (7, 512, 2048, 1, 1), "c5_3x3": (7, 512, 512, 3, 1)}
CUTS = ("loads", "quantize", "+quantize", "+products", "whole", "gemm", "no_stores")
HBM_BYTES_PER_S, INT8_OPS_PER_S = 3.35e12, 1979e12


def bound_ms(b: int, h: int, c: int, n: int, kernel: int, stride: int) -> float:
    """The site's bound in ms: bf16 x, int8 W and the bf16 output moved once,
    or its int8 products at the peak."""
    ho = (h + 2 * (kernel // 2) - kernel) // stride + 1
    m, k = b * ho * ho, kernel * kernel * c
    nbytes = b * h * h * c * 2 + k * n + m * n * 2 + n * 4
    return max(nbytes / HBM_BYTES_PER_S, 2 * m * k * n / INT8_OPS_PER_S) * 1e3


def run(batch: int = 256, iters: int = 10, sites: Sequence[str] = tuple(SITES)) -> List[dict]:
    """Time every site; one result dict per site (ms per site)."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for name in sites:
        h, c, n, kernel, stride = SITES[name]
        x = torch.randn((batch, h, h, c), generator=gen, device="cuda").to(torch.bfloat16)
        k = kernel * kernel * c
        qw = Q.pack_weight(torch.randint(-127, 128, (k, n), generator=gen, device="cuda")
                           .to(torch.int8))
        cs = torch.rand((n,), generator=gen, device="cuda") * 1e-3
        inv = Q.f32_reciprocal(x.float().abs().max().item() / 127.0)
        kw = dict(kernel=kernel, stride=stride, padding=kernel // 2)
        got = Q.ptq_int8_conv(x, qw, cs, None, inv, **kw)
        ref = Q.ptq_int8_conv_plain(x, qw, cs, None, inv, **kw)
        err = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        del got, ref
        xq = Q.ptq_int8_quantize(x, inv)
        wc = torch.randn((n, c, kernel, kernel), generator=gen, device="cuda").to(torch.bfloat16)
        xc = x.permute(0, 3, 1, 2)
        in_gemm = Q.quantizes_in_gemm(x.dtype, x.dtype, **kw, k=k, n=n)

        def gemm(a, cut):  # the GEMM on x quantized beforehand, or on x itself
            return Q.ptq_int8_gemm(a, qw, cs, None, out_dtype=torch.bfloat16, cut=cut,
                                   inv_s=inv if a.dtype == torch.bfloat16 else None, **kw)

        def site_a():  # the GEMM's A as the site makes it
            return x if in_gemm else Q.ptq_int8_quantize(x, inv)

        fns = {
            "loads": lambda: gemm(x if in_gemm else xq, 0),
            "quantize": lambda: Q.ptq_int8_quantize(x, inv),
            "+quantize": lambda: gemm(site_a(), 0),
            "+products": lambda: gemm(site_a(), 2),
            "whole": lambda: Q.ptq_int8_conv(x, qw, cs, None, inv, **kw),
            "gemm": lambda: gemm(x if in_gemm else xq, 3),
            "no_stores": lambda: gemm(site_a(), 5),
            "cudnn": lambda: F.conv2d(xc, wc, None, stride, kernel // 2),
        }
        readings = {cut: [] for cut in fns}
        for cut in list(fns) + list(fns)[::-1]:
            readings[cut].append(cuda_ms(fns[cut], iters))
        ms = {cut: sum(r) / len(r) for cut, r in readings.items()}
        bound = bound_ms(batch, h, c, n, kernel, stride)
        print(f"[{name} ({batch},{h},{h},{c})->{n} k{kernel} s{stride}"
              f"{' quantized in the GEMM' if in_gemm else ''}] whole vs plain "
              f"max|d|/max|ref| {err:.2e}; " + ", ".join(f"{cut} {t:.4f}" for cut, t in ms.items())
              + f" ms; bound {bound:.4f} ms; whole/bound {ms['whole'] / bound:.2f}, "
                f"whole/cuDNN {ms['whole'] / ms['cudnn']:.2f} [{card_line()}]", flush=True)
        results.append(dict(name=name, batch=batch, rel_err=err, ms=ms, bound=bound,
                            in_gemm=in_gemm))
        del x, qw, xq, wc, xc, fns
        torch.cuda.empty_cache()
    return results


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sites", nargs="+", choices=list(SITES), default=list(SITES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("exp_ptq_int8: no CUDA device is available; the cuts are CUDA kernels")
    print(f"device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    return run(args.batch, args.iters, args.sites)


if __name__ == "__main__":
    main()
