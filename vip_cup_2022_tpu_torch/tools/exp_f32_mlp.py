#!/usr/bin/env python3
"""The f32 MLP GEMMs on one CUDA card: the 3xTF32 wgmma kernels against the
FFMA kernels they replaced and cuBLAS's f32 product, in one call.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_f32_mlp [--batch 256]
        [--check-batches 8 512] [--no-cuts]

At each main-path shape (ConvNeXt's s1-s4 at 200 px, N = 4C, eps 1e-6;
GCViTTiny's L1-L4 at 224, N = 3C, eps 1e-5), on seeded inputs:

- checks ``ln_fc1_gelu_f32`` and ``fc2_scale_residual_f32`` (and, at GCViT's
  levels, ``fc2_scale_residual_mmf32``'s bf16 output) against their plain
  versions in f32 with TF32 off (``F32_BOUND`` of max|ref|; the bf16 output
  within one bf16 rounding, ``BF16_BOUND``), at ``--batch`` and each of
  ``--check-batches``, the FFMA kernels beside them;
- times at ``--batch`` by device time (``bench_util.device_ms``: a CUDA
  graph of the launches replayed): the FFMA kernels (``csrc/f32_mlp_cuts.cu``,
  ``csrc/f32_gemm.cuh``), the 3xTF32 kernels with the weights' split kept
  as the models keep it, cuBLAS's f32 product alone (``F.linear``, TF32
  off), and the new kernels' phase cuts (:data:`..ops.kernels.convnext_block.TF32_CUTS`);
- the least time of each launch: its bytes (inputs read once, outputs
  written once) over 3.35 TB/s, its f32 products over 165 TFLOP/s (495 / 3:
  three TF32 passes) and, beside it, over FFMA's 67 TFLOP/s;

then sums each per ConvNeXt + GCViTTiny forward (18 + 31 blocks). Needs a
CUDA device; the last line is the results as one JSON object. No counterpart
in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.kernels import convnext_block as K
from ..ops.kernels.tf32 import tf32_weight
from .bench_util import card_line, device_ms

# name: tokens a side, C, N / C, LN eps, blocks a forward
SHAPES = {"s1": (99, 96, 4, 1e-6, 3), "s2": (49, 192, 4, 1e-6, 3), "s3": (24, 384, 4, 1e-6, 9),
          "s4": (12, 768, 4, 1e-6, 3), "L1": (56, 64, 3, 1e-5, 3), "L2": (28, 128, 3, 1e-5, 4),
          "L3": (14, 256, 3, 1e-5, 19), "L4": (7, 512, 3, 1e-5, 5)}
F32_BOUND = 1e-5  # of max|ref|: f32 products kept to about 22 bits, sums in another order
BF16_BOUND = 2.0 ** -8  # of max|ref|: one rounding of the output to bf16
HBM_BYTES_PER_S = 3.35e12
PEAK = {"3xtf32": 495e12 / 3, "ffma": 67e12}


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _inputs(g: torch.Generator, m: int, c: int, n: int, dev) -> dict:
    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    p = dict(x=u((m, c)), lg=u((c,), 0.5, 1.5), lb=u((c,), -0.1, 0.1),
             w1=u((n, c)) * c ** -0.5, b1=u((n,), -0.1, 0.1), w2=u((c, n)) * n ** -0.5,
             b2=u((c,), -0.1, 0.1), gamma=u((c,), 0.5, 1.5), res=u((m, c)))
    p["s1"], p["s2"] = tf32_weight(p["w1"]), tf32_weight(p["w2"])
    return p


def _check(name: str, shape: str, b: int, p: dict, eps: float, mmf32: bool) -> dict:
    """Each kernel (and its FFMA twin) against the plain version."""
    hid = K.ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], eps, w_split=p["s1"])
    out = K.fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"], p["res"], w_split=p["s2"])
    ffma_hid = K.ffma_ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], eps)
    ffma_out = K.ffma_fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"], p["res"])
    torch.cuda.synchronize()
    ref_hid = K.ln_fc1_gelu_plain(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], eps)
    ref_out = K.fc2_scale_residual_plain(hid, p["w2"], p["b2"], p["gamma"], p["res"])
    errs = {"ln_fc1_gelu_f32": _rel(hid, ref_hid), "fc2_scale_residual_f32": _rel(out, ref_out),
            "ffma ln_fc1_gelu": _rel(ffma_hid, ref_hid), "ffma fc2": _rel(ffma_out, ref_out)}
    del ref_hid, ffma_hid, ffma_out, out
    bounds = {n: F32_BOUND for n in errs}
    if mmf32:
        mm = K.fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"], p["res"],
                                  out_dtype=torch.bfloat16, w_split=p["s2"])
        errs["fc2_scale_residual_mmf32"] = _rel(mm, ref_out)
        bounds["fc2_scale_residual_mmf32"] = BF16_BOUND
    print(f"[check] {shape} b{b} ({name}): " + ", ".join(
        f"{k} {v:.3e} (bound {bounds[k]:g})" for k, v in errs.items()), flush=True)
    bad = {k: v for k, v in errs.items() if not v <= bounds[k]}
    if bad:
        raise AssertionError(f"{shape} b{b}: beyond the bound against plain f32: {bad}")
    return errs


def run(batch: int = 256, check_batches: Sequence[int] = (8, 512), cuts: bool = True) -> dict:
    if not torch.cuda.is_available():
        sys.exit("exp_f32_mlp: no CUDA device is available; the measurements are CUDA kernels")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    g = torch.Generator(device=dev).manual_seed(11)
    results = {"card": card, "shapes": {}, "per_forward": {}}
    for shape, (grid, c, ratio, eps, blocks) in SHAPES.items():
        n, gcvit = ratio * c, shape.startswith("L")
        for b in check_batches:
            p = _inputs(g, b * grid * grid, c, n, dev)
            _check(shape, shape, b, p, eps, gcvit)
            del p
            torch.cuda.empty_cache()
        m = batch * grid * grid
        p = _inputs(g, m, c, n, dev)
        errs = _check(shape, shape, batch, p, eps, gcvit)
        hid = K.ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], eps, w_split=p["s1"])
        calls = {
            "ln_fc1_gelu_f32": lambda: K.ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"], p["b1"],
                                                     eps, w_split=p["s1"]),
            "ffma ln_fc1_gelu": lambda: K.ffma_ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"],
                                                           p["b1"], eps),
            "cublas fc1": lambda: F.linear(p["x"], p["w1"]),
            "fc2_scale_residual_f32": lambda: K.fc2_scale_residual(
                hid, p["w2"], p["b2"], p["gamma"], p["res"], w_split=p["s2"]),
            "ffma fc2": lambda: K.ffma_fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"],
                                                          p["res"]),
            "cublas fc2": lambda: F.linear(hid, p["w2"]),
        }
        if gcvit:
            calls["fc2_scale_residual_mmf32"] = lambda: K.fc2_scale_residual(
                hid, p["w2"], p["b2"], p["gamma"], p["res"], out_dtype=torch.bfloat16,
                w_split=p["s2"])
            calls["ffma fc2 mmf32"] = lambda: K.ffma_fc2_scale_residual(
                hid, p["w2"], p["b2"], p["gamma"], p["res"], torch.bfloat16)
        if cuts:
            for cut in K.TF32_CUTS:
                calls[f"gelu cut {cut}"] = lambda cut=cut: K.tf32_mlp_cut(
                    "gelu", cut, p["x"], p["s1"], p["b1"], ln_weight=p["lg"], ln_bias=p["lb"],
                    eps=eps)
                calls[f"res cut {cut}"] = lambda cut=cut: K.tf32_mlp_cut(
                    "res", cut, hid, p["s2"], p["b2"], gamma=p["gamma"], residual=p["res"])
        ms = {name: device_ms(fn, calls=5, replays=3) for name, fn in calls.items()}
        ops = 2 * m * c * n  # each GEMM's f32 products
        nbytes = {"fc1": 4 * (m * c + n * c + n + 2 * c + m * n),
                  "fc2": 4 * (m * n + c * n + 2 * c + 2 * m * c),
                  "fc2 mmf32": 4 * (m * n + c * n + 2 * c + m * c) + 2 * m * c}
        bound = {}
        for gemm, nb in nbytes.items():
            t_bytes = nb / HBM_BYTES_PER_S * 1e3
            bound[gemm] = {"bytes_ms": t_bytes, "ops_ms_3xtf32": ops / PEAK["3xtf32"] * 1e3,
                           "ops_ms_ffma": ops / PEAK["ffma"] * 1e3}
            bound[gemm]["bound_ms"] = max(t_bytes, bound[gemm]["ops_ms_3xtf32"])
        results["shapes"][shape] = {"M": m, "C": c, "N": n, "blocks": blocks, "ms": ms,
                                    "bound": bound, "max_rel_err": errs}
        print(f"[time] {shape} (M {m}, C {c}, N {n}; plans "
              f"{K.tf32_gemm_plan('gelu', c, n)['bn']}/{K.tf32_gemm_plan('res', n, c)['bn']} "
              f"columns): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f" device ms; bound fc1 {bound['fc1']['bound_ms']:.3f}, fc2 "
              f"{bound['fc2']['bound_ms']:.3f} ms [{card}]", flush=True)
        del p, hid, calls
        torch.cuda.empty_cache()
    per = results["per_forward"]
    for shape, r in results["shapes"].items():
        for name, t in r["ms"].items():
            per[name] = per.get(name, 0.0) + r["blocks"] * t
        for gemm, bd in r["bound"].items():
            for k, v in bd.items():
                key = f"bound {gemm} {k}"
                per[key] = per.get(key, 0.0) + r["blocks"] * v
    print(f"[forward] per ConvNeXt + GCViTTiny batch-{batch} forward (18 + 31 blocks), device "
          f"ms: " + ", ".join(f"{k} {v:.2f}" for k, v in per.items()) + f" [{card}]", flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--check-batches", type=int, nargs="*", default=[8, 512])
    ap.add_argument("--no-cuts", action="store_true")
    args = ap.parse_args(argv)
    results = run(args.batch, args.check_batches, not args.no_cuts)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
