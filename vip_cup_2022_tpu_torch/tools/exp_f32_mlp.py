#!/usr/bin/env python3
"""The f32 GEMMs of the fused blocks on one CUDA card: the 3xTF32 wgmma kernels
beside cuBLAS's f32 product, in one call.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_f32_mlp [--batch 256]
        [--check-batches 8 512] [--no-cuts]

At each main-path shape (ConvNeXt's s1-s4 at 200 px, N = 4C, eps 1e-6;
GCViTTiny's L1-L4 at 224, N = 3C, eps 1e-5), on seeded inputs:

- checks ``ln_fc1_gelu_f32`` and ``fc2_scale_residual_f32`` (and, at GCViT's
  levels, ``fc2_scale_residual_mmf32``'s bf16 output, and ``ln_qkv_f32`` /
  ``_mmf32`` local and global and ``proj_scale_residual_f32`` / ``_mmf32``)
  against their plain versions in f32 with TF32 off (``F32_BOUND`` of
  max|ref|; the bf16 output within one bf16 rounding, ``BF16_BOUND``), at
  ``--batch`` and each of ``--check-batches``;
- times at ``--batch`` by device time (``bench_util.device_ms``: a CUDA
  graph of the launches replayed): the 3xTF32 kernels with the weights'
  split kept as the models keep it, cuBLAS's f32 product alone
  (``F.linear``, TF32 off; for an ``_mmf32`` mode on the bf16 activations
  widened inside the timed call, the kernel's own conversion), and the
  kernels' phase cuts (:data:`..ops.kernels.convnext_block.TF32_CUTS`; the
  f32 modes);
- the least time of each launch: its bytes (inputs read once, outputs
  written once) over 3.35 TB/s, its f32 products over 165 TFLOP/s (495 / 3:
  three TF32 passes), or over 247.5 (495 / 2) for ``proj_scale_residual_mmf32``,
  whose bf16 A is exact in TF32 and takes two passes;

then sums each per ConvNeXt + GCViTTiny forward (18 + 31 blocks; GCViT's
local- and global-query blocks apart). Needs a CUDA device; the last line is
the results as one JSON object. No counterpart in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.kernels import convnext_block as K
from ..ops.kernels import gcvit_block as G
from ..ops.kernels.tf32 import tf32_weight
from .bench_util import card_line, device_ms

# name: tokens a side, C, N / C, LN eps, blocks a forward
SHAPES = {"s1": (99, 96, 4, 1e-6, 3), "s2": (49, 192, 4, 1e-6, 3), "s3": (24, 384, 4, 1e-6, 9),
          "s4": (12, 768, 4, 1e-6, 3), "L1": (56, 64, 3, 1e-5, 3), "L2": (28, 128, 3, 1e-5, 4),
          "L3": (14, 256, 3, 1e-5, 19), "L4": (7, 512, 3, 1e-5, 5)}
F32_BOUND = 1e-5  # of max|ref|: f32 products kept to about 22 bits, sums in another order
BF16_BOUND = 2.0 ** -8  # of max|ref|: one rounding of the output to bf16
HBM_BYTES_PER_S = 3.35e12
PEAK_TF32 = 495e12  # dense TF32 tensor-core products, one pass
PASSES = {"proj_scale_residual_mmf32": 2}  # TF32 passes a product; 3 for any other
MM_MODES = {"f32": torch.float32, "mmf32": torch.bfloat16}  # GCViT's qkv / proj: x's dtype


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _inputs(g: torch.Generator, m: int, c: int, n: int, dev, gcvit: bool) -> dict:
    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    p = dict(x=u((m, c)), lg=u((c,), 0.5, 1.5), lb=u((c,), -0.1, 0.1),
             w1=u((n, c)) * c ** -0.5, b1=u((n,), -0.1, 0.1), w2=u((c, n)) * n ** -0.5,
             b2=u((c,), -0.1, 0.1), gamma=u((c,), 0.5, 1.5), res=u((m, c)))
    p["s1"], p["s2"] = tf32_weight(p["w1"]), tf32_weight(p["w2"])
    if gcvit:  # the qkv and proj GEMMs: W_qkv (3C, C), its k/v rows, W_p; the attention output
        p.update(wq=u((3 * c, c)) * c ** -0.5, bq=u((3 * c,), -0.1, 0.1), a=u((m, c)),
                 wp=u((c, c)) * c ** -0.5, bp=u((c,), -0.1, 0.1))
        p["sq"], p["skv"], p["sp"] = (tf32_weight(p["wq"]), tf32_weight(p["wq"][c:]),
                                      tf32_weight(p["wp"]))
        p["xb"], p["ab"] = p["x"].to(torch.bfloat16), p["a"].to(torch.bfloat16)
    return p


def _gcvit_calls(p: dict, c: int) -> dict:
    """name -> (kernel call, plain call) of the qkv and proj GEMMs in both f32
    modes, the outputs concatenated."""
    f32 = torch.float32
    calls = {}
    for mode, act in MM_MODES.items():
        x, a = (p["x"], p["a"]) if act == f32 else (p["xb"], p["ab"])
        for where, w, b, s in (("local", p["wq"], p["bq"], p["sq"]),
                               ("global", p["wq"][c:], p["bq"][c:], p["skv"])):
            calls[f"ln_qkv_{mode} {where}"] = (
                lambda x=x, w=w, b=b, s=s: G.ln_qkv(x, p["lg"], p["lb"], w, b, 1e-5,
                                                    mm_dtype=f32, w_split=s),
                lambda x=x, w=w, b=b: G.ln_qkv_plain(x, p["lg"], p["lb"], w, b, 1e-5,
                                                     mm_dtype=f32))
        calls[f"proj_scale_residual_{mode}"] = (
            lambda x=x, a=a: G.proj_scale_residual(a, p["wp"], p["bp"], p["gamma"], x,
                                                   mm_dtype=f32, w_split=p["sp"]),
            lambda x=x, a=a: G.proj_scale_residual_plain(a, p["wp"], p["bp"], p["gamma"], x,
                                                         f32))
    return calls


def _check(shape: str, b: int, p: dict, c: int, eps: float, gcvit: bool) -> dict:
    """Each kernel against its plain version."""
    hid = K.ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], eps, w_split=p["s1"])
    out = K.fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"], p["res"], w_split=p["s2"])
    torch.cuda.synchronize()
    ref_out = K.fc2_scale_residual_plain(hid, p["w2"], p["b2"], p["gamma"], p["res"])
    errs = {"ln_fc1_gelu_f32": _rel(hid, K.ln_fc1_gelu_plain(p["x"], p["lg"], p["lb"], p["w1"],
                                                             p["b1"], eps)),
            "fc2_scale_residual_f32": _rel(out, ref_out)}
    del out
    bounds = {n: F32_BOUND for n in errs}
    if gcvit:
        mm = K.fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"], p["res"],
                                  out_dtype=torch.bfloat16, w_split=p["s2"])
        errs["fc2_scale_residual_mmf32"] = _rel(mm, ref_out)
        bounds["fc2_scale_residual_mmf32"] = BF16_BOUND
        for name, (kern, plain) in _gcvit_calls(p, c).items():
            cat = lambda t: torch.cat(t, 1) if isinstance(t, tuple) else t  # noqa: E731
            got = cat(kern())
            torch.cuda.synchronize()
            errs[name], bounds[name] = _rel(got, cat(plain())), F32_BOUND
            del got
    print(f"[check] {shape} b{b}: " + ", ".join(
        f"{k} {v:.3e} (bound {bounds[k]:g})" for k, v in errs.items()), flush=True)
    bad = {k: v for k, v in errs.items() if not v <= bounds[k]}
    if bad:
        raise AssertionError(f"{shape} b{b}: beyond the bound against plain f32: {bad}")
    return errs


def _count(name: str, blocks: int) -> int:
    """Launches of ``name`` a forward at a level of ``blocks`` blocks: GCViT's
    even blocks take a local query, the odd ones the global one."""
    if name.endswith(" local"):
        return (blocks + 1) // 2
    if name.endswith(" global"):
        return blocks // 2
    return blocks


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
            p = _inputs(g, b * grid * grid, c, n, dev, gcvit)
            _check(shape, b, p, c, eps, gcvit)
            del p
            torch.cuda.empty_cache()
        m = batch * grid * grid
        p = _inputs(g, m, c, n, dev, gcvit)
        errs = _check(shape, batch, p, c, eps, gcvit)
        hid = K.ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], eps, w_split=p["s1"])
        calls = {
            "ln_fc1_gelu_f32": lambda: K.ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"], p["b1"],
                                                     eps, w_split=p["s1"]),
            "cublas fc1": lambda: F.linear(p["x"], p["w1"]),
            "fc2_scale_residual_f32": lambda: K.fc2_scale_residual(
                hid, p["w2"], p["b2"], p["gamma"], p["res"], w_split=p["s2"]),
            "cublas fc2": lambda: F.linear(hid, p["w2"]),
        }
        ops = {"fc1": 2 * m * c * n, "fc2": 2 * m * c * n}  # each GEMM's f32 products
        nbytes = {"fc1": 4 * (m * c + n * c + n + 2 * c + m * n),
                  "fc2": 4 * (m * n + c * n + 2 * c + 2 * m * c)}
        if gcvit:
            calls["fc2_scale_residual_mmf32"] = lambda: K.fc2_scale_residual(
                hid, p["w2"], p["b2"], p["gamma"], p["res"], out_dtype=torch.bfloat16,
                w_split=p["s2"])
            nbytes["fc2 mmf32"] = 4 * (m * n + c * n + 2 * c + m * c) + 2 * m * c
            ops["fc2 mmf32"] = ops["fc2"]
            calls.update({name: kern for name, (kern, _) in _gcvit_calls(p, c).items()})
            for mode, act in MM_MODES.items():
                e = 4 if act == torch.float32 else 2  # bytes of an activation element
                x, a = (p["x"], p["a"]) if e == 4 else (p["xb"], p["ab"])
                wide = (lambda t: t) if e == 4 else (lambda t: t.float())  # noqa: E731
                calls[f"cublas qkv {mode} local"] = lambda x=x, w=wide: F.linear(w(x), p["wq"])
                calls[f"cublas qkv {mode} global"] = lambda x=x, w=wide: F.linear(
                    w(x), p["wq"][c:])
                calls[f"cublas proj {mode}"] = lambda a=a, w=wide: F.linear(w(a), p["wp"])
                for s, where in ((3, "local"), (2, "global")):
                    key = f"ln_qkv_{mode} {where}"
                    nbytes[key] = e * m * c + 4 * (s * c * c + s * c + 2 * c + s * m * c)
                    ops[key] = 2 * m * c * s * c
                key = f"proj_scale_residual_{mode}"
                nbytes[key] = 2 * e * m * c + 4 * (c * c + 2 * c + m * c)
                ops[key] = 2 * m * c * c
        if cuts:
            for cut in K.TF32_CUTS:
                calls[f"gelu cut {cut}"] = lambda cut=cut: K.tf32_mlp_cut(
                    "gelu", cut, p["x"], p["s1"], p["b1"], ln_weight=p["lg"], ln_bias=p["lb"],
                    eps=eps)
                calls[f"res cut {cut}"] = lambda cut=cut: K.tf32_mlp_cut(
                    "res", cut, hid, p["s2"], p["b2"], gamma=p["gamma"], residual=p["res"])
                if gcvit:
                    calls[f"qkv cut {cut} local"] = lambda cut=cut: K.tf32_mlp_cut(
                        "qkv", cut, p["x"], p["sq"], p["bq"], ln_weight=p["lg"],
                        ln_bias=p["lb"], eps=eps)
                    calls[f"proj cut {cut}"] = lambda cut=cut: K.tf32_mlp_cut(
                        "proj", cut, p["a"], p["sp"], p["bp"], gamma=p["gamma"],
                        residual=p["x"])
        ms = {name: device_ms(fn, calls=5, replays=3) for name, fn in calls.items()}
        bound = {}
        for gemm, nb in nbytes.items():
            passes = PASSES.get(gemm, 3)
            t_bytes, t_ops = nb / HBM_BYTES_PER_S * 1e3, ops[gemm] * passes / PEAK_TF32 * 1e3
            bound[gemm] = {"bytes_ms": t_bytes, "ops_ms": t_ops,
                           "bound_ms": max(t_bytes, t_ops)}
        results["shapes"][shape] = {"M": m, "C": c, "N": n, "blocks": blocks, "ms": ms,
                                    "bound": bound, "max_rel_err": errs}
        plans = f"{K.tf32_gemm_plan('gelu', c, n)['bn']}/{K.tf32_gemm_plan('res', n, c)['bn']}"
        if gcvit:
            plans += (f", qkv/proj {K.tf32_gemm_plan('qkv', c, 3 * c)['bn']}/"
                      f"{K.tf32_gemm_plan('proj', c, c)['bn']}")
        print(f"[time] {shape} (M {m}, C {c}, N {n}; column tiles {plans}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + " device ms; bounds "
              + ", ".join(f"{k} {v['bound_ms']:.3f}" for k, v in bound.items())
              + f" ms [{card}]", flush=True)
        del p, hid, calls
        torch.cuda.empty_cache()
    per = results["per_forward"]
    for shape, r in results["shapes"].items():
        for name, t in r["ms"].items():
            per[name] = per.get(name, 0.0) + _count(name, r["blocks"]) * t
        for gemm, bd in r["bound"].items():
            for k, v in bd.items():
                key = f"bound {gemm} {k}"
                per[key] = per.get(key, 0.0) + _count(gemm, r["blocks"]) * v
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
