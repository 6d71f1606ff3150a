#!/usr/bin/env python3
"""Phase cuts of the kernels on the wgmma + TMA engine at the main path's shapes, on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_mlp_gemm [--iters 10] [--batch 256]
        [--shapes s1 s2 ... L4] [--kernels bf16 mixed]
    python3 vip_cup_2022_tpu_torch/tools/exp_mlp_gemm.py --root DIR --kernels mixed

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
cuts is what a phase adds where it is not hidden behind the others.

``--kernels mixed`` (at L1-L4; in the default run after the bf16 kernels):
the three GEMMs of ``VIPTPU_GCVIT_MM=bf16`` on f32 activations with f32
outputs, ``ln_qkv_mmbf16`` (f32 x, S = 3 in the local blocks and S = 2,
``kv``, in the global-query ones), ``fc2_scale_residual_mmbf16`` (bf16
hidden, K = 3C) and ``proj_scale_residual_mmbf16`` (f32 attention output,
K = C), by device time (``bench_util.device_ms``): whole and their cuts
(loads, ln for ``ln_qkv_mmbf16``, products, no_stores) where the checkout
has them, beside cuBLAS's bf16 product with the f32 activations cast to
bf16 inside the timed call (fc2's hidden is bf16 already; for
``ln_qkv_mmbf16`` x stands in for its LN output) and the bound, then per
GCViTTiny forward (each level's launches times its blocks: local and
global-query blocks apart for ``ln_qkv_mmbf16``). ``--root DIR`` imports the package from DIR, a
checkout of another commit (run this file by its path, so that nothing is
imported before the root is chosen): two builds are timed by the same code,
one process each, in one chip call. No counterpart in the JAX package.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
K = G = None  # the kernel modules of the checkout timed (:func:`_load`)
cuda_ms = device_ms = card_line = None


def _load(root: str) -> None:
    """Import the kernel modules and the timers from checkout ``root``."""
    global K, G, cuda_ms, device_ms, card_line
    if root not in sys.path[:1]:
        sys.path.insert(0, root)
    from vip_cup_2022_tpu_torch.ops.kernels import convnext_block, gcvit_block
    from vip_cup_2022_tpu_torch.tools import bench_util

    K, G = convnext_block, gcvit_block
    cuda_ms, device_ms, card_line = bench_util.cuda_ms, bench_util.device_ms, bench_util.card_line


# name: grid, C, N / C, residual dtype, blocks per forward
SHAPES = {"s1": (99, 96, 4, torch.bfloat16, 3), "s2": (49, 192, 4, torch.bfloat16, 3),
          "s3": (24, 384, 4, torch.bfloat16, 9), "s4": (12, 768, 4, torch.bfloat16, 3),
          "L1": (56, 64, 3, torch.float32, 3), "L2": (28, 128, 3, torch.float32, 4),
          "L3": (14, 256, 3, torch.float32, 19), "L4": (7, 512, 3, torch.float32, 5)}
LN_CUTS = {"loads": 0, "ln": 1, "products": 2, "whole": 3, "raw_stores": 4, "no_stores": 5}
FC2_CUTS = {"loads": 0, "products": 2, "whole": 3, "raw_stores": 4, "no_stores": 5}
QKV_CUTS = {"loads": 0, "ln": 1, "products": 2, "whole": 3, "no_stores": 5}
PROJ_CUTS = {"loads": 0, "products": 2, "whole": 3, "no_stores": 5}
MIXED_CUTS = {"loads": 0, "products": 2, "no_stores": 5, "whole": 3}
MIXED_QKV_CUTS = {"loads": 0, "ln": 1, "products": 2, "no_stores": 5, "whole": 3}
GLOBAL_BLOCKS = {"L1": 1, "L2": 2, "L3": 9, "L4": 2}  # GCViTTiny's global-query blocks a level
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


def mixed_bounds_ms(m: int, c: int) -> tuple:
    """(fc2_scale_residual_mmbf16, proj_scale_residual_mmbf16) bounds in ms:
    the bf16 hidden (K = 3C) or the f32 attention output (K = C), the bf16
    weight, bias and gamma read once, the f32 residual read and the f32
    output written once; or the products at the bf16 peak."""
    io = m * c * 8 + 2 * c * 4
    fc2 = max((m * 3 * c * 2 + 3 * c * c * 2 + io) / HBM_BYTES_PER_S,
              2 * m * 3 * c * c / BF16_OPS_PER_S)
    proj = max((m * c * 4 + c * c * 2 + io) / HBM_BYTES_PER_S, 2 * m * c * c / BF16_OPS_PER_S)
    return fc2 * 1e3, proj * 1e3


def mixed_qkv_bound_ms(m: int, c: int, s: int = 3) -> float:
    """``ln_qkv_mmbf16``'s bound in ms: f32 x, the bf16 W_qkv, the LN
    parameters and the bias read once, S f32 (M, C) outputs written once;
    or the products at the bf16 peak."""
    nbytes = (s + 1) * m * c * 4 + s * c * c * 2 + (2 + s) * c * 4
    return max(nbytes / HBM_BYTES_PER_S, 2 * m * c * s * c / BF16_OPS_PER_S) * 1e3


def _timed(fns: dict, iters: int, timer=None) -> dict:
    timer = timer or (lambda fn: cuda_ms(fn, iters))
    readings = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        readings[name].append(timer(fns[name]))
    return {name: sum(r) / len(r) for name, r in readings.items()}


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def run_mixed(batch: int = 256, iters: int = 10,
              levels: Sequence[str] = ("L1", "L2", "L3", "L4")) -> dict:
    """The mixed-mode GEMMs with f32 outputs at GCViTTiny's levels by device
    time (ms per launch), each whole kernel first checked against its plain
    version (max|d| / max|ref| on 4096 rows); their cuts where the checkout
    has them; then per GCViTTiny forward: a reading's total over ``levels``
    where it was timed at each of them, else marked partial with the levels
    it covers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32

    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    timer = lambda fn: device_ms(fn, calls=iters)  # noqa: E731
    per_level, forward = {}, {}
    rows = slice(0, 4096)
    cat = lambda t: torch.cat(t, 1) if isinstance(t, tuple) else t  # noqa: E731
    for name in levels:
        grid, c, ratio, _, blocks = SHAPES[name]
        m = batch * grid * grid
        hid = u((m, ratio * c)).to(bf16)
        w2 = (u((c, ratio * c)) * (ratio * c) ** -0.5).to(bf16)
        attn, x, r1 = u((m, c)), u((m, c)) * 2, u((m, c)) * 2
        wp = (u((c, c)) * c ** -0.5).to(bf16)
        bias, gamma = u((c,), -0.1, 0.1), u((c,), 0.5, 1.5)
        lg, lb = u((c,), 0.5, 1.5), u((c,), -0.1, 0.1)
        wq, bq = (u((3 * c, c)) * c ** -0.5).to(bf16), u((3 * c,), -0.1, 0.1)
        qkv_cut = getattr(G, "ln_qkv_mmbf16_cut", None)
        # name: (whole, plain, cut, the cut's arguments, its cuts, cuBLAS, bound, blocks)
        kernels = {}
        for label, s_, count in (("ln_qkv_mmbf16", 3, blocks - GLOBAL_BLOCKS[name]),
                                 ("ln_qkv_mmbf16 kv", 2, GLOBAL_BLOCKS[name])):
            w_, b_ = wq[(3 - s_) * c:], bq[(3 - s_) * c:]
            kernels[label] = (
                lambda w_=w_, b_=b_: G.ln_qkv(x, lg, lb, w_, b_, 1e-5, mm_dtype=bf16),
                lambda w_=w_, b_=b_: G.ln_qkv_plain(x[rows], lg, lb, w_, b_, 1e-5, bf16),
                qkv_cut, (x, lg, lb, w_, b_, 1e-5), MIXED_QKV_CUTS,
                lambda w_=w_: F.linear(x.to(bf16), w_), mixed_qkv_bound_ms(m, c, s_), count)
        bound_fc2, bound_proj = mixed_bounds_ms(m, c)
        kernels["fc2_scale_residual_mmbf16"] = (
            lambda: K.fc2_scale_residual(hid, w2, bias, gamma, r1, out_dtype=f32),
            lambda: K.fc2_scale_residual_plain(hid[rows], w2, bias, gamma, r1[rows], f32),
            getattr(K, "fc2_scale_residual_mmbf16_cut", None),
            (hid, w2, bias, gamma, r1), MIXED_CUTS, lambda: F.linear(hid, w2), bound_fc2, blocks)
        kernels["proj_scale_residual_mmbf16"] = (
            lambda: G.proj_scale_residual(attn, wp, bias, gamma, x, mm_dtype=bf16),
            lambda: G.proj_scale_residual_plain(attn[rows], wp, bias, gamma, x[rows], bf16),
            getattr(G, "proj_scale_residual_mmbf16_cut", None),
            (attn, wp, bias, gamma, x), MIXED_CUTS, lambda: F.linear(attn.to(bf16), wp),
            bound_proj, blocks)
        level = per_level[name] = {}
        for kernel, (whole, plain, cut, args, cuts, cublas, bound, count) in kernels.items():
            err = _rel(cat(whole())[rows], cat(plain()))
            fns = {"whole": whole, "cublas": cublas}
            if cut is not None:
                fns.update({cn: functools.partial(cut, *args, v) for cn, v in cuts.items()
                            if cn != "whole"})
            ms = _timed(fns, iters, timer)
            level[kernel] = dict(ms=ms, bound=bound, rel_err=err, blocks=count)
            acc = forward.setdefault(kernel.split(" ")[0], {})
            for cn, t in list(ms.items()) + [("bound", bound)]:
                total, covered = acc.get(cn, (0.0, []))
                acc[cn] = (total + t * count, covered + ([name] if name not in covered else []))
            print(f"[mixed {name} ({m},{c})] {kernel}: whole vs plain max|d|/max|ref| {err:.2e}; "
                  "device " + ", ".join(f"{cn} {t:.4f}" for cn, t in ms.items())
                  + f" ms; bound {bound:.4f} ms; whole/bound "
                  f"{ms['whole'] / bound:.2f}, whole/cuBLAS with the cast "
                  f"{ms['whole'] / ms['cublas']:.2f}; {count} blocks [{card_line()}]", flush=True)
        del hid, w2, attn, x, r1, wp, wq, kernels
        torch.cuda.empty_cache()
    for kernel, acc in forward.items():
        whole = {cn: t for cn, (t, covered) in acc.items() if covered == list(levels)}
        partial = {cn: (t, covered) for cn, (t, covered) in acc.items() if cn not in whole}
        forward[kernel] = whole
        print(f"[mixed] {kernel} per GCViTTiny batch-{batch} forward ({', '.join(levels)}), "
              "device ms: " + ", ".join(f"{cn} {t:.4f}" for cn, t in whole.items())
              + "".join(f"; {cn} {t:.4f} partial: {', '.join(covered)} only"
                        for cn, (t, covered) in partial.items())
              + f" [{card_line()}]", flush=True)
    return dict(levels=per_level, forward=forward)


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
    ap.add_argument("--kernels", nargs="+", choices=["bf16", "mixed"], default=["bf16", "mixed"])
    ap.add_argument("--root", default=CHECKOUT, help="checkout whose package is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("exp_mlp_gemm: no CUDA device is available; the cuts are CUDA kernels")
    root = os.path.abspath(args.root)
    _load(root)
    print(f"root={root} device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    results = run(args.batch, args.iters, args.shapes) if "bf16" in args.kernels else []
    levels = [s for s in args.shapes if s.startswith("L")]
    if "mixed" in args.kernels and levels:  # each level's dict gains "mixed"
        mixed = run_mixed(args.batch, args.iters, levels)["levels"]
        by_name = {r["name"]: r for r in results}
        for name in levels:
            if name not in by_name:
                by_name[name] = dict(name=name)
                results.append(by_name[name])
            by_name[name]["mixed"] = mixed[name]
    return results


if __name__ == "__main__":
    main()
