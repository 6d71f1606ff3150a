#!/usr/bin/env python3
"""ConvNeXt block variants at the stage shapes, on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_convnext_s12 [s1|s2|s3|s4|all]
        [--iters 20] [--batch 256] [--only V,V,...] [--skip-equiv]

Counterpart of ``tools/exp_convnext_s12.py``, with its shapes (s1 (B, 99,
99, 96) hidden 384, s2 (B, 49, 49, 192) hidden 768, s3 (B, 25, 25, 384)
hidden 1536, s4 (B, 13, 13, 768) hidden 3072; ``all`` runs s1 and s2) and
its seeded ``make_params``. Per shape, ms per block of each variant on one
bf16 input, by CUDA events over ``--iters`` launches after a warm-up:

  eager     cuDNN depthwise, F.layer_norm, F.linear, F.gelu, F.linear in
            bf16: the library counterpart of the JAX tool's ``xla`` block
  fused     the three-launch ConvNeXt block (``dwconv7x7_nhwc``,
            ``ln_fc1_gelu``, ``fc2_scale_residual``), the hidden through
            device memory
  dw_true   cuDNN depthwise alone
  lnmlp     ``fused_ln_mlp_residual`` alone (hidden kept on chip)
  hyb_nhwc  cuDNN depthwise, then ``fused_ln_mlp_residual``
  hyb_hwcn  cuDNN depthwise on the (H, W, C, B) view, then ``lnmlp_batchlane``
  hyb_chwn  cuDNN depthwise on the (C, H, W, B) view, then ``lnmlp_chanfirst``
  tposes    NHWC -> HWCN + 1 -> NHWC transposes alone

Before timing, each kernel variant (fused, lnmlp, hyb_*) is held to its
plain version in f32 on the first two images: max|d| / max|ref| <= 1e-2 or
the tool raises. Variants of the JAX tool that are not carried over:
``fused_sig`` (a sigmoid GELU priced the TPU's VPU), ``dw_bdiag`` and the
block-diagonal convs inside ``hyb_*`` (an MXU trick; a true depthwise conv
takes their place), ``hyb_chwn_l512`` and ``hyb_chwn_l2048`` (TPU lane
tiles of the same function). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels import convnext_block as K
from ..ops.kernels import ln_mlp as LM
from .bench_util import card_line, cuda_ms

EPS = 1e-6
SHAPES = {  # tag: (H, W, C, hidden)
    "s1": (99, 99, 96, 384),
    "s2": (49, 49, 192, 768),
    "s3": (25, 25, 384, 1536),
    "s4": (13, 13, 768, 3072),
}
VARIANTS = ("eager", "fused", "dw_true", "lnmlp", "hyb_nhwc", "hyb_hwcn", "hyb_chwn", "tposes")
KERNEL_VARIANTS = ("fused", "lnmlp", "hyb_nhwc", "hyb_hwcn", "hyb_chwn")
# the input layout of each variant, as a permutation of NHWC
LAYOUTS = {"hyb_hwcn": LM.LAYOUTS["lnmlp_batchlane"], "hyb_chwn": LM.LAYOUTS["lnmlp_chanfirst"]}
EQUIV_BOUND = 1e-2


def make_params(c: int, hidden: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """The JAX tool's seeded parameters, in its convention (w1 (C, hidden),
    w2 (hidden, C), taps (7, 7, C))."""
    r = lambda *s: rng.randn(*s).astype(np.float32) * 0.05  # noqa: E731
    return dict(
        wdw=r(7, 7, c), bdw=r(c), g=r(c) + 1.0, b=r(c),
        w1=r(c, hidden), b1=r(hidden), w2=r(hidden, c), b2=r(c),
        ls=r(c) * 0.1 + 1e-2,
    )


def torch_params(p: Dict[str, np.ndarray], dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The port's convention: w1 (hidden, C) and w2 (C, hidden) in ``dtype``,
    the other parameters in f32, and the cuDNN depthwise weight (C, 1, 7, 7)
    and bias in ``dtype``."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    c = p["wdw"].shape[-1]
    out = {k: t(p[k]) for k in ("wdw", "bdw", "g", "b", "b1", "b2", "ls")}
    out["w1"] = t(p["w1"].T).to(dtype)
    out["w2"] = t(p["w2"].T).to(dtype)
    out["wdw_c"] = t(p["wdw"]).permute(2, 0, 1).reshape(c, 1, 7, 7).to(dtype).contiguous()
    out["bdw_c"] = out["bdw"].to(dtype)
    return out


def _dw(x_nchw: torch.Tensor, P: dict) -> torch.Tensor:
    """cuDNN's depthwise 7 x 7 + bias on an NCHW view (any strides)."""
    return F.conv2d(x_nchw, P["wdw_c"], P["bdw_c"], padding=3, groups=x_nchw.shape[1])


def build_variants(P: dict, plain: bool = False) -> dict:
    """name -> fn of the variant's input layout. ``plain`` runs the plain
    versions of the port's kernels in their place (the reference)."""
    lnmlp = LM.fused_ln_mlp_residual_plain if plain else LM.fused_ln_mlp_residual
    batchlane = LM.lnmlp_batchlane_plain if plain else LM.lnmlp_batchlane
    chanfirst = LM.lnmlp_chanfirst_plain if plain else LM.lnmlp_chanfirst
    mlp = (P["g"], P["b"], P["w1"], P["b1"], P["w2"], P["b2"], P["ls"])

    def dw_nhwc(x):
        return _dw(x.permute(0, 3, 1, 2), P).permute(0, 2, 3, 1).contiguous()

    def eager(x):
        c, dt = x.shape[-1], x.dtype
        y = F.layer_norm(dw_nhwc(x), (c,), P["g"].to(dt), P["b"].to(dt), EPS)
        h = F.gelu(F.linear(y, P["w1"], P["b1"].to(dt)))
        return x + F.linear(h, P["w2"], P["b2"].to(dt)) * P["ls"].to(dt)

    def fused(x):
        if not plain:
            return K.convnext_block(x, P["wdw"], P["bdw"], *mlp, eps=EPS)
        b, h, w, c = x.shape
        d = K.dwconv7x7_nhwc_plain(x, P["wdw"], P["bdw"]).view(-1, c)
        hid = K.ln_fc1_gelu_plain(d, P["g"], P["b"], P["w1"], P["b1"], EPS)
        return K.fc2_scale_residual_plain(hid, P["w2"], P["b2"], P["ls"],
                                          x.reshape(-1, c)).view(b, h, w, c)

    return {
        "eager": eager,
        "fused": fused,
        "dw_true": dw_nhwc,
        "lnmlp": lambda x: lnmlp(x, x, *mlp, eps=EPS),
        "hyb_nhwc": lambda x: lnmlp(dw_nhwc(x), x, *mlp, eps=EPS),
        # (H, W, C, B) -> NCHW view (B, C, H, W), conv, back to (H, W, C, B)
        "hyb_hwcn": lambda xt: batchlane(
            _dw(xt.permute(3, 2, 0, 1), P).permute(2, 3, 1, 0).contiguous(), xt, *mlp, eps=EPS),
        # (C, H, W, B) -> NCHW view (B, C, H, W), conv, back to (C, H, W, B)
        "hyb_chwn": lambda xc: chanfirst(
            _dw(xc.permute(3, 0, 1, 2), P).permute(1, 2, 3, 0).contiguous(), xc, *mlp, eps=EPS),
        "tposes": lambda x: (x.permute(1, 2, 3, 0).contiguous() + 1).permute(3, 0, 1, 2)
        .contiguous(),
    }


def to_layout(x: torch.Tensor, name: str) -> torch.Tensor:
    perm = LAYOUTS.get(name)
    return x if perm is None else x.permute(*perm).contiguous()


def from_layout(y: torch.Tensor, name: str) -> torch.Tensor:
    perm = LAYOUTS.get(name)
    return y if perm is None else y.permute(*np.argsort(perm).tolist())


def check_equiv(P: dict, P32: dict, x: torch.Tensor, which) -> Dict[str, float]:
    """Each kernel variant against its plain version in f32 on the first two
    images; raises past ``EQUIV_BOUND`` of max|ref|."""
    xs = x[:2].contiguous()
    kern, ref = build_variants(P), build_variants(P32, plain=True)
    errs = {}
    for name in KERNEL_VARIANTS:
        if which and name not in which:
            continue
        got = from_layout(kern[name](to_layout(xs, name)), name).float()
        want = from_layout(ref[name](to_layout(xs.float(), name)), name)
        errs[name] = ((got - want).abs().max() / want.abs().max()).item()
        print(f"  equiv {name}: max|d|/max|ref| = {errs[name]:.3e}", flush=True)
        if not errs[name] <= EQUIV_BOUND:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{errs[name]:.3e} > {EQUIV_BOUND:g}")
    return errs


def run_shape(tag: str, batch: int, iters: int, which=None, skip_equiv: bool = False) -> dict:
    h, w, c, hidden = SHAPES[tag]
    print(f"== {tag}: ({batch},{h},{w},{c}) hidden={hidden} bf16 ==", flush=True)
    p = make_params(c, hidden, np.random.RandomState(0))
    P, P32 = torch_params(p, torch.bfloat16, "cuda"), torch_params(p, torch.float32, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((batch, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    errs = {} if skip_equiv else check_equiv(P, P32, x, which)
    variants = build_variants(P)
    ms = {}
    with torch.inference_mode():
        for name in VARIANTS:
            if which and name not in which:
                continue
            xin = to_layout(x, name)
            ms[name] = cuda_ms(lambda: variants[name](xin), iters)
            print(f"  {name:10s} {ms[name]:8.3f} ms/block", flush=True)
            del xin
            torch.cuda.empty_cache()
    return dict(tag=tag, shape=(batch, h, w, c), hidden=hidden, ms=ms, equiv=errs)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shape", nargs="?", default="all", choices=["s1", "s2", "s3", "s4", "all"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--skip-equiv", action="store_true")
    args = ap.parse_args(argv)
    which = set(args.only.split(",")) if args.only else None
    if which and which - set(VARIANTS):
        ap.error(f"unknown variants {sorted(which - set(VARIANTS))}; known: {VARIANTS}")
    if not torch.cuda.is_available():
        sys.exit("exp_convnext_s12: no CUDA device is available; the kernels have no CPU timing")
    print(f"device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    tags = ("s1", "s2") if args.shape == "all" else (args.shape,)
    return [run_shape(t, args.batch, args.iters, which, args.skip_equiv) for t in tags]


if __name__ == "__main__":
    main()
