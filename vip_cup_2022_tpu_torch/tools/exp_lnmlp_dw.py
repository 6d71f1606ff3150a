#!/usr/bin/env python3
"""Device time of the depthwise (K9) and LN-MLP (K3 / K12) kernels at their
tools' shapes, on one CUDA card, of this checkout or of another.

    python3 vip_cup_2022_tpu_torch/tools/exp_lnmlp_dw.py [--root DIR]
        [--only dw|lnmlp] [--batch 256] [--iters 10] [--yardsticks]
        [--cuts]

- ``depthwise_conv_nhwc`` at the ``exp_dw`` shapes (beside cuDNN's depthwise
  conv, ``F.conv2d(groups=C)`` on channels-last bf16, with ``--yardsticks``);
- the LN-MLP kernel in its three layouts (``fused_ln_mlp_residual``,
  ``lnmlp_batchlane``, ``lnmlp_chanfirst``) at the ``exp_convnext_s12``
  shapes s1-s4, hidden 4C (with ``--yardsticks`` beside the engine's
  two-launch pair ``ln_fc1_gelu`` + ``fc2_scale_residual`` on the same
  inputs, the hidden through device memory and x as the f32 rows
  ``ln_fc1_gelu`` takes, and beside cuBLAS's two products alone, ``F.linear``
  of the bf16 operands, TF32 off).

Each by device time (``bench_util.device_ms``: ``--iters`` calls captured in
a CUDA graph and replayed) and by CUDA events around ``--iters`` calls,
in turns. ``--root DIR`` imports the package from DIR, a checkout of another
commit (run this file by its path, so that nothing is imported before the
root is chosen): two builds are timed by the same code, one process each,
in one chip call. ``--cuts`` adds the LN-MLP kernel's phase cuts in the
rows layout (``ln_mlp.ln_mlp_rows_cut``: the weights' stream and the x copy
/ + LN / + products / + GELU, then the kernel). Prints a line per kernel and
shape, then one JSON line of the results. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=CHECKOUT, help="checkout whose package is timed")
    ap.add_argument("--only", choices=["dw", "lnmlp"], default=None)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--yardsticks", action="store_true")
    ap.add_argument("--cuts", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(sys.argv[1:] if argv is None else argv)
    root = os.path.abspath(args.root)
    if root not in sys.path[:1]:
        sys.path.insert(0, root)
    if not torch.cuda.is_available():
        sys.exit("exp_lnmlp_dw: no CUDA device is available; the kernels have no CPU timing")
    from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
    from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D
    from vip_cup_2022_tpu_torch.ops.kernels import ln_mlp as LM
    from vip_cup_2022_tpu_torch.tools import exp_convnext_s12, exp_dw
    from vip_cup_2022_tpu_torch.tools.bench_util import card_line, cuda_ms, device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"root={root} device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)

    def timed(fn) -> dict:
        """device ms and event ms of one call, in turns: device, events, events, device."""
        d1, e1 = device_ms(fn, calls=args.iters), cuda_ms(fn, args.iters)
        e2, d2 = cuda_ms(fn, args.iters), device_ms(fn, calls=args.iters)
        return {"device": (d1 + d2) / 2, "events": (e1 + e2) / 2}

    results = {"root": root, "card": card_line(), "dw": {}, "lnmlp": {}}
    if args.only in (None, "dw"):
        for tag, _, h, w, c, k in exp_dw.SHAPES:
            x, kern = exp_dw.inputs(args.batch, h, w, c, k)
            pad = ((k // 2, k // 2), (k // 2, k // 2))
            row = {"kernel": timed(lambda: D.depthwise_conv_nhwc(x, kern, padding=pad))}
            if args.yardsticks:
                w_cudnn = kern.reshape(k, k, c).permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16)
                x_nchw = x.permute(0, 3, 1, 2)
                row["cudnn"] = timed(lambda: F.conv2d(x_nchw, w_cudnn, padding=k // 2, groups=c))
            results["dw"][tag] = row
            print(f"[dw {tag}] " + ", ".join(f"{n} {t['device']:.4f} ms device ({t['events']:.4f} "
                                             f"events)" for n, t in row.items()), flush=True)
            del x, kern
            torch.cuda.empty_cache()
    if args.only in (None, "lnmlp"):
        gen = torch.Generator(device="cuda").manual_seed(6)
        for tag, (h, w, c, n) in exp_convnext_s12.SHAPES.items():
            x, r, prm = lnmlp_inputs(args.batch, h, w, c, gen)
            row = {}
            for name, perm in LM.LAYOUTS.items():
                xl, rl = x.permute(*perm).contiguous(), r.permute(*perm).contiguous()
                fn = getattr(LM, name)
                row[name] = timed(lambda: fn(xl, rl, *prm))
                del xl, rl
            if args.cuts:
                x2, r2 = x.view(-1, c), r.view(-1, c)
                for cut in LM.CUTS:
                    row[f"cut_{cut}"] = timed(lambda: LM.ln_mlp_rows_cut(x2, r2, *prm, cut))
            if args.yardsticks:
                m = args.batch * h * w
                xf, r2 = x.view(m, c).float(), r.view(m, c)
                g, b, w1, b1, w2, b2, ls = prm
                row["pair"] = timed(lambda: K.fc2_scale_residual(
                    K.ln_fc1_gelu(xf, g, b, w1, b1, 1e-6), w2, b2, ls, r2))
                y = x.view(m, c)
                hid = F.linear(y, w1)
                row["cublas"] = timed(lambda: (F.linear(y, w1), F.linear(hid, w2)))
                del xf, hid
            results["lnmlp"][tag] = row
            print(f"[lnmlp {tag}] " + ", ".join(
                f"{n} {t['device']:.4f} ms device ({t['events']:.4f} events)"
                for n, t in row.items()), flush=True)
            del x, r, prm
            torch.cuda.empty_cache()
    for part in ("dw", "lnmlp"):
        rows = results[part]
        if rows:
            names = next(iter(rows.values())).keys()
            sums = {n: {u: sum(rw[n][u] for rw in rows.values()) for u in ("device", "events")}
                    for n in names}
            print(f"[{part} sum] " + ", ".join(f"{n} {t['device']:.4f} ms device ({t['events']:.4f}"
                                               f" events)" for n, t in sums.items()), flush=True)
    print(json.dumps(results), flush=True)
    return results


def lnmlp_inputs(b, h, w, c, gen):
    """bf16 x and residual (b, h, w, c) ~ U(-1, 1) and the LN-MLP parameters
    (hidden 4C; LN and layer scales ~ U(0.5, 1.5), biases ~ U(-0.1, 0.1),
    weights ~ U(-1, 1) / sqrt(fan-in) in bf16), drawn on the card."""
    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    n = 4 * c
    x, r = u((b, h, w, c)).to(torch.bfloat16), u((b, h, w, c)).to(torch.bfloat16)
    prm = (u((c,), 0.5, 1.5), u((c,), -0.1, 0.1), (u((n, c)) * c ** -0.5).to(torch.bfloat16),
           u((n,), -0.1, 0.1), (u((c, n)) * n ** -0.5).to(torch.bfloat16), u((c,), -0.1, 0.1),
           u((c,), 0.5, 1.5))
    return x, r, prm


if __name__ == "__main__":
    main()
