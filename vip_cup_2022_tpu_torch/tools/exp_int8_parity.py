#!/usr/bin/env python3
"""The int8 block kernels of this checkout against another checkout's, on
one CUDA card: are their outputs the same bits, and what do they cost.

    python3 vip_cup_2022_tpu_torch/tools/exp_int8_parity.py [--root DIR]
        [--batch 256] [--out FILE] [--against FILE]

At ConvNeXt's stages s1-s4 (N = 4C) and GCViTTiny's levels L1-L4 (N = 3C),
batch ``--batch``, on inputs and int8 weights drawn on the card from one
seed (the same in every process on the same card and torch):

- the MLP chain ``ln_fc1_gelu_int8`` -> ``quantize_rows`` ->
  ``fc2_scale_residual_int8`` (its f32 hidden, the hidden's codes and row
  scales, the output), and where the root's package has it the MLP pair
  ``ln_fc1_rowmax_int8`` -> ``mlp_int8_scale_residual`` (its output, and
  whether it equals the chain's);
- at GCViT's levels ``ln_qkv_int8`` (q, k, v), ``quantize_rows`` of a bf16
  (M, C) activation and ``proj_scale_residual_int8`` on its codes;
- the bf16 kernels built on the same GEMM engine (``ln_fc1_gelu``,
  ``fc2_scale_residual``; at GCViT's levels ``ln_qkv``,
  ``proj_scale_residual``), timed only.

Each output's SHA-256 and each kernel's device time a launch
(``bench_util.device_ms``, two readings in turns). ``--root DIR`` imports the
package from DIR, a checkout of another commit (run this file by its path,
so that nothing is imported before the root is chosen): two builds are
compared by the same code, one process each, in one chip call. ``--out``
writes the results as JSON; ``--against FILE`` compares each digest with
FILE's, another root's results, and prints which outputs are equal and
each kernel's time beside FILE's. The last line is the results as one JSON
object. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
# name: grid, C, N / C, int8 blocks a forward (ConvNeXt's stages as chip_smoke.STAGES,
# GCViTTiny's levels as exp_window_attention.LEVELS)
SHAPES = {"s1": (99, 96, 4, 3), "s2": (49, 192, 4, 3), "s3": (24, 384, 4, 9),
          "s4": (12, 768, 4, 3), "L1": (56, 64, 3, 3), "L2": (28, 128, 3, 4),
          "L3": (14, 256, 3, 19), "L4": (7, 512, 3, 5)}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=CHECKOUT, help="checkout whose package is run")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", default=None, help="write the results here as JSON")
    ap.add_argument("--against", default=None, help="another root's --out to compare with")
    return ap.parse_args(argv)


def digest(*tensors: torch.Tensor) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().data)
    return h.hexdigest()


def main(argv=None) -> dict:
    args = parse(sys.argv[1:] if argv is None else argv)
    root = os.path.abspath(args.root)
    if root not in sys.path[:1]:
        sys.path.insert(0, root)
    if not torch.cuda.is_available():
        sys.exit("exp_int8_parity: no CUDA device is available; the kernels have no CPU run")
    from vip_cup_2022_tpu_torch.ops.kernels import block_int8 as B8
    from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
    from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G
    from vip_cup_2022_tpu_torch.tools.bench_util import card_line, device_ms

    has_pair = hasattr(B8, "mlp_int8_scale_residual")
    print(f"root={root} device={torch.cuda.get_device_name(0)} pair={has_pair} [{card_line()}]",
          flush=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    results = {"root": root, "card": card_line(), "batch": args.batch, "shapes": {}}
    for tag, (grid, c, ratio, blocks) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(1000 + c)

        def u(shape, lo=-1.0, hi=1.0):
            return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

        def w8(rows, cols):
            return (torch.randint(-127, 128, (rows, cols), generator=g, device=dev)
                    .to(torch.int8), u((rows,), 0.5, 1.5) * (cols ** -0.5 / 127))

        m, n, eps = args.batch * grid * grid, ratio * c, 1e-6 if ratio == 4 else 1e-5
        x, lg, lb = u((m, c)), u((c,), 0.5, 1.5), u((c,), -0.1, 0.1)
        (w1, s1), b1 = w8(n, c), u((n,), -0.1, 0.1)
        (w2, s2), b2, gamma = w8(c, n), u((c,), -0.1, 0.1), u((c,), 0.5, 1.5)
        res = u((m, c)).to(bf16) if ratio == 4 else u((m, c))
        w1b, w2b = u((n, c), -0.1, 0.1).to(bf16), u((c, n), -0.1, 0.1).to(bf16)
        calls = {  # name: one launch
            "ln_fc1_gelu_int8": lambda: B8.ln_fc1_gelu_int8(x, lg, lb, w1, s1, b1, eps)}
        hid = calls["ln_fc1_gelu_int8"]()
        h_q, h_s = B8.quantize_rows(hid)
        calls["quantize_rows hidden"] = lambda: B8.quantize_rows(hid)
        calls["fc2_scale_residual_int8"] = lambda: B8.fc2_scale_residual_int8(
            h_q, h_s, w2, s2, b2, gamma, res, bf16)
        out = calls["fc2_scale_residual_int8"]()
        row = {"digest": {"ln_fc1_gelu_int8": digest(hid),
                          "quantize_rows hidden": digest(h_q, h_s),
                          "fc2_scale_residual_int8": digest(out)}}
        if has_pair:
            x_q, x_s, p_s = B8.ln_fc1_rowmax_int8(x, lg, lb, w1, s1, b1, eps)
            calls["ln_fc1_rowmax_int8"] = lambda: B8.ln_fc1_rowmax_int8(x, lg, lb, w1, s1, b1, eps)
            calls["mlp_int8_scale_residual"] = lambda: B8.mlp_int8_scale_residual(
                x_q, x_s, p_s, w1, s1, b1, w2, s2, b2, gamma, res, bf16)
            pair = calls["mlp_int8_scale_residual"]()
            row["digest"]["mlp_int8_scale_residual"] = digest(pair)
            row["pair_equals_chain"] = bool(torch.equal(pair, out) and torch.equal(p_s, h_s))
            del pair
        hid16 = hid.to(bf16)
        calls["ln_fc1_gelu"] = lambda: K.ln_fc1_gelu(x, lg, lb, w1b, b1, eps)
        calls["fc2_scale_residual"] = lambda: K.fc2_scale_residual(hid16, w2b, b2, gamma, res)
        if ratio == 3:  # GCViT's attention-side kernels at this level
            xb, (wq, sq), bq = x.to(bf16), w8(3 * c, c), u((3 * c,), -0.1, 0.1)
            (wp, sp), bp, g1 = w8(c, c), u((c,), -0.1, 0.1), u((c,), 0.5, 1.5)
            attn, wqb, wpb = u((m, c)).to(bf16), u((3 * c, c), -0.1, 0.1).to(bf16), \
                u((c, c), -0.1, 0.1).to(bf16)
            calls["ln_qkv_int8"] = lambda: B8.ln_qkv_int8(xb, lg, lb, wq, sq, bq, eps)
            calls["quantize_rows attention"] = lambda: B8.quantize_rows(attn)
            a_q, a_s = B8.quantize_rows(attn)
            calls["proj_scale_residual_int8"] = lambda: B8.proj_scale_residual_int8(
                a_q, a_s, wp, sp, bp, g1, xb)
            calls["ln_qkv"] = lambda: G.ln_qkv(xb, lg, lb, wqb, bq, eps)
            calls["proj_scale_residual"] = lambda: G.proj_scale_residual(attn, wpb, bp, g1, xb)
            row["digest"]["ln_qkv_int8"] = digest(*calls["ln_qkv_int8"]())
            row["digest"]["quantize_rows attention"] = digest(a_q, a_s)
            row["digest"]["proj_scale_residual_int8"] = digest(
                calls["proj_scale_residual_int8"]())
        torch.cuda.synchronize()
        first = {k: device_ms(f, calls=5, replays=4) for k, f in calls.items()}
        second = {k: device_ms(f, calls=5, replays=4) for k, f in reversed(list(calls.items()))}
        row["ms"] = {k: (first[k] + second[k]) / 2 for k in calls}
        row["blocks"] = blocks
        results["shapes"][tag] = row
        print(f"[parity {tag}] M {m} C {c} N {n}: " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in row["ms"].items())
            + (f"; pair equals chain: {row['pair_equals_chain']}" if has_pair else ""), flush=True)
        del x, hid, hid16, h_q, h_s, out, res, calls
        torch.cuda.empty_cache()
    if args.against:
        with open(args.against) as f:
            other = json.load(f)
        compare = {}
        for tag, row in results["shapes"].items():
            theirs = other["shapes"].get(tag, {"digest": {}, "ms": {}})
            for k, d in row["digest"].items():
                if k in theirs["digest"]:
                    compare[f"{tag} {k}"] = d == theirs["digest"][k]
            print(f"[against {tag}] equal to {other['root']}: "
                  + ", ".join(f"{k} {row['digest'][k] == theirs['digest'][k]}"
                              for k in row["digest"] if k in theirs["digest"])
                  + "; ms here / there: " + ", ".join(
                      f"{k} {t:.4f} / {theirs['ms'][k]:.4f}" for k, t in row["ms"].items()
                      if k in theirs["ms"]), flush=True)
        results["equal_to_against"] = compare
        print(f"[against] {sum(compare.values())} of {len(compare)} outputs equal bit for bit to "
              f"{other['root']}'s", flush=True)
    for label, keep in (("ConvNeXt", lambda t: t[0] == "s"),
                        ("GCViTTiny L2-L4", lambda t: t in ("L2", "L3", "L4"))):
        sums = {}
        for tag, row in results["shapes"].items():
            if keep(tag):
                for k, t in row["ms"].items():
                    sums[k] = sums.get(k, 0.0) + row["blocks"] * t
        results[f"per_forward {label}"] = sums
        print(f"[per forward {label}, each kernel once a block] " + ", ".join(
            f"{k} {t:.3f} ms" for k, t in sums.items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
