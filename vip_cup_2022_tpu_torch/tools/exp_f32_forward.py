#!/usr/bin/env python3
"""Each member's batch-256 f32 forward on one CUDA card, of this checkout or
of another.

    python3 vip_cup_2022_tpu_torch/tools/exp_f32_forward.py [--root DIR]
        [--members NAME ...] [--batch 256] [--iters 5] [--rounds 2]

Builds each member at full width in f32 as ``chip_smoke.py``'s f32 phase
does (seeded weights, one output, logits; GCViT and ConvNeXt on their fused
blocks), in the smoke's order, TF32 off, and times its forward on a seeded
batch after one warm-up: ``--rounds`` runs of ``--iters`` forwards each,
between two CUDA events (ms a forward), and the host's time to issue the
same forwards (ms a forward; as long as the events' time when the host
sets the pace). ``--root DIR`` imports the package from DIR, a checkout of
another commit (run this file by its path, so that nothing is imported
before the root is chosen): two builds are timed by the same code, one
process each, in one chip call. Prints a line per member, then one JSON
line of the results. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
# the seven members and their input sizes, in the order of chip_smoke.py's MANIFEST
MEMBERS = {"convnext_tiny_in22k": (200, 200), "ResNest50": (200, 200), "GCViTTiny": (224, 224),
           "EfficientNetV2T": (200, 200), "EfficientNetV1B4": (224, 224),
           "ECA_NFNetL0": (200, 200), "ResNetRS50": (200, 200)}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=CHECKOUT, help="checkout whose package is timed")
    ap.add_argument("--members", nargs="+", choices=list(MEMBERS), default=list(MEMBERS))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    return ap.parse_args(argv)


def timed(model, x, iters: int) -> tuple:
    """(event ms, host issue ms) a forward over ``iters`` forwards."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        model(x)
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def main(argv=None) -> dict:
    args = parse(sys.argv[1:] if argv is None else argv)
    root = os.path.abspath(args.root)
    if root not in sys.path[:1]:
        sys.path.insert(0, root)
    if not torch.cuda.is_available():
        sys.exit("exp_f32_forward: no CUDA device is available")
    from vip_cup_2022_tpu_torch.models import create_model
    from vip_cup_2022_tpu_torch.tools.bench_util import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"root={root} device={torch.cuda.get_device_name(0)} [{card}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(23)
    results = {"root": root, "card": card, "batch": args.batch, "members": {}}
    for name in args.members:
        dim = MEMBERS[name]
        model, _ = create_model(name, input_size=dim, nb_classes=1, classifier_activation=None,
                                dtype=torch.float32, seed=0)
        model = model.cuda().eval()
        x = torch.rand((args.batch, *dim, 3), generator=gen, device="cuda")
        with torch.inference_mode():
            model(x)  # builds and loads the kernels, warms the allocator
            runs = [timed(model, x, args.iters) for _ in range(args.rounds)]
        ev, host = [r[0] for r in runs], [r[1] for r in runs]
        results["members"][name] = {"events_ms": ev, "host_issue_ms": host}
        print(f"[f32 forward] {name} {dim[0]}x{dim[1]} b{args.batch}: events "
              + ", ".join(f"{t:.2f}" for t in ev) + " ms a forward; host issue "
              + ", ".join(f"{t:.2f}" for t in host) + f" ms [{card}]", flush=True)
        del model, x
        torch.cuda.empty_cache()
    total = sum(min(r["events_ms"]) for r in results["members"].values())
    results["sum_of_least_ms"] = total
    print(f"[f32 forward] sum of each member's least events ms: {total:.2f} [{card}]", flush=True)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
