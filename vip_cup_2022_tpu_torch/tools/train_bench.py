#!/usr/bin/env python3
"""Training-step throughput of one member on the card (counterpart of
``tools/train_bench.py``).

    python3 -m vip_cup_2022_tpu_torch.tools.train_bench [--member ResNetRS50] [--dim 200]
        [--batch 128] [--reps 8]
    python3 -m vip_cup_2022_tpu_torch.tools.train_bench --cpu --dim 64 --batch 2 --reps 1

Times ``Trainer.train_step``, the step ``Trainer.fit`` takes (forward in
training mode, the loss, the backward, the AdamW update), of a one-output
member with bf16 compute and f32 parameters (f32 on the CPU), at lr 1e-3
and weight decay 1e-4 with ``bce_timm``: one step on the first of
``--reps + 1`` distinct batches drawn on the device (the kernels' builds and
first launches), then ``--reps`` steps on the others, the host clock read
after a synchronise at both ends.

The model's FLOPs are counted, not estimated: one forward and backward of
the same member in f32 at batch 2 on the plain path
(:func:`..ops.kernels.reference.plain_kernels`; a hand-written kernel is
opaque to the counter) under ``torch.utils.flop_counter.FlopCounterMode``,
per image, times the batch. It counts the products of convs and Linears,
forward and backward; the depthwise convs' taps, norms and elementwise ops
are not counted. ``mfu`` is that over the step time, against the peak named
in ``mfu_peak`` (an H100 SXM's dense bf16 tensor-core rate); null off the
card.

The last line is one JSON object with the JAX tool's keys (``metric``,
``member``, ``batch``, ``dim``, ``per_step_ms``, ``img_per_sec``,
``compile_plus_first_step_s``, ``loss_first``), the counted
``train_gflops_per_img``, ``mfu`` and ``mfu_peak``. ``--cpu`` runs on the
CPU and narrows ConvNeXt and GCViT as ``train_flip.CPU_MEMBERS`` does.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..infer.engine import default_device
from ..models import create_model
from ..ops.kernels.reference import plain_kernels
from ..train import TrainConfig, Trainer
from ..train.losses import binary_cross_entropy_timm
from .bench_util import card_line
from .train_flip import CPU_MEMBERS

PEAK_FLOPS = 989e12
PEAK_NAME = "989 TFLOP/s: NVIDIA H100 SXM dense bf16 tensor-core peak (data sheet)"
COUNT_BATCH = 2


def _model(member: str, dim: int, dtype: torch.dtype, overrides: Dict) -> torch.nn.Module:
    model, _ = create_model(member, input_size=(dim, dim), nb_classes=1,
                            classifier_activation=None, dtype=dtype,
                            param_dtype=torch.float32, **overrides)
    return model


def train_flops_per_image(member: str, dim: int, overrides: Dict,
                          device: torch.device) -> float:
    """Counted FLOPs of one training forward and backward, per image, on
    the plain f32 path at batch ``COUNT_BATCH``."""
    model = _model(member, dim, torch.float32, overrides).to(device).train()
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((COUNT_BATCH, dim, dim, 3), generator=gen, device=device)
    y = (torch.rand((COUNT_BATCH, 1), generator=gen, device=device) < 0.5).float()
    counter = FlopCounterMode(display=False)
    with plain_kernels(), counter:
        binary_cross_entropy_timm(y, model(x).float()).mean().backward()
    return counter.get_total_flops() / COUNT_BATCH


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--member", default="ResNetRS50")
    ap.add_argument("--dim", type=int, default=200)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, narrowed")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu else default_device()
    cuda = device.type == "cuda"
    print(f"[train_bench] device {card_line() if cuda else 'cpu'}", flush=True)
    overrides = {name: kw for name, _, kw in CPU_MEMBERS}.get(args.member, {}) if args.cpu else {}
    flops = train_flops_per_image(args.member, args.dim, overrides, device)

    model = _model(args.member, args.dim, torch.bfloat16 if cuda else torch.float32, overrides)
    gen = torch.Generator(device=device).manual_seed(1)
    batches = [(torch.rand((args.batch, args.dim, args.dim, 3), generator=gen, device=device),
                (torch.rand((args.batch, 1), generator=gen, device=device) < 0.5).float())
               for _ in range(args.reps + 1)]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tr = Trainer(model, TrainConfig(lr_schedule="constant", lr_base=1e-3, loss="bce_timm",
                                        weight_decay=1e-4, ckpt_dir=ckpt_dir), device=device)
        sync()
        t0 = time.perf_counter()
        loss_first = tr.train_step(*batches[0], 1e-3).item()
        first_s = time.perf_counter() - t0
        sync()
        t0 = time.perf_counter()
        for x, y in batches[1:]:
            loss = tr.train_step(x, y, 1e-3)
        sync()
        per_step = (time.perf_counter() - t0) / args.reps
        loss.item()
    out = {
        "metric": "train_step_img_per_sec",
        "member": args.member,
        "batch": args.batch,
        "dim": args.dim,
        "per_step_ms": per_step * 1e3,
        "img_per_sec": args.batch / per_step,
        "compile_plus_first_step_s": first_s,
        "loss_first": loss_first,
        "train_gflops_per_img": flops / 1e9,
        "mfu": flops * args.batch / per_step / PEAK_FLOPS if cuda else None,
        "mfu_peak": PEAK_NAME,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
