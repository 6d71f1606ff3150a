#!/usr/bin/env python3
"""The loss of a few training steps of full-width GCViTTiny@224 on one
repeated batch, for a grid of settings.

    python3 -m vip_cup_2022_tpu_torch.tools.train_steps [--init registry perturbed]
        [--lr 3e-4 1e-4] [--drop-path 0.2 0] [--batch 64] [--steps 8]

For each (init, lr, drop_path): a one-output, no-activation GCViTTiny with
f32 parameters (bf16 compute on the card, f32 on the CPU), ``Trainer`` with
AdamW, weight decay 1e-4 and a constant lr, ``--steps`` steps of
``Trainer.train_step`` on one seeded batch of noise with random labels, and
one line: each step's training loss (the forward before that step's
update, DropPath drawing from the trainer's generator) and the eval-mode
loss on the batch before and after. ``registry`` is the registry's seeded
init (rel-pos tables std 0.02, LN scales 1); ``perturbed`` is
``chip_smoke.py::_model``'s draw for GCViT on top of it (rel-pos tables
~ U(-1, 1), LN scales ~ U(0.5, 1.5), from a generator seeded with 1). Runs
where ``infer/engine.py::default_device`` says (``VIPTPU_PLATFORM=cpu`` for
the CPU).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import torch

from ..infer.engine import default_device
from ..models import create_model
from ..train import TrainConfig, Trainer
from .bench_util import card_line


def perturb(model: torch.nn.Module) -> None:
    """Rel-pos tables ~ U(-1, 1) and LN scales ~ U(0.5, 1.5), drawn in
    parameter order from a generator seeded with 1."""
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".gamma", "norm1.weight", "norm2.weight")):
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
            elif name.endswith("relative_position_bias_table"):
                p.copy_(torch.rand(p.shape, generator=gen) * 2 - 1)


def run(init: str, lr: float, drop_path: float, batch: int, steps: int,
        device: torch.device) -> dict:
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1,
                            classifier_activation=None, dtype=dtype,
                            drop_path_rate=drop_path, param_dtype=torch.float32)
    if init == "perturbed":
        perturb(model)
        model.gather_bias()
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.rand((batch, 224, 224, 3), generator=gen, device=device)
    y = (torch.rand((batch, 1), generator=gen, device=device) > 0.5).float()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tr = Trainer(model, TrainConfig(lr_schedule="constant", lr_base=lr, weight_decay=1e-4,
                                        seed=0, ckpt_dir=ckpt_dir), device=device)
        before = tr.eval_step(x, y)[0].item()
        t0 = time.perf_counter()
        losses = [tr.train_step(x, y, lr).item() for _ in range(steps)]
        seconds = time.perf_counter() - t0
        after = tr.eval_step(x, y)[0].item()
    return {"init": init, "lr": lr, "drop_path": drop_path, "losses": losses,
            "eval_before": before, "eval_after": after, "ms_per_step": seconds / steps * 1000}


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init", nargs="+", default=["registry"], choices=("registry", "perturbed"))
    ap.add_argument("--lr", nargs="+", type=float, default=[3e-4])
    ap.add_argument("--drop-path", nargs="+", type=float, default=[0.2])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    device = default_device()
    where = card_line() if device.type == "cuda" else "cpu"
    results = []
    for init in args.init:
        for lr in args.lr:
            for dp in args.drop_path:
                r = run(init, lr, dp, args.batch, args.steps, device)
                results.append(r)
                print(f"[train_steps] {init} lr {lr:g} drop_path {dp:g} batch {args.batch}: "
                      f"losses {', '.join(f'{v:.4f}' for v in r['losses'])}; eval "
                      f"{r['eval_before']:.4f} -> {r['eval_after']:.4f} "
                      f"({r['ms_per_step']:.0f} ms a step) [{where}]", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
