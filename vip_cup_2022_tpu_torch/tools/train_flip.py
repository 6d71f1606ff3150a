#!/usr/bin/env python3
"""Decision flips of the bf16 and int8 serving paths against the f32
reference, on trained weights (counterpart of ``tools/train_flip.py``).

    python3 -m vip_cup_2022_tpu_torch.tools.train_flip [--members 3] [--epochs 2]
        [--steps 80] [--batch 64] [--n-eval 1024] [--eval-batch 256] [--ckpt-dir DIR]
    python3 -m vip_cup_2022_tpu_torch.tools.train_flip --cpu --members 3 --epochs 1 \\
        --steps 2 --batch 4 --n-eval 8 --eval-batch 8

Random weights put every score near the same value, so the flips they show
say little about a trained ensemble. This trains the members first, on a
synthetic real-vs-fake task, until their scores split, then counts the
decisions at 0.487 that the serving paths flip against the f32 reference on
held-out images.

The task: every image is 8 x 8 blocks of uniform grey levels plus uniform
+-16 noise; a fake one also carries a faint 2 x 2 checkerboard (amplitude
4-8, random phase), the classic transposed-conv artifact. The images are
drawn on the device from a ``torch.Generator``.

Training: each member of ``MEMBERS`` (one output, no activation, bf16
compute with f32 parameters on the card, f32 on the CPU) through
``Trainer.fit``: AdamW at a constant lr 3e-4, weight decay 1e-4,
``bce_timm``, ``--epochs`` x ``--steps`` batches of ``--batch`` at the
member's size; the weights are saved as ``<ckpt-dir>/<member>.msgpack``
(Flax names and layouts, the JAX package reads them) and reused if there.

Evaluation: ``--n-eval`` held-out images at 200 x 200 as uint8, through
three arms, each the ensemble mean of the members' sigmoid scores after the
engine's resize to each member's size:
- f32: the members in f32 on the device with every kernel routed through
  its plain version (:func:`..ops.kernels.reference.plain_kernels`) and the
  unfused block paths, the reference (the engine itself takes no f32
  compute on CUDA, ROADMAP A15);
- bf16: ``EnsembleEngine.build_fused_ensemble`` in bf16, the serving path;
- int8: the same with the members of the JAX engine's ``INT8_AUTO`` set
  (ResNetRS50 of the three) quantized after calibration on the first eval
  batch.

The last line is the JAX tool's JSON: the task's balanced accuracy of the
f32 arm, its share of scores within 0.01 of the threshold, and per arm the
flip rate against the f32 decisions, the balanced accuracies against those
decisions and against the labels, and the mean and max |dp|.

``--cpu`` runs on the CPU at a narrowed size (``CPU_MEMBERS``: ConvNeXt
and GCViT narrow, ResNetRS50 and ConvNeXt at 64 px); otherwise the tool
runs where ``infer/engine.py::default_device`` says (the card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..eval.metrics import balanced_accuracy_score
from ..infer.engine import NATIVE_SIZE, EnsembleEngine, _to_binary, default_device
from ..models import create_model, transfer_weights
from ..models.registry import model_entry
from ..ops.kernels.reference import plain_kernels
from ..ops.resize import resize
from ..quant import QuantizedSite
from ..train import TrainConfig, Trainer
from ..utils.checkpoint import load_variables, save_variables
from ..weights.from_jax import flax_to_torch
from ..weights.to_flax import torch_to_flax
from .bench_util import card_line

THR = 0.487  # the CLI's decision threshold

# the three families of the JAX tool: both kernel members and the int8 one
MEMBERS: List[Tuple[str, Tuple[int, int], Dict]] = [
    ("ResNetRS50", (200, 200), {}),
    ("convnext_tiny_in22k", (200, 200), {}),
    ("GCViTTiny", (224, 224), {}),
]
CPU_MEMBERS: List[Tuple[str, Tuple[int, int], Dict]] = [
    ("ResNetRS50", (64, 64), {}),
    ("convnext_tiny_in22k", (64, 64), dict(nb_blocks=(1, 1, 1, 1), embed_dim=(32, 64, 128, 256))),
    ("GCViTTiny", (224, 224), dict(dim=32, num_heads=(1, 2, 4, 8), depths=(2, 2, 2, 2))),
]
INT8_AUTO = {"ResNetRS50", "ResNest50"}  # the JAX engine's INT8_AUTO


def make_batch(gen: torch.Generator, batch: int, hw: Tuple[int, int],
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(images (B, H, W, 3) f32 in [0, 1], labels (B, 1) f32)`` drawn
    from ``gen`` on ``device``: 8 x 8 blocks plus +-16 noise, and on the
    fakes (label 1) a 2 x 2 checkerboard of amplitude 4-8 and random
    phase."""
    h, w = hw
    base = torch.randint(0, 256, (batch, h // 8 + 1, w // 8 + 1, 3), generator=gen,
                         device=device).float()
    img = base.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w, :]
    noise = torch.rand((batch, h, w, 3), generator=gen, device=device) * 32.0 - 16.0
    img = (img + noise).clamp(0, 255)
    labels = (torch.rand((batch, 1), generator=gen, device=device) < 0.5).float()
    yy = torch.arange(h, device=device).view(1, h, 1, 1)
    xx = torch.arange(w, device=device).view(1, 1, w, 1)
    phase = torch.randint(0, 2, (batch, 1, 1, 1), generator=gen, device=device)
    amp = 4.0 + 4.0 * torch.rand((batch, 1, 1, 1), generator=gen, device=device)
    checker = (((yy // 2 + xx // 2 + phase) % 2) * 2 - 1).float()
    img = (img + labels[:, :, None, None] * amp * checker).clamp(0, 255)
    return img / 255.0, labels


def train_member(name: str, dim, overrides: Dict, epochs: int, steps: int, batch: int,
                 ckpt_dir: str, device: torch.device) -> str:
    """Train one member and save its weights; returns the checkpoint path."""
    path = os.path.join(ckpt_dir, f"{name}.msgpack")
    if os.path.isfile(path):
        print(f"[train] {name}: cached {path}", flush=True)
        return path
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, _ = create_model(name, input_size=dim, nb_classes=1, classifier_activation=None,
                            dtype=dtype, param_dtype=torch.float32, **overrides)
    cfg = TrainConfig(epochs=epochs, steps_per_epoch=steps, lr_base=3e-4,
                      lr_schedule="constant", loss="bce_timm", weight_decay=1e-4,
                      ckpt_dir=os.path.join(ckpt_dir, f"_state_{name}"), nan_check_every=steps)
    trainer = Trainer(model, cfg, device=device)
    gen = torch.Generator(device=device)

    def train_iter():
        gen.manual_seed(trainer.global_step + 1)
        for _ in range(steps):
            yield make_batch(gen, batch, dim, device)

    trainer.fit(train_iter, verbose=1)
    variables = torch_to_flax(trainer.model)
    trained = {"params": variables["params"]}
    if variables["batch_stats"]:
        trained["batch_stats"] = variables["batch_stats"]
    save_variables(path, trained)
    print(f"[train] {name}: saved {path}", flush=True)
    return path


def _trained(name: str, dim, overrides: Dict, ckpt_dir: str, dtype: torch.dtype,
             device: torch.device) -> Tuple[torch.nn.Module, Dict]:
    """The member with a sigmoid head, its trained weights loaded, on the
    device in eval mode; and the checkpoint's tree."""
    tree = load_variables(os.path.join(ckpt_dir, f"{name}.msgpack"))
    model, _ = create_model(name, input_size=dim, nb_classes=1, classifier_activation="sigmoid",
                            dtype=dtype, **overrides)
    transfer_weights(tree, model, strict=True)
    return model.to(device).eval(), tree


def _unfused(name: str) -> Dict:
    """The override that puts a member on its unfused block path, if it has
    a fused one (ConvNeXt, GCViT)."""
    return {"fused_block": False} if hasattr(model_entry(name)[1], "fused_block") else {}


def eval_arms(spec, ckpt_dir: str, n_eval: int, batch: int, device: torch.device):
    """``({arm: ensemble probabilities (n,)}, labels (n,))`` of the f32,
    bf16 and int8 arms over the held-out images."""
    gen = torch.Generator(device=device).manual_seed(10_000)
    u8_batches, labels = [], []
    for _ in range(n_eval // batch):
        img, lab = make_batch(gen, batch, NATIVE_SIZE, device)
        u8_batches.append((img * 255.0).round().clamp(0, 255).to(torch.uint8).cpu().numpy())
        labels.append(lab.cpu().numpy())
    y = np.concatenate(labels)[:, 0]

    results = {}
    # f32: plain versions of every kernel, the unfused block paths
    with plain_kernels(), torch.inference_mode():
        members = [(_trained(name, dim, {**kw, **_unfused(name)}, ckpt_dir, torch.float32,
                             device)[0], tuple(dim)) for name, dim, kw in spec]
        outs = []
        for u8 in u8_batches:
            x0 = torch.from_numpy(u8).to(device).float() / 255.0
            preds = [_to_binary(model(resize(x0, dim) if dim != NATIVE_SIZE else x0).float())
                     for model, dim in members]
            outs.append(torch.stack(preds).mean(0).cpu().numpy())
        results["f32"] = np.concatenate(outs)[:, 0]
        del members
    print(f"[eval] f32: mean p={results['f32'].mean():.3f}", flush=True)

    for arm in ("bf16", "int8"):
        engine = EnsembleEngine(device=device, compute_dtype=torch.bfloat16, verbose=0)
        members, scales, f32_weights = [], [], []
        for name, dim, kw in spec:
            model, tree = _trained(name, dim, kw, ckpt_dir, torch.bfloat16, device)
            members.append(([model], tuple(dim)))
            if arm == "int8" and name in INT8_AUTO:
                scales.append(engine._calibrate_member(model, dim, u8_batches[0]))
                f32_weights.append([flax_to_torch(tree)])
            else:
                scales.append(None)
                f32_weights.append(None)
        fwd = engine.build_fused_ensemble(members, quant_scales=scales,
                                          f32_weights=f32_weights)
        results[arm] = np.concatenate([fwd(u8).cpu().numpy() for u8 in u8_batches])[:, 0]
        sites = {name: sum(isinstance(m, QuantizedSite) for m in folds[0].modules())
                 for (name, _, _), (folds, _) in zip(spec, members)}
        engine.close()
        del members, fwd
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[eval] {arm}: mean p={results[arm].mean():.3f}; int8 sites "
              f"{ {n: k for n, k in sites.items() if k} }", flush=True)
    return results, y


def summarize(results: Dict[str, np.ndarray], y: np.ndarray, members: int) -> Dict:
    """The JAX tool's JSON record."""
    p32 = results["f32"]
    d32 = (p32 > THR).astype(int)
    out = {"n": len(p32), "members": members,
           "task_balanced_acc_f32": balanced_accuracy_score(y.astype(int), d32),
           "frac_within_0.01_of_thr_f32": float((np.abs(p32 - THR) < 0.01).mean())}
    for arm in ("bf16", "int8"):
        p = results[arm]
        d = (p > THR).astype(int)
        out[arm] = {
            "flip_rate": float((d != d32).mean()),
            "balanced_acc_vs_f32_decisions": balanced_accuracy_score(d32, d),
            "task_balanced_acc": balanced_accuracy_score(y.astype(int), d),
            "mean_abs_dp": float(np.abs(p - p32).mean()),
            "max_abs_dp": float(np.abs(p - p32).max()),
        }
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=len(MEMBERS))
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-eval", type=int, default=1024)
    ap.add_argument("--eval-batch", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="train_flip_ckpts")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU, with the members narrowed (CPU_MEMBERS)")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu else default_device()
    print(f"[train_flip] device {card_line() if device.type == 'cuda' else 'cpu'}", flush=True)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    spec = (CPU_MEMBERS if args.cpu else MEMBERS)[: args.members]
    for name, dim, kw in spec:
        train_member(name, dim, kw, args.epochs, args.steps, args.batch, args.ckpt_dir, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    results, y = eval_arms(spec, args.ckpt_dir, args.n_eval, min(args.eval_batch, args.n_eval),
                           device)
    out = summarize(results, y, len(spec))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
