"""The training loop (counterpart of ``vip_cup_2022_tpu/train/trainer.py``).

``Trainer(model, cfg).fit(train_iter_fn, val_iter_fn)`` trains a port model
on the card (``infer/engine.py::default_device``; the CPU only when
``VIPTPU_PLATFORM=cpu`` or a ``device`` says so). The model computes in its
config's dtype (bf16 or f32, on CUDA as on the CPU) with its parameters held
in f32, as Flax's ``param_dtype``. In f32 on CUDA every step and evaluation
runs with TF32 off for cuDNN and cuBLAS (``utils/precision.py::f32_scope``),
and a GCViT or ConvNeXt whose config leaves the block path to the default
trains on its unfused block and evaluates on its fused one, in f32 as in
bf16 (the models' rule). A step: uint8
batches / 255, mixup / cutmix, the forward in training mode (GCViT's
unfused path: K8, K9 and K10 under autograd), the loss in f32 (plus the
teacher's distillation KL), the gradient (SAM's second pass with
``use_sam``), the optimizer's update at learning rate 1 times the step's lr.
Behaviours of the JAX trainer kept: the four lr schedules, the eval
accuracy rules (NaN where none is defined), the NaN stop checked every
``nan_check_every`` steps and at each epoch's end, the latest, best (the
previous best pruned) and per-epoch checkpoints (pruned to
``keep_n_checkpoints``, spared every ``keep_checkpoint_every_n_hours`` on
an injectable clock), resume, the history JSON and the metric log.

Checkpoints are the JAX package's msgpack with its ``.md5`` sidecar:
``params`` and ``batch_stats`` in Flax names and layouts (the JAX package's
``load_variables`` reads them), the optimizer state in the port's own layout
(``optimizers.py``; only the port resumes from it) and ``meta``. Dropout
and DropPath draw from a generator on the device, mixup from one on the
host, both seeded with ``cfg.seed``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..infer.engine import default_device
from ..ops.drop import set_generator
from ..utils.checkpoint import load_variables, save_variables
from ..utils.precision import f32_scope
from ..weights.from_jax import state_dict_from_flax
from ..weights.to_flax import flax_paths, torch_to_flax
from .logging import MetricLogger
from .losses import binary_cross_entropy_timm, categorical_cross_entropy, distill_kl_divergence
from .mixup import mixup_cutmix
from .optimizers import create_optimizer, weight_decay_mask
from .sam import sam_gradient, value_and_grad
from .schedules import CosineLrScheduler, exp_scheduler, multistep_schedule


@dataclasses.dataclass
class TrainConfig:
    """The JAX ``TrainConfig``'s fields and defaults."""

    epochs: int = 10
    steps_per_epoch: int = 100
    lr_base: float = 1e-3
    # cosine (per step, with restarts) | constant | multistep | exp
    lr_schedule: str = "cosine"
    lr_decay_steps: Tuple[int, ...] = (30, 60, 90)
    lr_decay_rate: float = 0.1
    first_restart_step: float = 10
    warmup_epochs: float = 1
    cooldown_epochs: float = 0
    lr_min: float = 1e-6
    t_mul: float = 2.0
    m_mul: float = 0.5
    optimizer: str = "adamw"
    weight_decay: float = 0.02
    momentum: float = 0.9
    grad_clip_norm: Optional[float] = None
    loss: str = "bce_timm"  # bce_timm | categorical
    label_smoothing: float = 0.0
    target_threshold: float = 0.0  # bce_timm binarization point
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    use_sam: bool = False
    sam_rho: float = 0.05
    monitor: str = "val_loss"  # the best checkpoint's criterion
    monitor_mode: str = "min"
    ckpt_dir: str = "checkpoints"
    basic_save_name: str = "model"
    # > 0: per-epoch snapshots too, pruned to the newest N
    keep_n_checkpoints: int = 0
    # > 0: a snapshot due for pruning is kept for good when this many hours
    # passed since the last one kept
    keep_checkpoint_every_n_hours: float = 0.0
    # fetch the loss for the NaN check only every N steps (each fetch waits
    # for the card)
    nan_check_every: int = 50
    # per-epoch metrics to <log_dir>/<basic_save_name>.jsonl when set
    log_dir: Optional[str] = None
    seed: int = 42


def _lookup(tree: Dict, path: Tuple[str, ...]):
    for part in path:
        tree = tree[part]
    return tree


class Trainer:
    """Trains ``model`` (a port module) in place. Data iterators yield
    ``(images, labels)`` numpy batches: uint8 or float NHWC images, one- or
    multi-hot float labels (or int class ids for the categorical loss);
    tensors, on the card or not, are taken as well."""

    def __init__(self, model: nn.Module, cfg: TrainConfig,
                 device: Optional[torch.device] = None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else default_device()
        self.compute_dtype = getattr(getattr(model, "cfg", None), "dtype", torch.float32)
        # the parameters in f32 from here on, Flax's param_dtype
        self.model = model.to(device=self.device, dtype=torch.float32)
        self.params = dict(self.model.named_parameters())
        state_keys = set(self.model.state_dict())
        self._stats = {k: b for k, b in self.model.named_buffers() if k in state_keys}

        if cfg.lr_schedule == "cosine":
            self.lr_fn = CosineLrScheduler(
                cfg.lr_base, cfg.first_restart_step, steps_per_epoch=cfg.steps_per_epoch,
                m_mul=cfg.m_mul, t_mul=cfg.t_mul, lr_min=cfg.lr_min,
                warmup_steps=cfg.warmup_epochs, cooldown_steps=cfg.cooldown_epochs)
            self._lr_for = lambda step, epoch: self.lr_fn(step)
        elif cfg.lr_schedule == "constant":
            self._lr_for = lambda step, epoch: cfg.lr_base
        elif cfg.lr_schedule == "multistep":
            self._lr_for = lambda step, epoch: multistep_schedule(
                epoch, cfg.lr_base, cfg.lr_decay_steps, cfg.lr_decay_rate,
                warmup_epochs=int(cfg.warmup_epochs))
        elif cfg.lr_schedule == "exp":
            decay_step = cfg.lr_decay_steps[0] if cfg.lr_decay_steps else 1
            self._lr_for = lambda step, epoch: exp_scheduler(
                epoch, cfg.lr_base, decay_step, cfg.lr_decay_rate, lr_min=cfg.lr_min,
                warmup_steps=int(cfg.warmup_epochs))
        else:
            raise ValueError(f"lr_schedule must be cosine|constant|multistep|exp, "
                             f"got {cfg.lr_schedule!r}")
        # the decay mask from the Flax names (the JAX rule exempts "weight",
        # which torch gives every Linear)
        paths = flax_paths(self.model)
        masks = weight_decay_mask(torch_to_flax(self.model)["params"])
        self.decay_mask = {k: _lookup(masks, paths[k][1:]) for k in self.params}
        self.tx = create_optimizer(cfg.optimizer, weight_decay=cfg.weight_decay,
                                   momentum=cfg.momentum, grad_clip_norm=cfg.grad_clip_norm,
                                   mask=self.decay_mask)
        self.opt_state = self.tx.init({k: p.detach() for k, p in self.params.items()})
        self.global_step = 0
        self.initial_epoch = 0
        self._teacher = None
        self.history: Dict[str, list] = {"lr": [], "loss": [], "val_loss": [], "val_acc": []}
        self._best = math.inf if cfg.monitor_mode == "min" else -math.inf
        self._best_path = None
        self._epoch_ckpts: list = []
        self._preserved_ckpts: list = []  # spared by keep_checkpoint_every_n_hours
        self._clock = time.time  # injectable for retention tests
        self._last_preserved_ts = self._clock()
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.mix_generator = torch.Generator().manual_seed(cfg.seed)
        set_generator(self.model, self.generator)

    def set_teacher(self, model: nn.Module, temperature: float = 10.0, weight: float = 1.0):
        """Distillation: loss = task loss + weight * KL(teacher || student)
        at ``temperature``; the teacher runs in eval mode without gradients."""
        self._teacher = (model.to(self.device).eval(), temperature, weight)

    # ------------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return a.to(self.device)

    def _input(self, images) -> torch.Tensor:
        x = self._tensor(images)
        return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()

    def _loss(self, labels: torch.Tensor, outputs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if labels.ndim == outputs.ndim - 1 and not labels.is_floating_point():
            labels = F.one_hot(labels.long(), outputs.shape[-1]).to(outputs.dtype)
        if cfg.loss == "bce_timm":
            return binary_cross_entropy_timm(labels, outputs, cfg.target_threshold,
                                             cfg.label_smoothing).mean()
        return categorical_cross_entropy(labels, outputs, cfg.label_smoothing).mean()

    def train_step(self, images, labels, lr: float) -> torch.Tensor:
        """One step on a batch at learning rate ``lr``; returns the loss (a
        0-d f32 tensor on the device, not fetched)."""
        with f32_scope(self.device, self.compute_dtype):
            return self._train_step(images, labels, lr)

    def _train_step(self, images, labels, lr: float) -> torch.Tensor:
        cfg = self.cfg
        x = self._input(images)
        y = self._tensor(labels)
        if cfg.mixup_alpha or cfg.cutmix_alpha:
            x, y = mixup_cutmix(x, y, cfg.mixup_alpha, cfg.cutmix_alpha,
                                generator=self.mix_generator)
        self.model.train()

        def loss_fn():
            out = self.model(x).float()
            loss = self._loss(y, out)
            if self._teacher is not None:
                teacher, temperature, weight = self._teacher
                with torch.no_grad():
                    t_out = teacher(x).float()
                loss = loss + weight * distill_kl_divergence(t_out, out, temperature).mean()
            return loss

        if cfg.use_sam:
            loss, grads = sam_gradient(loss_fn, self.params, cfg.sam_rho, state=self._stats)
        else:
            loss, grads = value_and_grad(loss_fn, self.params)
        params = {k: p.detach() for k, p in self.params.items()}
        updates, self.opt_state = self.tx.update(grads, self.opt_state, params)
        with torch.no_grad():
            torch._foreach_add_(list(params.values()), [updates[k] for k in params], alpha=lr)
        return loss

    def eval_step(self, images, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, accuracy) of one batch in eval mode; the accuracy is NaN
        where the label layout defines none."""
        self.model.eval()
        with torch.no_grad(), f32_scope(self.device, self.compute_dtype):
            out = self.model(self._input(images)).float()
        y = self._tensor(labels)
        loss = self._loss(y, out)
        if y.ndim == out.ndim and out.shape[-1] == y.shape[-1] == 1:
            # one binary logit: threshold it, no argmax over a size-1 axis
            acc = ((out > 0.5) == (y > 0.5)).float().mean()
        elif y.ndim == out.ndim and out.shape[-1] == y.shape[-1]:
            acc = (out.argmax(-1) == y.argmax(-1)).float().mean()
        elif y.ndim == out.ndim - 1 and not y.is_floating_point():
            acc = (out.argmax(-1) == y).float().mean()
        else:
            acc = torch.full((), math.nan, device=self.device)
        return loss, acc

    # ------------------------------------------------------------------
    # checkpoints: latest, best by the monitor (the previous best pruned),
    # per-epoch snapshots
    # ------------------------------------------------------------------
    def _save(self, tag: str) -> str:
        path = os.path.join(self.cfg.ckpt_dir, f"{self.cfg.basic_save_name}_{tag}.msgpack")
        variables = torch_to_flax(self.model)
        save_variables(path, {
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": self.opt_state,
            "meta": {"global_step": np.asarray(self.global_step),
                     "epoch": np.asarray(self.initial_epoch)},
        })
        return path

    def save_latest(self) -> str:
        return self._save("latest")

    def _save_epoch_snapshot(self, epoch: int) -> str:
        """A per-epoch snapshot, the oldest pruned past ``keep_n_checkpoints``,
        unless ``keep_checkpoint_every_n_hours`` separate it from the last one
        kept: then it is kept for good."""
        path = self._save(f"epoch{epoch:03d}")
        self._epoch_ckpts.append((path, self._clock()))
        n_h = self.cfg.keep_checkpoint_every_n_hours
        while len(self._epoch_ckpts) > self.cfg.keep_n_checkpoints:
            old, ts = self._epoch_ckpts.pop(0)
            if old == path:
                continue
            if n_h > 0 and ts - self._last_preserved_ts >= n_h * 3600.0:
                self._last_preserved_ts = ts
                self._preserved_ckpts.append(old)
                continue
            self._remove_ckpt(old)
        return path

    @staticmethod
    def _remove_ckpt(path: str) -> None:
        """Delete a checkpoint and its .md5 sidecar."""
        for p in (path, path + ".md5"):
            if os.path.exists(p):
                os.remove(p)

    def maybe_save_best(self, monitor_value: float, epoch: int) -> Optional[str]:
        better = (monitor_value < self._best if self.cfg.monitor_mode == "min"
                  else monitor_value > self._best)
        if not better:
            return None
        self._best = monitor_value
        path = self._save(f"epoch{epoch}_{self.cfg.monitor}{monitor_value:.4f}")
        if self._best_path:
            self._remove_ckpt(self._best_path)
        self._best_path = path
        return path

    def restore_latest(self) -> bool:
        """Load the latest checkpoint (weights, optimizer state, step and
        epoch) if there is one."""
        path = os.path.join(self.cfg.ckpt_dir, f"{self.cfg.basic_save_name}_latest.msgpack")
        if not os.path.isfile(path):
            return False
        state = load_variables(path)
        variables = {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
        self.model.load_state_dict(
            state_dict_from_flax(variables, self.model.state_dict(), strict=True), strict=True)

        def tensors(tree, like):
            if isinstance(like, dict):
                return {k: tensors(tree[k], v) for k, v in like.items()}
            return torch.tensor(np.asarray(tree), dtype=like.dtype, device=like.device)

        self.opt_state = tensors(state["opt_state"], self.opt_state)
        self.global_step = int(state["meta"]["global_step"])
        self.initial_epoch = int(state["meta"]["epoch"])
        return True

    def _dump_history(self) -> None:
        os.makedirs(self.cfg.ckpt_dir, exist_ok=True)
        path = os.path.join(self.cfg.ckpt_dir, f"{self.cfg.basic_save_name}_hist.json")
        with open(path, "w") as fh:
            json.dump(self.history, fh)

    # ------------------------------------------------------------------
    def fit(self, train_iter_fn: Callable[[], Iterable[Tuple[np.ndarray, np.ndarray]]],
            val_iter_fn: Optional[Callable[[], Iterable[Tuple[np.ndarray, np.ndarray]]]] = None,
            verbose: int = 1) -> Dict[str, list]:
        cfg = self.cfg
        # re-iterable loaders are taken as they are
        if train_iter_fn is not None and not callable(train_iter_fn):
            loader = train_iter_fn
            train_iter_fn = lambda: iter(loader)  # noqa: E731
        if val_iter_fn is not None and not callable(val_iter_fn):
            vloader = val_iter_fn
            val_iter_fn = lambda: iter(vloader)  # noqa: E731
        logger = (MetricLogger(cfg.log_dir, name=cfg.basic_save_name,
                               config=dataclasses.asdict(cfg)) if cfg.log_dir else None)
        try:
            for epoch in range(self.initial_epoch, cfg.epochs):
                if not self._epoch(epoch, train_iter_fn, val_iter_fn, logger, verbose):
                    break
        finally:
            if logger is not None:
                logger.finish()
        return self.history

    def _epoch(self, epoch, train_iter_fn, val_iter_fn, logger, verbose) -> bool:
        """One epoch; False when a NaN or Inf loss stopped training."""
        cfg = self.cfg
        t0 = time.time()
        losses = []  # on the device: fetched once at the epoch's end
        lr = cfg.lr_base
        nan_seen = False
        for step, (images, labels) in enumerate(train_iter_fn()):
            if step >= cfg.steps_per_epoch:
                break
            lr = self._lr_for(self.global_step, epoch)
            loss = self.train_step(images, labels, lr)
            self.global_step += 1
            losses.append(loss)
            # the NaN stop, amortised: a fetch every step would wait for the
            # card every step
            if cfg.nan_check_every and (step + 1) % cfg.nan_check_every == 0:
                if not math.isfinite(float(loss)):
                    nan_seen = True
                    break
        host = torch.stack(losses).cpu().numpy() if losses else np.array([])
        if nan_seen or (host.size and not np.isfinite(host[-1])):
            print(f"NaN/Inf loss at step {self.global_step}; terminating.")
            self._dump_history()
            return False
        epoch_loss = float(np.mean(host)) if host.size else float("nan")
        self.history["lr"].append(float(lr))
        self.history["loss"].append(epoch_loss)

        val_loss, val_acc = float("nan"), float("nan")
        if val_iter_fn is not None:
            vl, va, n = 0.0, 0.0, 0
            for images, labels in val_iter_fn():
                loss, acc = self.eval_step(images, labels)
                vl += float(loss)
                va += float(acc)
                n += 1
            if n:
                val_loss, val_acc = vl / n, va / n
        self.history["val_loss"].append(val_loss)
        self.history["val_acc"].append(val_acc)

        self.initial_epoch = epoch + 1
        self.save_latest()
        if cfg.keep_n_checkpoints > 0:
            self._save_epoch_snapshot(epoch + 1)
        monitor = {"val_loss": val_loss, "loss": epoch_loss, "val_acc": val_acc}.get(
            cfg.monitor, val_loss)
        if not math.isnan(monitor):
            self.maybe_save_best(monitor, epoch)
        self._dump_history()
        if logger is not None:
            logger.log({"loss": epoch_loss, "val_loss": val_loss, "val_acc": val_acc,
                        "lr": float(lr), "epoch_time_s": time.time() - t0, "epoch": epoch + 1},
                       step=self.global_step)
        if verbose:
            print(f"epoch {epoch + 1}/{cfg.epochs} loss={epoch_loss:.4f} "
                  f"val_loss={val_loss:.4f} val_acc={val_acc:.4f} lr={lr:.3e} "
                  f"({time.time() - t0:.1f}s)")
        return True
