"""Learning-rate schedules as plain step -> lr functions on the host
(counterpart of ``vip_cup_2022_tpu/train/schedules.py``): keras'
``CosineDecay`` and ``CosineDecayRestarts``, kecam's ``CosineLrScheduler``
(warmup, cosine with restarts, cooldown), and the constant, exponential and
multistep schedules by epoch."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def cosine_decay(step, lr_base, decay_steps, alpha=0.0) -> float:
    """keras ``CosineDecay``, in f32 as the JAX schedule computes it."""
    p = np.clip(np.float32(step) / np.float32(decay_steps), 0.0, 1.0).astype(np.float32)
    cosine = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * p))
    return float(np.float32(lr_base) * (np.float32(1 - alpha) * cosine + np.float32(alpha)))


def cosine_decay_restarts(step, lr_base, first_decay_steps, t_mul=2.0, m_mul=0.5,
                          alpha=0.0) -> float:
    """keras ``CosineDecayRestarts``: periods ``first_decay_steps *
    t_mul**i``, the i-th restart's peak scaled by ``m_mul**i``; in f32, as
    the JAX schedule computes it."""
    step = np.float32(step)
    if t_mul == 1.0:
        i_restart = np.floor(step / np.float32(first_decay_steps))
        frac = step / np.float32(first_decay_steps) - i_restart
    else:
        ratio = step / np.float32(first_decay_steps) * np.float32(t_mul - 1.0) + np.float32(1.0)
        i_restart = np.floor(np.log(ratio) / np.float32(math.log(t_mul)))
        sum_r = (np.float32(t_mul) ** i_restart - np.float32(1.0)) / np.float32(t_mul - 1.0)
        frac = (step / np.float32(first_decay_steps) - sum_r) / np.float32(t_mul) ** i_restart
    m_fac = np.float32(m_mul) ** i_restart
    cosine = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * frac))
    return float(np.float32(lr_base) * ((np.float32(1 - alpha)) * m_fac * cosine
                                        + np.float32(alpha)))


class CosineLrScheduler:
    """Warmup -> cosine (with restarts) -> per-cycle cooldown, stepped per
    batch (kecam ``CosineLrScheduler``): restart periods
    ``first_restart_step * t_mul**i`` epochs with ``cooldown_steps`` epochs
    of ``lr_min`` after each cycle, and a linear warmup from ``lr_warmup``
    (``lr_min`` by default) over ``warmup_steps`` epochs."""

    def __init__(self, lr_base: float, first_restart_step: float, steps_per_epoch: int,
                 m_mul: float = 0.5, t_mul: float = 2.0, lr_min: float = 1e-5,
                 lr_warmup: float = -1, warmup_steps: float = 0, cooldown_steps: float = 0):
        self.lr_base, self.m_mul, self.t_mul, self.lr_min = lr_base, m_mul, t_mul, lr_min
        self.steps_per_epoch = steps_per_epoch
        self.first_restart_step = first_restart_step
        self.cooldown_steps = cooldown_steps
        self.warmup_batch_steps = warmup_steps * steps_per_epoch
        self.lr_warmup = lr_warmup if lr_warmup > 0 else lr_min
        self.alpha = lr_min / lr_base
        self.no_restart = lr_min == lr_base * m_mul
        if not self.no_restart:
            aa = [first_restart_step * (t_mul ** i) for i in range(5)]
            self.cooldown_epochs_start = np.array(
                [int(sum(aa[:i]) + cooldown_steps * (i - 1)) for i in range(1, 5)])
            self.cooldown_epochs_end = self.cooldown_epochs_start + cooldown_steps
        else:
            self.cooldown_epochs_start = np.array([])
            self.cooldown_epochs_end = np.array([])

    def __call__(self, global_step: int) -> float:
        epoch = global_step // self.steps_per_epoch
        if global_step < self.warmup_batch_steps:
            return float(self.lr_warmup + (self.lr_base - self.lr_warmup) * global_step
                         / self.warmup_batch_steps)
        previous_cooldown_steps = 0
        if self.cooldown_epochs_end.shape[0]:
            pos = int((self.cooldown_epochs_end > epoch).argmax())
            previous_cooldown_steps = self.cooldown_steps * pos * self.steps_per_epoch
            if epoch >= self.cooldown_epochs_end[pos] - self.cooldown_steps:
                return float(self.lr_min)
        step = global_step - previous_cooldown_steps
        decay_steps = self.first_restart_step * self.steps_per_epoch
        if self.no_restart:
            return cosine_decay(step, self.lr_base, decay_steps, self.alpha)
        return cosine_decay_restarts(step, self.lr_base, decay_steps, self.t_mul, self.m_mul,
                                     self.alpha)


def constant_scheduler(epoch, lr_base, lr_decay_steps: Sequence[int], decay_rate=0.1,
                       warmup_steps=0):
    """kecam ``constant_scheduler``: warmup, then ``decay_rate`` at each
    boundary passed."""
    if epoch < warmup_steps:
        return lr_base * (epoch + 1) / (warmup_steps + 1)
    return lr_base * decay_rate ** int(np.sum(epoch >= np.array(lr_decay_steps)))


def exp_scheduler(epoch, lr_base=0.1, decay_step=1, decay_rate=0.9, lr_min=0.0, warmup_steps=0):
    """kecam ``exp_scheduler``: ``lr_base * decay_rate**(epoch / decay_step)``,
    at least ``lr_min``, after a warmup."""
    if epoch < warmup_steps:
        return (lr_base - lr_min) * (epoch + 1) / (warmup_steps + 1)
    lr = lr_base * decay_rate ** (epoch / decay_step)
    return lr if lr > lr_min else lr_min


def multistep_schedule(epoch, lr_base, boundaries: Sequence[int], decay_rate=0.1,
                       warmup_epochs=0):
    """tfimm's multistep schedule."""
    if epoch < warmup_epochs:
        return lr_base * (epoch + 1) / (warmup_epochs + 1)
    return lr_base * decay_rate ** int(np.sum(epoch >= np.array(boundaries)))
