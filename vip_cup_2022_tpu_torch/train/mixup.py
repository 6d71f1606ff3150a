"""Mixup and CutMix batch augments (counterpart of
``vip_cup_2022_tpu/train/mixup.py``, kecam's ``imagenet/data.py``).

Every random draw is an argument: mixup's per-sample weights ``w`` and
pairing ``perm``; cutmix's batch weight ``w0``, box centre ``(cy, cx)`` and
``perm``; the switch's uniform ``u``. A draw left None comes from
``generator`` (a CPU ``torch.Generator``; torch's default when None) and is
moved to the images' device. The tests hand in JAX's draws, since JAX's keys
cannot be reproduced in torch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def sample_beta(shape, alpha0: float, alpha1: float,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Beta(alpha1, alpha0) as g1 / (g1 + g2) of two gamma draws, f32, CPU."""
    g1 = torch._standard_gamma(torch.full(shape, float(alpha1)), generator=generator)
    g2 = torch._standard_gamma(torch.full(shape, float(alpha0)), generator=generator)
    return g1 / (g1 + g2)


def _perm(b: int, perm, generator) -> torch.Tensor:
    return torch.randperm(b, generator=generator) if perm is None else torch.tensor(perm)


def mixup(images: torch.Tensor, labels: torch.Tensor, alpha: float = 0.4,
          min_mix_weight: float = 0.0, w=None, perm=None,
          generator: Optional[torch.Generator] = None) -> Pair:
    """Per-sample weights ``max(w, 1 - w)`` (1 above ``1 - min_mix_weight``)
    mix each image and label with the ``perm``-th; labels in f32."""
    b, dev = images.shape[0], images.device
    w = sample_beta((b,), alpha, alpha, generator) if w is None else torch.tensor(w)
    w = torch.maximum(w, 1.0 - w).float()
    if min_mix_weight > 0:
        w = torch.where(w > 1.0 - min_mix_weight, torch.ones_like(w), w)
    perm = _perm(b, perm, generator).to(dev)
    w = w.to(dev)
    iw = w.reshape(b, 1, 1, 1).to(images.dtype)
    lw = w.reshape(b, 1)
    labels = labels.float()
    return images * iw + images[perm] * (1.0 - iw), labels * lw + labels[perm] * (1.0 - lw)


def cutmix(images: torch.Tensor, labels: torch.Tensor, alpha: float = 0.5,
           min_mix_weight: float = 0.0, w0=None, cy=None, cx=None, perm=None,
           generator: Optional[torch.Generator] = None) -> Pair:
    """One box a batch: half sides ``max(int(sqrt(1 - w0) / 2 * side), 1)``
    around ``(cy, cx)``, clipped at the borders; inside it each image takes
    the ``perm``-th's pixels, and the labels mix by the clipped box's area.
    Skipped (f32 labels unmixed) where that weight or its complement is
    below ``min_mix_weight``."""
    b, hh, ww, _ = images.shape
    dev = images.device
    w0 = float(sample_beta((), alpha, alpha, generator) if w0 is None else w0)
    cy = int(torch.randint(0, hh, (), generator=generator) if cy is None else cy)
    cx = int(torch.randint(0, ww, (), generator=generator) if cx is None else cx)
    perm = _perm(b, perm, generator).to(dev)
    cut_half = torch.sqrt(torch.tensor(1.0 - w0, dtype=torch.float32)) / 2.0
    ch = max(int(cut_half * hh), 1)
    cw = max(int(cut_half * ww), 1)
    yl, yr = min(max(cy - ch, 0), hh), min(max(cy + ch, 0), hh)
    xl, xr = min(max(cx - cw, 0), ww), min(max(cx + cw, 0), ww)
    w = 1.0 - torch.tensor(float((yr - yl) * (xr - xl)), dtype=torch.float32) / float(hh * ww)
    labels = labels.float()
    if min_mix_weight > 0 and (w < min_mix_weight or 1.0 - w < min_mix_weight):
        return images, labels
    mixed = images.clone()
    mixed[:, yl:yr, xl:xr] = images[perm][:, yl:yr, xl:xr]
    w = w.to(dev)
    return mixed, labels * w + labels[perm] * (1.0 - w)


def mixup_cutmix(images: torch.Tensor, labels: torch.Tensor, mixup_alpha: float = 0.1,
                 cutmix_alpha: float = 1.0, switch_prob: float = 0.5, u=None,
                 mixup_draws: Optional[dict] = None, cutmix_draws: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None) -> Pair:
    """With both alphas in (0, 1]: mixup where the uniform ``u`` exceeds
    ``switch_prob``, else cutmix; with one, that one; else unchanged.
    ``mixup_draws`` / ``cutmix_draws`` pass each op's draws by name."""
    use_mixup, use_cutmix = 0 < mixup_alpha <= 1, 0 < cutmix_alpha <= 1
    if use_mixup and use_cutmix:
        u = float(torch.rand((), generator=generator) if u is None else u)
        use_mixup, use_cutmix = u > switch_prob, not u > switch_prob
    if use_mixup:
        return mixup(images, labels, mixup_alpha, generator=generator, **(mixup_draws or {}))
    if use_cutmix:
        return cutmix(images, labels, cutmix_alpha, generator=generator, **(cutmix_draws or {}))
    return images, labels
