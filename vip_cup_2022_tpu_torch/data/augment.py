"""The shipped test-time augmentation (TTA) as batched PyTorch ops.

Counterpart of ``vip_cup_2022_tpu/data/augment.py``'s ``random_flip``,
``random_gray`` and ``apply_augment``: gate at ``u <= 0.8``, then a
horizontal and a vertical flip at 0.5 each, then BT.601 gray at 0.3, every
decision per sample. Each op is split from its random draw: :func:`flip`,
:func:`gray` and :func:`apply_augment` take explicit per-sample bool masks
of shape (B,), and :func:`draw_masks` draws those masks from an explicit
``torch.Generator``. JAX's PRNG keys cannot be reproduced in torch; a
caller that must match the JAX package's draws passes masks drawn the JAX
way.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

GRAY_W = (0.2989, 0.5870, 0.1140)  # ITU-R BT.601, as tf.image.rgb_to_grayscale
# apply_augment's probabilities: the gate, the two flips, gray
AUGMENT_PROB, HFLIP_PROB, VFLIP_PROB, GRAY_PROB = 0.80, 0.5, 0.5, 0.3


class TTAMasks(NamedTuple):
    """Per-sample decisions of one augmented copy, each a bool (B,)."""
    gate: torch.Tensor
    hflip: torch.Tensor
    vflip: torch.Tensor
    gray: torch.Tensor

    def to(self, device) -> "TTAMasks":
        return TTAMasks(*(m.to(device) for m in self))


def _per_sample(mask: torch.Tensor) -> torch.Tensor:
    return mask.view(-1, 1, 1, 1)


def flip(img: torch.Tensor, hflip: torch.Tensor, vflip: torch.Tensor) -> torch.Tensor:
    """``random_flip``: the samples ``hflip`` marks mirrored along W, then
    those ``vflip`` marks along H; img (B, H, W, C)."""
    img = torch.where(_per_sample(hflip), img.flip(2), img)
    return torch.where(_per_sample(vflip), img.flip(1), img)


def gray(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``random_gray``: the samples ``mask`` marks replaced by their BT.601
    gray in every channel, the weights cast to the image's dtype as the JAX
    op casts them."""
    w = torch.tensor(GRAY_W, dtype=img.dtype, device=img.device)
    g = (img * w).sum(-1, keepdim=True)
    return torch.where(_per_sample(mask), g.expand_as(img), img)


def apply_augment(img: torch.Tensor, masks: TTAMasks) -> torch.Tensor:
    """``apply_augment``: flips and gray where the gate is set, the input
    elsewhere."""
    aug = gray(flip(img, masks.hflip, masks.vflip), masks.gray)
    return torch.where(_per_sample(masks.gate), aug, img)


def draw_masks(generator: torch.Generator, batch: int) -> TTAMasks:
    """The masks of one augmented copy of a batch, from four uniforms a sample
    drawn from ``generator``, with ``apply_augment``'s comparisons."""
    u = torch.rand((4, batch), generator=generator)
    return TTAMasks(u[0] <= AUGMENT_PROB, u[1] < HFLIP_PROB, u[2] < VFLIP_PROB, u[3] < GRAY_PROB)
