"""Stochastic depth and dropout (counterparts of ``DropPath`` of
``vip_cup_2022_tpu/ops/drop.py`` and of Flax's ``nn.Dropout``).

Both are the identity in eval mode and at rate 0. In training they draw
their uniforms from the module's ``generator`` (a ``torch.Generator`` on
x's device, set by :func:`set_generator`; torch's default generator when
None), or take them as the ``noise`` argument: the seam through which the
tests hand both frameworks the same numbers, since JAX's keys cannot be
reproduced in torch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def _uniform(module: nn.Module, shape, x: torch.Tensor,
             noise: Optional[torch.Tensor]) -> torch.Tensor:
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {tuple(shape)}")
        return noise.to(device=x.device, dtype=torch.float32)
    return torch.rand(shape, generator=module.generator, device=x.device)


class DropPath(nn.Module):
    """Per-sample stochastic depth: ``mask = floor(keep + u)`` with one f32
    uniform a sample, ``x / keep * mask`` in x's dtype."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        u = _uniform(self, (x.shape[0],) + (1,) * (x.ndim - 1), x, noise)
        return x / keep * torch.floor(keep + u).to(x.dtype)


class Dropout(nn.Module):
    """Flax's ``nn.Dropout``: keep an element where its f32 uniform is below
    ``keep = 1 - rate`` and scale it by ``1 / keep``, else 0; all zeros at
    rate 1."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        u = _uniform(self, x.shape, x, noise)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every :class:`DropPath` and :class:`Dropout` of ``model`` the
    generator its uniforms come from."""
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.generator = generator
