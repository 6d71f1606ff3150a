"""Activations on the port's path: exact GELU, ReLU, swish (SiLU), softmax
over the last axis and sigmoid (counterparts of
``vip_cup_2022_tpu/ops/act.py``'s ``gelu``, ``relu``, ``swish`` / ``silu``,
``softmax`` and ``sigmoid`` entries)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


ACTIVATIONS = {
    None: lambda x: x,
    "gelu": gelu_exact,
    "relu": F.relu,
    "swish": F.silu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def get_activation(name):
    if name not in ACTIVATIONS:
        raise KeyError(f"activation '{name}' is not ported (ported: "
                       f"{sorted(k for k in ACTIVATIONS if k)})")
    return ACTIVATIONS[name]


def apply_activation(x: torch.Tensor, name) -> torch.Tensor:
    return get_activation(name)(x)
