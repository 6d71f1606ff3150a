"""Activations on the port's path: exact GELU, ReLU, swish (SiLU), softmax
over the last axis and sigmoid (counterparts of
``vip_cup_2022_tpu/ops/act.py``'s ``gelu``, ``relu``, ``swish`` / ``silu``,
``softmax`` and ``sigmoid`` entries), and NFNet's variance-preserving
gammas, the port's own copy of that module's ``NON_LINEAR_GAMMA``."""
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


# NFNet variance-preserving gammas (reference nfnets/nfnets.py:23-38)
NON_LINEAR_GAMMA = {
    "identity": 1.0,
    "celu": 1.270926833152771,
    "elu": 1.2716004848480225,
    "gelu": 1.7015043497085571,
    "leaky_relu": 1.70590341091156,
    "log_sigmoid": 1.9193484783172607,
    "log_softmax": 1.0002083778381348,
    "relu": 1.7139588594436646,
    "relu6": 1.7131484746932983,
    "selu": 1.0008515119552612,
    "sigmoid": 4.803835391998291,
    "swish": 1.7881293296813965,  # silu
    "silu": 1.7881293296813965,
    "softsign": 2.338853120803833,
    "softplus": 1.9203323125839233,
    "tanh": 1.5939117670059204,
}
