"""Optimizers as plain tensor functions that mirror optax (counterpart of
``vip_cup_2022_tpu/train/optimizers.py``).

``create_optimizer(name, ...)`` builds, as the JAX factory does with optax,
the chain: clip by global norm (when ``grad_clip_norm``) -> decoupled weight
decay ``g + wd * p`` (sgd, sgdw and rmsprop, so the decay passes through the
momentum) -> the optimizer (sgd / sgdw: momentum trace; rmsprop: scale by
``rsqrt(nu + eps)`` then the trace; adam; adamw: adam, decay; lamb: adam
with eps 1e-6, decay, trust ratio), each ending in the sign flip of
``scale_by_learning_rate(1)``: the optimizer is built at learning rate 1 and
the trainer multiplies its updates by the step's lr, as the JAX trainer
does. Not ``torch.optim``: its defaults, its RMSprop (eps outside the root)
and its missing LAMB differ from optax.

Parameters, gradients and updates are flat dicts of tensors under the same
keys; ``mask`` (same keys, bool) says where the weight decay applies, from
:func:`weight_decay_mask` on the Flax names. The state is the port's own
layout: ``{"count": int64 tensor, "mu" / "nu" / "trace": {key: tensor}}``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

# kecam's excludes: bn gamma / beta, biases, positional embeddings, layer scales
DEFAULT_NO_DECAY = (
    "gamma",
    "beta",
    "bias",
    "gain",
    "positional_embedding",
    "pos_emb",
    "relative_position_bias_table",
    "cls_token",
    "moving_mean",
    "moving_variance",
    "vv",
    "weight",  # ChannelAffine layer-scale
    "gamma1",
    "gamma2",
)

OPTIMIZERS = ("sgd", "sgdw", "rmsprop", "adam", "adamw", "lamb")
RMSPROP_DECAY = 0.9  # the JAX factory's default ``rho``
Tensors = Dict[str, torch.Tensor]


def weight_decay_mask(params: Mapping, no_decay_names: Sequence[str] = DEFAULT_NO_DECAY) -> Dict:
    """The nested tree of bools over a Flax-named params tree: True where the
    leaf's name is not in ``no_decay_names`` and it has two or more axes."""
    return {k: (weight_decay_mask(v, no_decay_names) if isinstance(v, Mapping)
                else (k not in no_decay_names and len(getattr(v, "shape", ())) >= 2))
            for k, v in params.items()}


def global_norm(tensors: Tensors) -> torch.Tensor:
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors.values()))


class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)`` of one of :data:`OPTIMIZERS` at learning rate 1.
    Each element-wise formula runs once over all tensors
    (``torch._foreach_*``), optax's formulas in optax's order."""

    def __init__(self, name: str, weight_decay: float = 0.0, momentum: float = 0.9,
                 grad_clip_norm: Optional[float] = None, mask: Optional[Mapping] = None):
        name = name.lower()
        if name not in OPTIMIZERS:
            raise KeyError(f"unknown optimizer '{name}'")
        self.name, self.weight_decay, self.momentum = name, weight_decay, momentum
        self.grad_clip_norm, self.mask = grad_clip_norm, mask
        self.eps = 1e-6 if name == "lamb" else 1e-8

    def init(self, params: Tensors) -> Dict:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        state = {"count": torch.zeros((), dtype=torch.int64)}  # on the host
        if self.name in ("adam", "adamw", "lamb"):
            state.update(mu=zeros(), nu=zeros())
        else:
            state["trace"] = zeros()
            if self.name == "rmsprop":
                state["nu"] = zeros()
        return state

    def _decay(self, keys: list, u: list, params: Tensors) -> None:
        """u += wd * p where the mask allows, in place."""
        pick = [i for i, k in enumerate(keys) if self.mask is None or self.mask[k]]
        if pick:
            torch._foreach_add_([u[i] for i in pick], [params[keys[i]] for i in pick],
                                alpha=self.weight_decay)

    def _trace(self, keys: list, u: list, trace: Tensors) -> list:
        """optax ``trace`` (no Nesterov): t = g + m t, the update and the
        new state."""
        return torch._foreach_add(u, [trace[k] for k in keys], alpha=self.momentum)

    @staticmethod
    def _moment(keys: list, g: list, old: Tensors, decay: float, order: int) -> list:
        """(1 - decay) g^order + decay old."""
        if order == 2:
            gk = torch._foreach_mul(g, g)
            torch._foreach_mul_(gk, 1 - decay)
        else:
            gk = torch._foreach_mul(g, 1 - decay)
        torch._foreach_add_(gk, torch._foreach_mul([old[k] for k in keys], decay))
        return gk

    def update(self, grads: Tensors, state: Dict, params: Tensors) -> tuple:
        keys = list(grads)
        u = [grads[k] for k in keys]
        if self.grad_clip_norm:
            g_norm = global_norm(grads)
            if not g_norm < self.grad_clip_norm:
                u = torch._foreach_div(u, g_norm)
                torch._foreach_mul_(u, self.grad_clip_norm)
        if self.weight_decay and self.name in ("sgd", "sgdw", "rmsprop"):
            u = list(u) if self.grad_clip_norm else [t.clone() for t in u]
            self._decay(keys, u, params)
        count = state["count"] + 1
        new_state = {"count": count}
        if self.name in ("sgd", "sgdw"):
            trace = self._trace(keys, u, state["trace"])
            new_state["trace"] = dict(zip(keys, trace))
            u = torch._foreach_neg(trace)
        elif self.name == "rmsprop":
            nu = self._moment(keys, u, state["nu"], RMSPROP_DECAY, 2)
            scaled = torch._foreach_add(nu, self.eps)
            torch._foreach_rsqrt_(scaled)
            u = self._trace(keys, torch._foreach_neg(torch._foreach_mul(scaled, u)),
                            state["trace"])
            new_state.update(nu=dict(zip(keys, nu)), trace=dict(zip(keys, u)))
        else:
            b1, b2 = 0.9, 0.999
            mu = self._moment(keys, u, state["mu"], b1, 1)
            nu = self._moment(keys, u, state["nu"], b2, 2)
            c = np.float32(int(count))  # bias corrections in f32, as optax computes them
            bc1, bc2 = float(1 - np.float32(b1) ** c), float(1 - np.float32(b2) ** c)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if self.name in ("adamw", "lamb") and self.weight_decay:
                self._decay(keys, u, params)
            if self.name == "lamb":
                u = [t * _trust_ratio(params[k], t) for k, t in zip(keys, u)]
            torch._foreach_neg_(u)
            new_state.update(mu=dict(zip(keys, mu)), nu=dict(zip(keys, nu)))
        return dict(zip(keys, u)), new_state


def _trust_ratio(param: torch.Tensor, update: torch.Tensor) -> torch.Tensor:
    """optax ``scale_by_trust_ratio``: ||p|| / ||u||, 1 where either is 0."""
    pn, un = torch.linalg.vector_norm(param), torch.linalg.vector_norm(update)
    zero = (pn == 0) | (un == 0)
    return torch.where(zero, torch.ones((), dtype=param.dtype, device=param.device), pn / un)


def create_optimizer(name: str, weight_decay: float = 0.0, momentum: float = 0.9,
                     grad_clip_norm: Optional[float] = None,
                     mask: Optional[Mapping] = None) -> Optimizer:
    """name in :data:`OPTIMIZERS`, at learning rate 1; ``mask`` (flat, the
    params' keys) applies the decay where True (everywhere when None), as
    the JAX factory's mask does when ``weight_decay`` is set."""
    return Optimizer(name, weight_decay, momentum, grad_clip_norm,
                     mask if weight_decay else None)
