"""Sharpness-Aware Minimization (counterpart of
``vip_cup_2022_tpu/train/sam.py``): the gradient at the parameters, a step
of ``rho * g / ||g||`` along it, the gradient there, and the parameters put
back; first order, as standard SAM."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .optimizers import global_norm

Tensors = Dict[str, torch.Tensor]


def value_and_grad(loss_fn: Callable[[], torch.Tensor], params: Tensors) -> Tuple:
    """``(loss, {key: gradient})`` of ``loss_fn()`` (a closure over the
    tensors of ``params``, which require grad)."""
    loss = loss_fn()
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def sam_gradient(loss_fn: Callable[[], torch.Tensor], params: Tensors, rho: float = 0.05,
                 state: Optional[Tensors] = None) -> Tuple:
    """``(loss, grads)`` of the second pass, at the perturbed parameters.
    ``params`` are updated in place for that pass and restored after.
    ``state`` (e.g. BN running statistics, which each forward moves in
    place) is put back to its value before the first pass, so that after
    the call it holds the second pass's update, as the JAX step returns the
    second pass's statistics."""
    before = {k: t.detach().clone() for k, t in (state or {}).items()}
    _, grads1 = value_and_grad(loss_fn, params)
    scale = rho / (global_norm(grads1) + 1e-12)
    originals = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.add_(grads1[k].to(p.dtype) * scale.to(p.dtype))
        for k, t in (state or {}).items():
            t.copy_(before[k])
    try:
        return value_and_grad(loss_fn, params)
    finally:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(originals[k])
