"""The conv-BN fold on Flax variable trees of numpy arrays.

Counterpart of ``vip_cup_2022_tpu/utils/surgery.py``'s ``fuse_conv_bn``,
``discover_conv_bn_pairs`` and ``fuse_all_conv_bn``, on the same trees
(``{"params": ..., "batch_stats": ...}``, as a checkpoint holds them) with
numpy alone, so that the same rule finds the same pairs and the fold gives
the same f32 arrays. The one difference: ``fuse_all_conv_bn`` takes the
eps of each pair's BN (a mapping from the BN's path), as the JAX docstring
asks, where the JAX engine passes one default eps for every member.

A member built with random weights folds the values it holds, read as a
tree by :func:`..weights.to_flax.torch_to_flax`.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from ..ops.norms import BatchNorm
from ..weights import from_jax

Path = Tuple[str, ...]


def _flatten(tree: Mapping) -> Dict[Path, np.ndarray]:
    return {path: v for path, v, _ in from_jax._flatten(tree)}


def _unflatten(flat: Mapping[Path, np.ndarray]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def fuse_conv_bn(variables: Mapping, conv_path: Path, bn_path: Path, eps: float = 1e-5) -> Dict:
    """Fold one BN into its preceding conv: w' = w * gamma / sqrt(var + eps),
    b' = (b - mean) * gamma / sqrt(var + eps) + beta. The BN stays, neutral:
    mean 0, var 1 - eps, gamma 1; the fused bias goes to the conv's bias
    where it has one (beta 0), else to the BN's beta."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    kernel = np.asarray(params[conv_path + ("kernel",)])
    has_bias = conv_path + ("bias",) in params
    bias = (np.asarray(params[conv_path + ("bias",)]) if has_bias
            else np.zeros(kernel.shape[-1], np.float32))
    gamma = np.asarray(params[bn_path + ("gamma",)])
    beta = np.asarray(params[bn_path + ("beta",)])
    mean = np.asarray(stats[bn_path + ("moving_mean",)])
    var = np.asarray(stats[bn_path + ("moving_variance",)])

    scale = gamma / np.sqrt(var + eps)
    fused_bias = (bias - mean) * scale + beta
    params[conv_path + ("kernel",)] = kernel * scale
    params[bn_path + ("gamma",)] = np.ones_like(gamma)
    stats[bn_path + ("moving_mean",)] = np.zeros_like(mean)
    stats[bn_path + ("moving_variance",)] = np.full_like(var, 1.0 - eps)
    if has_bias:
        params[conv_path + ("bias",)] = fused_bias
        params[bn_path + ("beta",)] = np.zeros_like(beta)
    else:
        params[bn_path + ("beta",)] = fused_bias
    out = dict(variables)
    out["params"] = _unflatten(params)
    if stats:
        out["batch_stats"] = _unflatten(stats)
    return out


# a DepthwiseConv module holds its conv as 'dw_conv', toolkit conv wrappers as 'conv'
_CONV_WRAPPER_LEAVES = ("conv", "dw_conv")
_BN_SPELLINGS = ("bn", "batch_norm", "batchnorm")


def discover_conv_bn_pairs(variables: Mapping) -> list:
    """(conv module path, BN module path) pairs by name: a module with a 4-D
    kernel pairs with the BN in the same parent named as the conv with
    'conv' -> 'bn' / 'batch_norm' / 'batchnorm' and as many channels, wrapper
    leaves stripped first; each BN pairs once."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    bns = {p[:-1] for p in stats if p[-1] == "moving_mean"}
    pairs, used = [], set()
    for path in sorted(p for p in params if p[-1] == "kernel" and np.ndim(params[p]) == 4):
        conv_mod = base = path[:-1]
        if len(base) > 1 and base[-1] in _CONV_WRAPPER_LEAVES:
            base = base[:-1]
        name = base[-1]
        if "conv" not in name:
            continue
        for repl in _BN_SPELLINGS:
            cand = base[:-1] + (name.replace("conv", repl),)
            if (cand in bns and cand not in used
                    and np.shape(stats[cand + ("moving_mean",)])[-1]
                    == np.shape(params[path])[-1]):
                pairs.append((conv_mod, cand))
                used.add(cand)
                break
    return pairs


def fuse_all_conv_bn(variables: Mapping, eps: Union[float, Mapping[Path, float]] = 1e-5,
                     pairs=None) -> tuple:
    """Fold every conv -> BN pair (``pairs`` defaults to
    :func:`discover_conv_bn_pairs`); ``eps`` is one value or each BN path's.
    Returns ``(fused variables, pairs)``."""
    if pairs is None:
        pairs = discover_conv_bn_pairs(variables)
    for conv_path, bn_path in pairs:
        e = eps[bn_path] if isinstance(eps, Mapping) else eps
        variables = fuse_conv_bn(variables, conv_path, bn_path, eps=e)
    return variables, pairs


def bn_eps(module: torch.nn.Module) -> Dict[Path, float]:
    """The eps of each of the module's BNs, by its Flax path."""
    return {tuple(name.split(".")): m.eps for name, m in module.named_modules()
            if isinstance(m, BatchNorm)}
