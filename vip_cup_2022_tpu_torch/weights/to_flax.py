"""Map a port module onto a Flax variables tree: the inverse of
:mod:`.from_jax`.

The leaf names and layouts follow from the module types:

- :class:`..ops.norms.LayerNorm` / :class:`..ops.norms.BatchNorm` ``weight`` /
  ``bias`` -> ``gamma`` / ``beta``; the BN's ``running_mean`` /
  ``running_var`` -> ``batch_stats`` ``moving_mean`` / ``moving_variance``;
- :class:`..ops.conv.Linear` ``weight`` (out, in) -> ``kernel`` (in, out);
- :class:`..ops.conv.Conv` and :class:`..ops.conv.ScaledStdConv` ``weight``
  OIHW -> ``kernel`` HWIO (grouped or not);
- :class:`..ops.conv.DepthwiseConv` / :class:`..ops.conv.DepthwiseTaps`
  ``weight`` (k, k, C) -> ``kernel`` (k, k, 1, C);
- :class:`..ops.attention.ECA` ``weight`` (O, I, k) -> ``kernel`` (k, I, O);
- any other parameter (``bias``, a layer scale ``gamma``, the rel-pos
  tables, a gain) keeps its name and layout.

Non-persistent buffers (the dense rel-pos bias, a unit layer scale) are not
state and are left out, as :meth:`torch.nn.Module.state_dict` leaves them.
A module path ``levels_0.blocks_1.attn.qkv`` is the Flax path
``("levels_0", "blocks_1", "attn", "qkv")``. The arrays are f32 numpy.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.attention import ECA
from ..ops.conv import Conv, DepthwiseConv, DepthwiseTaps, Linear, ScaledStdConv
from ..ops.norms import BatchNorm, LayerNorm

Path = Tuple[str, ...]

_NORM_LEAVES = {"weight": "gamma", "bias": "beta"}
_STATS_LEAVES = {"running_mean": "moving_mean", "running_var": "moving_variance"}
_KERNEL_LAYOUTS = (Linear, Conv, ScaledStdConv, DepthwiseConv, DepthwiseTaps, ECA)


def _flax_leaf(module: nn.Module, name: str) -> Tuple[str, str]:
    """(collection, Flax leaf name) of one entry of ``module``."""
    if isinstance(module, (LayerNorm, BatchNorm)):
        if name in _STATS_LEAVES:
            return "batch_stats", _STATS_LEAVES[name]
        return "params", _NORM_LEAVES.get(name, name)
    if name == "weight" and isinstance(module, _KERNEL_LAYOUTS):
        return "params", "kernel"
    return "params", name


def _flax_layout(module: nn.Module, name: str, value: torch.Tensor) -> torch.Tensor:
    if name != "weight" or not isinstance(module, _KERNEL_LAYOUTS):
        return value
    if isinstance(module, Linear):
        return value.t()
    if isinstance(module, (Conv, ScaledStdConv)):
        return value.permute(2, 3, 1, 0)
    if isinstance(module, (DepthwiseConv, DepthwiseTaps)):
        return value.unsqueeze(2)
    return value.permute(2, 1, 0)  # ECA


def _entries(model: nn.Module) -> Iterator[Tuple[str, Path, nn.Module, str, torch.Tensor]]:
    """``(state_dict key, (collection, *Flax path), module, name, tensor)``
    of every parameter and persistent buffer of ``model``."""
    for prefix, module in model.named_modules():
        entries = [(n, p) for n, p in module._parameters.items() if p is not None]
        entries += [(n, b) for n, b in module._buffers.items()
                    if b is not None and n not in module._non_persistent_buffers_set]
        modules = tuple(prefix.split(".")) if prefix else ()
        for name, value in entries:
            collection, leaf = _flax_leaf(module, name)
            key = f"{prefix}.{name}" if prefix else name
            yield key, (collection,) + modules + (leaf,), module, name, value


def flax_paths(model: nn.Module) -> Dict[str, Path]:
    """{state_dict key: (collection, *Flax path)}."""
    return {key: path for key, path, *_ in _entries(model)}


def torch_to_flax(model: nn.Module,
                  values: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Dict]:
    """``{"params": ..., "batch_stats": ...}``: the model's state as a Flax
    variables tree of f32 numpy arrays in Flax names and layouts (the
    inverse of :func:`.from_jax.flax_to_torch`). With ``values`` (by
    state_dict key, e.g. gradients), the tree of those tensors in place of
    the model's own, over the keys they cover."""
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, path, module, name, value in _entries(model):
        if values is not None:
            if key not in values:
                continue
            value = values[key]
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if path[-1] in node:
            raise ValueError(f"two state_dict entries map to the Flax path {'/'.join(path)}")
        # a copy (a CPU f32 parameter's numpy() would share its storage), C order,
        # a 0-d leaf kept 0-d
        node[path[-1]] = _flax_layout(module, name, value.detach()).to(
            "cpu", torch.float32, copy=True).contiguous().numpy()
    return tree
