"""Model factory: create a registered model, load a checkpoint, transfer
its weights (counterpart of ``vip_cup_2022_tpu/models/factory.py``).

Every checkpoint route yields the Flax variables tree of the model: a
native ``.msgpack``, a Keras ``.h5``, a SavedModel or a timm/PyTorch state
dict, the last three through the family mappers of :mod:`..weights`.
:func:`transfer_weights` carries the tree into the module through the weight
bridge (:func:`..weights.from_jax.state_dict_from_flax`). Unlike the JAX
factory, whose default warns and keeps random init, a leaf the checkpoint
does not cover raises by default.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from ..utils.checkpoint import load_variables
from ..weights.from_jax import state_dict_from_flax
from .base import ModelConfig, preprocess_input
from .registry import is_model, model_entry


def create_model(name: str, pretrained: bool = False, model_path: str = "", *,
                 in_channels: Optional[int] = None,
                 nb_classes: Optional[int] = None,
                 input_size: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 param_dtype: Optional[torch.dtype] = None,
                 **kwargs) -> Tuple[nn.Module, ModelConfig]:
    """Build ``(module, cfg)`` for a registered model on the CPU in eval
    mode, its weights drawn from a ``torch.Generator`` seeded with ``seed``,
    then, with ``model_path``, loaded from that checkpoint (any format of
    :func:`load_weights`; an overridden ``in_channels`` adapts the first
    conv and an overridden ``nb_classes`` swaps the classifier, as
    :func:`transfer_weights` does). ``dtype`` is the compute dtype; the
    floating parameters are held in ``param_dtype`` (``dtype`` when None, as
    serving holds them; f32 for training, Flax's ``param_dtype``). JSON
    lists among the overrides become tuples."""
    if not is_model(name):
        raise KeyError(f"unknown model '{name}'")
    cls, cfg = model_entry(name)
    overrides: Dict[str, Any] = {k: tuple(v) if isinstance(v, list) else v
                                 for k, v in kwargs.items()}
    if in_channels is not None:
        overrides["in_channels"] = in_channels
    if nb_classes is not None:
        overrides["nb_classes"] = nb_classes
    if input_size is not None:
        overrides["input_size"] = tuple(input_size)
    overrides["dtype"] = dtype
    valid = {f.name for f in dataclasses.fields(cfg)}
    unknown = set(overrides) - valid
    if unknown:
        raise TypeError(f"unknown config overrides for {name}: {sorted(unknown)}")
    cfg = cfg.replace(**overrides)
    module = cls(cfg)
    if param_dtype is not None:
        module.to(param_dtype)
    module.init_weights(torch.Generator().manual_seed(seed))
    if model_path:
        transfer_weights(load_weights(model_path, name), module)
    elif pretrained:
        raise NotImplementedError(
            "pretrained-weight download is not wired in this (no-egress) "
            "environment; pass model_path to a local checkpoint instead — "
            ".h5/.msgpack, a SavedModel dir, or a timm/PyTorch .pt/.pth "
            "state dict (weights/torch_pt.py converts on the fly)")
    return module.eval(), cfg


def load_weights(model_path: str, model_name: str = "") -> Mapping:
    """The Flax variables tree of a checkpoint: a Keras ``.h5`` / ``.hdf5``
    (needs ``h5py``), a timm/PyTorch ``.pt`` / ``.pth`` / ``.bin`` state
    dict, a SavedModel directory or its ``saved_model.pb`` (needs
    TensorFlow), a directory holding ``variables.msgpack``, or a native
    ``.msgpack``. The foreign formats go through the mapper registered for
    ``model_name``'s family."""
    from ..weights.savedmodel import savedmodel_dir

    if model_path.endswith((".h5", ".hdf5")):
        from ..weights.keras_h5 import convert_keras_h5

        return convert_keras_h5(model_path, model_name)
    if model_path.endswith((".pt", ".pth", ".bin")):
        from ..weights.torch_pt import convert_torch_weights

        return convert_torch_weights(model_path, model_name)
    if savedmodel_dir(model_path):
        from ..weights.savedmodel import convert_savedmodel

        return convert_savedmodel(model_path, model_name)
    if os.path.isdir(model_path):
        candidate = os.path.join(model_path, "variables.msgpack")
        if os.path.isfile(candidate):
            return load_variables(candidate)
    return load_variables(model_path)


def transfer_weights(variables: Mapping, module: nn.Module, strict: bool = False,
                     adapt_first_conv: bool = True, on_mismatch: str = "raise") -> nn.Module:
    """Copy a Flax variables tree into ``module`` through the weight bridge.
    A conv kernel that differs only in its input channels is adapted
    (``adapt_first_conv``: summed for 1 channel, tiled and rescaled for N).
    The classifier head may differ (the swap of fine-tuning) unless
    ``strict``, as it may not for a trained fold. Any other uncovered leaf
    raises (``on_mismatch="raise"``, the default) or keeps the module's
    value, with a warning (``"warn"``, the JAX factory's default) or
    without (``"silent"``)."""
    module.load_state_dict(state_dict_from_flax(variables, module.state_dict(), strict,
                                                adapt_first_conv, on_mismatch), strict=True)
    return module


def create_preprocessing(cfg: ModelConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """The [0, 1] -> normalized preprocessing function of a model (the JAX
    factory's, tfimm's ``create_preprocessing``)."""

    def fn(x: torch.Tensor) -> torch.Tensor:
        return preprocess_input(x, cfg)

    return fn
