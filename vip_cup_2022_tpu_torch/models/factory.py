"""Model factory: create a registered model, load a checkpoint, transfer
its weights (counterpart of ``vip_cup_2022_tpu/models/factory.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from ..utils.checkpoint import load_variables
from ..weights.from_jax import state_dict_from_flax
from .base import ModelConfig
from .registry import is_model, model_entry


def create_model(name: str, *, in_channels: Optional[int] = None,
                 nb_classes: Optional[int] = None,
                 input_size: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 param_dtype: Optional[torch.dtype] = None,
                 **kwargs) -> Tuple[nn.Module, ModelConfig]:
    """Build ``(module, cfg)`` for a registered model on the CPU in eval
    mode, its weights drawn from a ``torch.Generator`` seeded with ``seed``.
    ``dtype`` is the compute dtype; the floating parameters are held in
    ``param_dtype`` (``dtype`` when None, as serving holds them; f32 for
    training, Flax's ``param_dtype``). JSON lists among the overrides become
    tuples."""
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
    return module.eval(), cfg


def load_weights(model_path: str) -> Mapping:
    """The Flax variables tree of a native ``.msgpack`` checkpoint."""
    if model_path.endswith((".h5", ".hdf5", ".pt", ".pth", ".bin", ".pb")):
        raise NotImplementedError(
            f"{model_path}: only the native .msgpack format is ported; Keras .h5, "
            "SavedModel and PyTorch checkpoints are ROADMAP item A0")
    return load_variables(model_path)


def transfer_weights(variables: Mapping, module: nn.Module, strict: bool = False) -> nn.Module:
    """Copy a Flax variables tree into ``module`` through the weight bridge.
    Anything uncovered raises; the classifier head may differ (the swap of
    fine-tuning) unless ``strict``, as it may not for a trained fold."""
    module.load_state_dict(state_dict_from_flax(variables, module.state_dict(), strict),
                           strict=True)
    return module
