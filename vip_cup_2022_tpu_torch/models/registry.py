"""Model registry: name -> zero-argument factory of ``(ModuleClass,
ModelConfig)`` (counterpart of ``vip_cup_2022_tpu/models/registry.py`` over
``core/registry.py::Registry``)."""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

from .base import ModelConfig

_MODELS: Dict[str, Callable[[], Tuple[Type, ModelConfig]]] = {}


def register_model(fn: Callable[[], Tuple[Type, ModelConfig]]):
    """Register a factory under its function name."""
    if fn.__name__ in _MODELS:
        raise KeyError(f"duplicate model registry key: {fn.__name__}")
    _MODELS[fn.__name__] = fn
    return fn


def is_model(name: str) -> bool:
    return name in _MODELS


def model_entry(name: str) -> Tuple[Type, ModelConfig]:
    if name not in _MODELS:
        raise KeyError(f"unknown model '{name}'")
    return _MODELS[name]()
