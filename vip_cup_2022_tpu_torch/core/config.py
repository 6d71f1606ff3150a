"""Untyped attribute-bag config that the CLI populates imperatively.

Counterpart of ``vip_cup_2022_tpu/core/config.py::Config`` (itself the
reference ``utils/config.py:4-6``). The typed dataclass/YAML system of that
module serves training and is not part of the inference port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class Config:
    """Untyped attribute-bag config."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.__dict__.update(**(data or {}))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Config({self.__dict__!r})"
