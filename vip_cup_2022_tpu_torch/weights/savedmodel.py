"""TF SavedModel checkpoint reader (counterpart of
``vip_cup_2022_tpu/weights/savedmodel.py``).

The reference loads SavedModel ensemble members via
``tf.keras.models.load_model`` when a manifest entry has no ``.h5``. The
foreign graph is never executed: ``tf.saved_model.load`` restores only the
variable objects, whose names keep the original Keras ``layer/weight``
naming, so the same per-family mappers as the h5 route apply
(:mod:`.keras_h5`).

TensorFlow is imported lazily and only here; without it a clear error
tells the user to convert the checkpoint instead of failing deep inside
msgpack parsing.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .keras_h5 import _dedupe_layer_prefix, apply_weight_mapper


def savedmodel_dir(path: str) -> str:
    """Normalize a manifest-resolved path (``.../saved_model.pb`` or the
    directory containing it) to the SavedModel directory, or '' if not one."""
    if path.endswith("saved_model.pb"):
        return os.path.dirname(path) or "."
    if os.path.isdir(path) and os.path.isfile(os.path.join(path, "saved_model.pb")):
        return path
    return ""


def read_savedmodel(path: str) -> Dict[str, np.ndarray]:
    """Flatten a SavedModel's variables into {'layer/weight': array} with
    ':0' suffixes stripped — the same flat layout :func:`read_keras_h5`
    produces, so the family mappers are shared."""
    try:
        import tensorflow as tf  # noqa: F401 — gated: TF only needed for SavedModel ckpts
    except ImportError as e:
        raise NotImplementedError(
            "loading a SavedModel checkpoint requires TensorFlow, which is "
            "not installed; convert the checkpoint to .h5 or .msgpack instead"
        ) from e

    sm_dir = savedmodel_dir(path) or path
    obj = tf.saved_model.load(sm_dir)
    out: Dict[str, np.ndarray] = {}
    for v in obj.variables:
        key = v.name.split(":")[0]
        out[key] = np.asarray(v.numpy())
    if not out:
        raise ValueError(f"SavedModel at {sm_dir} restored zero variables")
    return out


def convert_savedmodel(path: str, model_name: str, mapper: str = ""):
    """Convert a SavedModel checkpoint to a variables pytree via the family
    mapper (same dispatch as :func:`convert_keras_h5`)."""
    weights = {_dedupe_layer_prefix(k): v for k, v in read_savedmodel(path).items()}
    return apply_weight_mapper(weights, model_name, mapper)
