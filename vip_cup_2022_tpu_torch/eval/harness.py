"""The CSV harness (counterpart of ``vip_cup_2022_tpu/eval/harness.py``):
:func:`evaluate_csv` scores a prediction CSV against a labeled input CSV,
:func:`parity_diff` compares two prediction CSVs or arrays."""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import pandas as pd

from .metrics import balanced_accuracy_score


def evaluate_csv(input_csv: str, label_column: str = "label", pred_csv: Optional[str] = None,
                 threshold: float = 0.487, pred_format: str = "auto") -> Dict[str, float]:
    """Balanced accuracy and accuracy of ``pred_csv`` (a ``filename,logit``
    CSV) against the ``label_column`` of ``input_csv``, over the filenames
    both hold. ``pred_format``: ``"binary"`` (the logits are 0 / 1
    decisions, the CLI's output), ``"raw"`` (probabilities, thresholded at
    ``> threshold``) or ``"auto"`` (raw when a logit exceeds 1 or more than
    two values occur; ambiguous for raw probabilities that take two values,
    so name the format)."""
    truth = pd.read_csv(input_csv)
    preds = pd.read_csv(pred_csv)
    merged = truth.merge(preds, on="filename", how="inner", suffixes=("", "_pred"))
    y_true = merged[label_column].values.astype(np.int64)
    logit = merged["logit"].values.astype(np.float64)
    if pred_format == "raw":
        binarize = True
    elif pred_format == "binary":
        binarize = False
    elif pred_format == "auto":
        binarize = logit.max() > 1.0 or len(np.unique(logit)) > 2
    else:
        raise ValueError(f"pred_format must be binary|raw|auto, got {pred_format!r}")
    y_pred = (logit > threshold).astype(np.int64) if binarize else logit.astype(np.int64)
    return {"balanced_accuracy": balanced_accuracy_score(y_true, y_pred),
            "accuracy": float(np.mean(y_true == y_pred)),
            "n": int(len(merged))}


def parity_diff(ours, reference, atol: float = 1e-4) -> Dict[str, float]:
    """Max and mean |ours - reference| and the count above ``atol``; each
    side an array or a CSV path (its ``logit`` column in filename order)."""
    def load(x):
        if isinstance(x, (str, os.PathLike)):
            return pd.read_csv(x).sort_values("filename")["logit"].values.astype(np.float64)
        return np.asarray(x, np.float64)

    diff = np.abs(load(ours) - load(reference))
    return {"max_abs_diff": float(diff.max()),
            "mean_abs_diff": float(diff.mean()),
            "n_exceed_atol": int((diff > atol).sum()),
            "n": int(diff.size)}
