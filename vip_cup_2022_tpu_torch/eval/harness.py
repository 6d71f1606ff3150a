"""Evaluation harnesses (counterpart of ``vip_cup_2022_tpu/eval/harness.py``):
:func:`evaluate_csv` scores a prediction CSV against a labeled input CSV,
:func:`parity_diff` compares two prediction CSVs or arrays, and
:func:`evaluation` takes the top-1 / top-5 accuracy of a model over an
image list through the central-crop eval loader."""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import pandas as pd

from .metrics import balanced_accuracy_score, top_k_accuracy


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


def evaluation(model, paths, labels, nb_classes: int, batch_size: int = 64,
               target_shape=(224, 224), central_crop: float = 0.95,
               resize_method: str = "bilinear") -> Dict[str, float]:
    """Top-1 and top-5 accuracy of ``model`` (a port module; its weights
    carry what the JAX function's ``variables`` do) over ``paths`` with
    class ids ``labels``: an ``EvalLoader`` (central crop, resize), the
    forward in eval mode without gradients on the model's device, on the
    uint8 batch / 255."""
    import torch

    from ..data.train_pipeline import EvalLoader

    loader = EvalLoader(paths, labels, nb_classes, batch_size, target_shape,
                        central_crop=central_crop, resize_method=resize_method)
    device = next(model.parameters()).device
    model.eval()
    probs, trues = [], []
    try:
        with torch.no_grad():
            for images, onehot in loader:
                x = torch.from_numpy(images).to(device).float() / 255.0
                probs.append(model(x).float().cpu().numpy())
                trues.append(onehot.argmax(-1))
    finally:
        loader.close()
    probs = np.concatenate(probs)
    trues = np.concatenate(trues)
    return {"top1": float(np.mean(probs.argmax(-1) == trues)),
            "top5": top_k_accuracy(trues, probs, k=5),
            "n": int(len(trues))}
