"""Training losses and accuracies (counterpart of
``vip_cup_2022_tpu/train/losses.py``): timm's thresholded binary cross
entropy, label-smoothed categorical cross entropy, the distillation KL, and
the binary and balanced accuracies."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_cross_entropy_timm(y_true: torch.Tensor, y_pred: torch.Tensor,
                              target_threshold: float = 0.0, label_smoothing: float = 0.0,
                              from_logits: bool = True) -> torch.Tensor:
    """BCE with the targets binarized at ``target_threshold`` (soft mixup
    targets become hard), optionally smoothed towards 0.5, mean over the
    classes (last axis). ``from_logits``: log-sigmoid of the logits, else
    the probabilities clipped to [1e-7, 1 - 1e-7]."""
    y_true = (y_true > target_threshold).to(y_pred.dtype)
    if label_smoothing:
        y_true = y_true * (1.0 - label_smoothing) + 0.5 * label_smoothing
    if from_logits:
        log_p, log_not_p = F.logsigmoid(y_pred), F.logsigmoid(-y_pred)
    else:
        p = y_pred.clamp(1e-7, 1.0 - 1e-7)
        log_p, log_not_p = torch.log(p), torch.log(1.0 - p)
    return (-(y_true * log_p + (1.0 - y_true) * log_not_p)).mean(dim=-1)


def categorical_cross_entropy(y_true: torch.Tensor, logits: torch.Tensor,
                              label_smoothing: float = 0.0) -> torch.Tensor:
    """Softmax CE over one-hot or soft targets, smoothed towards uniform;
    the log-softmax in f32."""
    if label_smoothing:
        y_true = y_true * (1.0 - label_smoothing) + label_smoothing / logits.shape[-1]
    return -(y_true * torch.log_softmax(logits.float(), dim=-1)).sum(dim=-1)


def distill_kl_divergence(teacher_prob: torch.Tensor, student_prob: torch.Tensor,
                          temperature: float = 10.0) -> torch.Tensor:
    """KL(teacher || student) of the two inputs softened by a softmax at
    ``temperature``, the logs of probabilities clipped to [1e-7, 1]."""
    t = torch.softmax(teacher_prob / temperature, dim=-1)
    s = torch.softmax(student_prob / temperature, dim=-1)
    return (t * (torch.log(t.clamp(1e-7, 1.0)) - torch.log(s.clamp(1e-7, 1.0)))).sum(dim=-1)


def binary_accuracy(y_true: torch.Tensor, y_pred: torch.Tensor,
                    threshold: float = 0.5) -> torch.Tensor:
    return ((y_pred > threshold) == (y_true > 0.5)).float().mean()


def balanced_accuracy(y_true: torch.Tensor, y_pred: torch.Tensor,
                      threshold: float = 0.5) -> torch.Tensor:
    """The competition metric: the mean of the two classes' recalls, each
    over at least one sample."""
    pred = (y_pred > threshold).float()
    pos = (y_true > 0.5).float()
    tpr = (pred * pos).sum() / pos.sum().clamp(min=1)
    tnr = ((1 - pred) * (1 - pos)).sum() / (1 - pos).sum().clamp(min=1)
    return 0.5 * (tpr + tnr)
