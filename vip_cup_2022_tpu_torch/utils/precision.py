"""f32 that stays f32 on CUDA.

PyTorch lets cuDNN's convs (and, where set, cuBLAS's products) compute f32
in TF32 by default. The f32 compute path (``VIPTPU_DTYPE=float32``, the
reference arm of the bf16 decision-flip check) wants full f32 there, so the
engine's forwards and the trainer's steps run inside :func:`f32_scope`.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32_off():
    """cuDNN's convs and cuBLAS's products in full f32 (no TF32) until exit;
    both flags are restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def f32_scope(device: torch.device, dtype: torch.dtype):
    """The context of a forward (or a training step) in ``dtype`` on
    ``device``: :func:`tf32_off` for f32 on CUDA, where PyTorch's default
    would run the convs in TF32; nothing otherwise."""
    if torch.device(device).type == "cuda" and dtype == torch.float32:
        return tf32_off()
    return contextlib.nullcontext()
