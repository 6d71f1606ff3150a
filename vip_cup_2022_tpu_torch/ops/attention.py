"""Window attention (counterpart of ``vip_cup_2022_tpu/ops/attention.py``):
the relative-position bias (``relative_position_index`` and its dense
``(heads, N, N)`` gather) and the ``WindowAttention`` module; and ECA, the
efficient channel attention of AotNet and NFNet (``_eca`` of
``vip_cup_2022_tpu/models/aotnet.py`` and ``models/nfnets.py``)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv import Linear
from .drop import Dropout
from .kernels import window_attention as attention_kernel


def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(N, N) index into a ((2wh-1)*(2ww-1))-row bias table (GCViT/Swin scheme)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)  # (N, N, 2)
    xx = (rel[:, :, 0] + wh - 1) * (2 * ww - 1)
    yy = rel[:, :, 1] + ww - 1
    return (xx + yy).astype(np.int32)


def dense_relative_position_bias(table: torch.Tensor, window_size: int) -> torch.Tensor:
    """((2ws-1)^2, heads) table -> (heads, N, N) f32 bias, N = ws*ws."""
    n = window_size * window_size
    idx = torch.from_numpy(relative_position_index(window_size, window_size).reshape(-1).astype(np.int64))
    bias = table.float()[idx.to(table.device)].reshape(n, n, -1)
    return bias.permute(2, 0, 1).contiguous()


class WindowAttention(nn.Module):
    """Windowed multi-head self-attention with a relative-position bias, on
    (B*nW, N, C) tokens. With ``global_query`` the qkv projection emits k and
    v only and the per-image query (B, N, C) is repeated over each image's
    windows.

    The dense (heads, N, N) bias: in eval mode the buffer ``bias_dense``
    (outside the state dict), gathered from the table by :meth:`gather_bias`
    after a weight load and on every return to eval mode; in training mode
    gathered from ``relative_position_bias_table`` inside the graph on every
    forward, so the table gets its gradient. The attention is the
    window-attention kernel (under autograd, :func:`..kernels.
    window_attention.window_attention_fn`), except with ``attn_drop`` > 0 in
    training, where it is the JAX package's plain path: scaled q times k in
    the compute dtype, f32 softmax with the bias, dropout, times v.
    ``proj_drop`` drops after the projection in training."""

    def __init__(self, dim: int, heads: int, window: int, global_query: bool,
                 dtype: torch.dtype, qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.window, self.heads, self.global_query = window, heads, global_query
        self.scale = qk_scale or (dim // heads) ** -0.5
        self.qkv = Linear(dim, dim * (2 if global_query else 3), dtype)
        self.proj = Linear(dim, dim, dtype)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        n = window * window
        self.register_buffer("bias_dense", torch.zeros(heads, n, n), persistent=False)

    @torch.no_grad()
    def gather_bias(self) -> None:
        """(Re)build the dense (heads, N, N) bias from the table."""
        self.bias_dense.copy_(dense_relative_position_bias(self.relative_position_bias_table,
                                                           self.window))

    def train(self, mode: bool = True) -> "WindowAttention":
        super().train(mode)
        if not mode:  # the table may have moved while training
            self.gather_bias()
        return self

    def forward(self, x: torch.Tensor, q_global: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B*nW, N, C) -> (B*nW, N, C); ``q_global`` (B, N, C) in
        global-query blocks."""
        b_, n, c = x.shape
        hd = c // self.heads
        parts = 2 if self.global_query else 3
        qkv = self.qkv(x).reshape(b_, n, parts, self.heads, hd).permute(2, 0, 3, 1, 4)
        if self.global_query:
            k, v = qkv[0], qkv[1]
            q = q_global.repeat_interleave(b_ // q_global.shape[0], dim=0)
            q = q.reshape(b_, n, self.heads, hd).transpose(1, 2)
        else:
            q, k, v = qkv[0], qkv[1], qkv[2]
        if not self.training:
            bias = self.bias_dense
        else:
            bias = dense_relative_position_bias(self.relative_position_bias_table, self.window)
        if self.training and self.attn_drop.rate > 0:
            attn = torch.matmul(q * self.scale, k.transpose(-1, -2)).float() + bias
            attn = self.attn_drop(torch.softmax(attn, dim=-1).to(x.dtype))
            out = torch.matmul(attn, v)
        else:
            out = attention_kernel.window_attention_fn(q.contiguous(), k.contiguous(),
                                                       v.contiguous(), bias, self.scale)
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(b_, n, c)))


def eca_kernel_size(channels: int) -> int:
    """ECA's 1-D kernel: ``int((log2 C + 1) / 2)`` made odd (one up), at
    least 3; 5 at C = 256, 512 and 1536."""
    t = int((math.log2(float(channels)) + 1.0) / 2.0)
    return max(t if t % 2 else t + 1, 3)


class ECA(nn.Module):
    """Efficient channel attention on NHWC x: the spatial mean in f32 cast
    to x's dtype, a bias-free 1-D conv over the channels zero-padded by
    k // 2 (the Flax ``conv1d`` kernel (k, 1, 1), held (1, 1, k) in the
    compute dtype), sigmoid, and x times that gate."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(1, 1, eca_kernel_size(channels), dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x.float().mean(dim=(1, 2)).to(self.dtype)
        k = self.weight.shape[-1]
        v = F.conv1d(v.unsqueeze(1), self.weight.to(self.dtype), padding=k // 2).squeeze(1)
        return x * torch.sigmoid(v)[:, None, None, :].to(x.dtype)
