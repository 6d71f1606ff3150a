"""GCViT, Global Context Vision Transformer (ensemble member ``GCViTTiny-224x224``).

Counterpart of ``vip_cup_2022_tpu/models/gcvit.py``, NHWC throughout:

- stem: 3x3 stride-2 conv with bias, then ReduceSize(keep_dim);
- ReduceSize: LN -> [dw3x3, GELU, SE, 1x1] residual -> 3x3 strided conv -> LN;
- level: FitWindow centred pad, the FeatExtract pyramid that makes the
  level's global query (zero pad then a 3x3 stride-2 max pool, no LN, no
  projection), then the blocks, window reverse, crop, and ReduceSize down to
  the next level;
- block (odd blocks with the global query), on one of two paths that read
  the same parameters (:func:`_use_fused_block` picks):
  - fused: on window-ordered tokens (partitioned once per level), through
    the kernels of :mod:`..ops.kernels.gcvit_block`; the residual after
    attention stays f32 into LN2, as on the TPU; under
    ``VIPTPU_INT8_KERNELS=1`` the blocks at least
    ``VIPTPU_GCVIT_INT8_MIN_C`` (128) wide run their dense GEMMs int8
    (:class:`GCViTBlock`); in f32 every kernel has its f32 mode;
    ``VIPTPU_GCVIT_MM`` is read here as the JAX model reads it
    (:func:`gcvit_mm_dtype`): the blocks' GEMMs in that dtype, the
    activations in the compute dtype (the kernels' mixed modes);
  - unfused (the JAX package's Flax path): on NHWC, LN1 -> window partition
    -> :class:`..ops.attention.WindowAttention` (the window-attention kernel
    of :mod:`..ops.kernels.window_attention`) -> window reverse -> residual
    in the compute dtype, then LN2 -> :class:`..ops.mlp.Mlp` -> residual;
- head: LN -> global average pool in f32 -> f32 Linear -> activation.

Training (``model.train()``) runs the unfused path, as the JAX package
does: each block's branches through DropPath at the rates ``linspace(0,
drop_path_rate, sum(depths))`` in block order, dropout at ``drop_rate``
after the stem, in the MLP and after the attention's projection, and at
``attn_drop`` on the attention's probabilities; the rel-pos bias gathered
from each table inside the graph; K8, K9 and K10 under autograd. Returning
to eval mode regathers every dense bias from its table
(:meth:`..ops.attention.WindowAttention.train`), so serving after training
reads the trained tables. The fused path casts the weights to the compute
dtype, so a model trained with f32 parameters serves on it too.

Module and parameter names follow the Flax paths (``patch_embed.conv_down.
conv_2.fc_0``, ``levels_0.blocks_1.attn.relative_position_bias_table``, ...),
so the weight bridge maps a Flax variables tree onto :meth:`state_dict` by
renaming leaves only. The dense (heads, N, N) rel-pos bias of each block is
gathered from its table once, after weights are loaded or drawn, and kept as
a buffer outside the state dict. Every LN runs the LN kernel of
:mod:`..ops.kernels.layernorm`; the convs, SE, the qkv / proj / MLP Linears
of the unfused block and the head stay plain PyTorch, as the JAX package
leaves them to XLA.

int8 PTQ (:mod:`..quant.ptq`) finds the JAX pass's sites on either block
path (``int8_sites_match_jax``): the ReduceSize ``reduction`` and the
``conv_3`` of each ReduceSize / FeatExtract branch, the SE's ``fc_0`` /
``fc_2`` where they pass the width rule at a batch of two or more (their
rows are the batch), and on the unfused path each block's MLP ``fc1`` /
``fc2``; the attention's Linears are skipped by name, and on the fused path
the block kernels read the block's Linears without calling them, so they
are no sites, as the JAX pass never sees the parameters a Pallas block
reads.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.act import apply_activation, gelu_exact
from ..ops.attention import WindowAttention
from ..ops.conv import Conv, DepthwiseConv, Linear, lecun_normal_
from ..ops.drop import DropPath, Dropout
from ..ops.kernels.block_int8 import window_transformer_block_int8
from ..ops.kernels.gcvit_block import window_transformer_block
from ..ops.mlp import Mlp
from ..ops.norms import LayerNorm
from ..ops.window import crop_from_window, fit_window_pad, window_partition, window_reverse
from ..quant import dyn_int8
from .base import ModelConfig, preprocess_input
from .registry import register_model

EPS = 1e-5  # every LayerNorm of GCViT


@dataclasses.dataclass(frozen=True)
class GCViTConfig(ModelConfig):
    window_size: Tuple[int, ...] = (7, 7, 14, 7)
    dim: int = 64
    depths: Tuple[int, ...] = (3, 4, 19, 5)
    num_heads: Tuple[int, ...] = (2, 4, 8, 16)
    mlp_ratio: float = 3.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    attn_drop: float = 0.0
    drop_path_rate: float = 0.2
    layer_scale: Optional[float] = None
    # the team's pipeline feeds [0, 1] straight in (no mean/std inside gcvit-tf)
    mean: Optional[Tuple[float, ...]] = None
    std: Optional[Tuple[float, ...]] = None
    classifier_activation: Optional[str] = "softmax"
    # the block path: None = auto (fused unless VIPTPU_NO_FUSED_BLOCK is
    # set), or force the fused (True) or the unfused (False) block
    fused_block: Optional[bool] = None


def _use_fused_block(cfg: GCViTConfig, training: bool,
                     device: Optional[torch.device] = None) -> bool:
    """Whether the blocks take the fused path, as the JAX package decides:
    never when training or with dropout, else ``cfg.fused_block`` when set,
    else not when ``VIPTPU_NO_FUSED_BLOCK`` is set. The same in either
    compute dtype on any ``device`` (the input's): the fused blocks have f32
    kernels on CUDA. The auto case differs: the port is fused on the CPU and
    on CUDA alike, where the JAX package is fused only on a TPU, so on the
    CPU it runs the unfused path."""
    del device
    if training or cfg.drop_rate or cfg.attn_drop:
        return False
    if cfg.fused_block is not None:
        return cfg.fused_block
    return not os.environ.get("VIPTPU_NO_FUSED_BLOCK")


# VIPTPU_GCVIT_MM's values as the JAX model reads them on its fused path
GCVIT_MM = {"bf16": torch.bfloat16, "f32": torch.float32}


def gcvit_mm_dtype(dtype: torch.dtype) -> torch.dtype:
    """The fused blocks' GEMM dtype under ``VIPTPU_GCVIT_MM``, which the JAX
    model's fused path reads as its kernels' ``force_mm_dtype``: ``bf16`` or
    ``f32``, else (unset, or a value the JAX model ignores too) the compute
    ``dtype``. The activations keep ``dtype`` either way."""
    return GCVIT_MM.get(os.environ.get("VIPTPU_GCVIT_MM", ""), dtype)


class SE(nn.Module):
    """GCViT's SE: f32 spatial mean cast back, bias-free Dense C -> C/4,
    exact GELU, Dense C/4 -> C, sigmoid, channel scale."""

    def __init__(self, dim: int, dtype: torch.dtype, expansion: float = 0.25):
        super().__init__()
        self.fc_0 = Linear(dim, int(dim * expansion), dtype, bias=False)
        self.fc_2 = Linear(int(dim * expansion), dim, dtype, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(1, 2)).to(x.dtype)
        s = torch.sigmoid(self.fc_2(gelu_exact(self.fc_0(s))))
        return x * s[:, None, None, :]


class _ConvBranch(nn.Module):
    """Holds the residual branch x + conv_3(SE(GELU(dw3x3(x)))) that
    ReduceSize and FeatExtract share, under the Flax names conv_0, conv_2,
    conv_3 (direct children, as in the Flax tree)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.conv_0 = DepthwiseConv(dim, 3, 1, dtype)
        self.conv_2 = SE(dim, dtype)
        self.conv_3 = Conv(dim, dim, 1, dtype=dtype, bias=False)

    def branch(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_3(self.conv_2(gelu_exact(self.conv_0(x))))


class ReduceSize(_ConvBranch):
    def __init__(self, dim: int, keep_dim: bool, dtype: torch.dtype, first_strides: int = 2):
        super().__init__(dim, dtype)
        dim_out = dim if keep_dim else 2 * dim
        self.norm1 = LayerNorm(dim, eps=EPS)
        self.reduction = Conv(dim, dim_out, 3, stride=first_strides, dtype=dtype, padding=1,
                              bias=False)
        self.norm2 = LayerNorm(dim_out, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm2(self.reduction(self.branch(self.norm1(x))))


class FeatExtract(_ConvBranch):
    def __init__(self, dim: int, keep_dim: bool, dtype: torch.dtype):
        super().__init__(dim, dtype)
        self.keep_dim = keep_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.branch(x)
        if self.keep_dim:
            return x
        # zero padding, then a VALID pool (max_pool2d's own padding is -inf)
        x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
        return F.max_pool2d(x, 3, 2).permute(0, 2, 3, 1).contiguous()


class Stem(nn.Module):
    def __init__(self, cin: int, dim: int, dtype: torch.dtype, first_strides: int):
        super().__init__()
        self.proj = Conv(cin, dim, 3, stride=2, dtype=dtype, padding=1)
        self.conv_down = ReduceSize(dim, True, dtype, first_strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_down(self.proj(x))


class GCViTBlock(nn.Module, dyn_int8.Int8Block):
    """One block on the fused or the unfused path. Under
    ``VIPTPU_INT8_KERNELS=1`` a fused block at least
    ``VIPTPU_GCVIT_INT8_MIN_C`` (128) wide runs its qkv, proj, fc1 and fc2
    GEMMs int8 (:func:`..ops.kernels.block_int8.window_transformer_block_int8`;
    the attention stays in the GEMM dtype), the weights quantized once
    from their f32 values (:class:`..quant.dyn_int8.Int8Block`). The fused
    block's GEMMs take ``mm_dtype`` (:func:`gcvit_mm_dtype`): the weights in
    the compute dtype, rounded to bf16 from f32 parameters, or, for f32 GEMMs
    in a bf16 block, the f32 values the parameters were cast from
    (:meth:`..quant.dyn_int8.Int8Block.f32_weights`), never a bf16 weight
    cast back up."""

    INT8_LINEARS = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")

    def __init__(self, cfg: GCViTConfig, dim: int, heads: int, window: int, global_query: bool,
                 path_drop: float = 0.0):
        super().__init__()
        self.dim, self.window, self.dtype = dim, window, cfg.dtype
        self.norm1 = LayerNorm(dim, eps=EPS)
        self.attn = WindowAttention(dim, heads, window, global_query, cfg.dtype, cfg.qk_scale,
                                    attn_drop=cfg.attn_drop, proj_drop=cfg.drop_rate)
        self.norm2 = LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), dtype=cfg.dtype, drop_rate=cfg.drop_rate)
        self.drop_path1 = DropPath(path_drop)
        self.drop_path2 = DropPath(path_drop)
        self.layer_scale = cfg.layer_scale is not None
        if self.layer_scale:
            self.gamma1 = nn.Parameter(torch.full((dim,), cfg.layer_scale))
            self.gamma2 = nn.Parameter(torch.full((dim,), cfg.layer_scale))
        else:  # gamma = 1, passed to the kernels as a vector all the same
            self.register_buffer("gamma1", torch.ones(dim), persistent=False)
            self.register_buffer("gamma2", torch.ones(dim), persistent=False)

    def mm_weights(self, mm_dtype: torch.dtype) -> dict:
        """The four Linears' weights in the GEMM dtype ``mm_dtype``."""
        if mm_dtype == torch.float32 and any(
                self.get_submodule(n).weight.dtype != torch.float32 for n in self.INT8_LINEARS):
            return self.f32_weights()
        return {n: self.get_submodule(n).weight.to(mm_dtype) for n in self.INT8_LINEARS}

    def forward(self, x: torch.Tensor, q_global: Optional[torch.Tensor],
                fused: bool = True, mm_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Fused: x window-ordered tokens (B, nWin*N, C), the GEMMs in
        ``mm_dtype`` (default the compute dtype). Unfused: x NHWC (B, H, W,
        C). q_global (B, N, C) or None."""
        if not fused:
            return self._unfused(x, q_global)
        a, mm = self.attn, mm_dtype or self.dtype
        if dyn_int8.gcvit_int8(self.dim):
            w = self.int8_weights()
            return window_transformer_block_int8(
                x, q_global, n=self.window * self.window,
                ln1_weight=self.norm1.weight, ln1_bias=self.norm1.bias, qkv=w["attn.qkv"],
                bqkv=a.qkv.bias, bias=a.bias_dense, proj=w["attn.proj"], bp=a.proj.bias,
                gamma1=self.gamma1, ln2_weight=self.norm2.weight, ln2_bias=self.norm2.bias,
                fc1=w["mlp.fc1"], b1=self.mlp.fc1.bias, fc2=w["mlp.fc2"], b2=self.mlp.fc2.bias,
                gamma2=self.gamma2, scale=a.scale, eps=EPS, mm_dtype=mm)
        w = self.mm_weights(mm)
        splits = {}
        if mm == torch.float32 and x.device.type != "cpu":  # the 3xTF32 GEMMs' weight pairs
            splits = {f"{key}_split": self.tf32_weight(name) for key, name in (
                ("wqkv", "attn.qkv"), ("wp", "attn.proj"), ("w1", "mlp.fc1"), ("w2", "mlp.fc2"))}
        return window_transformer_block(
            x, q_global, n=self.window * self.window,
            ln1_weight=self.norm1.weight, ln1_bias=self.norm1.bias,
            wqkv=w["attn.qkv"], bqkv=a.qkv.bias, bias=a.bias_dense,
            wp=w["attn.proj"], bp=a.proj.bias, gamma1=self.gamma1,
            ln2_weight=self.norm2.weight, ln2_bias=self.norm2.bias,
            w1=w["mlp.fc1"], b1=self.mlp.fc1.bias, w2=w["mlp.fc2"], b2=self.mlp.fc2.bias,
            gamma2=self.gamma2, scale=a.scale, eps=EPS, mm_dtype=mm, **splits)

    def _unfused(self, x: torch.Tensor, q_global: Optional[torch.Tensor]) -> torch.Tensor:
        """The Flax block: both residuals in x's dtype, each branch through
        its DropPath; gamma multiplies only with a layer scale (a Python 1.0
        in the JAX package otherwise, which keeps the bf16 residual bf16)."""
        b, h, w, c = x.shape
        ws = self.window
        y = window_partition(self.norm1(x), ws).reshape(-1, ws * ws, c)
        y = window_reverse(self.attn(y, q_global).reshape(-1, ws, ws, c), ws, h, w)
        x = x + self.drop_path1(y * self.gamma1 if self.layer_scale else y)
        m = self.mlp(self.norm2(x))
        return x + self.drop_path2(self.gamma2 * m if self.layer_scale else m)


class GCViTLevel(nn.Module):
    def __init__(self, cfg: GCViTConfig, dim: int, depth: int, heads: int, window: int,
                 keep_dims: Tuple[bool, ...], downsample: bool, path_drops: Tuple[float, ...]):
        super().__init__()
        self.window, self.depth, self.n_feat = window, depth, len(keep_dims)
        for i, keep in enumerate(keep_dims):
            self.add_module(f"q_global_gen_to_q_global_{i}", FeatExtract(dim, keep, cfg.dtype))
        for i in range(depth):
            self.add_module(f"blocks_{i}", GCViTBlock(cfg, dim, heads, window, bool(i % 2),
                                                      path_drops[i]))
        self.downsample = ReduceSize(dim, False, cfg.dtype) if downsample else None

    def forward(self, x: torch.Tensor, fused: bool = True,
                mm_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        ws = self.window
        x, h, w = fit_window_pad(x, ws)
        b, hp, wp, c = x.shape
        q = x
        for i in range(self.n_feat):
            q = getattr(self, f"q_global_gen_to_q_global_{i}")(q)
        q_global = q.reshape(b, ws * ws, c).contiguous()
        if fused:  # partition once per level, as the JAX package hoists it
            x = window_partition(x, ws).reshape(b, -1, c).contiguous()
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x, q_global if i % 2 else None, fused, mm_dtype)
        if fused:
            x = window_reverse(x.reshape(-1, ws, ws, c), ws, hp, wp)
        x = crop_from_window(x, h, w)
        if self.downsample is not None:
            x = self.downsample(x.contiguous())
        return x


class GCViT(nn.Module):
    int8_sites_match_jax = True
    reads_gcvit_mm = True  # VIPTPU_GCVIT_MM sets its fused blocks' GEMM dtype

    def __init__(self, cfg: GCViTConfig):
        super().__init__()
        if not cfg.qkv_bias:
            raise NotImplementedError("GCViT without a qkv bias is not ported; every "
                                      "registered variant has one")
        self.cfg = cfg
        self.patch_embed = Stem(cfg.in_channels, cfg.dim, cfg.dtype, cfg.first_strides)
        self.drop = Dropout(cfg.drop_rate)
        keep_dims = [(False, False, False), (False, False), (True,), (True,)]
        path_drops = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths)).tolist()
        for i, depth in enumerate(cfg.depths):
            lo = sum(cfg.depths[:i])
            self.add_module(f"levels_{i}", GCViTLevel(
                cfg, cfg.dim * 2 ** i, depth, cfg.num_heads[i], cfg.window_size[i],
                keep_dims[i], downsample=i < len(cfg.depths) - 1,
                path_drops=tuple(path_drops[lo:lo + depth])))
        dim_out = cfg.dim * 2 ** (len(cfg.depths) - 1)
        self.norm = LayerNorm(dim_out, eps=EPS)
        if cfg.nb_classes > 0:
            self.head = Linear(dim_out, cfg.nb_classes, torch.float32)
        for m in self.modules():
            if isinstance(m, WindowAttention):
                m.register_load_state_dict_post_hook(lambda module, _: module.gather_bias())

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator``: conv and dense weights normal with
        variance 1 / fan_in, biases 0, LN weight 1 and bias 0, rel-pos tables
        normal with std 0.02, layer scale ``cfg.layer_scale``."""
        for module in self.modules():
            if isinstance(module, (Conv, Linear, DepthwiseConv)):
                lecun_normal_(module, generator)
            elif isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, WindowAttention):
                t = module.relative_position_bias_table
                t.copy_(torch.randn(t.shape, generator=generator) * 0.02)
            elif isinstance(module, GCViTBlock) and self.cfg.layer_scale is not None:
                module.gamma1.fill_(self.cfg.layer_scale)
                module.gamma2.fill_(self.cfg.layer_scale)
        self.gather_bias()

    def gather_bias(self) -> None:
        """Rebuild every block's dense rel-pos bias from its table: after the
        tables are written other than by ``load_state_dict``."""
        for m in self.modules():
            if isinstance(m, WindowAttention):
                m.gather_bias()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) in [0, 1]; returns (B, nb_classes) f32."""
        cfg = self.cfg
        x = preprocess_input(x, cfg).to(cfg.dtype)
        x = self.drop(self.patch_embed(x))
        fused = _use_fused_block(cfg, self.training, x.device)
        mm = gcvit_mm_dtype(cfg.dtype) if fused else None
        for i in range(len(cfg.depths)):
            x = getattr(self, f"levels_{i}")(x, fused, mm)
        x = self.norm(x).float().mean(dim=(1, 2))
        if cfg.nb_classes <= 0:
            return x
        return apply_activation(self.head(x), cfg.classifier_activation)


def _make(name: str, **kw):
    return GCViT, GCViTConfig(name=name, **kw)


# the same variant set as the JAX package's registry, manifest aliases included


@register_model
def gcvit_xxtiny():
    return _make("gcvit_xxtiny", depths=(2, 2, 6, 2), drop_path_rate=0.2)


@register_model
def gcvit_xtiny():
    return _make("gcvit_xtiny", depths=(3, 4, 6, 5), drop_path_rate=0.2)


@register_model
def gcvit_tiny():
    return _make("gcvit_tiny", depths=(3, 4, 19, 5), drop_path_rate=0.2)


@register_model
def gcvit_small():
    return _make("gcvit_small", dim=96, depths=(3, 4, 19, 5), num_heads=(3, 6, 12, 24),
                 mlp_ratio=2.0, drop_path_rate=0.3, layer_scale=1e-5)


@register_model
def gcvit_base():
    return _make("gcvit_base", dim=128, depths=(3, 4, 19, 5), num_heads=(4, 8, 16, 32),
                 mlp_ratio=2.0, drop_path_rate=0.5, layer_scale=1e-5)


@register_model
def GCViTTiny():
    return _make("GCViTTiny", depths=(3, 4, 19, 5), drop_path_rate=0.2)


@register_model
def GCViTBase():
    return _make("GCViTBase", dim=128, depths=(3, 4, 19, 5), num_heads=(4, 8, 16, 32),
                 mlp_ratio=2.0, drop_path_rate=0.5, layer_scale=1e-5)
