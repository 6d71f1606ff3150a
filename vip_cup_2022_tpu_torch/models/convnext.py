"""ConvNeXt (ensemble member ``convnext_tiny_in22k-200x200``).

Counterpart of ``vip_cup_2022_tpu/models/convnext.py``, NHWC throughout:

- stem: conv patch_size x patch_size, stride ``first_down * 2`` (the team's
  stride-2 stem: 200 px -> 99 x 99 x 96), then LN;
- stage j > 0: LN + 2x2 stride-2 conv downsample, then the blocks;
- block: ``x + gamma * fc2(gelu(fc1(LN(dw7x7(x)))))``, on one of two paths
  that read the same parameters (:func:`_use_fused_block` picks):
  - fused: the three kernels of :mod:`..ops.kernels.convnext_block` (their
    plain versions on the CPU);
  - unfused (the JAX package's Flax path): the 7 x 7 depthwise conv through
    the depthwise kernel (K9, :func:`..ops.kernels.depthwise.
    depthwise_conv_fn`, taps rounded to the compute dtype as Flax's conv
    rounds its kernel) plus the bias, the LN kernel (K10), cuBLAS Linears
    with exact GELU and dropout at ``drop_rate`` after each, the layer
    scale, then DropPath at ``linspace(0, drop_path_rate, blocks)`` in block
    order and the residual, all in the compute dtype;
- head: global average pool in f32 -> LN -> dropout at ``drop_rate`` -> f32
  Linear -> activation.

Training (``model.train()``) runs the unfused path, as the JAX package
does, with K9 and K10 under autograd (their backwards the plain versions'
gradients); so does serving under ``VIPTPU_NO_FUSED_BLOCK``. The fused path
casts the two GEMM weights to the compute dtype, so a model trained with
f32 parameters serves on it too.

Module and parameter names follow the Flax module names
(``stages_0_blocks_0.conv_dw``, ``head_fc``, ...), so the weight bridge maps
a Flax variables tree onto :meth:`state_dict` by renaming leaves only.
The stem, downsample convs and the head stay plain PyTorch, as the JAX
package leaves them to XLA; every LN runs the LN kernel.

int8 PTQ (:mod:`..quant.ptq`) finds the JAX pass's sites on either block
path (``int8_sites_match_jax``): on the fused path the MLP Linears are read
by the block kernels and never called, so only the downsample convs are
sites, and of those only where the JAX model calls ``nn.Conv``: its fused
path runs stages narrower than :data:`BATCH_LANE_WIDTH` batch-last and the
downsample between two such stages by ``lax.conv`` directly, outside the
pass, which the port mirrors by running that conv without its module's
hooks (:meth:`ConvNeXt._downsample`). On the unfused path the MLP Linears
are sites too. The stem and head are skipped by name.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.act import apply_activation, gelu_exact
from ..ops.conv import Conv, DepthwiseTaps, Linear, lecun_normal_
from ..ops.drop import DropPath, Dropout
from ..ops.kernels.convnext_block import convnext_block
from ..ops.norms import LayerNorm
from .base import ModelConfig, preprocess_input
from .registry import register_model


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig(ModelConfig):
    patch_size: int = 4
    first_down: int = 1
    embed_dim: Tuple[int, ...] = (96, 192, 384, 768)
    nb_blocks: Tuple[int, ...] = (3, 3, 9, 3)
    mlp_ratio: float = 4.0
    conv_mlp_block: bool = False
    drop_path_rate: float = 0.1
    norm_eps: float = 1e-6
    act_layer: str = "gelu"
    init_scale: float = 1e-6
    crop_pct: float = 0.875
    classifier_activation: Optional[str] = "softmax"
    # the block path: None = auto (fused unless VIPTPU_NO_FUSED_BLOCK is
    # set), or force the fused (True) or the unfused (False) block
    fused_block: Optional[bool] = None


def _use_fused_block(cfg: ConvNeXtConfig, training: bool) -> bool:
    """Whether the blocks take the fused path, as the JAX package decides:
    never when training or with dropout, else ``cfg.fused_block`` when set,
    else not when ``VIPTPU_NO_FUSED_BLOCK`` is set. The auto case differs as
    GCViT's does: the port is fused on the CPU and on CUDA alike, where the
    JAX package is fused only on a TPU."""
    if training or cfg.drop_rate:
        return False
    if cfg.fused_block is not None:
        return cfg.fused_block
    return not os.environ.get("VIPTPU_NO_FUSED_BLOCK")


DW_PADDING = ((3, 3), (3, 3))  # the 7 x 7 depthwise conv's zero padding
# the JAX package's fused path runs a stage narrower than this batch-last
BATCH_LANE_WIDTH = 256


class ConvNeXtBlock(nn.Module):
    def __init__(self, cfg: ConvNeXtConfig, dim: int, path_drop: float = 0.0):
        super().__init__()
        hidden = int(cfg.mlp_ratio * dim)
        self.eps, self.dtype = cfg.norm_eps, cfg.dtype
        # depthwise taps and every non-GEMM parameter stay f32, as the TPU
        # kernel keeps them; the two GEMM weights take the compute dtype
        self.conv_dw = DepthwiseTaps(dim, 7)
        self.norm = LayerNorm(dim, eps=cfg.norm_eps)
        self.mlp_fc1 = Linear(dim, hidden, cfg.dtype)
        self.mlp_fc2 = Linear(hidden, dim, cfg.dtype)
        self.gamma = nn.Parameter(torch.full((dim,), cfg.init_scale))
        self.drop1 = Dropout(cfg.drop_rate)
        self.drop2 = Dropout(cfg.drop_rate)
        self.drop_path = DropPath(path_drop)

    def forward(self, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
        if not fused:
            return self._unfused(x)
        dt = self.dtype  # the GEMM weights in the compute dtype, held in f32 when trained
        return convnext_block(
            x, self.conv_dw.weight, self.conv_dw.bias, self.norm.weight, self.norm.bias,
            self.mlp_fc1.weight.to(dt), self.mlp_fc1.bias, self.mlp_fc2.weight.to(dt),
            self.mlp_fc2.bias, self.gamma, eps=self.eps)

    def _unfused(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = self.norm(self.conv_dw(x, DW_PADDING, dt))
        y = self.drop2(self.mlp_fc2(self.drop1(gelu_exact(self.mlp_fc1(y)))))
        return x + self.drop_path(y * self.gamma.to(dt))


class ConvNeXt(nn.Module):
    int8_sites_match_jax = True

    def __init__(self, cfg: ConvNeXtConfig):
        super().__init__()
        if cfg.conv_mlp_block or cfg.act_layer != "gelu":
            raise NotImplementedError(
                "ConvNeXt with a conv-flavour MLP or a non-GELU activation is not "
                "ported (ROADMAP A14); the ensemble's member uses neither")
        self.cfg = cfg
        dims = cfg.embed_dim
        self.stem_conv = Conv(cfg.in_channels, dims[0], cfg.patch_size,
                              stride=cfg.first_down * 2, dtype=cfg.dtype)
        self.stem_norm = LayerNorm(dims[0], eps=cfg.norm_eps)
        path_drops, pos = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.nb_blocks)), 0
        for j, nb in enumerate(cfg.nb_blocks):
            if j > 0:
                self.add_module(f"stages_{j}_downsample_norm",
                                LayerNorm(dims[j - 1], eps=cfg.norm_eps))
                self.add_module(f"stages_{j}_downsample_conv",
                                Conv(dims[j - 1], dims[j], 2, stride=2, dtype=cfg.dtype))
            for i in range(nb):
                self.add_module(f"stages_{j}_blocks_{i}",
                                ConvNeXtBlock(cfg, dims[j], float(path_drops[pos])))
                pos += 1
        self.head_norm = LayerNorm(dims[-1], eps=cfg.norm_eps)
        self.head_drop = Dropout(cfg.drop_rate)
        if cfg.nb_classes > 0:
            self.head_fc = Linear(dims[-1], cfg.nb_classes, torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator``: conv and dense weights normal with
        variance 1 / fan_in (Flax's lecun_normal without its truncation),
        biases 0, LN weight 1 and bias 0, layer scale ``cfg.init_scale``."""
        for module in self.modules():
            if isinstance(module, (Conv, Linear, DepthwiseTaps)):
                lecun_normal_(module, generator)
            elif isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, ConvNeXtBlock):
                module.gamma.fill_(self.cfg.init_scale)

    def _downsample(self, x: torch.Tensor, j: int, fused: bool) -> torch.Tensor:
        """Stage j's downsample conv. Between two batch-last stages of the
        fused path the JAX model convolves with the parameters directly,
        outside its int8 pass: there the conv runs without its module's
        hooks (:meth:`..ops.conv.Conv.conv`), so calibration never sees it
        and it is no int8 site."""
        conv = getattr(self, f"stages_{j}_downsample_conv")
        dims = self.cfg.embed_dim
        if fused and dims[j - 1] < BATCH_LANE_WIDTH and dims[j] < BATCH_LANE_WIDTH:
            return conv.conv(x)
        return conv(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) in [0, 1]; returns (B, nb_classes) f32."""
        cfg = self.cfg
        x = preprocess_input(x, cfg)
        x = self.stem_norm(self.stem_conv(x))
        fused = _use_fused_block(cfg, self.training)
        for j, nb in enumerate(cfg.nb_blocks):
            if j > 0:
                x = self._downsample(getattr(self, f"stages_{j}_downsample_norm")(x), j, fused)
            for i in range(nb):
                x = getattr(self, f"stages_{j}_blocks_{i}")(x, fused)
        x = x.float().mean(dim=(1, 2))
        x = self.head_drop(self.head_norm(x))
        if cfg.nb_classes <= 0:
            return x
        return apply_activation(self.head_fc(x), cfg.classifier_activation)


_DIMS = {
    "tiny": ((96, 192, 384, 768), (3, 3, 9, 3)),
    "small": ((96, 192, 384, 768), (3, 3, 27, 3)),
    "base": ((128, 256, 512, 1024), (3, 3, 27, 3)),
    "large": ((192, 384, 768, 1536), (3, 3, 27, 3)),
    "xlarge": ((256, 512, 1024, 2048), (3, 3, 27, 3)),
}


def _make(name: str, size: str, **kw):
    dims, blocks = _DIMS[size]
    return ConvNeXt, ConvNeXtConfig(name=name, embed_dim=dims, nb_blocks=blocks, **kw)


# the same variant set as the JAX package's registry, the team's _fd2
# first-down-2 models included


@register_model
def convnext_tiny():
    return _make("convnext_tiny", "tiny")


@register_model
def convnext_small():
    return _make("convnext_small", "small")


@register_model
def convnext_base():
    return _make("convnext_base", "base")


@register_model
def convnext_large():
    return _make("convnext_large", "large")


@register_model
def convnext_tiny_in22ft1k():
    return _make("convnext_tiny_in22ft1k", "tiny")


@register_model
def convnext_small_in22ft1k():
    return _make("convnext_small_in22ft1k", "small")


@register_model
def convnext_base_in22ft1k():
    return _make("convnext_base_in22ft1k", "base")


@register_model
def convnext_large_in22ft1k():
    return _make("convnext_large_in22ft1k", "large")


@register_model
def convnext_large_in22ft1k_fd2():
    return _make("convnext_large_in22ft1k_fd2", "large", first_down=2)


@register_model
def convnext_xlarge_in22ft1k():
    return _make("convnext_xlarge_in22ft1k", "xlarge")


@register_model
def convnext_tiny_384_in22ft1k():
    return _make("convnext_tiny_384_in22ft1k", "tiny", input_size=(384, 384), crop_pct=1.0)


@register_model
def convnext_small_384_in22ft1k():
    return _make("convnext_small_384_in22ft1k", "small", input_size=(384, 384), crop_pct=1.0)


@register_model
def convnext_base_384_in22ft1k():
    return _make("convnext_base_384_in22ft1k", "base", input_size=(384, 384), crop_pct=1.0)


@register_model
def convnext_large_384_in22ft1k():
    return _make("convnext_large_384_in22ft1k", "large", input_size=(384, 384), crop_pct=1.0)


@register_model
def convnext_xlarge_384_in22ft1k():
    return _make("convnext_xlarge_384_in22ft1k", "xlarge", input_size=(384, 384), crop_pct=1.0)


@register_model
def convnext_tiny_in22k():
    return _make("convnext_tiny_in22k", "tiny", nb_classes=21841)


@register_model
def convnext_small_in22k():
    return _make("convnext_small_in22k", "small", nb_classes=21841)


@register_model
def convnext_base_in22k():
    return _make("convnext_base_in22k", "base", nb_classes=21841)


@register_model
def convnext_base_in22k_fd2():
    return _make("convnext_base_in22k_fd2", "base", nb_classes=21841, first_down=2)


@register_model
def convnext_large_in22k():
    return _make("convnext_large_in22k", "large", nb_classes=21841)


@register_model
def convnext_xlarge_in22k():
    return _make("convnext_xlarge_in22k", "xlarge", nb_classes=21841)
