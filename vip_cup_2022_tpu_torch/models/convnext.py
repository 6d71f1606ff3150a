"""ConvNeXt (ensemble member ``convnext_tiny_in22k-200x200``).

Counterpart of ``vip_cup_2022_tpu/models/convnext.py``, NHWC throughout:

- stem: conv patch_size x patch_size, stride ``first_down * 2`` (the team's
  stride-2 stem: 200 px -> 99 x 99 x 96), then LN;
- stage j > 0: LN + 2x2 stride-2 conv downsample, then the blocks;
- block: ``x + gamma * fc2(gelu(fc1(LN(dw7x7(x)))))``, every block through
  the three kernels of :mod:`..ops.kernels.convnext_block` (their plain
  versions on the CPU);
- head: global average pool in f32 -> LN -> f32 Linear -> activation.

Module and parameter names follow the Flax module names
(``stages_0_blocks_0.conv_dw``, ``head_fc``, ...), so the weight bridge maps
a Flax variables tree onto :meth:`state_dict` by renaming leaves only.
The stem, downsample convs, standalone LNs and the head stay plain PyTorch,
as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.act import apply_activation
from ..ops.conv import Conv, DepthwiseTaps, Linear, lecun_normal_
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


class ConvNeXtBlock(nn.Module):
    def __init__(self, cfg: ConvNeXtConfig, dim: int):
        super().__init__()
        hidden = int(cfg.mlp_ratio * dim)
        self.eps = cfg.norm_eps
        # depthwise taps and every non-GEMM parameter stay f32, as the TPU
        # kernel keeps them; the two GEMM weights take the compute dtype
        self.conv_dw = DepthwiseTaps(dim, 7)
        self.norm = LayerNorm(dim, eps=cfg.norm_eps)
        self.mlp_fc1 = Linear(dim, hidden, cfg.dtype)
        self.mlp_fc2 = Linear(hidden, dim, cfg.dtype)
        self.gamma = nn.Parameter(torch.full((dim,), cfg.init_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return convnext_block(
            x, self.conv_dw.weight, self.conv_dw.bias, self.norm.weight, self.norm.bias,
            self.mlp_fc1.weight, self.mlp_fc1.bias, self.mlp_fc2.weight,
            self.mlp_fc2.bias, self.gamma, eps=self.eps)


class ConvNeXt(nn.Module):
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
        for j, nb in enumerate(cfg.nb_blocks):
            if j > 0:
                self.add_module(f"stages_{j}_downsample_norm",
                                LayerNorm(dims[j - 1], eps=cfg.norm_eps))
                self.add_module(f"stages_{j}_downsample_conv",
                                Conv(dims[j - 1], dims[j], 2, stride=2, dtype=cfg.dtype))
            for i in range(nb):
                self.add_module(f"stages_{j}_blocks_{i}", ConvNeXtBlock(cfg, dims[j]))
        self.head_norm = LayerNorm(dims[-1], eps=cfg.norm_eps)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) in [0, 1]; returns (B, nb_classes) f32."""
        cfg = self.cfg
        x = preprocess_input(x, cfg)
        x = self.stem_norm(self.stem_conv(x))
        for j, nb in enumerate(cfg.nb_blocks):
            if j > 0:
                x = getattr(self, f"stages_{j}_downsample_norm")(x)
                x = getattr(self, f"stages_{j}_downsample_conv")(x)
            for i in range(nb):
                x = getattr(self, f"stages_{j}_blocks_{i}")(x)
        x = x.float().mean(dim=(1, 2))
        x = self.head_norm(x)
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
