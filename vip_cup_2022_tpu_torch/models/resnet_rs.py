"""ResNet-RS (ensemble member ``ResNetRS50-200x200``).

Counterpart of ``vip_cup_2022_tpu/models/resnet_rs.py``, NHWC throughout:

- ResNet-D stem: four 3 x 3 convs (32, 32, 64, 64 filters; the first at
  ``first_strides``, the last at stride 2), each with BN and ReLU;
- bottleneck blocks 1 x 1 -> 3 x 3 (the block's stride) -> 1 x 1 (4x
  filters), BN after each, the conv-style SE, then ReLU(y + shortcut); the
  first block of a stage projects its shortcut with a 1 x 1 conv, after a
  2 x 2 average pool when it strides (TF ``SAME``: at an odd input the last
  window averages what is there); the residual branch passes a DropPath
  (``drop``) at ``drop_path_rate * (stage + 2) / 5``, the JAX package's
  rate (0 in every registry entry);
- head: global average pool in f32 -> dropout at ``drop_rate`` (0.25) ->
  f32 ``predictions`` Linear -> activation.

Training (``model.train()``): every BN normalises with the batch's
statistics and moves its running statistics by the config's
``bn_momentum``, 0.0 as in the JAX package, so after a step they are that
step's batch statistics; DropPath and dropout draw as in
:mod:`..ops.drop`. No kernel is on this model's training path.

Every conv pads ``k // 2`` on each side (``Conv2DFixedPadding``), in the
compute dtype, except the projection conv, which the JAX package builds
without a dtype: f32 weights and f32 compute, its f32 output going into BN.
The convs run as plain PyTorch (cuDNN), as the JAX package leaves them to
XLA; under int8 post-training quantization (:mod:`..quant.ptq`) the
eligible ones run the int8 kernel. Module and parameter names follow the
Flax tree, the JAX ``Conv`` wrapper's inner ``conv`` included
(``c2_block_0.conv_1.conv.weight``), so the weight bridge and the PTQ site
names (``c2_block_0/conv_1/conv``) match the JAX package's.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from ..ops.act import apply_activation
from ..ops.conv import Conv, Linear, lecun_normal_
from ..ops.drop import DropPath, Dropout
from ..ops.norms import BatchNorm
from ..ops.pad import symmetric_padding
from ..ops.pool import avg_pool_same
from .base import ModelConfig, preprocess_input
from .registry import register_model

BLOCK_ARGS: Dict[int, List[Dict[str, int]]] = {
    depth: [{"input_filters": f, "num_repeats": r} for f, r in stages]
    for depth, stages in {
        50: [(64, 3), (128, 4), (256, 6), (512, 3)],
        101: [(64, 3), (128, 4), (256, 23), (512, 3)],
        152: [(64, 3), (128, 8), (256, 36), (512, 3)],
        200: [(64, 3), (128, 24), (256, 36), (512, 3)],
        270: [(64, 4), (128, 29), (256, 53), (512, 4)],
        350: [(64, 4), (128, 36), (256, 72), (512, 4)],
        420: [(64, 4), (128, 44), (256, 87), (512, 4)],
    }.items()
}


@dataclasses.dataclass(frozen=True)
class ResNetRSConfig(ModelConfig):
    depth: int = 50
    bn_momentum: float = 0.0
    bn_epsilon: float = 1e-5
    activation: str = "relu"
    se_ratio: float = 0.25
    drop_rate: float = 0.25
    drop_path_rate: float = 0.0


def fixed_padding_conv(cin: int, cout: int, kernel: int, stride: int,
                       dtype: Optional[torch.dtype]) -> nn.Sequential:
    """``ops/conv.py::Conv`` of the JAX package: a bias-free conv with
    torch-style padding, held as its inner ``conv`` as Flax names it."""
    return nn.Sequential(collections.OrderedDict(conv=Conv(
        cin, cout, kernel, stride, dtype=dtype, padding=symmetric_padding(kernel), bias=False)))


class SE(nn.Module):
    """ResNet-RS's SE: the reduction width comes from the bottleneck's
    filter count; the spatial mean is taken in f32 and cast back."""

    def __init__(self, in_filters: int, se_ratio: float, dtype: torch.dtype,
                 expand_ratio: int = 1):
        super().__init__()
        width = 4 * in_filters * expand_ratio
        reduced = max(1, int(in_filters * 4 * se_ratio))
        self.se_reduce = Conv(4 * in_filters, reduced, 1, dtype=dtype)
        self.se_expand = Conv(reduced, width, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        se = torch.relu(self.se_reduce(se))
        return x * torch.sigmoid(self.se_expand(se))


class BottleneckBlock(nn.Module):
    def __init__(self, cfg: ResNetRSConfig, cin: int, filters: int, strides: int,
                 use_projection: bool, path_drop: float = 0.0):
        super().__init__()
        self.cfg, self.strides, self.use_projection = cfg, strides, use_projection
        bn = lambda c: BatchNorm(c, cfg.bn_epsilon, cfg.dtype, cfg.bn_momentum)  # noqa: E731
        if use_projection:
            # built without a dtype in the JAX package: f32 compute
            self.projection_conv = fixed_padding_conv(cin, 4 * filters, 1,
                                                      1 if strides == 2 else strides, None)
            self.projection_batch_norm = bn(4 * filters)
        self.conv_1 = fixed_padding_conv(cin, filters, 1, 1, cfg.dtype)
        self.batch_norm_1 = bn(filters)
        self.conv_2 = fixed_padding_conv(filters, filters, 3, strides, cfg.dtype)
        self.batch_norm_2 = bn(filters)
        self.conv_3 = fixed_padding_conv(filters, 4 * filters, 1, 1, cfg.dtype)
        self.batch_norm_3 = bn(4 * filters)
        if 0 < cfg.se_ratio < 1:
            self.se = SE(filters, cfg.se_ratio, cfg.dtype)
        self.drop = DropPath(path_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self.cfg.activation
        shortcut = x
        if self.use_projection:
            if self.strides == 2:
                shortcut = avg_pool_same(x, 2)
            shortcut = self.projection_batch_norm(self.projection_conv(shortcut))
        y = apply_activation(self.batch_norm_1(self.conv_1(x)), act)
        y = apply_activation(self.batch_norm_2(self.conv_2(y)), act)
        y = self.batch_norm_3(self.conv_3(y))
        if hasattr(self, "se"):
            y = self.se(y)
        return apply_activation(self.drop(y) + shortcut, act)


class ResNetRS(nn.Module):
    # every conv and Dense the JAX PTQ pass quantizes is a port Conv / Linear
    # under the same site name, so VIPTPU_INT8 may select it
    int8_sites_match_jax = True

    def __init__(self, cfg: ResNetRSConfig):
        super().__init__()
        if cfg.activation != "relu":
            raise NotImplementedError(f"ResNet-RS with activation {cfg.activation!r}: only "
                                      "ReLU is ported (every registry entry uses it)")
        if cfg.pool not in ("avg", "max", ""):
            raise ValueError(f"pool {cfg.pool!r} not in avg|max|''")
        self.cfg = cfg
        cin = cfg.in_channels
        for i, (f, s) in enumerate([(32, cfg.first_strides), (32, 1), (64, 1), (64, 2)]):
            self.add_module(f"stem_conv_{i + 1}", fixed_padding_conv(cin, f, 3, s, cfg.dtype))
            self.add_module(f"stem_batch_norm_{i + 1}",
                            BatchNorm(f, cfg.bn_epsilon, cfg.dtype, cfg.bn_momentum))
            cin = f
        self.block_names = []
        stages = BLOCK_ARGS[cfg.depth]
        for i, args in enumerate(stages):
            filters = args["input_filters"]
            path_drop = cfg.drop_path_rate * float(i + 2) / (len(stages) + 1)
            for j in range(args["num_repeats"]):
                name = f"c{i + 2}_block_{j}"
                self.add_module(name, BottleneckBlock(
                    cfg, cin, filters, (1 if i == 0 else 2) if j == 0 else 1, j == 0, path_drop))
                self.block_names.append(name)
                cin = 4 * filters
        self.num_features = cin
        if cfg.pool and cfg.nb_classes > 0:
            self.drop = Dropout(cfg.drop_rate)
            self.predictions = Linear(cin, cfg.nb_classes, torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator``: conv and dense weights normal with
        variance 1 / fan_in (Flax's lecun_normal without its truncation),
        biases 0, BN scale 1, shift 0, mean 0, variance 1."""
        for module in self.modules():
            if isinstance(module, (Conv, Linear)):
                lecun_normal_(module, generator)
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = preprocess_input(x, self.cfg)
        for i in range(1, 5):
            x = getattr(self, f"stem_batch_norm_{i}")(getattr(self, f"stem_conv_{i}")(x))
            x = apply_activation(x, self.cfg.activation)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) in [0, 1]; returns (B, nb_classes) f32, or the
        pooled features (``nb_classes`` <= 0) or the feature map (no pool)."""
        cfg = self.cfg
        x = self.forward_features(x)
        if cfg.pool == "avg":
            x = x.float().mean(dim=(1, 2))
        elif cfg.pool == "max":
            x = x.amax(dim=(1, 2)).float()
        else:
            return x
        if cfg.nb_classes <= 0:
            return x.to(cfg.dtype)
        return apply_activation(self.predictions(self.drop(x)), cfg.classifier_activation)


def _cfg(depth: int, name: str, **kw):
    return ResNetRS, ResNetRSConfig(name=name, depth=depth, **kw)


@register_model
def resnetrs50():
    return _cfg(50, "resnetrs50")


@register_model
def resnetrs101():
    return _cfg(101, "resnetrs101")


@register_model
def resnetrs152():
    return _cfg(152, "resnetrs152")


@register_model
def resnetrs200():
    return _cfg(200, "resnetrs200")


@register_model
def resnetrs270():
    return _cfg(270, "resnetrs270")


@register_model
def resnetrs350():
    return _cfg(350, "resnetrs350")


@register_model
def resnetrs420():
    return _cfg(420, "resnetrs420")


# manifest aliases: the reference checkpoint directory names
@register_model
def ResNetRS50():
    return _cfg(50, "ResNetRS50")


@register_model
def ResNetRS200():
    return _cfg(200, "ResNetRS200")
