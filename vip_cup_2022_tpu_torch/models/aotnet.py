"""AotNet in its ResNest configuration (ensemble member ``ResNest50-200x200``).

Counterpart of ``vip_cup_2022_tpu/models/aotnet.py`` for the four ResNest
registry names, NHWC throughout:

- deep stem: 3 x 3 convs of ``stem_width // 2`` (at ``first_strides``),
  ``stem_width // 2`` and ``stem_width`` filters, BN and ReLU after the
  first two, ``stem_bn`` and ReLU after the third, then one zero of padding
  on each side and a 3 x 3 max pool at stride 2;
- blocks 1 x 1 (``deep_1``, BN, ReLU) -> split attention -> 1 x 1
  (``deep_3``) -> the zero-gamma ``3_bn`` -> a DropPath
  (``stack{i}_block{j}_drop``) at the block's rate of
  ``drop_connect_rates_split(num_blocks, 0, drop_connect_rate)``, then
  ReLU(deep + shortcut). The first block of a stack projects its shortcut
  with a 1 x 1 conv and BN, after a SAME average pool
  (``count_include_pad=False``) where it strides;
- split attention of radix r >= 2 (``attn_params["groups"]``, 2 in every
  ResNest): one 3 x 3 conv per 1 / r of the channels (``sa_1_g{i}``, each
  to the full hidden width, always at stride 1), BN and ReLU over the r
  outputs side by side (channel g F + f is radix g, feature f); the f32
  spatial means of the radix parts summed and cast once; ``sa_2`` (1 x 1,
  bias, BN, ReLU) and ``sa_3`` (1 x 1, bias, to r F); a softmax over the
  radix in f32; the radix sum of gate times part in the compute dtype;
  where the block strides, one zero of padding and a 3 x 3 average pool at
  stride 2 that counts the zeros;
- head: the global mean in f32, dropout at ``drop_rate`` (``drop``, Flax's
  ``Dropout_0``), the f32 ``predictions`` Linear, the activation.

Training (``model.train()``): every BN normalises with the batch's
statistics and moves its running statistics by 0.9, the JAX package's
momentum; DropPath and dropout draw as in :mod:`..ops.drop` (both rates
are 0 in the registry); the radix softmax stays in f32. No kernel is on
this model's training path.

Every conv pads ``k // 2`` on each side in the compute dtype and runs on
cuDNN, as the JAX package leaves them to XLA; under int8 post-training
quantization (:mod:`..quant.ptq`) the eligible ones (``deep_1``, both
``sa_1_g`` halves, ``deep_3`` and the shortcut, 68 sites in ResNest50)
run the int8 kernel. Module names are the Flax tree's flat kecam names
(``stack2_block1_deep_2_sa_1_g1_conv``), so the weight bridge and the PTQ
site names match the JAX package's.

The other AotNet families (ResNet-D, ResNeXt, BotNet, HaloNet, CotNet and
the options they set: other stems, attention types, radix 1, SE, ECA,
preact, the strided-conv and anti-alias shortcuts) are not ported (ROADMAP
A14); a config that asks for one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.act import get_activation
from ..ops.conv import Conv, Linear, lecun_normal_
from ..ops.drop import DropPath, Dropout, drop_connect_rates_split
from ..ops.norms import BatchNorm
from ..ops.pool import avg_pool_3x3_s2_pad1, avg_pool_same, max_pool_3x3_s2_zero_pad
from .base import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, ModelConfig, preprocess_input
from .registry import register_model


@dataclasses.dataclass(frozen=True)
class AotNetConfig(ModelConfig):
    num_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    preact: bool = False
    strides: Tuple[int, ...] = (1, 2, 2, 2)
    strides_first: bool = True
    out_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    hidden_channel_ratio: Any = 0.25
    use_3x3_kernel: bool = False
    use_block_output_activation: bool = True
    use_evo_norm: bool = False
    evo_norm_group_size: int = -1
    bn_epsilon: float = 1e-5
    stem_width: int = 64
    stem_type: Optional[str] = None
    quad_stem_act: bool = False
    stem_last_strides: int = 1
    stem_downsample: bool = True
    attn_types: Any = None
    attn_params: Any = dataclasses.field(default_factory=dict)
    se_ratio: Any = 0.0
    use_eca: Any = False
    groups: Any = 1
    group_size: Any = 0
    bn_after_attn: bool = True
    shortcut_type: Optional[str] = "conv"
    activation: str = "relu"
    drop_connect_rate: float = 0.0
    output_num_features: int = 0
    drop_rate: float = 0.0
    classifier_activation: Optional[str] = "softmax"
    mean: Optional[Tuple[float, ...]] = IMAGENET_DEFAULT_MEAN
    std: Optional[Tuple[float, ...]] = IMAGENET_DEFAULT_STD


# the ResNest configuration: each of these fields must hold this value
_RESNEST = dict(preact=False, strides_first=True, use_3x3_kernel=False,
                use_block_output_activation=True, use_evo_norm=False, stem_type="deep",
                stem_downsample=True, se_ratio=0.0, use_eca=False, bn_after_attn=False,
                output_num_features=0)


def _per_stack(v, i):
    return v[i] if isinstance(v, (list, tuple)) else v


def _check_resnest(cfg: AotNetConfig) -> None:
    off = {k: getattr(cfg, k) for k, want in _RESNEST.items() if getattr(cfg, k) != want}
    attn = {_per_stack(_per_stack(cfg.attn_types, i), j)
            for i, n in enumerate(cfg.num_blocks) for j in range(n)}
    if attn != {"sa"}:
        off["attn_types"] = cfg.attn_types
    if cfg.shortcut_type != "avg":
        off["shortcut_type"] = cfg.shortcut_type
    if isinstance(cfg.hidden_channel_ratio, (list, tuple)):
        off["hidden_channel_ratio"] = cfg.hidden_channel_ratio
    if off:
        raise NotImplementedError(
            f"{cfg.name or 'AotNet'}: only the ResNest configuration of AotNet is ported (deep "
            f"stem, split attention, average-pool shortcut); {off} is ROADMAP item A14, not "
            "ported yet")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block: its Flax name prefix (``stack{i}_block{j}_``), stride,
    whether it projects its shortcut, hidden width and radix."""

    name: str
    stride: int
    conv_shortcut: bool
    hidden: int
    radix: int


class AotNet(nn.Module):
    # every conv the JAX PTQ pass quantizes is a port Conv under the same
    # site name, so VIPTPU_INT8 may select it
    int8_sites_match_jax = True

    def __init__(self, cfg: AotNetConfig):
        super().__init__()
        _check_resnest(cfg)
        self.cfg = cfg
        self.act = get_activation(cfg.activation)
        dt, eps = cfg.dtype, cfg.bn_epsilon

        def conv(name, cin, cout, kernel, stride=1, bias=False):
            self.add_module(name, Conv(cin, cout, kernel, stride, dt, kernel // 2, bias=bias))

        def bn(name, channels):
            self.add_module(name, BatchNorm(channels, eps, dt))

        sw = cfg.stem_width
        conv("stem_1_conv", cfg.in_channels, sw // 2, 3, cfg.first_strides)
        bn("stem_1_bn", sw // 2)
        conv("stem_2_conv", sw // 2, sw // 2, 3)
        bn("stem_2_bn", sw // 2)
        conv("stem_3_conv", sw // 2, sw, 3, cfg.stem_last_strides)
        bn("stem_bn", sw)
        self.blocks: List[BlockSpec] = []
        cin = sw
        rates = drop_connect_rates_split(cfg.num_blocks, 0.0, cfg.drop_connect_rate)
        for sid, (num_block, out, stride) in enumerate(zip(cfg.num_blocks, cfg.out_channels,
                                                           cfg.strides)):
            params = {"kernel_size": 3, "groups": 2, **(_per_stack(cfg.attn_params, sid) or {})}
            if params["kernel_size"] != 3 or params["groups"] < 2 or set(params) - {
                    "kernel_size", "groups"}:
                raise NotImplementedError(f"split attention with {params}: only kernel_size 3 "
                                          "and a radix (groups) of 2 or more are ported "
                                          "(ROADMAP A14)")
            radix = params["groups"]
            for bid in range(num_block):
                cur = stride if bid == 0 else 1
                spec = BlockSpec(f"stack{sid + 1}_block{bid + 1}_", cur,
                                 bid == 0 and (stride != 1 or cin != out),
                                 int(out * cfg.hidden_channel_ratio), radix)
                name, hidden = spec.name, spec.hidden
                if spec.conv_shortcut:
                    conv(name + "shortcut_conv", cin, out, 1)
                    bn(name + "shortcut_bn", out)
                conv(name + "deep_1_conv", cin, hidden, 1)
                bn(name + "deep_1_bn", hidden)
                sa = name + "deep_2_sa_"
                for g in range(radix):
                    conv(sa + f"1_g{g + 1}_conv", hidden // radix, hidden, 3)
                bn(sa + "1_bn", hidden * radix)
                inter = max(hidden * radix // 4, 32)
                conv(sa + "2_conv", hidden, inter, 1, bias=True)
                bn(sa + "2_bn", inter)
                conv(sa + "3_conv", inter, hidden * radix, 1, bias=True)
                conv(name + "deep_3_conv", hidden, out, 1)
                bn(name + "3_bn", out)
                self.add_module(name + "drop", DropPath(rates[sid][bid]))
                self.blocks.append(spec)
                cin = out
        self.num_features = cin
        if cfg.nb_classes > 0:
            self.drop = Dropout(cfg.drop_rate)
            self.predictions = Linear(cin, cfg.nb_classes, torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator``: conv and dense weights normal with
        variance 1 / fan_in (Flax's lecun_normal without its truncation),
        biases 0, BN scale 1 (0 for each block's closing ``3_bn``, the JAX
        model's zero gamma), shift 0, mean 0, variance 1."""
        for name, module in self.named_modules():
            if isinstance(module, (Conv, Linear)):
                lecun_normal_(module, generator)
            elif isinstance(module, BatchNorm):
                module.weight.fill_(0.0 if name.endswith("_3_bn") else 1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)

    def _conv_bn(self, x: torch.Tensor, conv: str, bn: str, act: bool = True) -> torch.Tensor:
        x = getattr(self, bn)(getattr(self, conv)(x))
        return self.act(x) if act else x

    def split_attention(self, x: torch.Tensor, spec: BlockSpec) -> torch.Tensor:
        """``_split_attention`` of the JAX model on the block's ``deep_1``
        output x (B, H, W, hidden)."""
        sa, r, f = spec.name + "deep_2_sa_", spec.radix, spec.hidden
        logits = torch.cat([getattr(self, sa + f"1_g{g + 1}_conv")(p)
                            for g, p in enumerate(torch.chunk(x, r, dim=-1))], dim=-1)
        logits = self.act(getattr(self, sa + "1_bn")(logits))
        b, h, w, _ = logits.shape
        parts = logits.view(b, h, w, r, f)
        gap = parts.float().mean(dim=(1, 2)).sum(dim=1).to(x.dtype).view(b, 1, 1, f)
        att = self._conv_bn(gap, sa + "2_conv", sa + "2_bn")
        att = getattr(self, sa + "3_conv")(att)
        att = torch.softmax(att.view(b, r, f).float(), dim=1).to(x.dtype)
        out = (att.view(b, 1, 1, r, f) * parts).sum(dim=3)
        return avg_pool_3x3_s2_pad1(out) if spec.stride > 1 else out

    def block(self, x: torch.Tensor, spec: BlockSpec) -> torch.Tensor:
        """One block, as the JAX model's ``_aot_block`` computes it."""
        name = spec.name
        shortcut = x
        if spec.conv_shortcut:
            if spec.stride > 1:
                shortcut = avg_pool_same(x, spec.stride)
            shortcut = self._conv_bn(shortcut, name + "shortcut_conv", name + "shortcut_bn",
                                     act=False)
        deep = self._conv_bn(x, name + "deep_1_conv", name + "deep_1_bn")
        deep = self.split_attention(deep, spec)
        deep = self._conv_bn(deep, name + "deep_3_conv", name + "3_bn", act=False)
        return self.act(shortcut + getattr(self, name + "drop")(deep))

    def forward(self, x: torch.Tensor, features_only: bool = False,
                feature_names: Tuple[str, ...] = ()):
        """x: (B, H, W, C) in [0, 1]; returns (B, nb_classes) f32, the pooled
        f32 features (``nb_classes`` <= 0), the feature map
        (``features_only``) or the outputs of the blocks ``feature_names``
        names (``"stack2_block1_output"``, ...) as a list."""
        cfg = self.cfg
        x = self._conv_bn(preprocess_input(x, cfg), "stem_1_conv", "stem_1_bn")
        x = self._conv_bn(x, "stem_2_conv", "stem_2_bn")
        x = max_pool_3x3_s2_zero_pad(self._conv_bn(x, "stem_3_conv", "stem_bn"))
        feats = {}
        for spec in self.blocks:
            x = self.block(x, spec)
            if feature_names:
                feats[spec.name + "output"] = x
        if feature_names:
            missing = [n for n in feature_names if n not in feats]
            if missing:
                raise KeyError(f"unknown feature names {missing}; available: {sorted(feats)}")
            return [feats[n] for n in feature_names]
        if features_only:
            return x
        x = x.float().mean(dim=(1, 2))
        if cfg.nb_classes <= 0:
            return x
        return get_activation(cfg.classifier_activation)(self.predictions(self.drop(x)))


def _resnest(name: str, num_blocks, stem_width: int, input_size):
    return AotNet, AotNetConfig(
        name=name, num_blocks=num_blocks, stem_width=stem_width, stem_type="deep",
        attn_types="sa", attn_params={"kernel_size": 3, "groups": 2}, bn_after_attn=False,
        shortcut_type="avg", input_size=input_size)


@register_model
def ResNest50():
    return _resnest("ResNest50", (3, 4, 6, 3), 64, (224, 224))


@register_model
def ResNest101():
    return _resnest("ResNest101", (3, 4, 23, 3), 128, (256, 256))


@register_model
def ResNest200():
    return _resnest("ResNest200", (3, 24, 36, 3), 128, (320, 320))


@register_model
def ResNest269():
    return _resnest("ResNest269", (3, 30, 48, 8), 128, (416, 416))
