"""NFNets, normalizer-free networks (ensemble member ``ECA_NFNetL0-200x200``).

Counterpart of ``vip_cup_2022_tpu/models/nfnets.py``, the whole ``NFNet``
class, NHWC throughout:

- every conv a :class:`..ops.conv.ScaledStdConv` (weight-standardized,
  per-filter gain, f32 bias), padded ``k // 2`` on each side in the L
  series (``torch_padding``), TF ``SAME`` in the F series;
- the activation's variance-preserving gamma (``NON_LINEAR_GAMMA``) scales
  each activation's output in the F series (``gamma_in_act``), each conv's
  standardized weight in the L series;
- stem: four 3 x 3 convs of ``stem_width`` / 8, / 4, / 2 and 1 filters (the
  first at ``first_strides``, the last at 2), the activation after the
  first three;
- blocks: ``preact`` = act(x) * beta, with beta = (1 + alpha^2 i)^-1/2 at
  the i-th block of a stack and the previous stack's last beta at its first
  (alpha 0.2); where the block strides or widens, the shortcut is a 1 x 1
  conv of preact (after a SAME average pool, ``count_include_pad=False``,
  where it strides), else x; the deep branch 1 x 1 -> act -> grouped 3 x 3
  (the block's stride, ``hidden // group_size`` groups) -> act -> grouped
  3 x 3 -> act -> 1 x 1, then SE or ECA times ``attn_gain`` 2.0, a
  DropPath (``stack{i}_block{j}_drop``) at the block's rate of
  ``drop_connect_rates_split(num_blocks, 0, drop_connect_rate)``, then the
  ``ZeroInitGain`` where the config has one; x = shortcut + deep * alpha;
- head: the 1 x 1 ``post_conv`` (``num_features_factor`` x the last width:
  1.5 x 1536 = 2304 in the L series), the activation, the global mean in
  f32, dropout at ``drop_rate`` (``drop``, Flax's ``Dropout_0``), the f32
  ``predictions`` Linear, the activation.

Training (``model.train()``): DropPath and dropout draw as in
:mod:`..ops.drop` (the registry: stochastic depth 0, dropout 0.2 in the L
series); each standardized conv computes its weight in the graph, so the
raw weights and gains get their gradients. No BN, no kernel.

Every conv runs on cuDNN in the compute dtype (the grouped ones as grouped
convs), as the JAX package leaves them to XLA. Module names are the Flax
tree's flat kecam names (``stack2_block1_deep_2_conv``,
``stack1_block1_eca_conv1d``). int8 post-training quantization of these
members, whose 3 x 3 sites are grouped standardized convs, is ROADMAP item
A9b: the engine raises for it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.act import NON_LINEAR_GAMMA, get_activation
from ..ops.attention import ECA
from ..ops.conv import Conv, Linear, ScaledStdConv, ZeroInitGain, lecun_normal_, make_divisible
from ..ops.drop import DropPath, Dropout, drop_connect_rates_split
from ..ops.pool import avg_pool_same
from .base import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, ModelConfig, preprocess_input
from .efficientnet import squeeze_excite
from .registry import register_model

ATTN_GAIN = 2.0


@dataclasses.dataclass(frozen=True)
class NFNetConfig(ModelConfig):
    num_blocks: Tuple[int, ...] = (1, 2, 6, 3)
    attn_type: str = "se"  # 'se' | 'eca'
    stem_width: int = 128
    out_channels: Tuple[int, ...] = (256, 512, 1536, 1536)
    channel_ratio: float = 0.5
    num_features_factor: float = 2.0
    strides: Tuple[int, ...] = (1, 2, 2, 2)
    se_ratio: float = 0.5
    group_size: int = 128
    use_zero_init_gain: bool = True
    torch_padding: bool = False
    gamma_in_act: bool = True
    alpha: float = 0.2
    width_factor: float = 1.0
    activation: str = "gelu"
    drop_connect_rate: float = 0.0
    drop_rate: float = 0.0
    classifier_activation: Optional[str] = "softmax"
    mean: Optional[Tuple[float, ...]] = IMAGENET_DEFAULT_MEAN
    std: Optional[Tuple[float, ...]] = IMAGENET_DEFAULT_STD


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One NF block: its Flax name prefix (``stack{i}_block{j}_``), stride,
    beta, whether it projects its shortcut, and its attention
    (``"se"``, ``"eca"`` or None)."""

    name: str
    stride: int
    beta: float
    conv_shortcut: bool
    attn: Optional[str]


class NFNet(nn.Module):
    def __init__(self, cfg: NFNetConfig):
        super().__init__()
        self.cfg = cfg
        self.act_fn = get_activation(cfg.activation)
        gamma = NON_LINEAR_GAMMA.get(cfg.activation.split("/")[0], 1.0)
        conv_gamma, self.act_gamma = (1.0, gamma) if cfg.gamma_in_act else (gamma, 1.0)
        dt = cfg.dtype

        def conv(name, cin, cout, kernel, stride=1, groups=1):
            if cfg.torch_padding and kernel > 1:
                padding = kernel // 2
            else:
                padding = "same" if kernel > 1 else 0
            self.add_module(name + "conv", ScaledStdConv(
                cin, cout, kernel, stride, padding, max(1, groups), conv_gamma, dt))

        sw = make_divisible(cfg.stem_width * cfg.width_factor, 8)
        cin = cfg.in_channels
        for i, (f, s) in enumerate([(sw // 8, cfg.first_strides), (sw // 4, 1), (sw // 2, 1),
                                    (sw, 2)]):
            conv(f"stem_{i + 1}_", cin, f, 3, s)
            cin = f
        betas_all = [(1 + cfg.alpha ** 2 * i) ** -0.5 for i in range(max(cfg.num_blocks) + 1)]
        attn = ("se" if cfg.se_ratio > 0 else None) if cfg.attn_type == "se" else (
            "eca" if cfg.attn_type == "eca" else None)
        self.blocks: List[BlockSpec] = []
        rates = drop_connect_rates_split(cfg.num_blocks, 0.0, cfg.drop_connect_rate)
        pre_beta = 1.0
        for sid, (num_block, out_c, stride) in enumerate(zip(cfg.num_blocks, cfg.out_channels,
                                                             cfg.strides)):
            out = make_divisible(out_c * cfg.width_factor, 8)
            betas = [pre_beta] + betas_all[1:num_block + 1]
            for bid in range(num_block):
                cur = stride if bid == 0 else 1
                spec = BlockSpec(f"stack{sid + 1}_block{bid + 1}_", cur, betas[bid],
                                 cur > 1 or cin != out, attn)
                name, hidden = spec.name, int(out * cfg.channel_ratio)
                groups = hidden // cfg.group_size
                if spec.conv_shortcut:
                    conv(name + "shortcut_", cin, out, 1)
                conv(name + "deep_1_", cin, hidden, 1)
                conv(name + "deep_2_", hidden, hidden, 3, cur, groups)
                conv(name + "deep_3_", hidden, hidden, 3, 1, groups)
                conv(name + "deep_4_", hidden, out, 1)
                if attn == "se":
                    reduction = make_divisible(out * cfg.se_ratio, 8)
                    self.add_module(name + "se_1_conv", Conv(out, reduction, 1, 1, dt))
                    self.add_module(name + "se_2_conv", Conv(reduction, out, 1, 1, dt))
                elif attn == "eca":
                    self.add_module(name + "eca_conv1d", ECA(out, dt))
                self.add_module(name + "drop", DropPath(rates[sid][bid]))
                if cfg.use_zero_init_gain:
                    self.add_module(name + "deep_gain", ZeroInitGain())
                self.blocks.append(spec)
                cin = out
            pre_beta = betas[-1]
        if cfg.num_features_factor > 0:
            post = make_divisible(
                cfg.num_features_factor * cfg.out_channels[-1] * cfg.width_factor, 8)
            conv("post_", cin, post, 1)
            cin = post
        self.num_features = cin
        if cfg.nb_classes > 0:
            self.drop = Dropout(cfg.drop_rate)
            self.predictions = Linear(cin, cfg.nb_classes, torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator``: every weight normal with variance
        1 / fan_in (Flax's lecun_normal without its truncation; the
        standardized convs normalise theirs anyway), biases 0, each
        standardized conv's gain 1 and each ``ZeroInitGain`` 0, as the JAX
        model initialises them."""
        for module in self.modules():
            if isinstance(module, (Conv, Linear, ScaledStdConv, ECA)):
                lecun_normal_(module, generator)
            if isinstance(module, ScaledStdConv):
                module.gain.fill_(1.0)
            elif isinstance(module, ZeroInitGain):
                module.gain.zero_()

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act_fn(x)
        return y if self.act_gamma == 1.0 else y * self.act_gamma

    def block(self, x: torch.Tensor, spec: BlockSpec) -> torch.Tensor:
        """One NF block, as the JAX model's loop body computes it."""
        name, cfg = spec.name, self.cfg
        preact = self._act(x) * spec.beta
        shortcut = x
        if spec.conv_shortcut:
            sc = avg_pool_same(preact, spec.stride) if spec.stride > 1 else preact
            shortcut = getattr(self, name + "shortcut_conv")(sc)
        deep = self._act(getattr(self, name + "deep_1_conv")(preact))
        deep = self._act(getattr(self, name + "deep_2_conv")(deep))
        deep = self._act(getattr(self, name + "deep_3_conv")(deep))
        deep = getattr(self, name + "deep_4_conv")(deep)
        if spec.attn == "se":
            deep = squeeze_excite(deep, getattr(self, name + "se_1_conv"),
                                  getattr(self, name + "se_2_conv"), torch.relu) * ATTN_GAIN
        elif spec.attn == "eca":
            deep = getattr(self, name + "eca_conv1d")(deep) * ATTN_GAIN
        deep = getattr(self, name + "drop")(deep)
        if cfg.use_zero_init_gain:
            deep = getattr(self, name + "deep_gain")(deep)
        return shortcut + deep * cfg.alpha

    def forward(self, x: torch.Tensor, features_only: bool = False):
        """x: (B, H, W, C) in [0, 1]; returns (B, nb_classes) f32, the pooled
        f32 features (``nb_classes`` <= 0) or the feature map after the
        head's activation (``features_only``)."""
        cfg = self.cfg
        x = preprocess_input(x, cfg)
        for i in range(1, 5):
            x = getattr(self, f"stem_{i}_conv")(x)
            if i < 4:
                x = self._act(x)
        for spec in self.blocks:
            x = self.block(x, spec)
        if cfg.num_features_factor > 0:
            x = self.post_conv(x)
        x = self._act(x)
        if features_only:
            return x
        x = x.float().mean(dim=(1, 2))
        if cfg.nb_classes <= 0:
            return x
        return get_activation(cfg.classifier_activation)(self.predictions(self.drop(x)))


def _f(name: str, num_blocks, input_size, drop_rate: float):
    return NFNet, NFNetConfig(name=name, num_blocks=num_blocks, input_size=input_size,
                              drop_rate=drop_rate)


@register_model
def NFNetF0():
    return _f("NFNetF0", (1, 2, 6, 3), (256, 256), 0.2)


@register_model
def NFNetF1():
    return _f("NFNetF1", (2, 4, 12, 6), (320, 320), 0.3)


@register_model
def NFNetF2():
    return _f("NFNetF2", (3, 6, 18, 9), (352, 352), 0.4)


@register_model
def NFNetF3():
    return _f("NFNetF3", (4, 8, 24, 12), (416, 416), 0.4)


@register_model
def NFNetF4():
    return _f("NFNetF4", (5, 10, 30, 15), (512, 512), 0.5)


@register_model
def NFNetF5():
    return _f("NFNetF5", (6, 12, 36, 18), (544, 544), 0.5)


@register_model
def NFNetF6():
    return _f("NFNetF6", (7, 14, 42, 21), (576, 576), 0.5)


_LIGHT = dict(channel_ratio=0.25, group_size=64, torch_padding=True, use_zero_init_gain=False,
              gamma_in_act=False, activation="swish", drop_rate=0.2)


@register_model
def NFNetL0():
    return NFNet, NFNetConfig(name="NFNetL0", num_blocks=(1, 2, 6, 3), input_size=(288, 288),
                              se_ratio=0.25, num_features_factor=1.5, **_LIGHT)


@register_model
def ECA_NFNetL0():
    return NFNet, NFNetConfig(name="ECA_NFNetL0", num_blocks=(1, 2, 6, 3),
                              input_size=(288, 288), attn_type="eca", num_features_factor=1.5,
                              **_LIGHT)


@register_model
def ECA_NFNetL1():
    return NFNet, NFNetConfig(name="ECA_NFNetL1", num_blocks=(2, 4, 12, 6),
                              input_size=(320, 320), attn_type="eca", **_LIGHT)


@register_model
def ECA_NFNetL2():
    return NFNet, NFNetConfig(name="ECA_NFNetL2", num_blocks=(3, 6, 18, 9),
                              input_size=(384, 384), attn_type="eca", **_LIGHT)


@register_model
def ECA_NFNetL3():
    return NFNet, NFNetConfig(name="ECA_NFNetL3", num_blocks=(4, 8, 24, 12),
                              input_size=(448, 448), attn_type="eca", **_LIGHT)
