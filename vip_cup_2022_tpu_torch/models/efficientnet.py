"""EfficientNet V1 and V2 (ensemble members ``EfficientNetV2T-200x200`` and
``EfficientNetV1B4-224x224``; ``EfficientNetV2T_GC`` too).

Counterpart of ``vip_cup_2022_tpu/models/efficientnet.py``, NHWC throughout:

- stem: a 3 x 3 conv of ``make_divisible(first_conv_filter, 8)`` filters at
  ``first_strides``, BN, the activation (swish);
- per stage (``expands``, ``out_channels``, ``depthes``, ``strides``,
  ``se_ratios``, ``kernel_sizes``), blocks of two kinds, Fused-MBConv where
  ``is_fused`` is ``"auto"`` and the stage has no SE: the expansion
  (``sortcut_conv``, 3 x 3 at the block's stride when fused, else 1 x 1),
  BN and swish; unfused, the k x k depthwise conv at the block's stride, BN
  and swish; SE (an f32 spatial mean cast back, 1 x 1 conv of
  ``make_divisible(C * se / expand, 1)``, swish, 1 x 1 conv, sigmoid); the
  projection (``fu_conv``, 3 x 3 with BN and swish, where a fused block has
  no expansion; else the 1 x 1 ``MB_pw_conv`` and BN) and, where the block
  keeps its width at stride 1, the shortcut, added in the compute dtype
  after the branch passes a DropPath (``stack_{i}_block{j}_drop``) at
  ``drop_connect_rate * gid / total``, gid counting every block before it
  and total the blocks of all stages (the JAX package's drop-connect);
- head: the 1 x 1 ``post_conv`` with BN and swish, the global mean in f32,
  dropout at ``drop_rate`` (``drop``, Flax's ``Dropout_0``), the f32
  ``predictions`` Linear, the activation.

Training (``model.train()``): every BN normalises with the batch's
statistics and moves its running statistics by 0.9, the JAX package's
momentum; DropPath and dropout draw as in :mod:`..ops.drop` (the registry:
V2T 0 and 0.2, V1B4 0.2 and 0.4). The stride-1 depthwise convs run K9
under autograd, its backward the plain version's gradient.

kecam's torch mode (``is_torch_mode``, EfficientNetV2T) pads every conv
``k // 2`` on each side and sets the BN epsilon to 1e-5; TF mode (V1,
V2S–XL) pads TF ``SAME``, asymmetric at stride 2, and sets it to 1e-3.
Each conv runs in the compute dtype on cuDNN, as the JAX package leaves them
to XLA, except the stride-1 depthwise convs, which run the depthwise kernel
(K9) through :class:`..ops.conv.DepthwiseConv`. Module names are the Flax
tree's, which are kecam's layer names (``stack_3_block0_MB_dw_``,
``stack_3_block0_se_1_conv``, ...): the convs are direct ``nn.Conv``s with no
inner ``conv``, so the weight bridge maps ``stem_conv/kernel`` onto
``stem_conv.weight``.

The global-context variant (``use_global_context_instead_of_se``,
``EfficientNetV2T_GC``; kecam's ``global_context_module``) replaces SE by:
``gc_attn_conv`` (1 x 1 to one channel, with bias), a softmax over the H W
positions in f32 cast back, the context ``attn @ x`` (a plain
``torch.matmul`` over (B, 1, 1, HW) x (B, 1, HW, C), as the JAX package
leaves it to XLA), ``gc_mlp_1_conv`` to ``make_divisible(C * se / expand, 1,
limit_round_down=0)`` channels, ``gc_ln`` (the LN kernel K10, at V2T's
widths 12 / 26 / 32 / 52, most of them not a multiple of its vector), the
activation, ``gc_mlp_2_conv`` back to C, a sigmoid gate on x.

int8 PTQ (:mod:`..quant.ptq`) finds the JAX pass's sites
(``int8_sites_match_jax``): the depthwise convs are skipped by their one
input feature a group, the SE and global-context convs by their one
position (or one output channel), the stem by name; every other conv with
32 or more input and output channels is a site (V1B4's all 1 x 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..ops.act import get_activation
from ..ops.conv import Conv, DepthwiseConv, Linear, lecun_normal_, make_divisible
from ..ops.drop import DropPath, Dropout
from ..ops.norms import BatchNorm, LayerNorm
from ..ops.pad import PaddingSpec
from .base import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, ModelConfig, preprocess_input
from .registry import register_model

TF_BN_EPS = 1e-3
TORCH_BN_EPS = 1e-5
GC_LN_EPS = 1e-5  # the global-context LayerNorm's (the JAX package's LayerNorm default)

RESCALE_STATS = {
    "torch": (IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD),
    "tf": ((128 / 255,) * 3, (128 / 255,) * 3),  # x * 255 / 128 - 1
    "raw": (None, None),
}


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig(ModelConfig):
    expands: Tuple[float, ...] = (1, 4, 4, 4, 6, 6)
    out_channels: Tuple[float, ...] = (16, 32, 48, 96, 112, 192)
    depthes: Tuple[int, ...] = (1, 2, 2, 3, 5, 8)
    strides: Tuple[int, ...] = (1, 2, 2, 2, 1, 2)
    se_ratios: Tuple[float, ...] = (0, 0, 0, 0.25, 0.25, 0.25)
    kernel_sizes: Tuple[int, ...] = (3,) * 6
    is_fused: Union[str, bool, Tuple[bool, ...]] = "auto"
    first_conv_filter: float = 32
    output_conv_filter: float = 1280
    is_torch_mode: bool = False
    use_global_context_instead_of_se: bool = False
    drop_connect_rate: float = 0.0
    activation: str = "swish"
    drop_rate: float = 0.2  # head dropout
    rescale_mode: str = "torch"
    classifier_activation: Optional[str] = "softmax"

    def __post_init__(self):
        mean, std = RESCALE_STATS[self.rescale_mode]
        object.__setattr__(self, "mean", mean)
        object.__setattr__(self, "std", std)


def conv_padding(kernel: int, stride: int, torch_mode: bool) -> PaddingSpec:
    """``_conv_nb``'s padding: ``k // 2`` on each side in torch mode, else
    TF ``SAME`` (VALID for a 1 x 1 conv at stride 1)."""
    if torch_mode and kernel // 2 > 0:
        return kernel // 2
    return "same" if kernel > 1 or stride > 1 else 0


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One MBConv or Fused-MBConv block: its Flax name prefix
    (``stack_{i}_block{j}_``), stride, whether it is fused, expands, has SE
    and takes the shortcut."""

    name: str
    stride: int
    fused: bool
    expand: bool
    se: bool
    shortcut: bool


def squeeze_excite(x: torch.Tensor, reduce: Conv, expand: Conv, act) -> torch.Tensor:
    """kecam's ``se_module`` with divisor 1: the spatial mean in f32 cast back
    to x's dtype, ``reduce``, ``act``, ``expand``, sigmoid, times x."""
    se = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
    return x * torch.sigmoid(expand(act(reduce(se))))


def global_context(x: torch.Tensor, attn_conv: Conv, mlp_1: Conv, ln: LayerNorm, mlp_2: Conv,
                   act) -> torch.Tensor:
    """kecam's ``global_context_module`` as the JAX package computes it:
    the softmax of ``attn_conv(x)`` over the positions in f32, cast back,
    the context ``attn @ x``, then ``mlp_1``, ``ln``, ``act``, ``mlp_2``,
    sigmoid, times x."""
    b, h, w, c = x.shape
    attn = attn_conv(x).reshape(b, 1, 1, h * w)
    attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
    context = torch.matmul(attn, x.reshape(b, 1, h * w, c))  # (B, 1, 1, C)
    return x * torch.sigmoid(mlp_2(act(ln(mlp_1(context)))))


class EfficientNet(nn.Module):
    int8_sites_match_jax = True

    def __init__(self, cfg: EfficientNetConfig):
        super().__init__()
        self.cfg = cfg
        self.act = get_activation(cfg.activation)
        dt, tm = cfg.dtype, cfg.is_torch_mode
        eps = TORCH_BN_EPS if tm else TF_BN_EPS
        stem = make_divisible(cfg.first_conv_filter, 8)
        self.stem_conv = Conv(cfg.in_channels, stem, 3, cfg.first_strides, dt,
                              conv_padding(3, cfg.first_strides, tm), bias=False)
        self.stem_bn = BatchNorm(stem, eps, dt)
        self.blocks: List[BlockSpec] = []
        cin = pre_out = stem
        gid, total = 0, sum(cfg.depthes)
        for sid, (expand, out_c, depth, stride0, se_ratio, ksize) in enumerate(zip(
                cfg.expands, cfg.out_channels, cfg.depthes, cfg.strides, cfg.se_ratios,
                cfg.kernel_sizes)):
            out = make_divisible(out_c, 8)
            if cfg.is_fused == "auto":
                fused = se_ratio == 0
            elif isinstance(cfg.is_fused, (tuple, list)):
                fused = bool(cfg.is_fused[sid])
            else:
                fused = bool(cfg.is_fused)
            for bid in range(depth):
                name = f"stack_{sid}_block{bid}_"
                stride = stride0 if bid == 0 else 1
                spec = BlockSpec(name, stride, fused, expand != 1, se_ratio > 0,
                                 out == pre_out and stride == 1)
                width = cin
                if spec.expand:
                    width = make_divisible(cin * expand, 8)
                    if fused:
                        conv = Conv(cin, width, 3, stride, dt, conv_padding(3, stride, tm),
                                    bias=False)
                    else:
                        conv = Conv(cin, width, 1, 1, dt, 0, bias=False)
                    self.add_module(name + "sortcut_conv", conv)
                    self.add_module(name + "sortcut_bn", BatchNorm(width, eps, dt))
                if not fused:
                    pad = ksize // 2 if tm and ksize // 2 > 0 else "same"
                    self.add_module(name + "MB_dw_", DepthwiseConv(width, ksize, pad, dt, stride))
                    self.add_module(name + "MB_dw_bn", BatchNorm(width, eps, dt))
                if spec.se and cfg.use_global_context_instead_of_se:
                    reduction = make_divisible(width * se_ratio / expand, 1,
                                               limit_round_down=0.0)
                    self.add_module(name + "gc_attn_conv", Conv(width, 1, 1, 1, dt))
                    self.add_module(name + "gc_mlp_1_conv", Conv(width, reduction, 1, 1, dt))
                    self.add_module(name + "gc_ln", LayerNorm(reduction, GC_LN_EPS))
                    self.add_module(name + "gc_mlp_2_conv", Conv(reduction, width, 1, 1, dt))
                elif spec.se:
                    reduction = make_divisible(width * se_ratio / expand, 1)
                    self.add_module(name + "se_1_conv", Conv(width, reduction, 1, 1, dt))
                    self.add_module(name + "se_2_conv", Conv(reduction, width, 1, 1, dt))
                if fused and not spec.expand:
                    self.add_module(name + "fu_conv", Conv(
                        width, out, 3, stride, dt, conv_padding(3, stride, tm), bias=False))
                    self.add_module(name + "fu_bn", BatchNorm(out, eps, dt))
                else:
                    self.add_module(name + "MB_pw_conv", Conv(width, out, 1, 1, dt, 0, bias=False))
                    self.add_module(name + "MB_pw_bn", BatchNorm(out, eps, dt))
                if spec.shortcut:
                    self.add_module(name + "drop", DropPath(cfg.drop_connect_rate * gid / total))
                self.blocks.append(spec)
                cin = pre_out = out
                gid += 1
        if cfg.output_conv_filter > 0:
            post = make_divisible(cfg.output_conv_filter, 8)
            self.post_conv = Conv(cin, post, 1, 1, dt, 0, bias=False)
            self.post_bn = BatchNorm(post, eps, dt)
            cin = post
        self.num_features = cin
        if cfg.nb_classes > 0:
            self.drop = Dropout(cfg.drop_rate)
            self.predictions = Linear(cin, cfg.nb_classes, torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator``: conv, depthwise and dense weights
        normal with variance 1 / fan_in (Flax's lecun_normal without its
        truncation), biases 0, BN scale 1, shift 0, mean 0, variance 1, LN
        scale 1, shift 0."""
        for module in self.modules():
            if isinstance(module, (Conv, DepthwiseConv, Linear)):
                lecun_normal_(module, generator)
            elif isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)

    def _conv_bn(self, x: torch.Tensor, conv: str, bn: str, act: bool) -> torch.Tensor:
        x = getattr(self, bn)(getattr(self, conv)(x))
        return self.act(x) if act else x

    def block(self, x: torch.Tensor, spec: BlockSpec) -> torch.Tensor:
        """One block of the stack, as the JAX model's loop body computes it."""
        name, inp = spec.name, x
        if spec.expand:
            x = self._conv_bn(x, name + "sortcut_conv", name + "sortcut_bn", True)
        if not spec.fused:
            x = self._conv_bn(x, name + "MB_dw_", name + "MB_dw_bn", True)
        if spec.se and self.cfg.use_global_context_instead_of_se:
            x = global_context(x, *(getattr(self, name + part) for part in (
                "gc_attn_conv", "gc_mlp_1_conv", "gc_ln", "gc_mlp_2_conv")), self.act)
        elif spec.se:
            x = squeeze_excite(x, getattr(self, name + "se_1_conv"),
                               getattr(self, name + "se_2_conv"), self.act)
        if spec.fused and not spec.expand:
            x = self._conv_bn(x, name + "fu_conv", name + "fu_bn", True)
        else:
            x = self._conv_bn(x, name + "MB_pw_conv", name + "MB_pw_bn", False)
        return getattr(self, name + "drop")(x) + inp if spec.shortcut else x

    def forward(self, x: torch.Tensor, features_only: bool = False,
                feature_names: Tuple[str, ...] = ()):
        """x: (B, H, W, C) in [0, 1]; returns (B, nb_classes) f32, the pooled
        f32 features (``nb_classes`` <= 0), the feature map
        (``features_only``) or the outputs of the blocks ``feature_names``
        names (``"stack_2_block1_output"``, ...) as a list."""
        cfg = self.cfg
        x = self._conv_bn(preprocess_input(x, cfg), "stem_conv", "stem_bn", True)
        feats = {}
        for spec in self.blocks:
            x = self.block(x, spec)
            if feature_names:
                feats[spec.name + "output"] = x
        if cfg.output_conv_filter > 0:
            x = self._conv_bn(x, "post_conv", "post_bn", True)
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


def _v2(name: str, **kw):
    return EfficientNet, EfficientNetConfig(name=name, **kw)


@register_model
def EfficientNetV2B0():
    return _v2("EfficientNetV2B0", input_size=(224, 224))


@register_model
def EfficientNetV2B1():
    return _v2("EfficientNetV2B1", input_size=(240, 240), depthes=(2, 3, 3, 4, 6, 9))


@register_model
def EfficientNetV2B2():
    return _v2(
        "EfficientNetV2B2", input_size=(260, 260),
        out_channels=(16, 32, 56, 104, 120, 208), depthes=(2, 3, 3, 4, 6, 10),
        output_conv_filter=1408, drop_rate=0.3,
    )


@register_model
def EfficientNetV2B3():
    return _v2(
        "EfficientNetV2B3", input_size=(300, 300),
        out_channels=(16, 40, 56, 112, 136, 232), depthes=(2, 3, 3, 5, 7, 12),
        first_conv_filter=40, output_conv_filter=1536, drop_rate=0.3,
    )


_V2T = dict(
    out_channels=(24, 40, 48, 104, 128, 208), depthes=(2, 4, 4, 6, 9, 14),
    first_conv_filter=24, output_conv_filter=1024, is_torch_mode=True,
)


@register_model
def EfficientNetV2T():
    return _v2("EfficientNetV2T", input_size=(288, 288), **_V2T)


@register_model
def EfficientNetV2T_GC():
    return _v2(
        "EfficientNetV2T_GC", input_size=(288, 288),
        use_global_context_instead_of_se=True, **_V2T,
    )


@register_model
def EfficientNetV2S():
    return _v2(
        "EfficientNetV2S", input_size=(384, 384),
        out_channels=(24, 48, 64, 128, 160, 256), depthes=(2, 4, 4, 6, 9, 15),
        first_conv_filter=24, rescale_mode="tf",
    )


_V2_LARGE = dict(
    expands=(1, 4, 4, 4, 6, 6, 6), strides=(1, 2, 2, 2, 1, 2, 1),
    se_ratios=(0, 0, 0, 0.25, 0.25, 0.25, 0.25), kernel_sizes=(3,) * 7,
    rescale_mode="tf",
)


@register_model
def EfficientNetV2M():
    return _v2(
        "EfficientNetV2M", input_size=(480, 480),
        out_channels=(24, 48, 80, 160, 176, 304, 512), depthes=(3, 5, 5, 7, 14, 18, 5),
        first_conv_filter=24, drop_rate=0.3, **_V2_LARGE,
    )


@register_model
def EfficientNetV2L():
    return _v2(
        "EfficientNetV2L", input_size=(480, 480),
        out_channels=(32, 64, 96, 192, 224, 384, 640), depthes=(4, 7, 7, 10, 19, 25, 7),
        drop_rate=0.4, **_V2_LARGE,
    )


@register_model
def EfficientNetV2XL():
    return _v2(
        "EfficientNetV2XL", input_size=(512, 512),
        out_channels=(32, 64, 96, 192, 256, 512, 640), depthes=(4, 8, 8, 16, 24, 32, 8),
        drop_rate=0.4, **_V2_LARGE,
    )


# V1 (kecam efficientnet_v1.py): width and depth scaling over the B0 table
def _v1_dims(width: float, depth: float, fix_head_stem: bool = False):
    out_channels = tuple(c * width for c in (16, 24, 40, 80, 112, 192, 320))
    depthes = tuple(int(math.ceil(d * depth)) for d in (1, 2, 2, 3, 3, 4, 1))
    if fix_head_stem:
        depthes = (1,) + depthes[1:-1] + (1,)
        first_conv, output_conv = 32, 1280
    else:
        first_conv, output_conv = 32 * width, 1280 * width
    return out_channels, depthes, first_conv, output_conv


def _v1(name: str, width: float, depth: float, input_size, drop_rate: float,
        lite: bool = False, **kw):
    out_channels, depthes, first_conv, output_conv = _v1_dims(width, depth, fix_head_stem=lite)
    return EfficientNet, EfficientNetConfig(
        name=name, input_size=input_size, expands=(1, 6, 6, 6, 6, 6, 6),
        out_channels=out_channels, depthes=depthes, strides=(1, 2, 2, 2, 1, 2, 1),
        se_ratios=(0,) * 7 if lite else (0.25,) * 7, kernel_sizes=(3, 3, 5, 3, 5, 5, 3),
        is_fused=False if lite else "auto", first_conv_filter=first_conv,
        output_conv_filter=output_conv, drop_connect_rate=0.2, drop_rate=drop_rate, **kw)


@register_model
def EfficientNetV1B0():
    return _v1("EfficientNetV1B0", 1.0, 1.0, (224, 224), 0.2)


@register_model
def EfficientNetV1B1():
    return _v1("EfficientNetV1B1", 1.0, 1.1, (240, 240), 0.2)


@register_model
def EfficientNetV1B2():
    return _v1("EfficientNetV1B2", 1.1, 1.2, (260, 260), 0.3)


@register_model
def EfficientNetV1B3():
    return _v1("EfficientNetV1B3", 1.2, 1.4, (300, 300), 0.3)


@register_model
def EfficientNetV1B4():
    return _v1("EfficientNetV1B4", 1.4, 1.8, (380, 380), 0.4)


@register_model
def EfficientNetV1B5():
    return _v1("EfficientNetV1B5", 1.6, 2.2, (456, 456), 0.4)


@register_model
def EfficientNetV1B6():
    return _v1("EfficientNetV1B6", 1.8, 2.6, (528, 528), 0.5)


@register_model
def EfficientNetV1B7():
    return _v1("EfficientNetV1B7", 2.0, 3.1, (600, 600), 0.5)


@register_model
def EfficientNetV1L2():
    return _v1("EfficientNetV1L2", 4.3, 5.3, (800, 800), 0.5)


@register_model
def EfficientNetV1Lite0():
    return _v1("EfficientNetV1Lite0", 1.0, 1.0, (320, 320), 0.2, lite=True)


@register_model
def EfficientNetV1Lite1():
    return _v1("EfficientNetV1Lite1", 1.0, 1.1, (384, 384), 0.2, lite=True)


@register_model
def EfficientNetV1Lite2():
    return _v1("EfficientNetV1Lite2", 1.1, 1.2, (448, 448), 0.3, lite=True)


@register_model
def EfficientNetV1Lite3():
    return _v1("EfficientNetV1Lite3", 1.2, 1.4, (512, 512), 0.3, lite=True)


@register_model
def EfficientNetV1Lite4():
    return _v1("EfficientNetV1Lite4", 1.4, 1.8, (640, 640), 0.3, lite=True)
