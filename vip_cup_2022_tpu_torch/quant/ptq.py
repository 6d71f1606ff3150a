"""Post-training int8 quantization (PTQ) of a member's convs and Linears.

Counterpart of ``vip_cup_2022_tpu/quant/ptq.py`` with the same sites,
eligibility rule, scales and arithmetic, in PyTorch's idiom:

- **calibration** (:func:`calibrate`): forward pre-hooks on every candidate
  (``Conv``, ``Linear``, ``DepthwiseConv``, ``DepthwiseTaps``,
  ``ScaledStdConv``) record the f32 abs-max of each eligible site's input
  over the batches (the depthwise ones never pass the rule, and are
  reported skipped as the JAX pass reports its grouped ``nn.Conv``);
- **quantized inference** (:func:`quantized`): each calibrated site's module
  is swapped for a :class:`QuantizedSite`, which quantizes the activation
  with the frozen scale (symmetric per-tensor int8), holds the weight
  quantized per output channel from its f32 values, and runs the int8
  kernel :func:`..ops.kernels.int8_gemm.ptq_int8_conv` (its plain version on
  the CPU): ``f32(acc) * (f32(s_x) * s_w) (+ bias)`` in f32, cast to the
  module's dtype, or x's when it has none.

A site is named as in the JAX package, ``"/".join`` of the Flax path of the
intercepted ``nn.Conv`` / ``nn.Dense`` / ``ScaledStdConv``: the port's
modules are named after the Flax modules, so the site is the module's dotted
name with ``/`` (``c2_block_0/conv_1/conv``, ResNest's flat
``stack1_block1_deep_2_sa_1_g1_conv``, NFNet's ``stack2_block1_deep_2_conv``).
A scale table written by either package loads in the other. ResNest's
split-attention convs read channel halves of their input, views that
:class:`QuantizedSite` makes contiguous before the kernel.

NFNet's weight-standardized convs (:class:`..ops.conv.ScaledStdConv`) are
sites as in the JAX pass (``_handle_stdconv``): the weight quantized is the
standardized one, computed in f32 from the f32 ``weight`` and ``gain``
(:func:`..ops.conv.standardize_weight`, JAX's ``_standardized_weight``),
never the raw weight or the compute-dtype copy the module caches. A grouped
conv runs the kernel in its groups (XLA's ``feature_group_count``), and a
padding of pairs or TF ``"same"`` is resolved at each call's size into the
(top, bottom), (left, right) pairs the kernel takes. A module whose block
reads its parameters into a fused kernel without calling it (ConvNeXt's and
GCViT's MLP Linears on the fused block path) is never called, so it is
neither calibrated nor swapped, as the JAX pass never intercepts the
parameters a Pallas block reads.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.conv import (Conv, DepthwiseConv, DepthwiseTaps, Linear, ScaledStdConv,
                        standardize_weight)
from ..ops.kernels import int8_gemm
from ..ops.pad import resolve_padding

CANDIDATES = (Conv, Linear, DepthwiseConv, DepthwiseTaps, ScaledStdConv)
DEPTHWISE = (DepthwiseConv, DepthwiseTaps)  # one input feature a group: never a site
CONVS = (Conv, ScaledStdConv)


@dataclasses.dataclass(frozen=True)
class PTQConfig:
    """Eligibility of a site (the JAX package's rule). A site is quantized
    only when ALL of:

    - per-group input features >= ``min_group_features`` (a depthwise conv
      has one, so it is never quantized);
    - total input features >= ``min_in_features`` (excludes the RGB stem);
    - output features >= ``min_out_features``;
    - more than one spatial position (a conv) or row (a Linear): SE gates on
      pooled features and pooled heads stay in float;
    - no lower-cased path component starts with one of
      ``skip_name_prefixes`` (heads keep full precision: the binary map
      feeds the 0.487 threshold).
    """

    min_in_features: int = 32
    min_out_features: int = 32
    min_group_features: int = 32
    skip_name_prefixes: Tuple[str, ...] = (
        "head", "predictions", "classifier", "logits", "se", "attn", "stem",
    )

    def eligible(self, site: str, in_per_group: int, fgc: int, out_features: int,
                 spatial_positions: int) -> bool:
        if in_per_group < self.min_group_features:
            return False
        if in_per_group * fgc < self.min_in_features:
            return False
        if out_features < self.min_out_features:
            return False
        if spatial_positions <= 1:
            return False
        parts = [p.lower() for p in site.split("/")]
        return not any(p.startswith(pref) for p in parts for pref in self.skip_name_prefixes)


def site_name(module_name: str) -> str:
    return module_name.replace(".", "/")


def _shape_args(module: nn.Module, x: torch.Tensor) -> Tuple[int, int, int, int]:
    """(in_per_group, groups, out_features, positions) of one call."""
    if isinstance(module, Linear):
        positions = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
        return x.shape[-1], 1, module.weight.shape[0], positions
    spatial = x.shape[1] * x.shape[2]
    if isinstance(module, DEPTHWISE):
        return 1, x.shape[-1], x.shape[-1], spatial
    return x.shape[-1] // module.groups, module.groups, module.weight.shape[0], spatial


def _eligible(config: PTQConfig, site: str, module: nn.Module, x: torch.Tensor) -> bool:
    if not isinstance(module, Linear) and x.ndim != 4:
        return False
    return config.eligible(site, *_shape_args(module, x))


def calibrate(model: nn.Module, batches: Iterable[Any],
              config: Optional[PTQConfig] = None) -> Dict[str, float]:
    """Run ``model`` over ``batches`` and return ``{site: abs-max of its
    input}`` for every eligible site that the batches reached; the maxima
    are taken in f32 on the device and read once at the end."""
    config = config or PTQConfig()
    traced: Dict[str, torch.Tensor] = {}

    def hook(site):
        def record(module, args):
            x = args[0]
            if _eligible(config, site, module, x):
                amax = x.detach().float().abs().amax()
                prev = traced.get(site)
                traced[site] = amax if prev is None else torch.maximum(prev, amax)
        return record

    handles = [m.register_forward_pre_hook(hook(site_name(name)))
               for name, m in model.named_modules() if isinstance(m, CANDIDATES)]
    try:
        with torch.inference_mode():
            for batch in batches:
                model(batch)
    finally:
        for h in handles:
            h.remove()
    return {site: float(v) for site, v in traced.items()}


class _Report:
    """The sites one forward quantized and skipped, in call order."""

    def __init__(self):
        self.quantized_sites: list = []
        self.skipped_sites: list = []


def quantize_weight(w_kn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an f32 (K, N) kernel:
    ``s = max(amax, 1e-8) / 127`` and ``clip(round(w / s), -127, 127)``,
    all in f32."""
    amax = w_kn.abs().amax(dim=0)
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w_kn / s), -127, 127).to(torch.int8)
    return q, s


class QuantizedSite(nn.Module):
    """A calibrated Conv, ScaledStdConv or Linear running the int8 kernel,
    ``weight`` the f32 (O, I / groups, kh, kw) or (out, in) values to
    quantize. A call that is not eligible (its input shape fails the rule)
    runs the float module it replaced, as the JAX pass falls through to the
    original op."""

    def __init__(self, site: str, module: nn.Module, amax: float, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], config: PTQConfig, report: Optional[_Report]):
        super().__init__()
        self.site, self.config, self._report = site, config, report
        self.float_module = module
        s_x = max(amax, 1e-8) / 127.0
        self.inv_s = int8_gemm.f32_reciprocal(s_x)
        n = weight.shape[0]
        if isinstance(module, CONVS):
            self.kernel, self.stride, self.padding = weight.shape[-1], module.stride, module.padding
            self.groups = module.groups
            w_kn = weight.permute(2, 3, 1, 0).reshape(-1, n)  # HWIO -> (kh kw I / groups, O)
        else:
            self.kernel, self.stride, self.padding, self.groups = None, 1, 0, 1
            w_kn = weight.t()
        qw, s_w = quantize_weight(w_kn.float())
        device = module.weight.device
        self.register_buffer("qweight", int8_gemm.pack_weight(qw).to(device))
        self.register_buffer("colscale", (torch.tensor(s_x, dtype=torch.float32) * s_w).to(device))
        self.register_buffer("bias_f32", None if bias is None else bias.float().to(device))
        self.out_dtype = module.dtype

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The replaced conv's own call without hooks (:meth:`..ops.conv.Conv.conv`),
        float: a call the JAX pass never sees is no int8 site."""
        return self.float_module.conv(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eligible = _eligible(self.config, self.site, self.float_module, x)
        if self._report is not None:
            (self._report.quantized_sites if eligible else self._report.skipped_sites).append(
                self.site)
        if not eligible:
            return self.float_module(x)
        padding = self.padding
        if self.kernel is not None and not isinstance(padding, int):
            padding = resolve_padding(padding, x.shape[1], x.shape[2], self.kernel, self.stride)
        return int8_gemm.ptq_int8_conv(
            x.contiguous(), self.qweight, self.colscale, self.bias_f32, self.inv_s,
            kernel=self.kernel, stride=self.stride, padding=padding, groups=self.groups,
            out_dtype=self.out_dtype or x.dtype)


def _f32_source(key: str, param: Optional[torch.Tensor],
                weights: Optional[Mapping[str, Any]]) -> Optional[torch.Tensor]:
    if param is None:
        return None
    if weights is not None and key in weights:
        value = weights[key]
        value = value.detach() if isinstance(value, torch.Tensor) else torch.as_tensor(
            np.asarray(value))
        if value.dtype != torch.float32 or tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{key}: f32 source {value.dtype} {tuple(value.shape)} does not "
                             f"match the parameter {tuple(param.shape)}")
        return value
    if param.dtype != torch.float32:
        raise ValueError(f"{key} is held in {param.dtype}; int8 weights are quantized from the "
                         "f32 values, so pass them in `weights`")
    return param.detach()


def quantized(model: nn.Module, scales: Mapping[str, float],
              config: Optional[PTQConfig] = None, report: Optional[dict] = None,
              weights: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """Swap each Conv / ScaledStdConv / Linear of ``model`` whose site has a
    scale for a :class:`QuantizedSite`, in place, and return ``model``.
    ``weights`` maps state_dict keys to the f32 values the parameters were
    cast from (a bf16 model's checkpoint,
    :func:`..weights.from_jax.flax_to_torch`); a parameter without one must
    itself be f32. A ScaledStdConv's int8 weight is standardized from its
    f32 ``weight`` and ``gain``. ``report``, if given,
    receives ``quantized_sites`` / ``skipped_sites`` after every forward
    (recorded by hooks that exist only then)."""
    config = config or PTQConfig()
    calls = _Report() if report is not None else None
    candidates = [(name, m) for name, m in model.named_modules() if isinstance(m, CANDIDATES)]
    for name, module in candidates:
        site = site_name(name)
        if site in scales and not isinstance(module, DEPTHWISE):
            weight = _f32_source(f"{name}.weight", module.weight, weights)
            if isinstance(module, ScaledStdConv):
                weight = standardize_weight(
                    weight, _f32_source(f"{name}.gain", module.gain, weights), module.gamma,
                    module.eps)
            new = QuantizedSite(site, module, float(scales[site]), weight,
                                _f32_source(f"{name}.bias", module.bias, weights), config, calls)
            parent, _, child = name.rpartition(".")
            setattr(model.get_submodule(parent), child, new)
        elif calls is not None:  # never quantized: JAX reports it skipped at every call
            module.register_forward_pre_hook(
                lambda _m, _a, site=site: calls.skipped_sites.append(site))
    if calls is None:
        return model

    def reset(_m, _a):
        calls.quantized_sites.clear()
        calls.skipped_sites.clear()

    def publish(_m, _a, _out):
        report["quantized_sites"] = list(calls.quantized_sites)
        report["skipped_sites"] = list(calls.skipped_sites)

    model.register_forward_pre_hook(reset)
    model.register_forward_hook(publish)
    return model


def save_scales(path: str, scales: Mapping[str, float]) -> None:
    with open(path, "w") as fh:
        json.dump(dict(scales), fh, indent=1, sort_keys=True)


def load_scales(path: str) -> Dict[str, float]:
    with open(path) as fh:
        return {k: float(v) for k, v in json.load(fh).items()}
