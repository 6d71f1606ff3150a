"""The in-kernel int8 scheme of the fused blocks, as plain functions.

Counterpart of the JAX package's ``VIPTPU_INT8_KERNELS=1`` mode
(``vip_cup_2022_tpu/ops/pallas/convnext_block.py::int8_kernels_enabled``,
``_quant_cols``; ``gcvit_block.py::_dyn_quant_rows``, ``_dot_i8``,
``gcvit_int8``): the dense GEMMs of ConvNeXt's and GCViT's fused blocks run
s8 x s8 -> s32, with weights quantized per output channel once and
activations quantized per row by a dynamic abs-max, so no calibration pass
is needed. The rounding, in the JAX package's order:

- weight scale ``amax / 127`` per output column (1 for an all-zero column,
  so its dequant stays 0), codes ``clip(round(w / s), -127, 127)`` by
  division, from the f32 weight;
- activation scale ``max(amax, 1e-8) * f32(1 / 127)`` per row, codes
  ``clip(round(y * f32(1 / s)), -127, 127)``, the reciprocal an f32
  division; ``round`` is half to even everywhere;
- the dequant ``f32(acc) * (s_row * s_col)``, then ``+ bias``, each step
  rounded on its own (no fused multiply-add).

The JAX ConvNeXt whole-image kernel (K1) takes one activation scale per
grid tile, a tile the TPU's VMEM pickers choose; the port takes one per row
at every site, K2's and GCViT's granularity, which does not depend on a
tiling. This module imports nothing of the JAX package.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.tf32 import Tf32Weight, tf32_weight

INV_127 = float(np.float32(1.0 / 127.0))  # the f32 constant of ``* (1.0 / 127.0)``
MIN_AMAX = float(np.float32(1e-8))
GCVIT_INT8_MIN_C = 128  # VIPTPU_GCVIT_INT8_MIN_C's default


def int8_kernels_enabled() -> bool:
    """``VIPTPU_INT8_KERNELS=1`` turns the mode on; any other value leaves
    it off, as the JAX package reads it."""
    return os.environ.get("VIPTPU_INT8_KERNELS", "0") == "1"


def gcvit_int8(c: int) -> bool:
    """Whether a GCViT block of width ``c`` runs its dense GEMMs int8: the
    mode is on and ``c >= VIPTPU_GCVIT_INT8_MIN_C`` (default 128, so
    GCViTTiny's first level, C = 64, stays bf16)."""
    return int8_kernels_enabled() and c >= int(
        os.environ.get("VIPTPU_GCVIT_INT8_MIN_C", str(GCVIT_INT8_MIN_C)))


def convnext_int8(c: int, batch_lane_width: int) -> bool:
    """Whether a ConvNeXt block of width ``c`` on the fused path runs its MLP
    int8: the mode is on and, for the stages the JAX package runs batch-last
    (``c < batch_lane_width``), its lane-fold GEMM is on
    (``VIPTPU_BATCHLANE_FOLD`` is ``1``, the default)."""
    if not int8_kernels_enabled():
        return False
    return c >= batch_lane_width or os.environ.get("VIPTPU_BATCHLANE_FOLD", "1") == "1"


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def quant_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 of an f32 (K, N) weight: (codes (K, N) int8,
    scales (N,) f32)."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    s = torch.where(amax > 0, amax / _f32(127.0, wf), _f32(1.0, wf))
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s


def quant_rows_with(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Codes of an (M, K) activation with given row scales ``s`` (M, 1):
    ``clip(round(y * f32(1 / s)), -127, 127)``, int8."""
    yf = y.float()
    inv = _f32(1.0, yf) / s
    return torch.clamp(torch.round(yf * inv), -127, 127).to(torch.int8)


def dyn_quant_rows(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row int8 of an (M, K) activation, taken in f32: (codes
    (M, K) int8, scales (M, 1) f32)."""
    yf = y.float()
    amax = yf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax, min=MIN_AMAX) * _f32(INV_127, yf)
    return quant_rows_with(yf, s), s


def int_matmul(q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) int8 @ (K, N) int8 -> int32, its products summed in f64
    (exact: |sum| <= 127^2 K < 2^53)."""
    return torch.matmul(q.double(), w_q.double()).round().to(torch.int32)


def dequant(acc: torch.Tensor, s_row: torch.Tensor, s_col: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``f32(acc) * (s_row * s_col)`` then ``+ bias``, each rounded apart."""
    o = acc.float() * (s_row * s_col)
    return o if bias is None else o + bias.float()


def dot_i8(y: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, K) activation @ int8 (K, N) weight with per-column scales
    ``s_w``: the activation quantized per row, the exact int32 product,
    then :func:`dequant`. f32 (M, N)."""
    q, s = dyn_quant_rows(y)
    return dequant(int_matmul(q, w_q), s, s_w, bias)


class Int8Weight(NamedTuple):
    """A Linear's weight quantized per output channel: codes (N, K) int8 in
    the nn.Linear layout, scales (N,) f32."""
    q: torch.Tensor
    s: torch.Tensor


def quantize_linear(weight: torch.Tensor) -> Int8Weight:
    """:func:`quant_cols` of an f32 nn.Linear weight (N, K)."""
    q, s = quant_cols(weight.t())
    return Int8Weight(q.t().contiguous(), s)


class Int8Block:
    """Mixin of a fused block whose dense GEMMs run int8 in the mode: the
    Linears named in ``INT8_LINEARS`` (dotted paths under the block) are
    quantized once, from their f32 values, and kept until a weight changes.

    :meth:`set_int8_weights` quantizes from ``weights`` (state_dict keys ->
    the f32 values a bf16 model was cast from, as the engine keeps them for
    int8) or, for a key it lacks, from the parameter itself if that is f32;
    otherwise it raises, as the weights are never quantized from a bf16
    cast. :meth:`int8_weights` returns the cache, made from the parameters
    on first use, and again after any of them changes (a reload or an
    in-place write moves its version counter, a move to another device its
    storage).

    The same f32 values feed the f32 GEMMs that ``VIPTPU_GCVIT_MM=f32`` asks
    of a bf16 GCViT block: :meth:`set_f32_weights` keeps them on the
    parameters' device and :meth:`f32_weights` returns them, under the same
    rules.

    The 3xTF32 f32 GEMMs (``csrc/tf32_gemm.cuh``) read a Linear's f32 weight
    as its split pair (:func:`..ops.kernels.tf32.tf32_weight`):
    :meth:`tf32_weight` makes it once per Linear, from the parameter if it is
    f32, else from :meth:`f32_weights`, and makes it again when the
    parameter's storage or version moves (an optimizer step, a reload, an
    in-place write) or :meth:`set_f32_weights` runs."""

    INT8_LINEARS: Tuple[str, ...] = ()
    _int8: Optional[Dict[str, Int8Weight]] = None
    _int8_key: Optional[tuple] = None
    _f32: Optional[Dict[str, torch.Tensor]] = None
    _f32_key: Optional[tuple] = None
    _f32_generation = 0  # set_f32_weights calls: a split from their values is remade after one
    _tf32: Optional[Dict[str, Tuple[tuple, Tf32Weight]]] = None

    def _int8_params(self):
        return [self.get_submodule(name).weight for name in self.INT8_LINEARS]

    def _int8_state(self) -> tuple:
        return tuple((p.data_ptr(), p._version) for p in self._int8_params())

    def set_int8_weights(self, weights: Optional[Mapping[str, Any]] = None,
                         prefix: str = "") -> None:
        from .ptq import _f32_source

        cache = {}
        for name, param in zip(self.INT8_LINEARS, self._int8_params()):
            src = _f32_source(f"{prefix}{name}.weight", param, weights)
            cache[name] = quantize_linear(src.to(param.device))
        self._int8, self._int8_key = cache, self._int8_state()

    def int8_weights(self) -> Dict[str, Int8Weight]:
        if self._int8 is None or self._int8_key != self._int8_state():
            self.set_int8_weights()
        return self._int8

    def set_f32_weights(self, weights: Optional[Mapping[str, Any]] = None,
                        prefix: str = "") -> None:
        from .ptq import _f32_source

        self._f32 = {name: _f32_source(f"{prefix}{name}.weight", param, weights)
                     .to(param.device).contiguous()
                     for name, param in zip(self.INT8_LINEARS, self._int8_params())}
        self._f32_key = self._int8_state()
        self._f32_generation += 1

    def f32_weights(self) -> Dict[str, torch.Tensor]:
        if self._f32 is None or self._f32_key != self._int8_state():
            self.set_f32_weights()
        return self._f32

    def tf32_weight(self, name: str) -> Tf32Weight:
        """The 3xTF32 pair of Linear ``name``'s f32 weight, cached."""
        param = self.get_submodule(name).weight
        src = param if param.dtype == torch.float32 else self.f32_weights()[name]
        key = (param.data_ptr(), param._version,
               None if src is param else self._f32_generation)
        if self._tf32 is None:
            self._tf32 = {}
        hit = self._tf32.get(name)
        if hit is None or hit[0] != key:
            hit = self._tf32[name] = (key, tf32_weight(src))
        return hit[1]


def attach(model: torch.nn.Module, weights: Optional[Mapping[str, Any]] = None,
           f32: bool = False) -> int:
    """Quantize the int8 weights of every :class:`Int8Block` of ``model``
    from ``weights`` (state_dict keys -> f32 values) or its own f32
    parameters, or, with ``f32``, keep those f32 values for its f32 GEMMs;
    returns the number of blocks."""
    blocks = 0
    for name, module in model.named_modules():
        if isinstance(module, Int8Block):
            setter = module.set_f32_weights if f32 else module.set_int8_weights
            setter(weights, f"{name}." if name else "")
            blocks += 1
    return blocks
