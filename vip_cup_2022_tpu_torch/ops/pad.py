"""Torch-style symmetric padding and TF ``SAME`` padding (counterpart of
``vip_cup_2022_tpu/ops/pad.py``).

The reference zoos pad ``k // 2`` on every side, even at stride 2 (ResNet-RS's
``Conv2DFixedPadding``, kecam's torch mode), where TF's ``SAME`` pads
asymmetrically: what Flax's ``padding="SAME"`` gives, and what kecam's TF mode
(EfficientNetV1) uses. The port's :class:`..ops.conv.Conv` and
:class:`..ops.conv.DepthwiseConv` take a padding as one symmetric int, as
explicit ``((top, bottom), (left, right))`` pairs, or as ``"same"``, resolved
at each call from the input's size by :func:`resolve_padding`.
"""
from __future__ import annotations

from typing import Tuple, Union

Padding = Tuple[Tuple[int, int], Tuple[int, int]]
PaddingSpec = Union[int, str, Padding]


def symmetric_padding(kernel_size: int) -> int:
    """Exact torch semantics for an odd square kernel: ``k // 2`` on every
    side."""
    return kernel_size // 2


def same_padding(size: int, kernel_size: int, stride: int) -> Tuple[int, int]:
    """TF ``SAME`` padding of one axis: ``ceil(size / stride)`` outputs, the
    total pad ``max((ceil(n / s) - 1) * s + k - n, 0)`` split with the odd
    one at the end, as ``lax.padtype_to_pads`` splits it."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel_size - size, 0)
    return total // 2, total - total // 2


def resolve_padding(padding: PaddingSpec, h: int, w: int, kernel_size: int,
                    stride: int) -> Padding:
    """``((top, bottom), (left, right))`` of a padding spec at an (h, w)
    input: an int pads every side by it, ``"same"`` is TF ``SAME``, explicit
    pairs pass through."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    if isinstance(padding, str):
        if padding != "same":
            raise ValueError(f"padding {padding!r} is not 'same', an int or explicit pairs")
        return same_padding(h, kernel_size, stride), same_padding(w, kernel_size, stride)
    (pt, pb), (pl, pr) = padding
    return (pt, pb), (pl, pr)
