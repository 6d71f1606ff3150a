"""Torch-style symmetric padding (counterpart of
``vip_cup_2022_tpu/ops/pad.py``).

The reference zoos pad ``k // 2`` on every side, even at stride 2 (ResNet-RS's
``Conv2DFixedPadding``), where TF's ``SAME`` would pad asymmetrically. The
port's :class:`..ops.conv.Conv` takes that symmetric padding as one int.
"""
from __future__ import annotations


def symmetric_padding(kernel_size: int) -> int:
    """Exact torch semantics for an odd square kernel: ``k // 2`` on every
    side."""
    return kernel_size // 2
