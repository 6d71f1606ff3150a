"""Pooling on NHWC tensors, the three forms the conv members use (Flax's
``nn.avg_pool`` / ``nn.max_pool`` as the JAX package calls them):

- :func:`avg_pool_same`: ``nn.avg_pool(x, (s, s), (s, s), "SAME",
  count_include_pad=False)``, the average-pool shortcut of ResNet-RS,
  ResNest and NFNet. TF ``SAME`` pads ``ceil(n / s) * s - n`` zeros split
  with the odd one at the end, and each window averages only the positions
  it covers: at 200 px, 25 -> 13 and 13 -> 7 at s = 2;
- :func:`max_pool_3x3_s2_zero_pad`: the AotNet stem's ``jnp.pad`` by one
  zero on each side, then a VALID 3 x 3 max pool at stride 2 (the padded
  zeros take part in the max, unlike a -inf padding);
- :func:`avg_pool_3x3_s2_pad1`: the pool after a strided split attention,
  one zero of padding on each side, then a VALID 3 x 3 average pool at
  stride 2: the padded zeros count, every window divides by 9.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .pad import same_padding


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def avg_pool_same(x: torch.Tensor, stride: int) -> torch.Tensor:
    """``nn.avg_pool(x, (s, s), (s, s), "SAME", count_include_pad=False)``
    on NHWC x. Where SAME pads only at the end (s = 2, or a side that
    divides), torch's ``ceil_mode`` windows are the same windows; otherwise
    the sum over the zero-padded input in f32 over the count of covered
    positions, cast back."""
    h, w = x.shape[1], x.shape[2]
    (pt, pb), (pl, pr) = same_padding(h, stride, stride), same_padding(w, stride, stride)
    if pt == pl == 0:
        return _nhwc(F.avg_pool2d(_nchw(x), stride, stride, ceil_mode=True,
                                  count_include_pad=False))
    xp = F.pad(_nchw(x).float(), (pl, pr, pt, pb))
    ones = F.pad(torch.ones((1, 1, h, w), device=x.device), (pl, pr, pt, pb))
    total = F.avg_pool2d(xp, stride, stride, divisor_override=1)
    count = F.avg_pool2d(ones, stride, stride, divisor_override=1)
    return _nhwc((total / count).to(x.dtype))


def max_pool_3x3_s2_zero_pad(x: torch.Tensor) -> torch.Tensor:
    """One zero on each side of H and W, then a VALID 3 x 3 max pool at
    stride 2."""
    return _nhwc(F.max_pool2d(F.pad(_nchw(x), (1, 1, 1, 1)), 3, 2))


def avg_pool_3x3_s2_pad1(x: torch.Tensor) -> torch.Tensor:
    """One zero on each side of H and W, then a VALID 3 x 3 average pool at
    stride 2: each window divides by 9, the padded zeros included."""
    return _nhwc(F.avg_pool2d(_nchw(x), 3, 2, padding=1, count_include_pad=True))
