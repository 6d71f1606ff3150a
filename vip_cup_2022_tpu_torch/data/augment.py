"""The test-time augmentation (TTA) and the training augment ops as batched
PyTorch ops (counterpart of ``vip_cup_2022_tpu/data/augment.py``).

The shipped TTA, ``apply_augment``: gate at ``u <= 0.8``, then a
horizontal and a vertical flip at 0.5 each, then BT.601 gray at 0.3, every
decision per sample. The reference's training ops that its shipped
pipeline leaves off: ``random_bgr``, ``random_jitter`` (hue in YIQ,
saturation, contrast, brightness), a Gaussian ``blur``,
``shift_scale_shear_rotate`` (one bilinear warp, zero fill), the on-device
JPEG round trip (``jpeg_roundtrip``, ``random_jpeg_quality``: YCbCr, 4:2:0
chroma, 8 x 8 DCT quantization at libjpeg's quality scaling) and the exact
host one through cv2 (``jpeg_compress_host``).

Each op is split from its random draw: the ops take explicit per-sample
masks and values of shape (B,) (the ``*Draws`` tuples), and the ``draw_*``
functions draw them from an explicit CPU ``torch.Generator``. JAX's PRNG
keys cannot be reproduced in torch; a caller that must match the JAX
package's draws passes values drawn the JAX way. Per-sample arguments are
computed on the CPU in the JAX module's f32 expressions and moved to the
images' device; the images stay where they are.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .randaugment import bilinear_taps, depthwise_same, matrix_from_rows

GRAY_W = (0.2989, 0.5870, 0.1140)  # ITU-R BT.601, as tf.image.rgb_to_grayscale
# apply_augment's probabilities: the gate, the two flips, gray
AUGMENT_PROB, HFLIP_PROB, VFLIP_PROB, GRAY_PROB = 0.80, 0.5, 0.5, 0.3


class TTAMasks(NamedTuple):
    """Per-sample decisions of one augmented copy, each a bool (B,)."""
    gate: torch.Tensor
    hflip: torch.Tensor
    vflip: torch.Tensor
    gray: torch.Tensor

    def to(self, device) -> "TTAMasks":
        return TTAMasks(*(m.to(device) for m in self))


def _per_sample(mask: torch.Tensor) -> torch.Tensor:
    return mask.view(-1, 1, 1, 1)


def flip(img: torch.Tensor, hflip: torch.Tensor, vflip: torch.Tensor) -> torch.Tensor:
    """``random_flip``: the samples ``hflip`` marks mirrored along W, then
    those ``vflip`` marks along H; img (B, H, W, C)."""
    img = torch.where(_per_sample(hflip), img.flip(2), img)
    return torch.where(_per_sample(vflip), img.flip(1), img)


def gray(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``random_gray``: the samples ``mask`` marks replaced by their BT.601
    gray in every channel, the weights cast to the image's dtype as the JAX
    op casts them."""
    w = torch.tensor(GRAY_W, dtype=img.dtype, device=img.device)
    g = (img * w).sum(-1, keepdim=True)
    return torch.where(_per_sample(mask), g.expand_as(img), img)


def apply_augment(img: torch.Tensor, masks: TTAMasks) -> torch.Tensor:
    """``apply_augment``: flips and gray where the gate is set, the input
    elsewhere."""
    aug = gray(flip(img, masks.hflip, masks.vflip), masks.gray)
    return torch.where(_per_sample(masks.gate), aug, img)


def draw_masks(generator: torch.Generator, batch: int) -> TTAMasks:
    """The masks of one augmented copy of a batch, from four uniforms a sample
    drawn from ``generator``, with ``apply_augment``'s comparisons."""
    u = torch.rand((4, batch), generator=generator)
    return TTAMasks(u[0] <= AUGMENT_PROB, u[1] < HFLIP_PROB, u[2] < VFLIP_PROB, u[3] < GRAY_PROB)


def draw_gate(generator: torch.Generator, batch: int, prob: float) -> torch.Tensor:
    """A per-sample bool (B,): ``u < prob``."""
    return torch.rand(batch, generator=generator) < prob


def random_bgr(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The channels of the samples ``mask`` marks reversed."""
    return torch.where(_per_sample(mask.to(img.device)), img.flip(-1), img)


class JitterDraws(NamedTuple):
    """``random_jitter``'s per-sample draws, each (B,): the gate, the
    brightness delta, the contrast and saturation factors, the hue turn."""
    apply: torch.Tensor
    delta: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor


def draw_jitter(generator: torch.Generator, batch: int, hue: float = 0.1,
                sat=(0.8, 1.2), cont=(0.8, 1.2), bri: float = 0.1,
                prob: float = 0.25) -> JitterDraws:
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator)

    return JitterDraws(draw_gate(generator, batch, prob), u(-bri, bri), u(*cont), u(*sat),
                       u(-hue, hue))


YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))


def _mix(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("ij,bhwj->bhwi", m, x)`` for a 3 x 3 ``m`` as elementwise
    products in f32, the sum over j in order."""
    xs = x.unbind(-1)
    return torch.stack([xs[0] * float(m[i, 0]) + xs[1] * float(m[i, 1]) + xs[2] * float(m[i, 2])
                        for i in range(3)], -1)


def random_jitter(img: torch.Tensor, d: JitterDraws) -> torch.Tensor:
    """Hue (a rotation of the YIQ chroma plane by ``hue`` turns),
    saturation (a blend with BT.601 gray), contrast (about the per-channel
    mean), brightness (plus ``delta``), clipped to [0, 1], on the samples
    ``d.apply`` marks; images in [0, 1]."""
    yiq = torch.tensor(YIQ, dtype=torch.float32)
    col = lambda v: v.to(device=img.device, dtype=img.dtype).view(-1, 1, 1, 1)  # noqa: E731
    theta = d.hue * 2.0 * math.pi
    cos_t, sin_t = col(torch.cos(theta)), col(torch.sin(theta))
    x_yiq = _mix(yiq, img)
    yy = x_yiq[..., 0:1]
    ii = x_yiq[..., 1:2] * cos_t - x_yiq[..., 2:3] * sin_t
    qq = x_yiq[..., 1:2] * sin_t + x_yiq[..., 2:3] * cos_t
    out = _mix(torch.linalg.inv(yiq), torch.cat([yy, ii, qq], -1))
    w = torch.tensor(GRAY_W, dtype=img.dtype, device=img.device)
    gray = (out * w).sum(-1, keepdim=True)
    out = gray + (out - gray) * col(d.saturation)
    mean = out.mean(dim=(1, 2), keepdim=True)
    out = (out - mean) * col(d.contrast) + mean
    out = torch.clamp(out + col(d.delta), 0.0, 1.0)
    return torch.where(_per_sample(d.apply.to(img.device)), out, img)


def gaussian_kernel(size: int, sigma: float) -> torch.Tensor:
    """The normalised (size, size) Gaussian in f32."""
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    return k[:, None] * k[None, :]


def blur(img: torch.Tensor, mask: torch.Tensor, filter_size: int = 3) -> torch.Tensor:
    """A Gaussian blur (sigma 1, zero-padded SAME) of the samples ``mask``
    marks: the JAX package's on-device half of the reference's ``Blur``,
    whose median branch is host-only."""
    blurred = depthwise_same(img, gaussian_kernel(filter_size, sigma=1.0))
    return torch.where(_per_sample(mask.to(img.device)), blurred, img)


class AffineDraws(NamedTuple):
    """``shift_scale_shear_rotate``'s draws: the gate (B,) and six standard
    normals (B, 6) for rotation, shear, the two zooms and the two shifts."""
    apply: torch.Tensor
    normal: torch.Tensor


def draw_affine(generator: torch.Generator, batch: int, prob: float = 0.65) -> AffineDraws:
    return AffineDraws(draw_gate(generator, batch, prob),
                       torch.randn((batch, 6), generator=generator))


def shift_scale_shear_rotate(img: torch.Tensor, d: AffineDraws, rot: float = 5.0,
                             shr: float = 5.0, h_zoom: float = 50.0, v_zoom: float = 50.0,
                             h_shift: float = 30.0, v_shift: float = 30.0) -> torch.Tensor:
    """The reference's affine (augment.py:68-107) on the samples
    ``d.apply`` marks: rotation ``rot * n0`` degrees, shear ``shr * n1``,
    zooms ``1 + n2 / h_zoom`` and ``1 + n3 / v_zoom``, shifts ``h_shift *
    n4`` and ``v_shift * n5``; one bilinear warp about the image centre
    through the inverse of rot @ shear @ zoom @ shift, zero outside."""
    b, h, w, _ = img.shape
    n = d.normal.float()
    rot_r = rot * n[:, 0] * math.pi / 180.0
    shear_r = shr * n[:, 1] * math.pi / 180.0
    hz, wz = 1.0 + n[:, 2] / h_zoom, 1.0 + n[:, 3] / v_zoom
    hs, ws = h_shift * n[:, 4], v_shift * n[:, 5]
    zero, one = torch.zeros(b), torch.ones(b)
    c2, s2 = torch.cos(shear_r), torch.sin(shear_r)
    cr, sr = torch.cos(-rot_r), torch.sin(-rot_r)
    m = (matrix_from_rows([[cr, sr, zero], [-sr, cr, zero], [zero, zero, one]])
         @ matrix_from_rows([[one, s2, zero], [zero, c2, zero], [zero, zero, one]])
         @ matrix_from_rows([[one / hz, zero, zero], [zero, one / wz, zero], [zero, zero, one]])
         @ matrix_from_rows([[one, zero, hs], [zero, one, ws], [zero, zero, one]]))
    inv = torch.linalg.inv(m).to(img.device)
    e = lambda i, j: inv[:, i, j].view(-1, 1, 1)  # noqa: E731
    gy = (torch.arange(h, dtype=torch.float32, device=img.device) - (h - 1) / 2.0).view(h, 1)
    gx = (torch.arange(w, dtype=torch.float32, device=img.device) - (w - 1) / 2.0).view(1, w)
    sy = e(0, 0) * gy + e(0, 1) * gx + e(0, 2) + (h - 1) / 2.0
    sx = e(1, 0) * gy + e(1, 1) * gx + e(1, 2) + (w - 1) / 2.0
    valid = ((sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1))[..., None]
    warped = torch.where(valid, bilinear_taps(img, sy, sx), torch.zeros((), device=img.device))
    return torch.where(_per_sample(d.apply.to(img.device)), warped, img)


# ---------------------------------------------------------------------------
# JpegCompress (reference dataset/augment.py:110-113, tf.image.
# random_jpeg_quality): the on-device round trip, without entropy coding,
# and the exact host one through cv2 / libjpeg
# ---------------------------------------------------------------------------

JPEG_LUMA = torch.tensor([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=torch.float32)

JPEG_CHROMA = torch.tensor([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
] + [[99] * 8] * 4, dtype=torch.float32)


def jpeg_quant_table(base: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """libjpeg's quality scaling (jcparam.c ``jpeg_quality_scaling``) of
    ``base`` (8, 8) for each quality (B,): (B, 8, 8) f32 on the CPU."""
    q = torch.clamp(torch.as_tensor(quality).cpu(), 1, 100).float().view(-1, 1, 1)
    scale = torch.where(q < 50, torch.full_like(q, 5000.0) / q, 200.0 - 2.0 * q)
    return torch.clamp(torch.floor((base * scale + 50.0) / 100.0), 1.0, 255.0)


def dct8() -> torch.Tensor:
    """The orthonormal 8-point DCT-II matrix, f32."""
    k = torch.arange(8, dtype=torch.float32)
    mat = torch.cos((2 * k[None, :] + 1) * k[:, None] * (math.pi / 16.0))
    alpha = torch.full((8,), math.sqrt(2.0 / 8.0))
    alpha[0] = math.sqrt(1.0 / 8.0)
    return mat * alpha[:, None]


def dct_blocks(chan: torch.Tensor) -> torch.Tensor:
    """The 8 x 8 blockwise DCT of ``chan`` (B, H, W): (B, H/8, W/8, 8, 8)."""
    b, h, w = chan.shape
    d = dct8().to(chan.device)
    blocks = chan.reshape(b, h // 8, 8, w // 8, 8).transpose(2, 3)
    return d @ blocks @ d.T


def _dct_quant_roundtrip(chan: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``chan`` (B, H, W), centred values: blockwise DCT, quantisation by
    each sample's ``table`` (B, 8, 8) with round half to even, inverse
    DCT."""
    b, h, w = chan.shape
    d = dct8().to(chan.device)
    table = table.to(chan.device)[:, None, None]
    coef = torch.round(dct_blocks(chan) / table) * table
    return (d.T @ coef @ d).transpose(2, 3).reshape(b, h, w)


def jpeg_ycbcr(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JPEG colour transform of [0, 1] images (B, H, W, 3), edge-padded
    to multiples of 16 in the 0-255 domain: Y, Cb, Cr, each (B, H', W')."""
    _, h, w, _ = img.shape
    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    x = img * 255.0
    if ph or pw:
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                                    mode="replicate").permute(0, 2, 3, 1)
    r, g, b = x.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return y, cb, cr


def chroma_420(c: torch.Tensor) -> torch.Tensor:
    """4:2:0 subsampling: the mean of each 2 x 2 block of ``c`` (B, H, W)."""
    b, h, w = c.shape
    return c.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def jpeg_roundtrip(img: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """The on-device JPEG round trip of [0, 1] images (B, H, W, 3) at each
    sample's ``quality`` (B,): Y at full resolution, Cb and Cr at 4:2:0,
    each quantised blockwise by libjpeg's tables; back to RGB in [0, 1]."""
    _, h, w, _ = img.shape
    y, cb, cr = jpeg_ycbcr(img)
    y = _dct_quant_roundtrip(y - 128.0, jpeg_quant_table(JPEG_LUMA, quality)) + 128.0
    ct = jpeg_quant_table(JPEG_CHROMA, quality)

    def chroma(c):
        sub = _dct_quant_roundtrip(chroma_420(c) - 128.0, ct) + 128.0
        return sub.repeat_interleave(2, 1).repeat_interleave(2, 2)

    cb, cr = chroma(cb), chroma(cr)
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    out = torch.stack([r, g, b], -1)[:, :h, :w]
    return torch.clamp(out / 255.0, 0.0, 1.0).to(img.dtype)


def draw_jpeg_quality(generator: torch.Generator, batch: int, quality=(85, 95),
                      prob: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``random_jpeg_quality``'s draws: the gate (B,) and a quality (B,)
    uniform over ``quality[0] .. quality[1]``."""
    return (draw_gate(generator, batch, prob),
            torch.randint(quality[0], quality[1] + 1, (batch,), generator=generator))


def random_jpeg_quality(img: torch.Tensor, gate: torch.Tensor,
                        quality: torch.Tensor) -> torch.Tensor:
    """The samples ``gate`` marks through :func:`jpeg_roundtrip` at their
    ``quality``, the rest as they are."""
    sel = gate.cpu().nonzero().squeeze(1)
    if not len(sel):
        return img
    idx = sel.to(img.device)
    return img.index_copy(0, idx, jpeg_roundtrip(img.index_select(0, idx),
                                                 torch.as_tensor(quality).cpu()[sel]))


def jpeg_compress_host(images_u8, rng: np.random.RandomState, quality=(85, 95),
                       prob: float = 0.5) -> List[np.ndarray]:
    """The exact JPEG round trip on the host through cv2 (libjpeg), as
    ``tf.image.random_jpeg_quality``: per uint8 HWC RGB image, with
    probability ``prob`` (``rng.uniform()``), re-encoded at a quality from
    ``rng.randint(quality[0], quality[1] + 1)``."""
    import cv2

    out = []
    for im in images_u8:
        if rng.uniform() < prob:
            q = int(rng.randint(quality[0], quality[1] + 1))
            ok, enc = cv2.imencode(".jpg", im[..., ::-1], [int(cv2.IMWRITE_JPEG_QUALITY), q])
            if ok:
                im = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
        out.append(im)
    return out
