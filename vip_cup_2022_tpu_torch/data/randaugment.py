"""RandAugment and AutoAugment as batched PyTorch ops (counterpart of
``vip_cup_2022_tpu/data/randaugment.py``, kecam's ``imagenet/augment.py``).

Images are (B, H, W, C) float on any device; inside the ops they are f32 in
the 0-255 domain, as the reference's uint8 math. Every op takes its
per-image arguments as (B,) tensors or Python numbers.

Each policy is split from its random draws, as the TTA ops of
``data/augment.py`` are: :func:`draw_rand_augment` and
:func:`draw_auto_augment` draw from an explicit CPU ``torch.Generator``
per image and layer the op, level, gate, sign (and the cutout centre);
:func:`rand_augment` and :func:`auto_augment` apply given draws. JAX's PRNG
cannot be reproduced in torch; a caller that must match the JAX package
passes draws made the JAX way.

The JAX package picks each image's op with ``lax.switch`` under ``vmap``,
which computes every branch for every image. Here the gated images of a
layer are grouped by their drawn op, and each op runs once on its group
with per-image arguments: at most 15 groups a layer for RandAugment, 25
sub-policies of two ops for AutoAugment. The per-image arguments are
computed on the CPU from the draws, in the JAX module's f32 expressions,
and moved to the images' device.

The geometric ops are one bilinear affine warp, a four-tap gather with the
JAX module's clamped indices and its ``0 <= s <= size - 1`` validity mask
(``F.grid_sample`` normalises coordinates and blends edges otherwise).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

Arg = Union[float, torch.Tensor]  # a Python number or one value an image (B,)

MAX_LEVEL = 10.0


def _per_image(v: Arg, img: torch.Tensor) -> Arg:
    """A (B,) argument shaped to broadcast over (B, H, W, C) on the
    images' device; a number as it is."""
    if isinstance(v, torch.Tensor):
        return v.to(device=img.device, dtype=torch.float32).view(-1, 1, 1, 1)
    return v


def _vector(v: Arg, n: int) -> torch.Tensor:
    """An argument as an f32 (n,) CPU tensor."""
    return torch.as_tensor(v, dtype=torch.float32).reshape(-1).expand(n).cpu()


def depthwise_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Every channel of ``img`` (B, H, W, C) convolved with ``kernel``
    (kh, kw), zero-padded as XLA's SAME, as a sum of shifted products in
    f32 (no library convolution, so no TF32 on a card)."""
    _, h, w, _ = img.shape
    kh, kw = kernel.shape
    top, left = (kh - 1) // 2, (kw - 1) // 2
    x = F.pad(img, (0, 0, left, kw - 1 - left, top, kh - 1 - top))
    out = None
    for i in range(kh):
        for j in range(kw):
            term = x[:, i:i + h, j:j + w] * float(kernel[i, j])
            out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# pixel ops (float images in [0, 255])
# ---------------------------------------------------------------------------


def _blend(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    return torch.clamp(b + (a - b) * factor, 0.0, 255.0)


def autocontrast(img: torch.Tensor) -> torch.Tensor:
    """Each image's channels stretched to [0, 255]; a flat channel as it is."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    out = (img - lo) * (255.0 / torch.clamp(hi - lo, min=1e-5))
    return torch.where(hi > lo, out.clamp(0, 255), img)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """PIL's histogram equalization per image and channel: one ``bincount``
    over (image, channel, bin) ids, PIL's LUT (step = (total - the last
    non-empty bin's count) // 255, shifted by one bin), a channel whose step
    is 0 as it is."""
    n, h, w, c = img.shape
    c8 = img.clamp(0, 255).to(torch.int64)
    group = (torch.arange(n, device=img.device).view(n, 1, 1, 1) * c
             + torch.arange(c, device=img.device).view(1, 1, 1, c))
    ids = group * 256 + c8
    histo = torch.bincount(ids.reshape(-1), minlength=n * c * 256).view(n * c, 256)
    bins = torch.arange(256, device=img.device)
    last_bin = torch.where(histo > 0, bins, -1).argmax(dim=1, keepdim=True)
    last = histo.gather(1, last_bin).squeeze(1)
    step = (histo.sum(1) - last) // 255
    lut = (histo.cumsum(1) + (step // 2)[:, None]) // step.clamp(min=1)[:, None]
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], 1).clamp(0, 255)
    out = lut.reshape(-1)[ids].to(img.dtype)
    return torch.where((step == 0).view(n, 1, 1, c), img, out)


def invert(img: torch.Tensor) -> torch.Tensor:
    return 255.0 - img


def posterize(img: torch.Tensor, bits: Arg) -> torch.Tensor:
    """Keep the top ``bits`` of each truncated uint8 value."""
    shift = (8.0 - _vector(bits, img.shape[0])).to(torch.int32).to(img.device).view(-1, 1, 1, 1)
    c8 = img.clamp(0, 255).to(torch.int32)
    return ((c8 >> shift) << shift).to(img.dtype)


def solarize(img: torch.Tensor, threshold: Arg = 128.0) -> torch.Tensor:
    return torch.where(img < _per_image(threshold, img), img, 255.0 - img)


def solarize_add(img: torch.Tensor, addition: Arg = 0.0, threshold: Arg = 128.0) -> torch.Tensor:
    added = torch.clamp(img + _per_image(addition, img), 0, 255)
    return torch.where(img < _per_image(threshold, img), added, img)


def color(img: torch.Tensor, factor: Arg) -> torch.Tensor:
    """Blend with the image's gray (0.299, 0.587, 0.114)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    gray = (img * w).sum(-1, keepdim=True)
    return _blend(img, gray.expand_as(img), _per_image(factor, img))


def contrast(img: torch.Tensor, factor: Arg) -> torch.Tensor:
    """Blend with a constant of H * W / 256: the reference's quirk (the
    upstream TF-TPU autoaugment's sum(histogram) / 256, the pixel count and
    not the mean intensity), kept for parity with reference-trained
    models."""
    mean = img.shape[1] * img.shape[2] / 256.0
    return _blend(img, torch.full_like(img, mean), _per_image(factor, img))


def brightness(img: torch.Tensor, factor: Arg) -> torch.Tensor:
    return _blend(img, torch.zeros_like(img), _per_image(factor, img))


SHARPNESS_KERNEL = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=torch.float32) / 13.0


def sharpness(img: torch.Tensor, factor: Arg) -> torch.Tensor:
    """Blend with PIL's smoothing ([[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13)
    of the interior, the border unchanged."""
    _, h, w, _ = img.shape
    blurred = depthwise_same(img, SHARPNESS_KERNEL)
    rows = torch.arange(h, device=img.device).view(1, h, 1, 1)
    cols = torch.arange(w, device=img.device).view(1, 1, w, 1)
    interior = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
    return _blend(img, torch.where(interior, blurred, img), _per_image(factor, img))


def cutout(img: torch.Tensor, pad_size: int, cy: torch.Tensor, cx: torch.Tensor,
           replace: float = 128.0) -> torch.Tensor:
    """The square of half-side ``pad_size`` around each image's (cy, cx)
    filled with ``replace``."""
    _, h, w, _ = img.shape
    rows = torch.arange(h, device=img.device).view(1, h, 1, 1)
    cols = torch.arange(w, device=img.device).view(1, 1, w, 1)
    cy = cy.to(img.device).view(-1, 1, 1, 1)
    cx = cx.to(img.device).view(-1, 1, 1, 1)
    mask = ((rows - cy).abs() < pad_size) & ((cols - cx).abs() < pad_size)
    return torch.where(mask, torch.full_like(img, replace), img)


# ---------------------------------------------------------------------------
# geometric ops: one bilinear affine warp
# ---------------------------------------------------------------------------


def bilinear_taps(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """The bilinear sample of ``img`` (B, H, W, C) at (sy, sx) (B, H', W'):
    the four taps' indices clamped into the image, summed in the JAX
    module's order; no mask."""
    b, h, w, c = img.shape
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    flat = img.reshape(b, h * w, c)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yi = torch.clamp(y0 + dy, 0, h - 1).to(torch.int64)
            xi = torch.clamp(x0 + dx, 0, w - 1).to(torch.int64)
            idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
            val = flat.gather(1, idx).view(*sy.shape, c)
            wgt = ((wx * dx + (1 - wx) * (1 - dx)) * (wy * dy + (1 - wy) * (1 - dy)))[..., None]
            out = out + val * wgt
    return out


def _affine_warp(img: torch.Tensor, m: torch.Tensor, replace: float = 128.0) -> torch.Tensor:
    """Warp each image by its inverse 2x3 affine ``m`` (B, 2, 3) (dst ->
    src), bilinear, ``replace`` outside."""
    _, h, w, _ = img.shape
    # the f32 entries' sums in f64, rounded once to f32: where a shear or a
    # translation puts a source coordinate on the border, the rounding
    # XLA's fused multiply-adds give, not one per product (which can cross
    # the validity mask's edge)
    m = m.to(dtype=torch.float32).to(device=img.device, dtype=torch.float64)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=img.device),
                            torch.arange(w, dtype=torch.float64, device=img.device),
                            indexing="ij")
    e = [[m[:, i, j].view(-1, 1, 1) for j in range(3)] for i in range(2)]
    sx = (e[0][0] * xx + e[0][1] * yy + e[0][2]).float()
    sy = (e[1][0] * xx + e[1][1] * yy + e[1][2]).float()
    out = bilinear_taps(img, sy, sx)
    valid = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1))[..., None]
    return torch.where(valid, out, torch.full_like(out, replace))


def matrix_from_rows(rows) -> torch.Tensor:
    """(B, R, C) from R rows of C (B,) tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], 1)


def rotate(img: torch.Tensor, degrees: Arg, replace: float = 128.0) -> torch.Tensor:
    """Rotation by ``degrees`` about the image's centre."""
    n, h, w, _ = img.shape
    rad = _vector(degrees, n) * math.pi / 180.0
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(rad), torch.sin(rad)
    m = matrix_from_rows([[cos, sin, cx - cos * cx - sin * cy],
                          [-sin, cos, cy + sin * cx - cos * cy]])
    return _affine_warp(img, m, replace)


def _shear_translate(img, sx_y, sx_c, sy_x, sy_c, replace):
    n = img.shape[0]
    one, zero = torch.ones(n), torch.zeros(n)
    v = lambda a: zero if a is None else _vector(a, n)  # noqa: E731
    m = matrix_from_rows([[one, v(sx_y), v(sx_c)], [v(sy_x), one, v(sy_c)]])
    return _affine_warp(img, m, replace)


def shear_x(img: torch.Tensor, level: Arg, replace: float = 128.0) -> torch.Tensor:
    return _shear_translate(img, level, None, None, None, replace)


def shear_y(img: torch.Tensor, level: Arg, replace: float = 128.0) -> torch.Tensor:
    return _shear_translate(img, None, None, level, None, replace)


def translate_x(img: torch.Tensor, pixels: Arg, replace: float = 128.0) -> torch.Tensor:
    return _shear_translate(img, None, pixels, None, None, replace)


def translate_y(img: torch.Tensor, pixels: Arg, replace: float = 128.0) -> torch.Tensor:
    return _shear_translate(img, None, None, None, pixels, replace)


# ---------------------------------------------------------------------------
# grouping: each op once on the images that drew it
# ---------------------------------------------------------------------------


def _apply_grouped(x: torch.Tensor, keys: torch.Tensor, fn) -> torch.Tensor:
    """``x`` with each group of images that share a key >= 0 (``keys``
    (B,) on the CPU) replaced by ``fn(key, their images, their CPU
    indices)``; images keyed -1 as they are."""
    out = x
    for k in keys[keys >= 0].unique().tolist():
        sel = (keys == k).nonzero().squeeze(1)
        idx = sel.to(x.device)
        if out is x:
            out = x.clone()
        out.index_copy_(0, idx, fn(k, x.index_select(0, idx), sel))
    return out


# ---------------------------------------------------------------------------
# RandAugment (timm / kecam parameterisation, augment.py:1028-1195)
# ---------------------------------------------------------------------------

RAND_AUG_OPS = (
    "autocontrast", "equalize", "invert", "rotate", "posterize", "solarize",
    "color", "contrast", "brightness", "sharpness", "shear_x", "shear_y",
    "translate_x", "translate_y", "solarize_add",
)


class RandAugmentDraws(NamedTuple):
    """Per image and layer (CPU tensors): the op's index into
    ``RAND_AUG_OPS`` (B, L), its level in [0, 10] (B, L) f32, the gate
    (B, L) bool, the sign +-1 (B, L) f32; and the cutout's centre (y, x)
    (B, 2), or None without cutout."""
    op: torch.Tensor
    level: torch.Tensor
    gate: torch.Tensor
    sign: torch.Tensor
    cutout: Optional[torch.Tensor] = None


def draw_rand_augment(generator: torch.Generator, batch: int, size, num_layers: int = 2,
                      magnitude: float = 6.0, magnitude_std: float = 0.5,
                      apply_probability: float = 0.5, use_cutout: bool = False
                      ) -> RandAugmentDraws:
    """RandAugment's draws for ``batch`` images of ``size`` (h, w): ops
    uniform over the table, levels ``magnitude + magnitude_std * N(0, 1)``
    clipped to [0, 10], gates ``u < apply_probability``, signs -1 where
    ``u < 0.5``; with ``use_cutout`` a centre uniform over the image."""
    shape = (batch, num_layers)
    op = torch.randint(0, len(RAND_AUG_OPS), shape, generator=generator)
    level = (magnitude + magnitude_std * torch.randn(shape, generator=generator)).clamp(
        0.0, MAX_LEVEL)
    gate = torch.rand(shape, generator=generator) < apply_probability
    sign = torch.where(torch.rand(shape, generator=generator) < 0.5, -1.0, 1.0)
    centre = None
    if use_cutout:
        centre = torch.stack([torch.randint(0, size[0], (batch,), generator=generator),
                              torch.randint(0, size[1], (batch,), generator=generator)], 1)
    return RandAugmentDraws(op, level, gate, sign, centre)


def _enhance(level: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    return 1.0 + sign * ((level / MAX_LEVEL * 0.9 + 0.1) - 0.1)


def _rand_op(name: str, img: torch.Tensor, level: torch.Tensor, sign: torch.Tensor,
             translate_pixels: float) -> torch.Tensor:
    """One RandAugment op at the JAX module's level-to-argument rules."""
    if name == "autocontrast":
        return autocontrast(img)
    if name == "equalize":
        return equalize(img)
    if name == "invert":
        return invert(img)
    if name == "rotate":
        return rotate(img, sign * (level / MAX_LEVEL * 30.0))
    if name == "posterize":
        return posterize(img, torch.clamp(8 - (level / MAX_LEVEL * 4), min=1.0))
    if name == "solarize":
        return solarize(img, 256.0 - level / MAX_LEVEL * 256.0)
    if name in ("color", "contrast", "brightness", "sharpness"):
        fn = {"color": color, "contrast": contrast, "brightness": brightness,
              "sharpness": sharpness}[name]
        return fn(img, _enhance(level, sign))
    if name == "shear_x":
        return shear_x(img, sign * (level / MAX_LEVEL * 0.3))
    if name == "shear_y":
        return shear_y(img, sign * (level / MAX_LEVEL * 0.3))
    if name == "translate_x":
        return translate_x(img, sign * level / MAX_LEVEL * translate_pixels)
    if name == "translate_y":
        return translate_y(img, sign * level / MAX_LEVEL * translate_pixels)
    if name == "solarize_add":
        return solarize_add(img, level / MAX_LEVEL * 110.0)
    raise KeyError(f"unknown RandAugment op {name!r}")


def rand_augment(images: torch.Tensor, draws: RandAugmentDraws, translate_const: float = 0.45,
                 cutout_const: float = 40.0) -> torch.Tensor:
    """RandAugment of [0, 1] images (B, H, W, C) by ``draws``: per layer
    each gated image's op at its level and sign (translations by
    ``translate_const * min(h, w)`` pixels at level 10), then the cutout of
    half-side ``cutout_const`` where the draws hold centres; back to
    [0, 1] in the input's dtype."""
    _, h, w, _ = images.shape
    translate_pixels = translate_const * min(h, w) * MAX_LEVEL / MAX_LEVEL
    x = images.float() * 255.0
    for layer in range(draws.op.shape[1]):
        level, sign = draws.level[:, layer], draws.sign[:, layer]
        keys = torch.where(draws.gate[:, layer], draws.op[:, layer], -1)
        x = _apply_grouped(x, keys, lambda k, img, sel: _rand_op(
            RAND_AUG_OPS[k], img, level[sel], sign[sel], translate_pixels))
    if draws.cutout is not None:
        x = cutout(x, int(cutout_const), draws.cutout[:, 0], draws.cutout[:, 1])
    return torch.clamp(x / 255.0, 0.0, 1.0).to(images.dtype)


# ---------------------------------------------------------------------------
# AutoAugment (reference imagenet/augment.py:704-1025)
# ---------------------------------------------------------------------------

# (op, probability, level) pairs; each sub-policy applies its two ops in
# sequence, each gated by its own Bernoulli draw (augment.py policy_v0 :938)
AUTOAUGMENT_POLICIES = {
    "v0": (
        (("Color", 0.4, 9), ("Equalize", 0.6, 3)),
        (("Solarize", 0.8, 3), ("Equalize", 0.4, 7)),
        (("Solarize", 0.4, 2), ("Solarize", 0.6, 2)),
        (("Color", 0.2, 0), ("Equalize", 0.8, 8)),
        (("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)),
        (("Color", 0.6, 1), ("Equalize", 1.0, 2)),
        (("Color", 0.4, 7), ("Equalize", 0.6, 0)),
        (("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)),
        (("Solarize", 0.6, 8), ("Color", 0.6, 9)),
        (("Equalize", 0.8, 4), ("Equalize", 0.0, 8)),
        (("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)),
        (("Posterize", 0.8, 2), ("Solarize", 0.6, 10)),
        (("Solarize", 0.6, 8), ("Equalize", 0.6, 1)),
        (("Equalize", 0.8, 1), ("ShearY", 0.8, 4)),
        (("Color", 0.4, 1), ("Rotate", 0.6, 8)),
        (("ShearX", 0.2, 9), ("Rotate", 0.6, 8)),
        (("Invert", 0.4, 9), ("Rotate", 0.6, 0)),
        (("Equalize", 1.0, 9), ("ShearY", 0.6, 3)),
        (("Solarize", 0.2, 4), ("Rotate", 0.8, 9)),
        (("Rotate", 1.0, 7), ("TranslateY", 0.8, 9)),
        (("ShearX", 0.0, 0), ("Solarize", 0.8, 4)),
        (("ShearY", 0.8, 0), ("Color", 0.6, 4)),
        (("Color", 1.0, 0), ("Rotate", 0.6, 2)),
        (("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)),
        (("Color", 0.8, 6), ("Rotate", 0.4, 5)),
    ),
}
# policy_simple = v0 without the geometric (custom-op) sub-policies
AUTOAUGMENT_POLICIES["simple"] = AUTOAUGMENT_POLICIES["v0"][:13]
# policy_positional = only the geometric sub-policies (augment.py :1003)
AUTOAUGMENT_POLICIES["positional"] = AUTOAUGMENT_POLICIES["v0"][13:]
AUTOAUGMENT_POLICIES["test"] = ((("TranslateX", 1.0, 4), ("Equalize", 1.0, 10)),)


class AutoAugmentDraws(NamedTuple):
    """Per image (CPU tensors): the sub-policy's index (B,), and per op of
    it the gate (B, 2) bool and the sign +-1 (B, 2) f32."""
    sub: torch.Tensor
    gate: torch.Tensor
    sign: torch.Tensor


def _policy(policy: str):
    if policy not in AUTOAUGMENT_POLICIES:
        raise ValueError(f"unknown policy {policy!r} (have {sorted(AUTOAUGMENT_POLICIES)})")
    return AUTOAUGMENT_POLICIES[policy]


def draw_auto_augment(generator: torch.Generator, batch: int, policy: str = "v0"
                      ) -> AutoAugmentDraws:
    """AutoAugment's draws: a sub-policy uniform over ``policy``'s, each op
    gated by ``u <`` its probability, signs -1 where ``u < 0.5``."""
    subs = _policy(policy)
    sub = torch.randint(0, len(subs), (batch,), generator=generator)
    probs = torch.tensor([[prob for _, prob, _ in s] for s in subs])
    gate = torch.rand((batch, 2), generator=generator) < probs[sub]
    sign = torch.where(torch.rand((batch, 2), generator=generator) < 0.5, -1.0, 1.0)
    return AutoAugmentDraws(sub, gate, sign)


def _auto_op(name: str, img: torch.Tensor, level: float, sign: torch.Tensor,
             translate_const: float) -> torch.Tensor:
    """One AutoAugment op at the v0 level-to-argument rules
    (augment.py:613-701); ``level`` is the table's."""
    lvl = level / MAX_LEVEL
    if name == "AutoContrast":
        return autocontrast(img)
    if name == "Equalize":
        return equalize(img)
    if name == "Invert":
        return invert(img)
    if name == "Rotate":
        return rotate(img, sign * lvl * 30.0)
    if name == "Posterize":
        return posterize(img, float(int(lvl * 4)))
    if name == "Solarize":
        return solarize(img, float(int(lvl * 256)))
    if name == "SolarizeAdd":
        return solarize_add(img, float(int(lvl * 110)))
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        fn = {"Color": color, "Contrast": contrast, "Brightness": brightness,
              "Sharpness": sharpness}[name]
        return fn(img, lvl * 1.8 + 0.1)  # _enhance_level_to_arg, no negation
    if name == "ShearX":
        return shear_x(img, sign * lvl * 0.3)
    if name == "ShearY":
        return shear_y(img, sign * lvl * 0.3)
    if name == "TranslateX":
        return translate_x(img, sign * lvl * translate_const)
    if name == "TranslateY":
        return translate_y(img, sign * lvl * translate_const)
    raise KeyError(f"unknown AutoAugment op {name!r}")


def auto_augment(images: torch.Tensor, draws: AutoAugmentDraws, policy: str = "v0",
                 translate_const: float = 250.0) -> torch.Tensor:
    """AutoAugment of [0, 1] images (B, H, W, C) by ``draws``: each image's
    sub-policy, its ops in sequence where their gates are set; back to
    [0, 1] in the input's dtype. No policy holds a Cutout, so the JAX
    function's ``cutout_const`` has nothing to set here."""
    subs = _policy(policy)
    x = images.float() * 255.0

    def apply_sub(k, img, sel):
        for i, (name, _, level) in enumerate(subs[k]):
            keys = torch.where(draws.gate[sel, i], 0, -1)
            sign = draws.sign[sel, i]
            img = _apply_grouped(img, keys, lambda _, part, rows: _auto_op(
                name, part, float(level), sign[rows], translate_const))
        return img

    x = _apply_grouped(x, draws.sub, apply_sub)
    return torch.clamp(x / 255.0, 0.0, 1.0).to(images.dtype)
