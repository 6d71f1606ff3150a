"""Token labeling (counterpart of ``vip_cup_2022_tpu/train/token_label.py``,
kecam's ``imagenet/token_label.py``).

- :func:`token_label_align` — TokenLabelAlign (:5-55): expand a stored
  (positions, scores) top-k token label into a dense (sh, sw, C) one-hot map,
  apply the same flip/crop/scale geometry as the image augmentation, and
  bilinearly align it onto the model's target patch grid (the tf
  crop_and_resize crop_size=(1,1) center-sampling semantics).
- :func:`build_token_labels` — build_token_label_file (:58+) role: run a
  teacher over images and store per-patch top-k (indices, scores) compactly.

Host-side numpy (a data-pipeline stage); the output is a (th, tw, C) target
for the train step. ``build_token_labels``' teacher is any callable from a
float batch to per-patch class scores.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _bilinear_sample(img: np.ndarray, cy: np.ndarray, cx: np.ndarray) -> np.ndarray:
    """Sample img (H, W, C) at float coords; TF crop_and_resize semantics
    (zero outside [0, H-1])."""
    h, w = img.shape[:2]
    y0 = np.floor(cy).astype(int)
    x0 = np.floor(cx).astype(int)
    fy = (cy - y0)[:, None]
    fx = (cx - x0)[:, None]

    def get(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        out = np.zeros((len(yy), img.shape[-1]), img.dtype)
        out[valid] = img[yy[valid], xx[valid]]
        return out

    v00 = get(y0, x0)
    v01 = get(y0, x0 + 1)
    v10 = get(y0 + 1, x0)
    v11 = get(y0 + 1, x0 + 1)
    out = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
           + v10 * fy * (1 - fx) + v11 * fy * fx)
    # TF crop_and_resize EXTRAPOLATES (whole sample -> 0) when the sample
    # point leaves [0, size-1] — it does not blend with zero padding
    inside = (cy >= 0) & (cy <= h - 1) & (cx >= 0) & (cx <= w - 1)
    return out * inside[:, None]


def token_label_align(
    token_label: np.ndarray,
    num_classes: int,
    target_num_patches: int | Tuple[int, int] = 14,
    flip_left_right: bool = False,
    scale_hh: float = 1.0,
    scale_ww: float = 1.0,
    crop_hh: float = 0.0,
    crop_ww: float = 0.0,
) -> np.ndarray:
    """token_label: (2, sh, sw, k) stacked [indices, scores]. Returns a dense
    (th, tw, num_classes) soft-label map aligned to the augmented image."""
    tl = np.asarray(token_label)
    label_pos = tl[0].astype(int)
    label_score = tl[1].astype(np.float32)
    sh, sw, k = label_pos.shape
    th, tw = (target_num_patches if isinstance(target_num_patches, (tuple, list))
              else (target_num_patches, target_num_patches))
    th = th if th > 0 else sh
    tw = tw if tw > 0 else sw

    one_hot = np.zeros((sh, sw, num_classes), np.float32)
    hh, ww = np.meshgrid(np.arange(sh), np.arange(sw), indexing="ij")
    one_hot[hh[..., None].repeat(k, -1), ww[..., None].repeat(k, -1), label_pos] = label_score

    if flip_left_right:
        one_hot = one_hot[:, ::-1]

    ti, tj = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    ti, tj = ti.reshape(-1).astype(np.float32), tj.reshape(-1).astype(np.float32)
    # boxes normalized to the target grid, shifted by crop, un-scaled, then
    # center-sampled on the (sh, sw) grid (crop_size=1 semantics)
    y1 = (ti / th + crop_hh) / scale_hh
    y2 = ((ti + 1) / th + crop_hh) / scale_hh
    x1 = (tj / tw + crop_ww) / scale_ww
    x2 = ((tj + 1) / tw + crop_ww) / scale_ww
    cy = (y1 + y2) / 2 * (sh - 1)
    cx = (x1 + x2) / 2 * (sw - 1)
    out = _bilinear_sample(one_hot, cy, cx)
    return out.reshape(th, tw, num_classes)


def build_token_labels(apply_fn, images: Sequence[np.ndarray], top_k: int = 5,
                       batch_size: int = 16) -> np.ndarray:
    """Run a teacher over images and keep each patch's top-k (indices,
    scores): returns (N, 2, sh, sw, top_k). ``apply_fn`` takes an f32
    numpy batch and returns (b, sh, sw, C) per-patch class scores, as a
    numpy array or a tensor on any device."""
    outs = []
    for s in range(0, len(images), batch_size):
        batch = np.stack(images[s : s + batch_size]).astype(np.float32)
        preds = apply_fn(batch)
        if isinstance(preds, torch.Tensor):
            preds = preds.detach().float().cpu().numpy()
        preds = np.asarray(preds)
        idx = np.argsort(-preds, axis=-1)[..., :top_k]
        scores = np.take_along_axis(preds, idx, axis=-1)
        outs.append(np.stack([idx.astype(np.float32), scores], axis=1))
    return np.concatenate(outs, axis=0)
