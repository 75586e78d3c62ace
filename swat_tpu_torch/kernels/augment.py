"""On-device batched train augmentation (counterpart of
``swat_tpu/kernels/augment.py:34-231``): random-resized-crop, horizontal
flip and CLIP normalization from uint8 canvases, and cutmix.

Every sampled quantity is an explicit input.  The host draws them from a
``numpy.random.Generator`` (``sample_crops``, ``sample_flips``,
``sample_cutmix``): a batch needs B x 10 candidate crop sizes and a few
scalars, and torch's Beta sampler takes no generator.  The device functions
(``random_resized_crop``, ``hflip``, ``train_augment``, ``cutmix``) apply
the draws, so a test can feed them the JAX package's own draws.  The other
mixing strategies (mixup, resizemix, saliencymix, CMO) are not ported yet
(ROADMAP Queue A item 6).

The resample is ``jax.image.scale_and_translate(method="cubic")``, not
``F.interpolate``: Keys' cubic (a = -0.5), antialiased on downscale, with
weights over the whole canvas (zero padding included), normalised per
output pixel under a 1000*eps guard, and output pixels whose sample point
falls outside [-0.5, in - 0.5] zeroed.  It runs as two per-sample weight
matrices applied with batched matmuls.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from swat_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD

CROP_SCALE = (0.9, 1.0)
CROP_RATIO = (3 / 4, 4 / 3)


@dataclasses.dataclass
class CropDraws:
    """Per-sample crop boxes [B, 4] as (top i, left j, height h, width w)
    inside each canvas's valid region, and flips [B] bool."""
    boxes: np.ndarray
    flips: np.ndarray


@dataclasses.dataclass
class CutmixDraws:
    """One batch's cutmix draws: the mix_prob gate, the Beta draw lam0, the
    pairing permutation [B] and the box (y1, y2, x1, x2) in image space."""
    gate: bool
    lam0: float
    perm: np.ndarray
    box: Tuple[int, int, int, int]


# ---------------------------------------------------------------------------
# host-side draws


def sample_crops(rng: np.random.Generator,
                 valid_hw: np.ndarray) -> np.ndarray:
    """torchvision RandomResizedCrop sampling, as ``augment._sample_crop``
    with scale CROP_SCALE and ratio CROP_RATIO: ten candidate (h, w) per
    sample, the first in-bounds one wins, else the ratio-clamped centre
    crop.  valid_hw [B, 2] -> boxes [B, 4]."""
    scale, ratio, tries = CROP_SCALE, CROP_RATIO, 10
    vh = np.asarray(valid_hw)[:, 0].astype(np.int64)
    vw = np.asarray(valid_hw)[:, 1].astype(np.int64)
    b = vh.shape[0]
    area = (vh * vw).astype(np.float32)[:, None]
    target = rng.uniform(scale[0], scale[1], (b, tries)).astype(
        np.float32) * area
    aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1]),
                                (b, tries)).astype(np.float32))
    w = np.round(np.sqrt(target * aspect)).astype(np.int64)
    h = np.round(np.sqrt(target / aspect)).astype(np.int64)
    ok = (w > 0) & (w <= vw[:, None]) & (h > 0) & (h <= vh[:, None])
    first = ok.argmax(axis=1)
    any_ok = ok.any(axis=1)
    # the fallback in float32, as the JAX package computes it
    vhf, vwf = vh.astype(np.float32), vw.astype(np.float32)
    in_ratio = vwf / vhf
    r0, r1 = np.float32(ratio[0]), np.float32(ratio[1])
    fb_w = np.where(in_ratio > r1, np.round(vhf * r1).astype(np.int64), vw)
    fb_h = np.where(in_ratio < r0, np.round(vwf / r0).astype(np.int64), vh)
    rows = np.arange(b)
    ch = np.where(any_ok, h[rows, first], fb_h)
    cw = np.where(any_ok, w[rows, first], fb_w)
    i = rng.integers(0, np.maximum(vh - ch, 0) + 1)
    j = rng.integers(0, np.maximum(vw - cw, 0) + 1)
    i = np.where(any_ok, i, (vh - ch) // 2)
    j = np.where(any_ok, j, (vw - cw) // 2)
    return np.stack([i, j, ch, cw], axis=1)


def sample_flips(rng: np.random.Generator, batch: int) -> np.ndarray:
    """Bernoulli(0.5) per sample."""
    return rng.random(batch) < 0.5


def rand_bbox(height: int, width: int, lam: float, cy: int,
              cx: int) -> Tuple[int, int, int, int]:
    """The reference rand_bbox (``augment._rand_bbox``) for a drawn centre:
    side = int(size * sqrt(1 - lam)) in float32, truncated; the box is
    centre -/+ side // 2, clipped to the image."""
    cut_rat = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.float32(height) * cut_rat)
    cut_w = int(np.float32(width) * cut_rat)
    y1 = int(np.clip(cy - cut_h // 2, 0, height))
    y2 = int(np.clip(cy + cut_h // 2, 0, height))
    x1 = int(np.clip(cx - cut_w // 2, 0, width))
    x2 = int(np.clip(cx + cut_w // 2, 0, width))
    return y1, y2, x1, x2


def sample_cutmix(rng: np.random.Generator, batch: int, height: int,
                  width: int, beta: float = 1.0,
                  mix_prob: float = 0.5) -> CutmixDraws:
    """One batch's cutmix draws (``augment.cutmix``): the gate is
    U[0,1) < mix_prob; beta <= 0 disables mixing with lam0 = 1
    (``_safe_beta``); the box centre is uniform over the image."""
    gate = bool(rng.random() < mix_prob)
    lam0 = float(rng.beta(beta, beta)) if beta > 0 else 1.0
    perm = rng.permutation(batch)
    cy = int(rng.integers(0, height))
    cx = int(rng.integers(0, width))
    return CutmixDraws(gate, lam0, perm,
                       rand_bbox(height, width, lam0, cy, cx))


# ---------------------------------------------------------------------------
# device functions


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5 (jax.image's _fill_keys_cubic_kernel)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """Per-sample antialiased cubic weights [B, in_size, out_size] in fp32,
    jax.image's compute_weight_mat for scale, translation [B]."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = ((out_pos[None, :] + 0.5) * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_pos[None, :, None]).abs() \
        / kernel_scale[:, None, None]
    weights = _keys_cubic(x)
    total = weights.sum(dim=1, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    weights = torch.where(
        total.abs() > 1000.0 * eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def random_resized_crop(canvases: torch.Tensor, boxes,
                        out_size: int = 224,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Crop boxes[b] = (i, j, h, w) of each canvas [B, C, C, 3] and resize
    it to out_size x out_size, bicubic, as ``augment._crop_resize_one``:
    -> [B, out, out, 3] in ``dtype``, pixel values in [0, 255] scale.
    ``dtype`` is the resample's compute and storage type."""
    dev = canvases.device
    b, ch, cw, c = canvases.shape
    boxes = torch.tensor(np.asarray(boxes), device=dev).float()
    i, j, h, w = boxes.unbind(dim=1)
    scale_y = out_size / h
    scale_x = out_size / w
    wy = resample_weights(ch, out_size, scale_y, -i * scale_y).to(dtype)
    wx = resample_weights(cw, out_size, scale_x, -j * scale_x).to(dtype)
    x = canvases.to(dtype).reshape(b, ch, cw * c)
    t = torch.matmul(wy.transpose(1, 2), x)                 # [B, out, cw*c]
    t = t.reshape(b, out_size, cw, c).transpose(2, 3).reshape(
        b, out_size * c, cw)
    o = torch.matmul(t, wx)                                # [B, out*c, out]
    return o.reshape(b, out_size, c, out_size).transpose(2, 3).contiguous()


def hflip(images: torch.Tensor, flips) -> torch.Tensor:
    """Mirror the images [B, H, W, C] whose flip is set."""
    f = torch.tensor(np.asarray(flips), device=images.device)
    return torch.where(f[:, None, None, None], images.flip(2), images)


def normalize_float_pixels(x: torch.Tensor,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[0, 255]-scale pixels -> CLIP-normalized, in ``dtype`` throughout
    (the constants too, as the JAX package rounds them)."""
    mean = torch.tensor(CLIP_MEAN, dtype=dtype, device=x.device) * 255.0
    std = torch.tensor(CLIP_STD, dtype=dtype, device=x.device) * 255.0
    return (x.to(dtype) - mean) / std


def train_augment(canvases: torch.Tensor, draws: CropDraws,
                  out_size: int = 224,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The reference train transform on the device: random-resized-crop,
    flip, normalize (``augment.train_augment``)."""
    x = random_resized_crop(canvases, draws.boxes, out_size, dtype)
    return normalize_float_pixels(hflip(x, draws.flips), dtype)


def cutmix(images: torch.Tensor, labels: torch.Tensor, draws: CutmixDraws):
    """The reference train_cutmix mixing (``augment.cutmix``): the box of
    each image is replaced by that of its permutation partner, lam is the
    exact pixel ratio kept (float32), y_b the partner's label.  With the
    gate off: the images unchanged, lam = 1, y_b = y_a.
    -> (mixed, y_a, y_b, lam)."""
    if not draws.gate:
        return images, labels, labels, 1.0
    b, h, w, _ = images.shape
    y1, y2, x1, x2 = draws.box
    perm = torch.tensor(np.asarray(draws.perm), device=images.device)
    mixed = images.clone()
    mixed[:, y1:y2, x1:x2] = images[perm, y1:y2, x1:x2]
    lam = np.float32(1.0) - (np.float32((y2 - y1) * (x2 - x1))
                             / np.float32(h * w))
    return mixed, labels, labels[perm], float(lam)
