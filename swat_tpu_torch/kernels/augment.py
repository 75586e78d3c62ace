"""On-device batched train augmentation (counterpart of
``swat_tpu/kernels/augment.py``): random-resized-crop, horizontal flip and
CLIP normalization from uint8 canvases, and the single-loader mixing
strategies: cutmix, mixup, resizemix, saliencymix and attentivemix.

Every sampled quantity is an explicit input.  The host draws them from a
``numpy.random.Generator`` (``sample_crops``, ``sample_flips``,
``sample_cutmix``, ``sample_mixup``, ``sample_resizemix``,
``sample_peak_mix``): a batch needs B x 10 candidate crop sizes and a few
scalars, and torch's Beta sampler takes no generator.  The device functions
(``random_resized_crop``, ``hflip``, ``train_augment``, ``cutmix``,
``mixup``, ``resizemix``, ``saliencymix``, ``attentivemix``) apply the
draws, so a test can feed them the JAX package's own draws.  The
twin-loader strategies (mixup-fs, cutmix-fs, CMO) are not ported yet
(ROADMAP Queue A item 6).

The resamples are ``jax.image.scale_and_translate``, not
``F.interpolate``: weights over the whole input (zero padding included),
normalised per output pixel under a 1000*eps guard, and output pixels whose
sample point falls outside [-0.5, in - 0.5] zeroed.  The crop uses Keys'
cubic (a = -0.5), antialiased on downscale, as two per-sample weight
matrices applied with batched matmuls; resizemix the triangle kernel
without antialiasing, with a translation, as one pair of matrices for the
batch.
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
    lam0 = _beta(rng, beta)
    perm = rng.permutation(batch)
    cy = int(rng.integers(0, height))
    cx = int(rng.integers(0, width))
    return CutmixDraws(gate, lam0, perm,
                       rand_bbox(height, width, lam0, cy, cx))


@dataclasses.dataclass
class MixupDraws:
    """One batch's mixup draws: lam, the Beta draw already replaced by 1
    where the mix_prob gate is off, and the pairing permutation [B]."""
    lam: float
    perm: np.ndarray


@dataclasses.dataclass
class ResizemixDraws:
    """One batch's resizemix draws: the gate, the pasted patch's size
    (rh, rw) = int32(size * tau) and its top-left corner, shared by the
    batch, and the pairing permutation [B]."""
    gate: bool
    rh: int
    rw: int
    pos_y: int
    pos_x: int
    perm: np.ndarray


@dataclasses.dataclass
class PeakMixDraws:
    """One batch's saliencymix / attentivemix draws: the gate, the Beta
    draw lam0 that sizes the boxes, and the pairing permutation [B].  The
    boxes' centres come from the images on the device."""
    gate: bool
    lam0: float
    perm: np.ndarray


def _beta(rng: np.random.Generator, beta: float) -> float:
    """Beta(beta, beta), or 1 when beta <= 0 (``augment._safe_beta``)."""
    return float(rng.beta(beta, beta)) if beta > 0 else 1.0


def sample_mixup(rng: np.random.Generator, batch: int, alpha: float = 1.0,
                 mix_prob: float = 0.5) -> MixupDraws:
    """``augment.mixup``'s draws: the gate is U[0,1) <= mix_prob."""
    gate = bool(rng.random() <= mix_prob)
    lam = _beta(rng, alpha)
    return MixupDraws(lam if gate else 1.0, rng.permutation(batch))


def resized_patch(height: int, width: int, tau) -> Tuple[int, int]:
    """(rh, rw) = int32(size * tau) of an fp32 product, truncated, as
    ``augment.resizemix`` computes them."""
    tau = np.float32(tau)
    return int(np.float32(height) * tau), int(np.float32(width) * tau)


def sample_resizemix(rng: np.random.Generator, batch: int, height: int,
                     width: int, mix_prob: float = 0.5,
                     tau_range=(0.1, 0.8)) -> ResizemixDraws:
    """``augment.resizemix``'s draws: one tau and one position for the
    whole batch."""
    gate = bool(rng.random() < mix_prob)
    rh, rw = resized_patch(height, width,
                           rng.uniform(tau_range[0], tau_range[1]))
    perm = rng.permutation(batch)
    pos_y = int(rng.integers(0, max(height - rh, 1)))
    pos_x = int(rng.integers(0, max(width - rw, 1)))
    return ResizemixDraws(gate, rh, rw, pos_y, pos_x, perm)


def sample_peak_mix(rng: np.random.Generator, batch: int, beta: float = 1.0,
                    mix_prob: float = 0.5) -> PeakMixDraws:
    """``augment.saliencymix`` / ``attentivemix``'s draws."""
    gate = bool(rng.random() < mix_prob)
    return PeakMixDraws(gate, _beta(rng, beta), rng.permutation(batch))


# ---------------------------------------------------------------------------
# device functions


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5 (jax.image's _fill_keys_cubic_kernel)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """The linear kernel (jax.image's _fill_triangle_kernel)."""
    return torch.clamp(1.0 - x.abs(), min=0.0)


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor, kernel=_keys_cubic,
                     antialias: bool = True) -> torch.Tensor:
    """Per-sample weights [B, in_size, out_size] in fp32, jax.image's
    compute_weight_mat for scale, translation [B]: Keys' cubic, antialiased
    on downscale, unless ``kernel`` / ``antialias`` say otherwise."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.ones_like(inv_scale))
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = ((out_pos[None, :] + 0.5) * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_pos[None, :, None]).abs() \
        / kernel_scale[:, None, None]
    weights = kernel(x)
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


def mixup(images: torch.Tensor, labels: torch.Tensor, draws: MixupDraws):
    """Reference mixup_data (``augment.mixup``): lam * x + (1 - lam) *
    x[perm], in fp32 whatever the images' dtype (lam is an fp32 array there,
    so bf16 images promote).  -> (mixed fp32, y_a, y_b, lam)."""
    perm = torch.as_tensor(np.asarray(draws.perm), device=images.device)
    lam = np.float32(draws.lam)
    x = images.float()
    mixed = float(lam) * x + float(np.float32(1.0) - lam) * x[perm]
    return mixed, labels, labels[perm], float(lam)


def resizemix(images: torch.Tensor, labels: torch.Tensor,
              draws: ResizemixDraws):
    """Reference train_resizemix (``augment.resizemix``): the permutation
    partner, shrunk to (rh, rw) with the triangle kernel and no
    antialiasing, replaces the box at (pos_y, pos_x); lam = 1 - the pasted
    area's share (float32).  With the gate off: the images unchanged,
    lam = 1, y_b = y_a.  -> (mixed, y_a, y_b, lam).

    ``scale_and_translate`` renders the whole shrunk image on a zero canvas
    and a box mask selects the patch; only the patch's own rows and columns
    of the two weight matrices are applied here."""
    if not draws.gate:
        return images, labels, labels, 1.0
    b, h, w, c = images.shape
    dev, dtype = images.device, images.dtype
    rh, rw, py, px = draws.rh, draws.rw, draws.pos_y, draws.pos_x

    def weights(size, r, pos):
        scale = torch.tensor([np.float32(r) / np.float32(size)], device=dev)
        wt = resample_weights(size, size, scale,
                              torch.tensor([float(pos)], device=dev),
                              kernel=_triangle, antialias=False)
        return wt[0, :, pos:pos + r].to(dtype)              # [size, r]

    wy, wx = weights(h, rh, py), weights(w, rw, px)
    perm = torch.as_tensor(np.asarray(draws.perm), device=dev)
    shuffled = images[perm]
    t = torch.matmul(wy.t(), shuffled.reshape(b, h, w * c))    # [B, rh, w*c]
    t = t.reshape(b, rh, w, c).transpose(2, 3)                 # [B, rh, c, w]
    patch = torch.matmul(t, wx).transpose(2, 3)                # [B, rh, rw, c]
    mixed = images.clone()
    mixed[:, py:py + rh, px:px + rw] = patch
    lam = np.float32(1.0) - np.float32(rh * rw) / np.float32(h * w)
    return mixed, labels, labels[perm], float(lam)


def saliency_map(images: torch.Tensor, blur: int = 7) -> torch.Tensor:
    """Centre-surround saliency proxy (``augment.saliency_map``): |pixel -
    local mean| of the grayscale image, the local mean a blur x blur box
    with zero padding that divides by blur^2 at the border too.
    [B, H, W, 3] -> [B, H, W] float32.  The box mean is an average pool,
    exact fp32 (a convolution could run in TF32 on the card)."""
    gray = images.float().mean(dim=-1)
    blurred = torch.nn.functional.avg_pool2d(
        gray[:, None], blur, stride=1, padding=blur // 2,
        count_include_pad=True)[:, 0]
    return (gray - blurred).abs()


def _peak_box_mix(images, labels, shuffled, perm, peak_y, peak_x,
                  lam0: float):
    """Per-image boxes of side int32(size * sqrt(1 - lam0)) centred on
    (peak_y, peak_x) [B], clipped to the image, filled from ``shuffled``;
    per-image lambdas = 1 - box area share (float32)."""
    b, h, w, _ = images.shape
    cut_rat = np.sqrt(np.float32(1.0) - np.float32(lam0))
    cut_h = int(np.float32(h) * cut_rat)
    cut_w = int(np.float32(w) * cut_rat)
    y1 = (peak_y - cut_h // 2).clamp(0, h)
    y2 = (peak_y + cut_h // 2).clamp(0, h)
    x1 = (peak_x - cut_w // 2).clamp(0, w)
    x2 = (peak_x + cut_w // 2).clamp(0, w)
    rows = torch.arange(h, device=images.device)[None, :, None]
    cols = torch.arange(w, device=images.device)[None, None, :]
    mask = ((rows >= y1[:, None, None]) & (rows < y2[:, None, None])
            & (cols >= x1[:, None, None]) & (cols < x2[:, None, None]))
    mixed = torch.where(mask[..., None], shuffled, images)
    lam = 1.0 - ((y2 - y1) * (x2 - x1)).float() / float(h * w)
    return mixed, labels, labels[perm], lam


def _ungated(images, labels):
    ones = torch.ones(images.shape[0], dtype=torch.float32,
                      device=images.device)
    return images, labels, labels, ones


def saliencymix(images: torch.Tensor, labels: torch.Tensor,
                draws: PeakMixDraws):
    """Reference train_saliencymix2 (``augment.saliencymix``): per-image
    boxes centred on the saliency peak of the permutation partner,
    per-image pixel-ratio lambdas.  -> (mixed, y_a, y_b, lam [B] fp32)."""
    if not draws.gate:
        return _ungated(images, labels)
    b, h, w, _ = images.shape
    perm = torch.as_tensor(np.asarray(draws.perm), device=images.device)
    shuffled = images[perm]
    flat = saliency_map(shuffled).reshape(b, -1).argmax(dim=-1)
    return _peak_box_mix(images, labels, shuffled, perm, flat // w, flat % w,
                         draws.lam0)


def attentivemix(images: torch.Tensor, labels: torch.Tensor,
                 heatmaps: torch.Tensor, draws: PeakMixDraws):
    """Reference train_attentivemix2 (``augment.attentivemix``): boxes
    centred on the peak of a model-provided heatmap.  heatmaps [B, h', w']
    belong to the unshuffled batch and are permuted with the images; the
    peak is the CENTRE of the argmax cell.  -> (mixed, y_a, y_b, lam [B]
    fp32)."""
    if not draws.gate:
        return _ungated(images, labels)
    b, h, w, _ = images.shape
    perm = torch.as_tensor(np.asarray(draws.perm), device=images.device)
    hm = heatmaps[perm]
    hh, hw = hm.shape[1], hm.shape[2]
    flat = hm.reshape(b, -1).argmax(dim=-1)
    peak_y = (flat // hw) * (h // hh) + (h // hh) // 2
    peak_x = (flat % hw) * (w // hw) + (w // hw) // 2
    return _peak_box_mix(images, labels, images[perm], perm, peak_y, peak_x,
                         draws.lam0)
