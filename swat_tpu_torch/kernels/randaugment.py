"""Batched RandAugment on the device, FixMatch's pool (counterpart of
``swat_tpu/kernels/randaugment.py``; reference RandAugmentMC,
utils/randaugment.py:147-220).

Images are [B, H, W, 3] float pixels on the 0..255 scale.  Each image
takes ``n`` rounds; a round picks one of the 14 ops with a magnitude
``randint(1, m)`` scaled per op, a random sign for the geometric ops and a
gate (the op applies when U[0,1) < 0.5); CutoutAbs, a gray box, is always
applied last.  Every one of those draws is made on the host
(``sample_rand_augment``), so the device work is batched by op rather than
by image: for each (round, op) the images that take it are a list known on
the host, and the op runs once over that subset (``index_select``, the op
with per-image magnitudes as [k, 1, 1, 1] tensors, ``index_copy_``).  No
value is read back from the device, and there is no loop over images.

The ops follow ``swat_tpu``'s, which mirror PIL: geometric ops sample the
input at the inverse-mapped pixel centres, nearest (truncation), black
outside; enhance ops blend with a degenerate image and clip to 0..255;
equalize builds PIL's per-channel LUT from a 256-bin histogram.  Like
``swat_tpu``, nothing clips the input: posterize truncates toward zero, the
LUT ops clip their indices to 0..255.  Plain PyTorch: ``swat_tpu``'s
version is batched JAX and reaches no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

PARAMETER_MAX = 10
N_ROUNDS = 2
MAGNITUDE = 10


@dataclasses.dataclass
class RandAugmentDraws:
    """One batch's RandAugment draws: per image and round the op index
    [B, n] in 0..13, the raw magnitude [B, n] in 1..m-1, the gate [B, n]
    (the op applies) and the sign [B, n] (+-1, read by the signed ops);
    per image the cutout's two uniforms [B, 2] (x, y) in [0, 1)."""
    ops: np.ndarray
    magnitudes: np.ndarray
    gates: np.ndarray
    signs: np.ndarray
    cutout: np.ndarray


def sample_rand_augment(rng: np.random.Generator, b: int, n: int = N_ROUNDS,
                        m: int = MAGNITUDE) -> RandAugmentDraws:
    """RandAugmentMC(n, m)'s draws for ``b`` images: ops, magnitudes,
    gates, signs, then the cutout's uniforms."""
    ops = rng.integers(0, NUM_OPS, (b, n))
    magnitudes = rng.integers(1, m, (b, n))
    gates = rng.random((b, n)) < 0.5
    signs = np.where(rng.random((b, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    cutout = rng.random((b, 2)).astype(np.float32)
    return RandAugmentDraws(ops, magnitudes, gates, signs, cutout)


# ---------------------------------------------------------------------------
# helpers (batched over the leading dim)


def _per_image(v: torch.Tensor) -> torch.Tensor:
    """[k] -> [k, 1, 1, 1], to broadcast over [k, H, W, 3]."""
    return v.reshape(-1, 1, 1, 1)


def _blend(img1: torch.Tensor, img2: torch.Tensor,
           factor: torch.Tensor) -> torch.Tensor:
    """PIL Image.blend: img1 + factor * (img2 - img1), clipped to 0..255
    (ImageEnhance(img2).enhance(factor), img1 the degenerate image)."""
    return torch.clamp(img1 + _per_image(factor) * (img2 - img1), 0.0, 255.0)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """PIL's L weights, [k, H, W, 3] -> [k, H, W, 1]."""
    return (img[..., 0:1] * 0.299 + img[..., 1:2] * 0.587
            + img[..., 2:3] * 0.114)


def _affine_nearest(img: torch.Tensor, a, b, c, d, e, f) -> torch.Tensor:
    """PIL transform(AFFINE), NEAREST: output pixel (x, y) samples the
    input at (a (x+.5) + b (y+.5) + c, d (x+.5) + e (y+.5) + f), truncated
    toward zero, black outside.  The coefficients are [k] tensors."""
    k, h, w, _ = img.shape
    ys = (torch.arange(h, dtype=torch.float32, device=img.device)
          + 0.5)[None, :, None]
    xs = (torch.arange(w, dtype=torch.float32, device=img.device)
          + 0.5)[None, None, :]

    def coef(t):
        return t.reshape(-1, 1, 1)

    sx = coef(a) * xs + coef(b) * ys + coef(c)
    sy = coef(d) * xs + coef(e) * ys + coef(f)
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    ix = sx.to(torch.int64).clamp(0, w - 1)
    iy = sy.to(torch.int64).clamp(0, h - 1)
    flat = (iy * w + ix).reshape(k, h * w, 1).expand(k, h * w, 3)
    out = torch.gather(img.reshape(k, h * w, 3), 1, flat).reshape(k, h, w, 3)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def _lut_indices(img: torch.Tensor) -> torch.Tensor:
    """Pixel values truncated toward zero and clipped to 0..255, one row
    a (image, channel): [k, H, W, 3] -> [k * 3, H * W] int64."""
    k, h, w, _ = img.shape
    idx = img.to(torch.int32).clamp(0, 255).to(torch.int64)
    return idx.permute(0, 3, 1, 2).reshape(k * 3, h * w)


# ---------------------------------------------------------------------------
# the ops: op(img [k, H, W, 3] fp32, v [k] fp32) -> img


def op_identity(img, v):
    return img


def op_autocontrast(img, v):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-5)
    out = torch.where(hi > lo, (img - lo) * scale, img)
    return torch.clamp(out, 0.0, 255.0)


def op_brightness(img, v):
    return _blend(torch.zeros_like(img), img, v)


def op_color(img, v):
    return _blend(_grayscale(img).expand_as(img), img, v)


def op_contrast(img, v):
    # PIL Contrast: the degenerate image is the mean of the L channel
    mean = _grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
    return _blend(mean.expand_as(img), img, v)


# PIL's SMOOTH kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13
_SMOOTH = np.array([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                   np.float32) / np.float32(13.0)


def op_sharpness(img, v):
    """Blend with the SMOOTH-filtered image, whose one-pixel border PIL
    keeps unfiltered.  The 3 x 3 filter is nine shifted products summed in
    fp32 (no convolution: on the card one could round through TF32)."""
    k, h, w, _ = img.shape
    padded = torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1))
    smoothed = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            smoothed = smoothed + float(_SMOOTH[dy, dx]) * padded[
                :, dy:dy + h, dx:dx + w]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    border = (ys == 0) | (ys == h - 1) | (xs == 0) | (xs == w - 1)
    smoothed = torch.where(border[None, :, :, None], img, smoothed)
    return _blend(smoothed, img, v)


def op_equalize(img, v):
    """PIL ImageOps.equalize per channel: step = (n - h[255]) // 255 of the
    256-bin histogram, lut = (step // 2 + exclusive cumsum) // step,
    identity where step is 0."""
    k, h, w, _ = img.shape
    idx = _lut_indices(img)
    hist = torch.zeros((k * 3, 256), dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx))
    step = (hist.sum(dim=1, keepdim=True) - hist[:, 255:]) // 255
    csum = torch.cumsum(hist, dim=1) - hist
    lut = (step // 2 + csum) // torch.clamp(step, min=1)
    ident = torch.arange(256, device=img.device).expand_as(lut)
    lut = torch.where(step == 0, ident, lut.clamp(0, 255))
    out = torch.gather(lut, 1, idx).to(torch.float32)
    return out.reshape(k, 3, h, w).permute(0, 2, 3, 1).contiguous()


def op_posterize(img, v):
    shift = _per_image(8 - v.to(torch.int32).clamp(1, 8))
    vals = img.to(torch.int32)
    return ((vals >> shift) << shift).to(torch.float32)


def op_solarize(img, v):
    threshold = _per_image(256.0 - v)
    return torch.where(img >= threshold, 255.0 - img, img)


def op_rotate(img, v):
    """PIL img.rotate(deg): the inverse map about (w/2, h/2) with the
    matrix [cos, -sin; sin, cos] of +deg."""
    h, w = img.shape[1], img.shape[2]
    theta = v * math.pi / 180.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = h / 2.0, w / 2.0
    a, b, d, e = cos, -sin, sin, cos
    c = cx - a * cx - b * cy
    f = cy - d * cx - e * cy
    return _affine_nearest(img, a, b, c, d, e, f)


def _ones(v):
    return torch.ones_like(v)


def op_shear_x(img, v):
    z = torch.zeros_like(v)
    return _affine_nearest(img, _ones(v), v, z, z, _ones(v), z)


def op_shear_y(img, v):
    z = torch.zeros_like(v)
    return _affine_nearest(img, _ones(v), z, z, v, _ones(v), z)


def op_translate_x(img, v):
    # the reference's int(v * w): truncation toward zero, not floor
    z = torch.zeros_like(v)
    return _affine_nearest(img, _ones(v), z, torch.trunc(v * img.shape[2]),
                           z, _ones(v), z)


def op_translate_y(img, v):
    z = torch.zeros_like(v)
    return _affine_nearest(img, _ones(v), z, z, z, _ones(v),
                           torch.trunc(v * img.shape[1]))


def cutout_box(u: np.ndarray, height: int, width: int,
               size: int) -> np.ndarray:
    """CutoutAbs's boxes (reference utils/randaugment.py:46-60) from the
    uniforms u [B, 2] (x, y), in float32 as ``swat_tpu`` computes them:
    the centre u times the image's side, the corner max(0, centre -
    size / 2) truncated, the far edge min(side, corner + size) -> [B, 4]
    int64 (x0, y0, x1, y1), the x1 / y1 edge included."""
    u = np.asarray(u, np.float32)
    half = np.float32(size / 2)
    x0 = np.maximum(np.float32(0), u[:, 0] * np.float32(width) - half
                    ).astype(np.int64)
    y0 = np.maximum(np.float32(0), u[:, 1] * np.float32(height) - half
                    ).astype(np.int64)
    return np.stack([x0, y0, np.minimum(width, x0 + size),
                     np.minimum(height, y0 + size)], axis=1)


def cutout_abs(img: torch.Tensor, boxes: np.ndarray) -> torch.Tensor:
    """A gray (127) box per image, boxes [k, 4] (x0, y0, x1, y1) with the
    x1 / y1 edge included (PIL ImageDraw.rectangle)."""
    k, h, w, _ = img.shape
    bx = torch.as_tensor(np.asarray(boxes), device=img.device)
    ys = torch.arange(h, device=img.device)[None, :, None]
    xs = torch.arange(w, device=img.device)[None, None, :]

    def edge(i):
        return bx[:, i].reshape(-1, 1, 1)

    mask = ((ys >= edge(1)) & (ys <= edge(3)) & (xs >= edge(0))
            & (xs <= edge(2)))
    return torch.where(mask[..., None], torch.full_like(img, 127.0), img)


# (op, max_v, bias, signed, integral magnitude): the reference's
# fixmatch_augment_pool (utils/randaugment.py:147-163), in its order
Op = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
POOL: Tuple[Tuple[Op, Optional[float], float, bool, bool], ...] = (
    (op_autocontrast, None, 0.0, False, False),
    (op_brightness, 0.9, 0.05, False, False),
    (op_color, 0.9, 0.05, False, False),
    (op_contrast, 0.9, 0.05, False, False),
    (op_equalize, None, 0.0, False, False),
    (op_identity, None, 0.0, False, False),
    (op_posterize, 4, 4, False, True),
    (op_rotate, 30, 0.0, True, False),
    (op_sharpness, 0.9, 0.05, False, False),
    (op_shear_x, 0.3, 0.0, True, False),
    (op_shear_y, 0.3, 0.0, True, False),
    (op_solarize, 256, 0.0, False, True),
    (op_translate_x, 0.3, 0.0, True, False),
    (op_translate_y, 0.3, 0.0, True, False),
)
NUM_OPS = len(POOL)


def op_values(op: int, magnitudes, signs) -> np.ndarray:
    """The value op ``op`` reads from raw magnitudes and signs, in float32
    as ``swat_tpu`` scales them: m * max_v / 10 + bias, floored before the
    bias for posterize and solarize, times the sign for the signed ops; 0
    for the ops that take none."""
    _, max_v, bias, signed, integral = POOL[op]
    mag = np.asarray(magnitudes, np.float32)
    if max_v is None:
        return np.zeros_like(mag)
    v = mag * np.float32(max_v) / np.float32(PARAMETER_MAX)
    if integral:
        v = np.floor(v)
    v = v + np.float32(bias)
    if signed:
        v = v * np.asarray(signs, np.float32)
    return v.astype(np.float32)


def apply_op(op: int, img: torch.Tensor, values) -> torch.Tensor:
    """Op ``op`` of the pool on every image of ``img`` with its value
    (``op_values``) -> new images."""
    v = torch.as_tensor(np.asarray(values, np.float32), device=img.device)
    return POOL[op][0](img, v)


def rand_augment(images: torch.Tensor, draws: RandAugmentDraws,
                 cutout: int = 112) -> torch.Tensor:
    """RandAugmentMC(n, m) of a batch [B, H, W, 3] fp32 (0..255) under its
    draws: each round applies each op once to the images that drew it with
    the gate on, then every image takes its cutout box of side ``cutout``
    (the reference's CutoutAbs(int(224 * 0.5)) at 224 pixels) -> a new
    tensor."""
    out = images.float().clone()
    dev = out.device
    b, rounds = draws.ops.shape
    for j in range(rounds):
        for op in range(NUM_OPS):
            rows = np.flatnonzero((draws.ops[:, j] == op) & draws.gates[:, j])
            if POOL[op][0] is op_identity or rows.size == 0:
                continue
            idx = torch.as_tensor(rows, device=dev)
            values = op_values(op, draws.magnitudes[rows, j],
                               draws.signs[rows, j])
            out.index_copy_(0, idx, apply_op(op, out.index_select(0, idx),
                                             values))
    boxes = cutout_box(draws.cutout, out.shape[1], out.shape[2], cutout)
    return cutout_abs(out, boxes)
