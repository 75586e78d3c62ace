# Copied from swat_tpu/data/transforms.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Host-side image preprocessing (counterpart of
``swat_tpu/data/transforms.py:22-117``; copied, since that module imports
the JAX augmentation kernels for its constants).

Eval: OpenCLIP's deterministic transform, resize the shorter side
(bicubic) -> center crop -> RGB -> CLIP-normalize.  Train: an
aspect-preserving resize onto a fixed uint8 canvas; the random crop, flip,
normalize and mixing run on the device (``swat_tpu_torch.kernels.augment``).
``host_train_preprocess`` is the reference's own train transform on the
host, with PIL (``--aug_mode host``, and the train-transform feature
snapshots of probing).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image

CANVAS_SIZE = 256  # train canvas; >= 224/sqrt(0.9*3/4) covers all crops

# CLIP normalization constants (reference utils/extras.py:67)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def load_image(path: str) -> Image.Image:
    """Raw PIL image, mode preserved: RGB conversion happens after the
    geometric transforms, as in the reference."""
    return Image.open(path)


def eval_crop(img: Image.Image, n_px: int = 224) -> Image.Image:
    """Resize(shorter side = n_px, bicubic) + CenterCrop(n_px) + RGB."""
    w, h = img.size
    # torchvision Resize truncates the long side (int(), not round)
    if w < h:
        nw, nh = n_px, max(n_px, int(h * n_px / w))
    else:
        nw, nh = max(n_px, int(w * n_px / h)), n_px
    img = img.resize((nw, nh), Image.BICUBIC)
    # torchvision F.center_crop: int(round(d / 2.0)), round-half-even
    left = int(round((nw - n_px) / 2.0))
    top = int(round((nh - n_px) / 2.0))
    return img.crop((left, top, left + n_px, top + n_px)).convert("RGB")


def normalize_u8(pixels: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] pixels -> CLIP-normalized float32."""
    x = pixels.astype(np.float32) / 255.0
    return ((x - np.asarray(CLIP_MEAN, np.float32))
            / np.asarray(CLIP_STD, np.float32))


def eval_preprocess(img: Image.Image, n_px: int = 224) -> np.ndarray:
    return normalize_u8(np.asarray(eval_crop(img, n_px), dtype=np.uint8))


def train_canvas(img: Image.Image, canvas: int = CANVAS_SIZE
                 ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Aspect-preserving resize (longest side -> canvas, bicubic) into the
    top-left of a [canvas, canvas, 3] uint8 array -> (canvas, (valid_h,
    valid_w)).  Small images upscale, so crop statistics stay comparable
    to the reference's full-resolution RandomResizedCrop."""
    w, h = img.size
    if w >= h:
        nw = canvas
        nh = max(1, int(round(h * canvas / w)))
    else:
        nh = canvas
        nw = max(1, int(round(w * canvas / h)))
    img = img.resize((nw, nh), Image.BICUBIC).convert("RGB")
    out = np.zeros((canvas, canvas, 3), dtype=np.uint8)
    out[:nh, :nw] = np.asarray(img, dtype=np.uint8)
    return out, (nh, nw)


def host_train_preprocess(img: Image.Image, rng: np.random.Generator,
                          n_px: int = 224, scale=(0.9, 1.0),
                          ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """The reference train transform on the host (RandomResizedCrop +
    HFlip + normalize, utils/extras.py:66-77), draw for draw as
    ``swat_tpu``'s: the same generator gives the same array."""
    w, h = img.size
    area = w * h
    for _ in range(10):
        target = rng.uniform(scale[0], scale[1]) * area
        aspect = float(np.exp(rng.uniform(np.log(ratio[0]),
                                          np.log(ratio[1]))))
        cw = int(round((target * aspect) ** 0.5))
        ch = int(round((target / aspect) ** 0.5))
        if 0 < cw <= w and 0 < ch <= h:
            j = int(rng.integers(0, w - cw + 1))
            i = int(rng.integers(0, h - ch + 1))
            break
    else:
        # torchvision RandomResizedCrop's fallback: the ratio-clamped
        # centre crop, not the whole image (with scale (0.9, 1.0) every
        # 3:2 image fails all ten attempts and lands here)
        in_ratio = w / h
        if in_ratio < ratio[0]:
            cw = w
            ch = int(round(cw / ratio[0]))
        elif in_ratio > ratio[1]:
            ch = h
            cw = int(round(ch * ratio[1]))
        else:
            cw, ch = w, h
        i = (h - ch) // 2
        j = (w - cw) // 2
    img = img.crop((j, i, j + cw, i + ch)).resize((n_px, n_px), Image.BICUBIC)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    # RGB convert after the geometry, as the reference places it
    return normalize_u8(np.asarray(img.convert("RGB"), dtype=np.uint8))
