"""The inputs of a run, made from the seed: the random streams and the
resident train pool of uint8 canvases.

Pixels are made on the device, in chunks: each class has a coarse colour
grid of its own; an image is its class's grid moved by a coarse
perturbation of its own, resampled bilinearly to the image size, plus fine
uniform noise.  So images differ in their large-scale content, and images
of one class resemble each other, as photographs do.  A train
canvas holds its image in the top-left valid region (one side 256, the
other drawn from ``short_side``, landscape and portrait alternating), zeros
elsewhere, as the port's decoder lays a photograph out.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

CHUNK = 2048          # images made at a time
COARSE = 8            # the colour grid's side
SPREAD = 48           # an image's coarse perturbation, +/- this many levels
NOISE = 24            # fine noise, +/- this many levels


@dataclasses.dataclass(frozen=True)
class Streams:
    """Independent seeds of one run: torch seeds for the weights, the head
    and the pixels; numpy generators' seeds for the pool's layout, the step
    draws and the batch order."""
    weights: int
    head: int
    pixels: int
    layout: np.random.SeedSequence
    draws: np.random.SeedSequence
    order: np.random.SeedSequence


def streams(seed: int) -> Streams:
    kids = np.random.SeedSequence(seed).spawn(6)
    torch_seed = [int(k.generate_state(1, np.uint64)[0]) for k in kids[:3]]
    return Streams(*torch_seed, *kids[3:])


def class_grids(classes: int, seed: int, device) -> torch.Tensor:
    """Each class's coarse colour grid [classes, 3, COARSE, COARSE]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (classes, 3, COARSE, COARSE), generator=gen,
                         device=device).float()


def _pixels(out: torch.Tensor, labels: torch.Tensor, grids: torch.Tensor,
            seed: int) -> None:
    """Fill uint8 images ``out`` [N, H, W, 3] of classes ``labels`` from
    their classes' ``grids``, perturbations and noise drawn from ``seed``."""
    gen = torch.Generator(device=out.device).manual_seed(seed)
    n, h, w, _ = out.shape
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        coarse = grids[labels[i:i + m]] + torch.randint(
            -SPREAD, SPREAD + 1, (m, 3, COARSE, COARSE), generator=gen,
            device=out.device, dtype=torch.int16)
        field = F.interpolate(coarse, size=(h, w), mode="bilinear",
                              align_corners=False)
        noise = torch.randint(-NOISE, NOISE + 1, (m, 3, h, w), generator=gen,
                              device=out.device, dtype=torch.int16)
        img = (field + noise).clamp_(0, 255).to(torch.uint8)
        out[i:i + m] = img.permute(0, 2, 3, 1)


def train_layout(pool: dict, seq: np.random.SeedSequence
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """valid_hw [N, 2] int32, labels [N] and the few-shot flag [N] of the
    resident train split: ``fewshot_per_class`` few-shot rows and
    ``retrieved_per_class`` retrieved rows of each class."""
    rng = np.random.default_rng(seq)
    c = pool["classes"]
    few, ret = pool["fewshot_per_class"], pool["retrieved_per_class"]
    n = c * (few + ret)
    lo, hi = pool["short_side"]
    short = rng.integers(lo, hi + 1, n)
    valid_hw = np.stack([short, np.full(n, pool["canvas"])], axis=1)
    valid_hw[::2] = valid_hw[::2, ::-1]
    labels = np.concatenate([np.repeat(np.arange(c), few),
                             np.repeat(np.arange(c), ret)])
    source = np.concatenate([np.ones(c * few), np.zeros(c * ret)])
    return (valid_hw.astype(np.int32), labels.astype(np.int64),
            source.astype(np.int64))


def train_canvases(valid_hw: np.ndarray, labels: np.ndarray, canvas: int,
                   seed: int, device: torch.device) -> torch.Tensor:
    """uint8 canvases [N, canvas, canvas, 3] on ``device``, zero outside
    each row's valid region."""
    n = len(valid_hw)
    out = torch.empty((n, canvas, canvas, 3), dtype=torch.uint8,
                      device=device)
    grids = class_grids(int(labels.max()) + 1, seed, device)
    _pixels(out, torch.from_numpy(labels).to(device), grids,
            (seed + 1) % 2 ** 64)
    hw = torch.from_numpy(valid_hw).to(device)
    at = torch.arange(canvas, device=device)
    for i in range(0, n, CHUNK):
        h, w = hw[i:i + CHUNK, 0], hw[i:i + CHUNK, 1]
        keep = (at[None, :, None] < h[:, None, None]) & \
            (at[None, None, :] < w[:, None, None])
        out[i:i + CHUNK].mul_(keep[..., None])
    return out
