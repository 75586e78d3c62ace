"""SWAT's stage-1 cutmix step in plain float32 PyTorch, followed for the
first steps of a run.

One step (SWAT's ``train_cutmix``, utils/training.py, with its train
transform, utils/extras.py): each canvas's random-resized crop (scale
0.9-1, ratio 3/4-4/3, ten tries, else the centre crop) resized to the
image size by ``jax.image.scale_and_translate``'s Keys cubic (a = -0.5,
antialiased on downscale, weights normalised per output pixel, outputs
whose sample point falls outside the input zeroed), a horizontal flip with
probability 1/2, CLIP's normalisation; then, with probability
``mix_prob``, a Beta(1, 1) box pasted from a permutation of the batch
(lam the exact share of pixels kept); the image tower, normalised
features against the head at exp(logit_scale), lam * CE(y_a) + (1 - lam) *
CE(y_b); AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled decay) on the
image tower at the backbone rate and on the head and logit_scale at the
classifier rate, under SWAT's schedule (utils/optimizers.py: the warm-up
rate at step 0, then linear to the base rate over 50 steps, then cosine).

The draws are this file's frozen copy of the sampler's arithmetic, taken
from a generator seeded as the program's: crops, flips, then the gate,
lam, permutation and box centre of the cutmix, in that order a step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference.vit import (LOG_INV_TEMPERATURE, Rounding,
                                     cross_entropy, image_features,
                                     normalized)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SCALE, RATIO, TRIES = (0.9, 1.0), (3 / 4, 4 / 3), 10
BETAS, EPS = (0.9, 0.999), 1e-8
WARMUP_ITER, ETA_MIN = 50, 1e-9


# -- the draws (frozen copy) ------------------------------------------------

def draw_crops(rng: np.random.Generator, valid_hw: np.ndarray) -> np.ndarray:
    """Boxes [B, 4] (top, left, height, width) inside each valid region."""
    vh = valid_hw[:, 0].astype(np.int64)
    vw = valid_hw[:, 1].astype(np.int64)
    b = len(vh)
    area = (vh * vw).astype(np.float32)[:, None]
    target = rng.uniform(SCALE[0], SCALE[1], (b, TRIES)).astype(
        np.float32) * area
    aspect = np.exp(rng.uniform(math.log(RATIO[0]), math.log(RATIO[1]),
                                (b, TRIES)).astype(np.float32))
    w = np.round(np.sqrt(target * aspect)).astype(np.int64)
    h = np.round(np.sqrt(target / aspect)).astype(np.int64)
    fits = (w > 0) & (w <= vw[:, None]) & (h > 0) & (h <= vh[:, None])
    first = fits.argmax(axis=1)
    found = fits.any(axis=1)
    fh, fw = vh.astype(np.float32), vw.astype(np.float32)
    lo, hi = np.float32(RATIO[0]), np.float32(RATIO[1])
    cw = np.where(fw / fh > hi, np.round(fh * hi).astype(np.int64), vw)
    ch = np.where(fw / fh < lo, np.round(fw / lo).astype(np.int64), vh)
    rows = np.arange(b)
    ch = np.where(found, h[rows, first], ch)
    cw = np.where(found, w[rows, first], cw)
    top = rng.integers(0, np.maximum(vh - ch, 0) + 1)
    left = rng.integers(0, np.maximum(vw - cw, 0) + 1)
    top = np.where(found, top, (vh - ch) // 2)
    left = np.where(found, left, (vw - cw) // 2)
    return np.stack([top, left, ch, cw], axis=1)


@dataclasses.dataclass
class Cutmix:
    gate: bool
    perm: np.ndarray
    box: tuple


def draw_cutmix(rng: np.random.Generator, batch: int, size: int,
                beta: float, mix_prob: float) -> Cutmix:
    gate = bool(rng.random() < mix_prob)
    lam = float(rng.beta(beta, beta)) if beta > 0 else 1.0
    perm = rng.permutation(batch)
    cy, cx = int(rng.integers(0, size)), int(rng.integers(0, size))
    cut = np.sqrt(np.float32(1.0) - np.float32(lam))
    half = int(np.float32(size) * cut) // 2
    box = tuple(int(np.clip(v, 0, size)) for v in
                (cy - half, cy + half, cx - half, cx + half))
    return Cutmix(gate, perm, box)


# -- the transform -----------------------------------------------------------

def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far,
                                                  torch.zeros_like(x)))


def _weights(in_size: int, out_size: int, start: torch.Tensor,
             length: torch.Tensor) -> torch.Tensor:
    """[B, in, out]: output pixel o samples input coordinate start +
    (o + 0.5) * length / out - 0.5."""
    dev = start.device
    step = length / out_size
    spread = torch.clamp(step, min=1.0)
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    at = start[:, None] + (o[None, :] + 0.5) * step[:, None] - 0.5
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    wts = _keys_cubic((at[:, None, :] - i[None, :, None]).abs()
                      / spread[:, None, None])
    total = wts.sum(dim=1, keepdim=True)
    ok = total.abs() > 1000.0 * float(np.finfo(np.float32).eps)
    wts = torch.where(ok, wts / torch.where(ok, total, torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (at >= -0.5) & (at <= in_size - 0.5)
    return wts * inside[:, None, :]


def transform(canvases: torch.Tensor, boxes: np.ndarray, flips: np.ndarray,
              size: int) -> torch.Tensor:
    """uint8 canvases [B, C, C, 3] -> normalised fp32 images [B, size,
    size, 3]."""
    dev = canvases.device
    box = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    wy = _weights(canvases.shape[1], size, box[:, 0], box[:, 2])
    wx = _weights(canvases.shape[2], size, box[:, 1], box[:, 3])
    img = canvases.float()
    rows = torch.einsum("byo,byxc->boxc", wy, img)
    out = torch.einsum("bxp,boxc->bopc", wx, rows)
    flip = torch.as_tensor(flips, device=dev)[:, None, None, None]
    out = torch.where(flip, out.flip(2), out)
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    return (out / 255.0 - mean) / std


def cutmix(images: torch.Tensor, labels: torch.Tensor, mix: Cutmix):
    """-> (images, y_a, y_b, lam)."""
    if not mix.gate:
        return images, labels, labels, 1.0
    y1, y2, x1, x2 = mix.box
    perm = torch.as_tensor(mix.perm, device=images.device)
    out = images.clone()
    out[:, y1:y2, x1:x2] = images[perm, y1:y2, x1:x2]
    _, h, w, _ = images.shape
    lam = float(np.float32(1.0) - np.float32((y2 - y1) * (x2 - x1))
                / np.float32(h * w))
    return out, labels, labels[perm], lam


# -- AdamW under SWAT's schedule --------------------------------------------

def learning_rate(step: int, base: float, total: int,
                  warmup_lr: float) -> float:
    if step == 0:
        return warmup_lr
    if step < WARMUP_ITER:
        return base * step / WARMUP_ITER
    s = step - (WARMUP_ITER - 1)
    return ETA_MIN + (base - ETA_MIN) * 0.5 * (1 + math.cos(math.pi * s
                                                            / total))


def adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
          t: int, lr: float, wd: float) -> None:
    """One AdamW update of ``p`` in place (t counts from 1)."""
    p.mul_(1 - lr * wd)
    m.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
    v.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
    m_hat = m / (1 - BETAS[0] ** t)
    v_hat = v / (1 - BETAS[1] ** t)
    p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))


# -- the steps ---------------------------------------------------------------

def leaf_parts(name: str, t: torch.Tensor):
    """The leaves the comparison counts: a tensor, or the q, k and v
    thirds of a packed in_proj, so that the key's bias, whose gradient is
    nought under softmax, is a leaf of its own."""
    if name.endswith(("attn.in_proj_weight", "attn.in_proj_bias")):
        return [(f"{name}[{part}]", third)
                for part, third in zip("qkv", t.chunk(3))]
    return [(name, t)]


def norms(named) -> Dict[str, float]:
    """{leaf: its norm} over (name, tensor) pairs, packed ones split."""
    return {leaf: float(torch.linalg.vector_norm(part))
            for name, t in named for leaf, part in leaf_parts(name, t)}


@dataclasses.dataclass
class Readings:
    """What the first steps produced: each step's loss, each trained
    leaf's first gradient norm and its change after the steps."""
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def follow(cfg: dict, traffic: dict, weights: Dict[str, torch.Tensor],
           head: torch.Tensor, canvases: Sequence[torch.Tensor],
           valid_hw: Sequence[np.ndarray], labels: Sequence[torch.Tensor],
           draws: np.random.Generator, total_iter: int,
           rounding: Rounding = Rounding()) -> Readings:
    """The reference's first ``len(canvases)`` steps from ``weights``
    (the ``visual.*`` leaves are trained) and ``head``, on the given rows,
    with the crops, flips and boxes drawn from ``draws``; ``total_iter``
    is the schedule's length."""
    opt = traffic["optimizer"]
    size = cfg["vision_cfg"]["image_size"]
    warmup_lr = 1e-5 if opt["lr_backbone"] > 5e-5 else 1e-6
    params = {k: w.detach().clone().requires_grad_(True)
              for k, w in weights.items() if k.startswith("visual.")}
    params["head"] = head.detach().clone().requires_grad_(True)
    params["logit_scale"] = torch.tensor(
        LOG_INV_TEMPERATURE, device=head.device).requires_grad_(True)
    start = {k: p.detach().clone() for k, p in params.items()}
    moments = {k: (torch.zeros_like(p), torch.zeros_like(p))
               for k, p in params.items()}
    losses, grad_norms = [], {}
    for t, (cv, hw, lb) in enumerate(zip(canvases, valid_hw, labels)):
        boxes = draw_crops(draws, hw)
        flips = draws.random(len(hw)) < 0.5
        mix = draw_cutmix(draws, len(hw), size, traffic["cutmix_beta"],
                          traffic["mix_prob"])
        with torch.no_grad():
            images = transform(cv, boxes, flips, size)
            images, y_a, y_b, lam = cutmix(images, lb, mix)
        feats = normalized(image_features(images, params, cfg, rounding))
        logits = feats @ params["head"].t() * params["logit_scale"].exp()
        loss = (lam * cross_entropy(logits, y_a).mean()
                + (1.0 - lam) * cross_entropy(logits, y_b).mean())
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if t == 0:
                grad_norms = norms(zip(params, grads))
            for (k, p), g in zip(params.items(), grads):
                group = "lr_classifier" if k in ("head", "logit_scale") \
                    else "lr_backbone"
                lr = learning_rate(t, opt[group], total_iter, warmup_lr)
                adamw(p, g, *moments[k], t + 1, lr, opt["wd"])
    with torch.no_grad():
        change = norms((k, p - start[k]) for k, p in params.items())
    return Readings(losses, grad_norms, change)
