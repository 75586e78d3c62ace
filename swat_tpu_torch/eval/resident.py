"""GPU-resident evaluation (counterpart of
``swat_tpu/train/scan_loop.py:208-326``).

The eval split is decoded and center-cropped once and kept on the device as
uint8 pixels, padded to a batch multiple with a mask; a validation pass then
normalizes, encodes and scores batch after batch on the device, with one
host sync at the end.  The loss is the mean over all samples, the JAX scan
engine's definition (scan_loop.py:316), not the streaming Evaluator's mean
of per-batch means.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from swat_tpu_torch.data.splits import Sample
from swat_tpu_torch.data.pipeline import eval_pixels_u8
from swat_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.head import head_logits
from swat_tpu_torch.train.losses import LossFn, cross_entropy


class ResidentEval:
    """An eval split on the device: uint8 pixels [N_pad, n_px, n_px, 3],
    labels, mask and source, N_pad a multiple of the batch size."""

    def __init__(self, images_u8, labels, mask, source):
        self.images_u8 = images_u8
        self.labels = labels
        self.mask = mask
        self.source = source

    @classmethod
    def from_samples(cls, samples: Sequence[Sample], device: torch.device,
                     n_px: int = 224,
                     batch_size: int = 256, num_workers: int = 16):
        images = eval_pixels_u8(samples, n_px, num_workers)
        n = len(samples)
        pad = (-n) % batch_size
        if pad:
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], np.uint8)])
        labels = np.asarray([s.label for s in samples] + [0] * pad, np.int64)
        source = np.asarray([s.is_fewshot for s in samples] + [0] * pad,
                            np.int64)
        mask = np.arange(n + pad) < n

        def put(x):
            return torch.from_numpy(x).to(device)

        return cls(put(images), put(labels), put(mask), put(source))


def normalize_u8(images: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] pixels -> CLIP-normalized float32, on their device."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=images.device)
    return (images.float() / 255.0 - mean) / std


def make_scan_eval(num_classes: int, batch_size: int = 256,
                   loss: LossFn = cross_entropy):
    """Returns eval_fn(model, head, logit_scale, resident_eval) ->
    (acc%, mean_loss, confusion_matrix), with ``loss`` the run's configured
    LossFn evaluated per sample (the reference validate computes args.loss,
    testing.py:441-447)."""

    def eval_fn(model: CLIPModel, head: torch.Tensor, logit_scale: float,
                ev: ResidentEval):
        dev = ev.images_u8.device
        head = head.to(dev)
        scale = torch.exp(torch.tensor(logit_scale, dtype=torch.float32,
                                       device=dev))
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        cnt = torch.zeros((), dtype=torch.int64, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        cm = torch.zeros(num_classes * num_classes, dtype=torch.int64,
                         device=dev)
        with torch.inference_mode():
            for i in range(0, ev.images_u8.shape[0], batch_size):
                sl = slice(i, i + batch_size)
                lb, mk, sc = ev.labels[sl], ev.mask[sl], ev.source[sl]
                feats = model.encode_image(normalize_u8(ev.images_u8[sl]),
                                           normalize=True)
                logits = head_logits(head, feats)
                preds = logits.argmax(dim=-1)
                correct += ((preds == lb) & mk).sum()
                per = loss.per_sample(logits * scale, lb, sc)
                loss_sum += (per * mk).sum()
                cnt += mk.sum()
                cm.index_add_(0, lb * num_classes + preds, mk.long())
        n = cnt.clamp_min(1)
        acc = correct.float() / n * 100.0
        return (float(acc), float(loss_sum / n),
                cm.reshape(num_classes, num_classes).cpu().numpy())

    return eval_fn
