"""GPU-resident evaluation (counterpart of
``swat_tpu/train/scan_loop.py:208-326``).

The eval split is decoded and center-cropped once and kept on the device as
uint8 pixels, padded to a batch multiple with a mask; a validation pass then
normalizes, encodes and scores batch after batch on the device, with one
host sync at the end.  The loss is the mean over all samples, the JAX scan
engine's definition (scan_loop.py:316), not the streaming Evaluator's mean
of per-batch means.

Under a data-parallel mesh each rank decodes and holds its rows of every
batch (the batch size must divide by the data axis); a pass encodes them
and gathers the features into the batch, so every rank scores the whole
split in the single-device order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from swat_tpu_torch.core.mesh import Mesh, active, on_rows
from swat_tpu_torch.data.splits import Sample
from swat_tpu_torch.data.pipeline import eval_pixels_u8
from swat_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.head import head_logits
from swat_tpu_torch.train.losses import LossFn, cross_entropy


class ResidentEval:
    """An eval split on the device: uint8 pixels [N_pad, n_px, n_px, 3],
    labels, mask and source, N_pad a multiple of the batch size.  With a
    ``mesh`` the pixels are this rank's rows of each batch,
    [N_pad / data, ...], the rest whole."""

    def __init__(self, images_u8, labels, mask, source,
                 mesh: Optional[Mesh] = None):
        self.images_u8 = images_u8
        self.labels = labels
        self.mask = mask
        self.source = source
        self.mesh = active(mesh)

    @classmethod
    def from_samples(cls, samples: Sequence[Sample], device: torch.device,
                     n_px: int = 224,
                     batch_size: int = 256, num_workers: int = 16,
                     mesh: Optional[Mesh] = None):
        mesh = active(mesh)
        n = len(samples)
        pad = (-n) % batch_size
        if mesh is None:
            images = eval_pixels_u8(samples, n_px, num_workers)
        else:
            rows = held_rows(n, batch_size, mesh)
            held = rows[rows < n]
            images = (eval_pixels_u8([samples[i] for i in held], n_px,
                                     num_workers) if len(held) else
                      np.zeros((0, n_px, n_px, 3), np.uint8))
            pad = len(rows) - len(held)
        if pad:
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], np.uint8)])
        total = n + (-n) % batch_size
        labels = np.asarray([s.label for s in samples] + [0] * (total - n),
                            np.int64)
        source = np.asarray(
            [s.is_fewshot for s in samples] + [0] * (total - n), np.int64)
        mask = np.arange(total) < n

        def put(x):
            return torch.from_numpy(x).to(device)

        return cls(put(images), put(labels), put(mask), put(source), mesh)


def held_rows(n: int, batch_size: int, mesh: Mesh) -> np.ndarray:
    """The rows of a split of ``n`` padded to a batch multiple that this
    rank holds: its rows of every batch, in order."""
    mine = mesh.rows(batch_size)
    return np.concatenate([np.arange(b + mine.start, b + mine.stop)
                           for b in range(0, n + (-n) % batch_size,
                                          batch_size)])


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
        rows = batch_size // (ev.mesh.data if ev.mesh is not None else 1)
        with torch.inference_mode():
            for b, i in enumerate(range(0, ev.labels.shape[0], batch_size)):
                sl = slice(i, i + batch_size)
                lb, mk, sc = ev.labels[sl], ev.mask[sl], ev.source[sl]
                feats = on_rows(ev.mesh, lambda x: model.encode_image(
                    normalize_u8(x), normalize=True),
                    ev.images_u8[b * rows: (b + 1) * rows], local=True)
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
