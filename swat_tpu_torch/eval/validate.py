"""Streaming evaluation (counterpart of ``swat_tpu/eval/validate.py:24-132,
194-227``): the ``validate`` path of the reference (testing.py:403-486).

Per batch: encode -> head logits -> argmax and masked loss, with the
(correct, count, sum of per-batch mean losses) carry and the confusion
matrix kept on the device, so a split costs one host sync at its end.  The
loss is the mean of per-batch means, the JAX package's definition
(validate.py:132), not the resident engine's mean over samples.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.head import head_logits
from swat_tpu_torch.train.losses import LossFn, cross_entropy


def cm_scatter_add(cm: torch.Tensor, preds: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """Confusion update in place (rows = true, cols = pred); masked-out
    padding rows add 0."""
    idx = labels.long() * num_classes + preds.long()
    cm.view(-1).index_add_(0, idx, mask.to(cm.dtype))
    return cm


class Evaluator:
    """Batch evaluation of image batches (or pre-extracted feature
    batches) for a fixed number of classes and loss."""

    def __init__(self, num_classes: int, loss: LossFn = cross_entropy,
                 device: torch.device = torch.device("cpu")):
        self.num_classes = num_classes
        self.loss = loss
        self.device = torch.device(device)

    def validate(self, model: Optional[CLIPModel], head: torch.Tensor,
                 logit_scale: float, loader, *,
                 return_confusion: bool = False):
        """Returns (acc_percent, mean_loss, confusion_matrix | None), the
        reference validate's signature (testing.py:403).  ``model`` may be
        None when the loader yields 'features' instead of 'images'."""
        dev = self.device
        c = self.num_classes
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        cm = torch.zeros((c, c), dtype=torch.int64, device=dev)
        scale = torch.exp(torch.tensor(logit_scale, dtype=torch.float32,
                                       device=dev))
        head = head.to(dev)
        batches = 0
        with torch.inference_mode():
            for batch in loader:
                if "features" in batch:
                    feats = torch.from_numpy(batch["features"]).to(dev)
                else:
                    images = torch.from_numpy(batch["images"]).to(dev)
                    feats = model.encode_image(images, normalize=True)
                labels = torch.from_numpy(batch["labels"]).to(dev).long()
                source = torch.from_numpy(batch["source"]).to(dev)
                mask = torch.from_numpy(batch["mask"]).to(dev)
                logits = head_logits(head, feats)
                preds = logits.argmax(dim=-1)
                correct += ((preds == labels) & mask).sum()
                nb = mask.sum()
                per = self.loss.per_sample(logits * scale, labels, source)
                loss_sum += (per * mask).sum() / nb.clamp_min(1)
                count += nb
                if return_confusion:
                    cm_scatter_add(cm, preds, labels, mask, c)
                batches += 1
        acc = int(correct) / max(int(count), 1) * 100.0
        return (acc, float(loss_sum) / max(batches, 1),
                cm.cpu().numpy() if return_confusion else None)


def validate_features(head, logit_scale, features, labels, num_classes: int,
                      loss: LossFn = cross_entropy, source=None):
    """Single-shot eval over a full pre-extracted feature matrix.
    Returns (acc%, loss, confusion_matrix)."""
    head = torch.as_tensor(head)
    dev = head.device
    feats = torch.as_tensor(np.asarray(features), device=dev)
    labels = torch.as_tensor(np.asarray(labels), device=dev).long()
    source = (torch.full_like(labels, -1) if source is None
              else torch.as_tensor(np.asarray(source), device=dev))
    with torch.inference_mode():
        logits = head_logits(head, feats)
        preds = logits.argmax(dim=-1)
        # the percentage as XLA computes mean() * 100: the count times one
        # fp32 constant, the fp32 reciprocal of n times 100 (all 12 of 12
        # right reads 100.000008 in both packages)
        pct = np.float32(np.float32(1.0 / max(labels.numel(), 1))
                         * np.float32(100.0))
        acc = (preds == labels).float().sum() * torch.tensor(
            pct, device=dev)
        scale = torch.exp(torch.tensor(logit_scale, dtype=torch.float32,
                                       device=dev))
        loss_val = loss(logits * scale, labels, source)
        cm = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                         device=dev)
        cm_scatter_add(cm, preds, labels, torch.ones_like(labels),
                       num_classes)
    return float(acc), float(loss_val), cm.cpu().numpy()
