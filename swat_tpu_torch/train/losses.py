"""Loss registry (counterpart of ``swat_tpu/train/losses.py``).

CE, WeightedCE (few-shot vs retrieved weights via the source flag), Focal
and BalancedSoftmax, dispatched by ``set_loss`` as in the reference
(utils/losses.py:9-23).  Each is a mean over per-sample terms, so each
``LossFn`` also exposes ``per_sample``: evaluation sums it under the
validity mask (the JAX package gets the same numbers by vmapping the mean
loss over rows).  ``mixup_criterion`` mixes two label sets under one lambda;
``mixup_criterion_lam_vector`` is the per-sample lambda criterion of
saliencymix and attentivemix.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def _ce_per_sample(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


class LossFn:
    """``loss(logits, labels, source)`` -> mean; ``per_sample`` -> [B]."""

    def __init__(self, per_sample: Callable[..., torch.Tensor]):
        self.per_sample = per_sample

    def __call__(self, logits, labels, source=None) -> torch.Tensor:
        return self.per_sample(logits, labels, source).mean()


cross_entropy = LossFn(lambda logits, labels, source=None:
                       _ce_per_sample(logits, labels))


def make_weighted_ce(fewshot_weight: float = 1.0) -> LossFn:
    """source==1 (few-shot) samples get ``fewshot_weight``, retrieved get 1
    (reference WeightedCELoss, utils/losses.py:74-96)."""

    def per_sample(logits, labels, source):
        s = source.float()
        return _ce_per_sample(logits, labels) * (s * fewshot_weight + 1.0 - s)

    return LossFn(per_sample)


def make_focal(alpha: float = 1.0, gamma: float = 2.0) -> LossFn:
    """reference FocalLoss utils/losses.py:26-46 (with its 1e-8 clamp)."""

    def per_sample(logits, labels, source=None):
        ce = _ce_per_sample(logits, labels).clamp_min(1e-8)
        pt = torch.exp(-ce)
        return alpha * (1 - pt) ** gamma * ce

    return LossFn(per_sample)


def make_balanced_softmax(cls_num_list: Sequence[int]) -> LossFn:
    """log-prior-adjusted CE (reference BalancedSoftmaxLoss,
    utils/losses.py:99-111)."""
    counts = torch.as_tensor(cls_num_list, dtype=torch.float32)
    log_prior = torch.log(counts / counts.sum())[None, :]

    def per_sample(logits, labels, source=None):
        return _ce_per_sample(logits + log_prior.to(logits.device), labels)

    return LossFn(per_sample)


def set_loss(loss_name: str, *, fewshot_weight: float = 1.0,
             focal_alpha: float = 1.0, focal_gamma: float = 2.0,
             cls_num_list: Optional[Sequence[int]] = None) -> LossFn:
    if loss_name == "CE":
        return cross_entropy
    if loss_name == "WeightedCE":
        return make_weighted_ce(fewshot_weight)
    if loss_name == "Focal":
        return make_focal(focal_alpha, focal_gamma)
    if loss_name == "BalancedSoftmax":
        if cls_num_list is None:
            raise ValueError("BalancedSoftmax needs cls_num_list")
        return make_balanced_softmax(cls_num_list)
    raise NotImplementedError(f"Loss {loss_name} not implemented.")


def mixup_criterion(loss: LossFn, logits, y_a, y_b, lam, source=None):
    """lam * L(y_a) + (1 - lam) * L(y_b) (reference utils/training.py:1157)."""
    return (lam * loss(logits, y_a, source)
            + (1.0 - lam) * loss(logits, y_b, source))


def mixup_criterion_lam_vector(logits, y_a, y_b, lam_vec):
    """Per-sample lambdas, SUMMED over the batch: the reference's
    mixup_criterion_lam_list (utils/training.py:1160-1162) sums the
    per-sample CE instead of averaging it (saliencymix and attentivemix use
    this; the ~bsz x larger gradient scale is part of the method)."""
    ce_a = _ce_per_sample(logits, y_a)
    ce_b = _ce_per_sample(logits, y_b)
    return torch.sum(lam_vec * ce_a + (1.0 - lam_vec) * ce_b)
