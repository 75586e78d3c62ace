"""AdamW and SGD param groups and the per-iteration LR schedule
(counterpart of ``swat_tpu/train/optim.py:29-157``), reproducing reference
utils/optimizers.py:

* per-iteration stepped schedule: optimizer step i (the count BEFORE the
  increment) uses
    i == 0        -> warmup_lr, absolute, for every group (the head too);
    1 <= i < 50   -> base_lr * i / 50;
    i >= 50       -> cosine anneal, s = i - 49 over total_iter:
                     eta + (base - eta) (1 + cos(pi s / T)) / 2;
  computed in float32 as the JAX package computes it;
* warmup_lr = 1e-5 if lr_backbone > 5e-5 else 1e-6;
* AdamW betas (0.9, 0.999), eps 1e-8, decoupled weight decay on every
  trained tensor, logit_scale included.  optax's adamw decays as
  lr * wd * p inside the update, torch's AdamW scales p by (1 - lr * wd)
  first: equal in math, different in rounding;
* ``--optim SGD``: momentum 0.9 (no dampening, no Nesterov), the weight
  decay added to the gradient before the momentum (optax's
  ``add_decayed_weights`` -> ``trace(0.9)`` -> the learning rate);
* groups by label: the visual tower at lr_backbone, head and logit_scale at
  lr_classifier, FLYP's two projections (``visual.proj``,
  ``text_projection``) at lr_projector, or lr_backbone when it is None.
  Frozen tensors (the text tower of the finetune family) are in no group,
  so they get neither update nor decay (optax's ``set_to_zero``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

WARMUP_ITER = 50
ETA_MIN = 1e-9

FINETUNE_METHODS = {
    "finetune", "finetune-multitask", "finetune-mixed", "dataset-cls",
    "mixup", "mixup-fs", "cutmix", "cutmix-fs", "resizemix",
    "saliencymix", "attentivemix", "CMO", "fixmatch",
}
# the whole model frozen: only the head trains, logit_scale pinned at ln 100
FROZEN_METHODS = {"zeroshot", "probing", "REAL-Linear", "CMLP"}


def make_lr_schedule(base_lr: float, total_iter: int,
                     warmup_iter: int = WARMUP_ITER,
                     warmup_lr: float = 1e-6,
                     eta_min: float = ETA_MIN) -> Callable[[int], float]:
    """step -> learning rate, in float32 (``optim.make_lr_schedule``)."""
    f32 = np.float32

    def schedule(step: int) -> float:
        i = f32(step)
        if i == 0:
            return float(f32(warmup_lr))
        if i < warmup_iter:
            return float(f32(base_lr) * i / f32(warmup_iter))
        s = i - f32(warmup_iter - 1)
        cos = np.cos(f32(np.pi) * s / f32(total_iter))
        return float(f32(eta_min)
                     + f32((base_lr - eta_min) * 0.5) * (f32(1.0) + cos))

    return schedule


def default_warmup_lr(lr_backbone: float) -> float:
    return 1e-5 if lr_backbone > 5e-5 else 1e-6


def label_params(model: nn.Module, method: str,
                 locked_text: bool = False) -> Dict[str, str]:
    """Parameter name -> 'backbone' | 'projector' | 'frozen' for the
    model's own tensors (reference set_params, utils/optimizers.py:38-120):
    finetune methods train the visual tower and lock the text tower; frozen
    methods lock both; FLYP trains both towers, its two projections as
    'projector' (an image tower without ``visual.proj``, the ResNet, is
    refused, as ``swat_tpu``'s labels fail on it), and under
    ``locked_text`` locks the text tower but for ``text_projection`` (the
    reference's lock_text_tower freezes it too, then its FLYP branch
    re-enables both projections, :103-120).  The CLIP
    module's own logit_scale is never trained: the train state carries its
    own (``state.init_logit_scale``)."""
    names = [n for n, _ in model.named_parameters()]
    if method in FROZEN_METHODS:
        return {n: "frozen" for n in names}
    if method in FINETUNE_METHODS:
        return {n: "backbone" if n.startswith("visual.") else "frozen"
                for n in names}
    if method == "FLYP":
        if "visual.proj" not in names:
            # swat_tpu's labels fail on this tree too ("Dict key mismatch")
            raise ValueError(
                "FLYP trains the image tower's projection visual.proj in "
                "its projector group (reference set_params, "
                "utils/optimizers.py:103-120); the ResNet image tower has "
                "no such tensor")

        def label(n):
            if n in ("visual.proj", "text_projection"):
                return "projector"
            if n.startswith("visual."):
                return "backbone"
            if n == "logit_scale" or locked_text:
                return "frozen"
            return "backbone"

        return {n: label(n) for n in names}
    raise NotImplementedError(f"Method {method} not implemented.")


def build_optimizer(groups: Dict[str, List[torch.Tensor]], *,
                    lr_classifier: float, lr_backbone: float,
                    total_iter: int, wd: float = 1e-2,
                    optim_type: str = "AdamW",
                    lr_projector: Optional[float] = None
                    ) -> torch.optim.Optimizer:
    """AdamW (or, for ``optim_type`` 'SGD', SGD with momentum) over the
    labeled groups {'backbone': [...], 'projector': [...], 'head': [...]}
    (empty groups are left out); each param group carries its
    ``schedule``, applied by ``set_lr`` before every step.  Every group
    warms up from ``default_warmup_lr(lr_backbone)``."""
    if optim_type not in ("AdamW", "SGD"):
        raise ValueError(f"--optim must be AdamW or SGD; got {optim_type!r}")
    warmup_lr = default_warmup_lr(lr_backbone)
    base = {"backbone": lr_backbone, "head": lr_classifier,
            "projector": (lr_projector if lr_projector is not None
                          else lr_backbone)}
    param_groups = []
    for label in ("backbone", "projector", "head"):
        if groups.get(label):
            schedule = make_lr_schedule(base[label], total_iter,
                                        warmup_lr=warmup_lr)
            param_groups.append({"params": groups[label], "label": label,
                                 "schedule": schedule, "lr": schedule(0)})
    if optim_type == "SGD":
        return torch.optim.SGD(param_groups, momentum=0.9, dampening=0.0,
                               nesterov=False, weight_decay=wd)
    return torch.optim.AdamW(param_groups, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=wd)


def set_lr(optimizer: torch.optim.Optimizer, step: int) -> None:
    """Every group's lr for optimizer step ``step`` (0-based count)."""
    for group in optimizer.param_groups:
        group["lr"] = group["schedule"](step)


def trains_logit_scale(method: str) -> bool:
    """Finetune/FLYP methods learn logit_scale (init ln(1/temperature));
    frozen methods pin it at ln(100) (reference :51-59,80,119)."""
    return method in FINETUNE_METHODS or method == "FLYP"
