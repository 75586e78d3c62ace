"""AdamW param groups and the per-iteration LR schedule (counterpart of
``swat_tpu/train/optim.py:29-157``), reproducing reference
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
* groups by label: the visual tower at lr_backbone, head and logit_scale at
  lr_classifier.  Frozen tensors (the text tower) are in no group, so they
  get neither update nor decay (optax's ``set_to_zero``).

SGD and the labeling of FLYP are not ported yet (ROADMAP Queue A item 6):
``label_params`` knows the finetune family (the single-loader mixes among
them) and the frozen methods, and raises for the rest.
"""

from __future__ import annotations

from typing import Callable, Dict, List

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


def label_params(model: nn.Module, method: str) -> Dict[str, str]:
    """Parameter name -> 'backbone' | 'frozen' for the model's own tensors
    (reference set_params, utils/optimizers.py:38-81): finetune methods
    train the visual tower and lock the text tower; frozen methods lock
    both.  The CLIP module's own logit_scale is never trained: the train
    state carries its own (``state.init_logit_scale``)."""
    if method in FROZEN_METHODS:
        return {n: "frozen" for n, _ in model.named_parameters()}
    if method in FINETUNE_METHODS:
        return {n: "backbone" if n.startswith("visual.") else "frozen"
                for n, _ in model.named_parameters()}
    raise NotImplementedError(
        f"--method {method}: its parameter groups are not ported to "
        "swat_tpu_torch yet (see ROADMAP, Queue A item 6); run it with "
        "swat_tpu")


def build_optimizer(groups: Dict[str, List[torch.Tensor]], *,
                    lr_classifier: float, lr_backbone: float,
                    total_iter: int, wd: float = 1e-2,
                    optim_type: str = "AdamW") -> torch.optim.AdamW:
    """AdamW over the labeled groups {'backbone': [...], 'head': [...]}
    (empty groups are left out); each param group carries its
    ``schedule``, applied by ``set_lr`` before every step."""
    if optim_type != "AdamW":
        raise NotImplementedError(
            f"--optim {optim_type} is not ported to swat_tpu_torch yet (see "
            "ROADMAP, Queue A item 6); run it with swat_tpu")
    warmup_lr = default_warmup_lr(lr_backbone)
    base = {"backbone": lr_backbone, "head": lr_classifier}
    param_groups = []
    for label in ("backbone", "head"):
        if groups.get(label):
            schedule = make_lr_schedule(base[label], total_iter,
                                        warmup_lr=warmup_lr)
            param_groups.append({"params": groups[label], "label": label,
                                 "schedule": schedule, "lr": schedule(0)})
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
