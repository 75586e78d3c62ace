"""Train state (counterpart of ``swat_tpu/train/state.py:29-123``).

The trainable set is the CLIP model, the classifier head and logit_scale
(and finetune-multitask's binary dataset head, ``swat_tpu``'s
``head['dataset']``); the state also holds the optimizer over them (AdamW
or SGD) and the step count.
The JAX package keeps these as one immutable pytree; here the model is
trained in place, and the head and logit_scale are the state's own
parameters.  Frozen tensors have ``requires_grad`` off and sit in no
optimizer group; so do the RN50 tower's BatchNorm running statistics,
which are buffers, not parameters (``swat_tpu`` labels them ``frozen``,
``swat_tpu/train/optim.py:105-113``).  A train-mode encode leaves the
batch's statistics on the state (``bn_updates``), and the optimizer update
folds them into the running ones, as ``swat_tpu``'s ``_fold_bn`` folds its
sown values after ``_apply_update``.

Under a data-parallel mesh (``mesh``) the update first sums the gradients
over the data group (``core.mesh.Mesh.sync_grads``): the towers' are
partial sums over each rank's rows; the head's and logit_scale's are whole
on every rank and are not summed.  The model is not wrapped in
``DistributedDataParallel``, so its state dict keeps its names (the
bundles and ``cli.convert`` read them), the frozen tensors stay out of the
sum as they stay out of the groups, and ``--accum`` needs no ``no_sync``:
the sum runs once an update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from swat_tpu_torch.core.mesh import Mesh, active
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.resnet import BNUpdates, fold_bn_updates
from swat_tpu_torch.train.optim import (build_optimizer, label_params,
                                        set_lr, trains_logit_scale)

LOG100 = 4.60517  # ln(100), fixed logit_scale for frozen methods


@dataclasses.dataclass
class TrainState:
    model: CLIPModel
    head: nn.Parameter            # [num_classes, embed_dim] fp32
    logit_scale: nn.Parameter     # scalar, the log of the scale
    optimizer: torch.optim.Optimizer
    step: int = 0
    # finetune-multitask's [2, embed_dim] dataset-source head, else None
    dataset_head: Optional[nn.Parameter] = None
    # the last train-mode encode's BatchNorm batch statistics (the RN50
    # tower's; empty for a ViT), folded by the next update
    bn_updates: Optional[BNUpdates] = None
    # the data-parallel mesh the steps run on, or None for one device
    mesh: Optional[Mesh] = None

    def apply_update(self) -> None:
        """One optimizer step with this count's learning rates, the
        pending BatchNorm statistics folded, then the count moves on (the
        gradients are already in .grad; under a mesh they are summed over
        the data group first)."""
        mesh = active(self.mesh)
        if mesh is not None:
            # the towers' parameters only: the head, dataset head and
            # logit_scale act on the gathered features, so every rank
            # holds their whole gradient already
            mesh.sync_grads(p for p in self.model.parameters()
                            if p.requires_grad)
        set_lr(self.optimizer, self.step)
        self.optimizer.step()
        if self.bn_updates:
            fold_bn_updates(self.bn_updates)
        self.bn_updates = None
        self.step += 1


def init_logit_scale(method: str, temperature: float = 0.07) -> float:
    """ln(1/temperature) for finetune methods, fixed ln(100) for frozen
    ones (reference utils/optimizers.py:51-59,80)."""
    if trains_logit_scale(method):
        return float(np.log(1.0 / temperature))
    return LOG100


def make_labels(model: CLIPModel, method: str,
                locked_text: bool = False) -> dict:
    """Labels of the trainable set: {'model': {name: label}, 'head':
    'head' | 'frozen', 'logit_scale': 'head' | 'frozen'}.  FLYP's head is
    rebuilt from the text tower (``stages._flyp_post_epoch``), not
    trained: it is in no optimizer group, so AdamW does not decay it with
    zero gradients (the reference's optimizer holds no head there,
    utils/optimizers.py:83-120).  fixmatch's loss never reads logit_scale,
    so it stays out of the optimizer (no phantom decay) too, as in the JAX
    package."""
    trains = trains_logit_scale(method) and method != "fixmatch"
    return {"model": label_params(model, method, locked_text),
            "head": "frozen" if method == "FLYP" else "head",
            "logit_scale": "head" if trains else "frozen"}


def create_train_state(model: CLIPModel, head: torch.Tensor, method: str, *,
                       lr_classifier: float = 1e-4,
                       lr_backbone: float = 1e-6,
                       total_iter: int = 1000, wd: float = 1e-2,
                       optim_type: str = "AdamW",
                       lr_projector: Optional[float] = None,
                       temperature: float = 0.07,
                       locked_text: bool = False,
                       dataset_head: Optional[torch.Tensor] = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """Marks the model's frozen tensors (``requires_grad`` off), copies the
    head (and ``dataset_head``, finetune-multitask's, trained in the head
    group) and makes logit_scale on the model's device, and builds the
    optimizer (``optim_type``: AdamW or SGD) over the labeled groups.  A
    model in the int8 layout (``CLIPModel.int8_``) is refused, as
    ``swat_tpu`` refuses a quantized tree."""
    if model.is_int8:
        raise ValueError(
            "refusing to train on an int8-quantized model: gradients "
            "through the rounding are zero (models/quant.py is "
            "inference-only; keep the fp32 weights for training)")
    labels = make_labels(model, method, locked_text)
    groups = {"backbone": [], "projector": [], "head": []}
    for name, p in model.named_parameters():
        label = labels["model"][name]
        p.requires_grad_(label != "frozen")
        if label != "frozen":
            groups[label].append(p)
    device = model.logit_scale.device

    def own(t, trains):
        return nn.Parameter(torch.as_tensor(t).detach().to(
            device=device, dtype=torch.float32).clone(), requires_grad=trains)

    head_p = own(head, labels["head"] == "head")
    dataset_p = (None if dataset_head is None
                 else own(dataset_head, labels["head"] == "head"))
    scale_p = own(init_logit_scale(method, temperature),
                  labels["logit_scale"] == "head")
    for p in (head_p, dataset_p, scale_p):
        if p is not None and p.requires_grad:
            groups["head"].append(p)
    optimizer = build_optimizer(groups, lr_classifier=lr_classifier,
                                lr_backbone=lr_backbone,
                                total_iter=total_iter, wd=wd,
                                optim_type=optim_type,
                                lr_projector=lr_projector)
    return TrainState(model, head_p, scale_p, optimizer,
                      dataset_head=dataset_p, mesh=mesh)
