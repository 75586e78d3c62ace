"""Train steps of the finetune family (counterpart of
``swat_tpu/train/steps.py:48-153,312-400``).

One step: on-device augmentation (random-resized-crop / flip / normalize
from uint8 canvases, when the batch carries them), the method's mix, the
image tower forward and backward through the attention kernels, the mixed
cross-entropy, and one AdamW update.  The per-step body is split as in the
JAX package: ``make_mix_fn`` (augment + mix) and ``make_encode_loss``
(encode + loss), shared by the streaming steps here and the resident epoch
(``train/resident.py``).

Every random quantity comes in as explicit draws (``StepDraws``), made on
the host by ``make_sampler`` from a ``numpy.random.Generator``; tests feed
the JAX package's own draws instead.  Only ``finetune`` and ``cutmix`` are
ported; the other mixes raise (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from swat_tpu_torch.kernels import augment as aug
from swat_tpu_torch.kernels.flash_attention import mha_qkv
from swat_tpu_torch.models.clip import Attention
from swat_tpu_torch.models.head import head_logits
from swat_tpu_torch.train.losses import LossFn, cross_entropy, mixup_criterion
from swat_tpu_torch.train.state import TrainState

MIX_METHODS = ("finetune", "cutmix")


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one step: crop boxes and flips (for canvas
    batches), and the cutmix draws (for cutmix)."""
    crops: Optional[aug.CropDraws] = None
    mix: Optional[aug.CutmixDraws] = None


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to swat_tpu_torch yet (see ROADMAP, Queue A "
        "item 6); run it with swat_tpu")


def _check_method(method: str) -> None:
    if method not in MIX_METHODS:
        raise _not_ported(f"--method {method} training")


def make_sampler(method: str, *, cutmix_beta: float = 1.0,
                 mix_prob: float = 0.5, image_size: int = 224):
    """sample(rng, batch) -> StepDraws for a batch whose ``valid_hw`` (if
    it carries canvases) is a host array.  Draw order: crops, flips, mix."""
    _check_method(method)

    def sample(rng: np.random.Generator, batch: Mapping) -> StepDraws:
        crops = None
        if "canvases" in batch:
            valid_hw = np.asarray(batch["valid_hw"])
            crops = aug.CropDraws(aug.sample_crops(rng, valid_hw),
                                  aug.sample_flips(rng, len(valid_hw)))
        mix = None
        if method == "cutmix":
            mix = aug.sample_cutmix(rng, len(batch["labels"]), image_size,
                                    image_size, cutmix_beta, mix_prob)
        return StepDraws(crops, mix)

    return sample


def make_mix_fn(method: str, *, image_size: int = 224,
                aug_dtype: torch.dtype = torch.float32):
    """THE augment + mix half of a step, shared by the streaming steps and
    the resident epoch.  mix(batch, draws) -> (images, y_a, y_b, lam,
    source), batch tensors on the device.  ``aug_dtype`` is the resample's
    type: fp32 for the streaming steps, the compute dtype in the resident
    epoch (as the JAX package picks it)."""
    _check_method(method)

    def mix(batch, draws: StepDraws):
        if "canvases" in batch:
            images = aug.train_augment(batch["canvases"], draws.crops,
                                       image_size, aug_dtype)
        else:
            images = batch["images"]
        labels, source = batch["labels"], batch["source"]
        if method == "finetune":
            return images, labels, labels, 1.0, source
        images, y_a, y_b, lam = aug.cutmix(images, labels, draws.mix)
        return images, y_a, y_b, lam, source

    return mix


def make_encode_loss(loss: LossFn, attention: Attention = mha_qkv):
    """encode_loss(state, mixed) -> scalar loss: the normalized image
    features, head logits scaled by exp(logit_scale), the mixed
    criterion.  ``attention`` is the towers' (the kernels by default)."""

    def encode_loss(state: TrainState, mixed):
        images, y_a, y_b, lam, source = mixed
        feats = state.model.encode_image(images, normalize=True,
                                         attention=attention)
        logits = head_logits(state.head, feats) * torch.exp(state.logit_scale)
        return mixup_criterion(loss, logits, y_a, y_b, lam, source)

    return encode_loss


def batch_to_device(batch: Mapping, device: torch.device) -> dict:
    """The arrays a step reads, as tensors on ``device`` (labels as int64);
    tensors already there pass through."""
    out = {}
    for key in ("canvases", "images", "labels", "source"):
        if key in batch:
            t = torch.as_tensor(batch[key])
            out[key] = t.to(device, torch.long if key == "labels" else None,
                            non_blocking=True)
    return out


def _make_step(loss: LossFn, mix, attention: Attention) -> Callable:
    encode_loss = make_encode_loss(loss, attention)

    def step(state: TrainState, batch, draws: StepDraws) -> torch.Tensor:
        """One update of ``state`` in place -> the step's loss (a 0-d
        tensor on the device, not synchronized)."""
        batch = batch_to_device(batch, state.head.device)
        val = encode_loss(state, mix(batch, draws))
        state.optimizer.zero_grad(set_to_none=True)
        val.backward()
        state.apply_update()
        return val.detach()

    return step


def make_ce_step(loss: LossFn = cross_entropy, image_size: int = 224,
                 aug_dtype: torch.dtype = torch.float32,
                 attention: Attention = mha_qkv):
    """Standard finetune CE (reference train_ce, utils/training.py:296-412)."""
    return _make_step(loss, make_mix_fn("finetune", image_size=image_size,
                                        aug_dtype=aug_dtype), attention)


def make_mixing_step(method: str, loss: LossFn = cross_entropy, *,
                     image_size: int = 224,
                     aug_dtype: torch.dtype = torch.float32,
                     attention: Attention = mha_qkv):
    """The mixing family; ported: cutmix (reference train_cutmix,
    utils/training.py:1422-1556)."""
    if method == "finetune":
        raise ValueError("finetune is make_ce_step")
    return _make_step(loss, make_mix_fn(method, image_size=image_size,
                                        aug_dtype=aug_dtype), attention)
