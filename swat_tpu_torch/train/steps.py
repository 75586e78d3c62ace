"""Train steps of the finetune and single-loader mixing families and of
linear probing (counterpart of ``swat_tpu/train/steps.py:48-222,312-400``).

One step: on-device augmentation (random-resized-crop / flip / normalize
from uint8 canvases, when the batch carries them), the method's mix, the
image tower forward and backward through the attention kernels, the mixed
cross-entropy, and one AdamW update.  The per-step body is split as in the
JAX package: ``make_mix_fn`` (augment + mix) and ``make_encode_loss``
(encode + loss), shared by the streaming steps here and the resident epoch
(``train/resident.py``).

Every random quantity comes in as explicit draws (``StepDraws``), made on
the host by ``make_sampler`` from a ``numpy.random.Generator``; tests feed
the JAX package's own draws instead.  Ported: ``finetune``, the
single-loader mixes (``MIX_METHODS``) and ``probing``
(``make_probing_step``: the head alone on pre-extracted or freshly encoded
features); the twin-loader mixes (mixup-fs, cutmix-fs, CMO,
finetune-mixed) raise (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch

from swat_tpu_torch.kernels import augment as aug
from swat_tpu_torch.kernels.flash_attention import mha_qkv
from swat_tpu_torch.models.clip import Attention
from swat_tpu_torch.models.head import head_logits
from swat_tpu_torch.train.losses import (LossFn, cross_entropy,
                                         mixup_criterion,
                                         mixup_criterion_lam_vector)
from swat_tpu_torch.train.state import TrainState

MIX_METHODS = ("finetune", "cutmix", "mixup", "resizemix", "saliencymix",
               "attentivemix")
# the methods whose epochs can run from device-resident canvases
# (``swat_tpu``'s scan_loop.SCAN_METHODS; attentivemix streams there too)
RESIDENT_METHODS = ("finetune", "cutmix", "mixup", "resizemix",
                    "saliencymix")
# every method whose step is ported
STEP_METHODS = MIX_METHODS + ("probing",)

MixDraws = Union[aug.CutmixDraws, aug.MixupDraws, aug.ResizemixDraws,
                 aug.PeakMixDraws]
# (model, images [B, H, W, 3], labels [B]) -> heatmaps [B, gh, gw]
HeatmapFn = Callable[..., torch.Tensor]


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one step: crop boxes and flips (for canvas
    batches), and the method's mix draws."""
    crops: Optional[aug.CropDraws] = None
    mix: Optional[MixDraws] = None


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to swat_tpu_torch yet (see ROADMAP, Queue A "
        "item 6); run it with swat_tpu")


def _check_method(method: str) -> None:
    if method not in MIX_METHODS:
        raise _not_ported(f"--method {method} training")


def make_sampler(method: str, *, mixup_alpha: float = 1.0,
                 cutmix_beta: float = 1.0, mix_prob: float = 0.5,
                 image_size: int = 224):
    """sample(rng, batch) -> StepDraws for a batch whose ``valid_hw`` (if
    it carries canvases) is a host array.  Draw order: crops, flips, mix
    (probing draws no mix)."""
    if method != "probing":
        _check_method(method)

    def sample(rng: np.random.Generator, batch: Mapping) -> StepDraws:
        crops = None
        if "canvases" in batch:
            valid_hw = np.asarray(batch["valid_hw"])
            crops = aug.CropDraws(aug.sample_crops(rng, valid_hw),
                                  aug.sample_flips(rng, len(valid_hw)))
        mix = None
        n = len(batch["labels"])
        if method == "cutmix":
            mix = aug.sample_cutmix(rng, n, image_size, image_size,
                                    cutmix_beta, mix_prob)
        elif method == "mixup":
            mix = aug.sample_mixup(rng, n, mixup_alpha, mix_prob)
        elif method == "resizemix":
            mix = aug.sample_resizemix(rng, n, image_size, image_size,
                                       mix_prob)
        elif method in ("saliencymix", "attentivemix"):
            mix = aug.sample_peak_mix(rng, n, cutmix_beta, mix_prob)
        return StepDraws(crops, mix)

    return sample


def make_mix_fn(method: str, *, heatmap_fn: Optional[HeatmapFn] = None,
                image_size: int = 224,
                aug_dtype: torch.dtype = torch.float32):
    """THE augment + mix half of a step, shared by the streaming steps and
    the resident epoch.  mix(state, batch, draws) -> (images, y_a, y_b,
    lam, lam_vec, source), batch tensors on the device; ``lam`` is the
    batch's one lambda and ``lam_vec`` None, or the reverse for the
    per-image lambdas of saliencymix and attentivemix.  ``aug_dtype`` is
    the resample's type: fp32 for the streaming steps, the compute dtype in
    the resident epoch (as the JAX package picks it).  ``heatmap_fn`` is
    attentivemix's; no gradient flows into it."""
    _check_method(method)
    if method == "attentivemix" and heatmap_fn is None:
        raise ValueError("attentivemix needs a heatmap_fn")

    def mix(state: TrainState, batch, draws: StepDraws):
        if "canvases" in batch:
            images = aug.train_augment(batch["canvases"], draws.crops,
                                       image_size, aug_dtype)
        else:
            images = batch["images"]
        labels, source = batch["labels"], batch["source"]
        lam, lam_vec = None, None
        if method == "finetune":
            y_a = y_b = labels
            lam = 1.0
        elif method == "cutmix":
            images, y_a, y_b, lam = aug.cutmix(images, labels, draws.mix)
        elif method == "mixup":
            images, y_a, y_b, lam = aug.mixup(images, labels, draws.mix)
        elif method == "resizemix":
            images, y_a, y_b, lam = aug.resizemix(images, labels, draws.mix)
        elif method == "saliencymix":
            images, y_a, y_b, lam_vec = aug.saliencymix(images, labels,
                                                        draws.mix)
        else:
            # the reference's heatmap model is a separate frozen model: no
            # gradient flows from the mixing loss into the heatmap network.
            # With the gate off the mix is the identity and needs no heatmap
            heatmaps = None
            if draws.mix.gate:
                with torch.no_grad():
                    heatmaps = heatmap_fn(state.model, images, labels)
            images, y_a, y_b, lam_vec = aug.attentivemix(
                images, labels, heatmaps, draws.mix)
        return images, y_a, y_b, lam, lam_vec, source

    return mix


def mix_criterion(loss: LossFn, logits, y_a, y_b, lam, lam_vec, source):
    """The scalar-lambda or the per-image-lambda mixing criterion (shared
    by the streaming and the resident paths)."""
    if lam_vec is not None:
        return mixup_criterion_lam_vector(logits, y_a, y_b, lam_vec)
    return mixup_criterion(loss, logits, y_a, y_b, lam, source)


def make_encode_loss(loss: LossFn, attention: Attention = mha_qkv,
                     use_mega: bool = False):
    """encode_loss(state, mixed) -> scalar loss: the normalized image
    features, head logits scaled by exp(logit_scale), the mixed
    criterion.  ``attention`` is the towers' (the kernels by default);
    ``use_mega`` encodes through the block-fused layer kernels instead."""

    def encode_loss(state: TrainState, mixed):
        images, y_a, y_b, lam, lam_vec, source = mixed
        feats = state.model.encode_image(images, normalize=True,
                                         attention=attention,
                                         use_mega=use_mega)
        logits = head_logits(state.head, feats) * torch.exp(state.logit_scale)
        return mix_criterion(loss, logits, y_a, y_b, lam, lam_vec, source)

    return encode_loss


def batch_to_device(batch: Mapping, device: torch.device) -> dict:
    """The arrays a step reads, as tensors on ``device`` (labels as int64);
    tensors already there pass through."""
    out = {}
    for key in ("canvases", "images", "features", "labels", "source"):
        if key in batch:
            t = torch.as_tensor(batch[key])
            out[key] = t.to(device, torch.long if key == "labels" else None,
                            non_blocking=True)
    return out


def _make_step(loss: LossFn, mix, attention: Attention,
               use_mega: bool) -> Callable:
    encode_loss = make_encode_loss(loss, attention, use_mega)

    def step(state: TrainState, batch, draws: StepDraws) -> torch.Tensor:
        """One update of ``state`` in place -> the step's loss (a 0-d
        tensor on the device, not synchronized)."""
        batch = batch_to_device(batch, state.head.device)
        val = encode_loss(state, mix(state, batch, draws))
        state.optimizer.zero_grad(set_to_none=True)
        val.backward()
        state.apply_update()
        return val.detach()

    return step


def make_ce_step(loss: LossFn = cross_entropy, image_size: int = 224,
                 aug_dtype: torch.dtype = torch.float32,
                 attention: Attention = mha_qkv, use_mega: bool = False):
    """Standard finetune CE (reference train_ce, utils/training.py:296-412)."""
    return _make_step(loss, make_mix_fn("finetune", image_size=image_size,
                                        aug_dtype=aug_dtype), attention,
                      use_mega)


def make_mixing_step(method: str, loss: LossFn = cross_entropy, *,
                     heatmap_fn: Optional[HeatmapFn] = None,
                     image_size: int = 224,
                     aug_dtype: torch.dtype = torch.float32,
                     attention: Attention = mha_qkv, use_mega: bool = False):
    """One factory for the single-loader mixing family (``use_mega``: the
    image tower through the block-fused layer kernels):

    cutmix       reference train_cutmix        utils/training.py:1422-1556
    mixup        reference train_mixup         :1164-1278
    resizemix    reference train_resizemix     :2309-2455
    saliencymix  reference train_saliencymix2  :2169-2306 (per-image
                 lambdas, summed loss)
    attentivemix reference train_attentivemix2 :2672-2831 (model heatmap)
    """
    if method == "finetune":
        raise ValueError("finetune is make_ce_step")
    return _make_step(loss, make_mix_fn(method, heatmap_fn=heatmap_fn,
                                        image_size=image_size,
                                        aug_dtype=aug_dtype), attention,
                      use_mega)


def make_probing_step(loss: LossFn = cross_entropy,
                      pre_extracted: bool = True, image_size: int = 224,
                      attention: Attention = mha_qkv):
    """Linear probe (reference train_probing, utils/training.py:47-161;
    ``swat_tpu.train.steps.make_probing_step``): the model frozen, CE of
    the head's logits at the state's fixed logit_scale.  Pre-extracted
    batches carry 'features'; otherwise (the parser's default,
    pre_extracted=False) each step augments the batch's canvases on the
    device (or takes its host-augmented images) and encodes them without
    a graph, through the attention kernels on the card."""

    def step(state: TrainState, batch, draws: StepDraws) -> torch.Tensor:
        batch = batch_to_device(batch, state.head.device)
        if pre_extracted:
            feats = batch["features"]
        else:
            if "canvases" in batch:
                images = aug.train_augment(batch["canvases"], draws.crops,
                                           image_size)
            else:
                images = batch["images"]
            with torch.no_grad():
                feats = state.model.encode_image(images, normalize=True,
                                                 attention=attention)
        logits = head_logits(state.head, feats) * torch.exp(state.logit_scale)
        val = loss(logits, batch["labels"], batch["source"])
        state.optimizer.zero_grad(set_to_none=True)
        val.backward()
        state.apply_update()
        return val.detach()

    return step
