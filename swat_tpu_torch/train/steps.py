"""Train steps of the finetune and mixing families, of linear probing
(probing, REAL-Linear), cross-modal probing (CMLP), FLYP, finetune-multitask,
dataset-cls and FixMatch (counterpart of
``swat_tpu/train/steps.py:48-251,254-552``).

One step: on-device augmentation (random-resized-crop / flip / normalize
from uint8 canvases, when the batch carries them), the method's mix, the
image tower forward and backward through the attention kernels, the mixed
cross-entropy, and one optimizer update.  The per-step body is split as in
the JAX package: ``make_mix_fn`` (augment + mix) and ``make_encode_loss``
(encode + loss), shared by the streaming steps here and the resident epoch
(``train/resident.py``).  The phases are profiler spans
(``utils.profiling.span``): ``train.augment``, ``train.forward``,
``train.backward``, ``train.optimizer``; the steps whose loss augments
its own batch (the probes, FLYP, multitask, dataset-cls, FixMatch) run
their augment inside ``train.forward``.

Every random quantity comes in as explicit draws (``StepDraws``), made on
the host by ``make_sampler`` from a ``numpy.random.Generator``; tests feed
the JAX package's own draws instead.  Ported: ``finetune``, the
single-loader mixes, the twin-loader methods (``TWIN_METHODS``: the second
loader's batch rides in the batch under ``_fs`` keys), ``probing`` and
REAL-Linear (``make_probing_step``: the head alone on pre-extracted or
freshly encoded features), CMLP (``make_cmlp_step``: the same with a batch
of prompt embeddings joined to the image features) and FLYP
(``make_flyp_step``: both towers trained by the batch's [B, B] image-text
contrastive loss), finetune-multitask (``make_multitask_step``: a second,
binary head scored against the batch's source flag), dataset-cls
(``make_dataset_cls_step``: the source flag as the label) and FixMatch
(``make_fixmatch_step``: a weak and a RandAugment-strong view of an
unlabeled batch, ``FixmatchDraws``).  ``accum > 1`` mixes the whole batch,
then encodes and differentiates it in that many microbatches, summing their
gradients; on RN50 it raises (``check_accum``: batch-statistics BN does not
decompose over microbatches).  Every step that trains the image tower
encodes in train mode (``encode_train``): RN50's BatchNorm normalizes with
the batch's statistics and the update writes the new running statistics
(``TrainState.apply_update``), FixMatch's three views as one BN batch; the
frozen probes encode with the running ones.

Under a data-parallel mesh (the state's ``mesh``) a step takes the global
batch, as one device does, draws included: the towers encode this rank's
rows of it alone and gather the features (``core.mesh.on_rows``), so the
mixes, the [B, B] FLYP logits, FixMatch's mask and every loss are those of
the global batch on every rank; RN50's BatchNorm all-reduces its sums; the
update sums the towers' gradients over the data group
(``TrainState.apply_update``).  ``--accum`` cuts the global batch into
microbatches, each encoded in its ranks' rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch

from swat_tpu_torch.core.mesh import Mesh, active, on_rows
from swat_tpu_torch.kernels import augment as aug
from swat_tpu_torch.kernels.flash_attention import mha_qkv
from swat_tpu_torch.kernels.randaugment import (RandAugmentDraws,
                                                rand_augment,
                                                sample_rand_augment)
from swat_tpu_torch.models.clip import Attention
from swat_tpu_torch.models.configs import ResNetConfig
from swat_tpu_torch.models.head import head_logits
from swat_tpu_torch.models.resnet import BNUpdates
from swat_tpu_torch.train.losses import (LossFn, cross_entropy,
                                         mixup_criterion,
                                         mixup_criterion_lam_vector)
from swat_tpu_torch.train.state import TrainState
from swat_tpu_torch.utils.profiling import span

MIX_METHODS = ("finetune", "cutmix", "mixup", "resizemix", "saliencymix",
               "attentivemix")
# the methods that take a second loader's batch (the *_fs keys)
TWIN_METHODS = ("finetune-mixed", "cutmix-fs", "mixup-fs", "CMO")
# the methods whose epochs can run from device-resident canvases
# (``swat_tpu``'s scan_loop.SCAN_METHODS | SCAN_TWIN_METHODS; attentivemix
# streams there too)
RESIDENT_METHODS = ("finetune", "cutmix", "mixup", "resizemix",
                    "saliencymix") + TWIN_METHODS
# the methods whose gradient decomposes over microbatches (--accum)
ACCUM_METHODS = MIX_METHODS + TWIN_METHODS
# the methods that train the head alone on frozen towers
FROZEN_STEP_METHODS = ("probing", "REAL-Linear", "CMLP")
# the methods whose step augments its batch and draws nothing else
CROP_ONLY_METHODS = FROZEN_STEP_METHODS + ("FLYP", "finetune-multitask",
                                          "dataset-cls")
# every method whose step is ported
STEP_METHODS = ACCUM_METHODS + CROP_ONLY_METHODS + ("fixmatch",)

MixDraws = Union[aug.CutmixDraws, aug.CutmixFromDraws, aug.MixupDraws,
                 aug.MixupFsDraws, aug.ResizemixDraws, aug.PeakMixDraws]
# (model, images [B, H, W, 3], labels [B]) -> heatmaps [B, gh, gw]
HeatmapFn = Callable[..., torch.Tensor]


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one step: crop boxes and flips (for canvas
    batches) of the batch and of its twin, and the method's mix draws."""
    crops: Optional[aug.CropDraws] = None
    mix: Optional[MixDraws] = None
    twin_crops: Optional[aug.CropDraws] = None


@dataclasses.dataclass
class FixmatchDraws:
    """The random inputs of one FixMatch step: the labeled batch's crops
    and flips (for canvas batches), those of the unlabeled canvases' weak
    and strong views, and the strong view's RandAugment draws."""
    crops: Optional[aug.CropDraws] = None
    weak: Optional[aug.CropDraws] = None
    strong: Optional[aug.CropDraws] = None
    rand_augment: Optional[RandAugmentDraws] = None


def _mesh_of(state) -> Optional[Mesh]:
    """The state's data-parallel mesh (None for a state that has none)."""
    return getattr(state, "mesh", None)


def _check_method(method: str) -> None:
    if method not in ACCUM_METHODS:
        raise ValueError(f"no train step for --method {method}")


def _sample_crops(rng: np.random.Generator, batch: Mapping,
                  suffix: str = "") -> Optional[aug.CropDraws]:
    if f"canvases{suffix}" not in batch:
        return None
    valid_hw = np.asarray(batch[f"valid_hw{suffix}"])
    return aug.CropDraws(aug.sample_crops(rng, valid_hw),
                         aug.sample_flips(rng, len(valid_hw)))


def make_sampler(method: str, *, mixup_alpha: float = 1.0,
                 cutmix_beta: float = 1.0, mix_prob: float = 0.5,
                 image_size: int = 224):
    """sample(rng, batch) -> StepDraws for a batch whose ``valid_hw`` (if
    it carries canvases) is a host array.  Draw order: crops, flips, the
    twin's crops and flips, mix (CROP_ONLY_METHODS draw no mix).
    cutmix-fs's permutation spans the batch and its twin joined.
    fixmatch's sampler is ``sample_fixmatch``."""
    if method == "fixmatch":
        return sample_fixmatch
    if method not in CROP_ONLY_METHODS:
        _check_method(method)

    def sample(rng: np.random.Generator, batch: Mapping) -> StepDraws:
        crops = _sample_crops(rng, batch)
        twin_crops = _sample_crops(rng, batch, "_fs")
        mix = None
        n = len(batch["labels"])
        if method == "cutmix-fs":
            n += len(batch["labels_fs"])
        if method in ("cutmix", "cutmix-fs"):
            mix = aug.sample_cutmix(rng, n, image_size, image_size,
                                    cutmix_beta, mix_prob)
        elif method == "CMO":
            mix = aug.sample_cutmix_from(rng, image_size, image_size,
                                         cutmix_beta, mix_prob)
        elif method == "mixup":
            mix = aug.sample_mixup(rng, n, mixup_alpha, mix_prob)
        elif method == "mixup-fs":
            mix = aug.sample_mixup_fs(rng, mix_prob)
        elif method == "resizemix":
            mix = aug.sample_resizemix(rng, n, image_size, image_size,
                                       mix_prob)
        elif method in ("saliencymix", "attentivemix"):
            mix = aug.sample_peak_mix(rng, n, cutmix_beta, mix_prob)
        return StepDraws(crops, mix, twin_crops)

    return sample


def sample_fixmatch(rng: np.random.Generator, batch: Mapping
                    ) -> FixmatchDraws:
    """FixMatch's draws for a batch (host ``valid_hw`` / ``valid_hw_u``):
    the labeled crops and flips, the unlabeled canvases' weak crops and
    flips, their strong crops and flips, then the strong view's
    RandAugment(2, 10) draws; none for the parts that carry images."""
    crops = _sample_crops(rng, batch)
    weak = _sample_crops(rng, batch, "_u")
    strong = _sample_crops(rng, batch, "_u")
    ra = (sample_rand_augment(rng, len(batch["valid_hw_u"]))
          if "canvases_u" in batch else None)
    return FixmatchDraws(crops, weak, strong, ra)


def _twin_of(batch: Mapping) -> Optional[dict]:
    """The second loader's sub-batch, carried as *_fs keys (the
    reference's tuple of loaders flattened into one dict)."""
    twin = {k[:-3]: v for k, v in batch.items() if k.endswith("_fs")}
    return twin or None


def make_mix_fn(method: str, *, heatmap_fn: Optional[HeatmapFn] = None,
                image_size: int = 224,
                aug_dtype: torch.dtype = torch.float32):
    """THE augment + mix half of a step, shared by the streaming steps and
    the resident epoch.  mix(state, batch, draws) -> (images, y_a, y_b,
    lam, lam_vec, source), batch tensors on the device; ``lam`` is the
    batch's one lambda and ``lam_vec`` None, or the reverse for the
    per-image lambdas of saliencymix and attentivemix.  A twin method's
    batch carries its twin under *_fs keys: finetune-mixed and cutmix-fs
    join the two batches (primary first), CMO pastes its box from the twin,
    mixup-fs takes one of the two whole.  ``aug_dtype`` is the resample's
    type: fp32 for the streaming steps, the compute dtype in the resident
    epoch (as the JAX package picks it).  ``heatmap_fn`` is attentivemix's;
    no gradient flows into it."""
    _check_method(method)
    if method == "attentivemix" and heatmap_fn is None:
        raise ValueError("attentivemix needs a heatmap_fn")

    def images_of(batch, draws, crops="crops"):
        """The batch's augmented canvases (its draws' ``crops`` field) or
        its images; an image batch needs no draws."""
        if "canvases" in batch:
            return aug.train_augment(batch["canvases"],
                                     getattr(draws, crops), image_size,
                                     aug_dtype)
        return batch["images"]

    def mix(state: TrainState, batch, draws: StepDraws):
        images = images_of(batch, draws)
        labels, source = batch["labels"], batch["source"]
        twin = _twin_of(batch)
        if twin is not None:
            images2 = images_of(twin, draws, "twin_crops")
            labels2 = twin["labels"]
        if method in ("finetune-mixed", "cutmix-fs"):
            images = torch.cat([images, images2])
            labels = torch.cat([labels, labels2])
            source = torch.cat([source, twin["source"]])
        lam, lam_vec = None, None
        if method in ("finetune", "finetune-mixed"):
            y_a = y_b = labels
            lam = 1.0
        elif method in ("cutmix", "cutmix-fs"):
            images, y_a, y_b, lam = aug.cutmix(images, labels, draws.mix)
        elif method == "CMO":
            images, y_a, y_b, lam = aug.cutmix_from(images, labels, images2,
                                                    labels2, draws.mix)
        elif method == "mixup":
            images, y_a, y_b, lam = aug.mixup(images, labels, draws.mix)
        elif method == "mixup-fs":
            images, y_a, y_b, lam = aug.mixup_fs(images, labels, images2,
                                                 labels2, draws.mix)
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
                    heatmaps = on_rows(
                        _mesh_of(state),
                        lambda im, lb: heatmap_fn(state.model, im, lb),
                        images, labels)
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


def encode_train(state: TrainState, images: torch.Tensor,
                 attention: Attention = mha_qkv,
                 use_mega: bool = False) -> torch.Tensor:
    """The training-mode encode of a step (``swat_tpu``'s
    ``_encode_train``) -> normalized features.  The RN50 tower normalizes
    with batch statistics (the reference's model.train()), which wait on
    the state for the update to fold them into the running statistics
    (``TrainState.apply_update``); a ViT tower adds none.  Under a mesh
    this rank's rows are encoded and the features gathered."""
    mesh = _mesh_of(state)
    state.bn_updates = BNUpdates(active(mesh))
    return on_rows(mesh, lambda x: state.model.encode_image(
        x, normalize=True, attention=attention, use_mega=use_mega,
        updates=state.bn_updates), images)


def check_accum(model, accum: int) -> None:
    """``--accum > 1`` is ViT-only (``swat_tpu``'s ``_check_accum``)."""
    if accum > 1 and isinstance(model.cfg.vision, ResNetConfig):
        raise ValueError(
            "grad accumulation (accum>1) is ViT-only: RN50's batch-stat "
            "BN is not microbatch-decomposable")


def make_encode_loss(loss: LossFn, attention: Attention = mha_qkv,
                     use_mega: bool = False):
    """encode_loss(state, mixed) -> scalar loss: the normalized image
    features (``encode_train``), head logits scaled by exp(logit_scale),
    the mixed criterion.  ``attention`` is the towers' (the kernels by
    default); ``use_mega`` encodes through the block-fused layer kernels
    instead."""

    def encode_loss(state: TrainState, mixed):
        images, y_a, y_b, lam, lam_vec, source = mixed
        feats = encode_train(state, images, attention, use_mega)
        logits = head_logits(state.head, feats) * torch.exp(state.logit_scale)
        return mix_criterion(loss, logits, y_a, y_b, lam, lam_vec, source)

    return encode_loss


# the batch keys a step reads; the integer ones go to the device as int64
_STEP_KEYS = ("canvases", "images", "features", "labels", "source",
              "prompt_tokens", "text_features", "text_labels", "images_w",
              "images_s")
_LONG_KEYS = ("labels", "prompt_tokens", "text_labels")


def batch_to_device(batch: Mapping, device: torch.device) -> dict:
    """The arrays a step reads, the twin's *_fs keys and FixMatch's
    unlabeled *_u keys included, as tensors on ``device`` (labels and tokens
    as int64); tensors already there pass through."""
    out = {}
    for suffix in ("", "_fs", "_u"):
        for key in _STEP_KEYS:
            if key + suffix in batch:
                t = torch.as_tensor(batch[key + suffix])
                out[key + suffix] = t.to(
                    device, torch.long if key in _LONG_KEYS else None,
                    non_blocking=True)
    return out


def accum_backward(state: TrainState, encode_loss: Callable, mixed,
                   accum: int) -> torch.Tensor:
    """Gradient accumulation (``steps._accum_value_and_grad``): the mixed
    batch, already made whole, is encoded and differentiated in ``accum``
    equal microbatches in order; .grad sums their unscaled gradients.  The
    registry losses reduce by the mean, so the sum and the summed loss are
    scaled by 1/accum once at the end; the per-image-lambda criterion
    (saliencymix, attentivemix) sums, so nothing is scaled.  -> the
    step's loss, summed in fp32 from 0.  RN50 raises (``check_accum``)."""
    check_accum(state.model, accum)
    images, y_a, y_b, lam, lam_vec, source = mixed
    n = images.shape[0]
    if n % accum:
        raise ValueError(
            f"batch size {n} is not divisible by accum={accum}")
    per_sample = [images, y_a, y_b, source]
    if lam_vec is not None:
        per_sample.append(lam_vec)
    chunks = [t.chunk(accum) for t in per_sample]
    val_sum = torch.zeros((), dtype=torch.float32, device=images.device)
    for i in range(accum):
        mb = [c[i] for c in chunks]
        with span("train.forward"):
            val = encode_loss(state, (mb[0], mb[1], mb[2], lam,
                                      mb[4] if lam_vec is not None else None,
                                      mb[3]))
        with span("train.backward"):
            val.backward()
        val_sum = val_sum + val.detach()
    if lam_vec is not None:
        return val_sum
    inv = 1.0 / accum
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is not None:
                p.grad.mul_(inv)
    return val_sum * inv


def _make_step(loss: LossFn, mix, attention: Attention, use_mega: bool,
               accum: int = 1) -> Callable:
    if accum < 1:
        raise ValueError(f"accum must be >= 1; got {accum}")
    encode_loss = make_encode_loss(loss, attention, use_mega)

    def step(state: TrainState, batch, draws: StepDraws) -> torch.Tensor:
        """One update of ``state`` in place -> the step's loss (a 0-d
        tensor on the device, not synchronized).  Its phases are the spans
        ``train.augment`` (augment + mix), ``train.forward``,
        ``train.backward`` (a pair a microbatch under ``accum``) and
        ``train.optimizer``; zero_grad stays ahead of the augment, so the
        last step's gradients are freed before this one allocates."""
        batch = batch_to_device(batch, state.head.device)
        state.optimizer.zero_grad(set_to_none=True)
        if accum > 1:
            # the whole batch is mixed outside the gradient: the pairing
            # permutation spans the batch, and no gradient flows through
            # the mix (attentivemix's heatmaps are taken without one)
            with span("train.augment"), torch.no_grad():
                mixed = mix(state, batch, draws)
            val = accum_backward(state, encode_loss, mixed, accum)
        else:
            with span("train.augment"):
                mixed = mix(state, batch, draws)
            with span("train.forward"):
                val = encode_loss(state, mixed)
            # the mixed batch lives on in the graph alone, freed with it
            del mixed
            with span("train.backward"):
                val.backward()
        with span("train.optimizer"):
            state.apply_update()
        return val.detach()

    return step


def make_ce_step(loss: LossFn = cross_entropy, image_size: int = 224,
                 aug_dtype: torch.dtype = torch.float32,
                 attention: Attention = mha_qkv, use_mega: bool = False,
                 concat_fs: bool = False, accum: int = 1):
    """Standard finetune CE (reference train_ce, utils/training.py:296-412);
    ``concat_fs``: the few-shot twin batch joined after the batch
    (reference train_ce_mixed, :692-816, ``--method finetune-mixed``).
    ``accum``: microbatches a step."""
    return _make_step(loss, make_mix_fn(
        "finetune-mixed" if concat_fs else "finetune",
        image_size=image_size, aug_dtype=aug_dtype), attention, use_mega,
        accum)


def make_mixing_step(method: str, loss: LossFn = cross_entropy, *,
                     heatmap_fn: Optional[HeatmapFn] = None,
                     image_size: int = 224,
                     aug_dtype: torch.dtype = torch.float32,
                     attention: Attention = mha_qkv, use_mega: bool = False,
                     accum: int = 1):
    """One factory for the mixing family (``use_mega``: the image tower
    through the block-fused layer kernels; ``accum``: microbatches a
    step, the mix made on the whole batch first):

    cutmix       reference train_cutmix        utils/training.py:1422-1556
    cutmix-fs    reference train_cutmix_fs2    :1701-1862 (the few-shot
                 twin joined, then cutmix over the joined batch)
    mixup        reference train_mixup         :1164-1278
    mixup-fs     reference train_mixup_fs      :1281-1401
    resizemix    reference train_resizemix     :2309-2455
    saliencymix  reference train_saliencymix2  :2169-2306 (per-image
                 lambdas, summed loss)
    attentivemix reference train_attentivemix2 :2672-2831 (model heatmap)
    CMO          reference train_CMO           :1865-2005 (the box from an
                 inverse-frequency twin batch)
    """
    if method in ("finetune", "finetune-mixed"):
        raise ValueError(f"{method} is make_ce_step")
    return _make_step(loss, make_mix_fn(method, heatmap_fn=heatmap_fn,
                                        image_size=image_size,
                                        aug_dtype=aug_dtype), attention,
                      use_mega, accum)


def _train_images(batch, draws: StepDraws, image_size: int):
    """The batch's canvases augmented on the device with its crop draws,
    or its host-augmented images."""
    if "canvases" in batch:
        return aug.train_augment(batch["canvases"], draws.crops, image_size)
    return batch["images"]


def _frozen_features(state: TrainState, batch, draws: StepDraws,
                     pre_extracted: bool, image_size: int,
                     attention: Attention) -> torch.Tensor:
    """The frozen image tower's normalized features of a batch: its
    pre-extracted 'features', or its images encoded without a graph."""
    if pre_extracted:
        return batch["features"]
    with torch.no_grad():
        return on_rows(_mesh_of(state), lambda x: state.model.encode_image(
            x, normalize=True, attention=attention),
            _train_images(batch, draws, image_size))


def _update(state: TrainState, val: torch.Tensor) -> torch.Tensor:
    """Backward of the step's loss, one optimizer update -> the loss; the
    spans ``train.backward`` and ``train.optimizer``."""
    state.optimizer.zero_grad(set_to_none=True)
    with span("train.backward"):
        val.backward()
    with span("train.optimizer"):
        state.apply_update()
    return val.detach()


def _loss_step(step_loss: Callable) -> Callable:
    """A step of ``step_loss(state, batch, draws)``: the batch to the
    device, the loss (a ``train.forward`` span, the augment inside it), its
    backward, one update -> the loss."""

    def step(state: TrainState, batch, draws) -> torch.Tensor:
        batch = batch_to_device(batch, state.head.device)
        with span("train.forward"):
            val = step_loss(state, batch, draws)
        return _update(state, val)

    return step


def make_probing_step(loss: LossFn = cross_entropy,
                      pre_extracted: bool = True, image_size: int = 224,
                      attention: Attention = mha_qkv):
    """Linear probe (reference train_probing, utils/training.py:47-161;
    ``swat_tpu.train.steps.make_probing_step``; REAL-Linear trains through
    it too): the model frozen, CE of the head's logits at the state's fixed
    logit_scale.  Pre-extracted batches carry 'features'; otherwise (the
    parser's default, pre_extracted=False) each step augments the batch's
    canvases on the device (or takes its host-augmented images) and
    encodes them without a graph, through the attention kernels on the
    card."""

    def step(state: TrainState, batch, draws: StepDraws) -> torch.Tensor:
        batch = batch_to_device(batch, state.head.device)
        with span("train.forward"):
            feats = _frozen_features(state, batch, draws, pre_extracted,
                                     image_size, attention)
            logits = (head_logits(state.head, feats)
                      * torch.exp(state.logit_scale))
            val = loss(logits, batch["labels"], batch["source"])
        return _update(state, val)

    return step


def make_cmlp_step(loss: LossFn = cross_entropy,
                   pre_extracted: bool = True, image_size: int = 224,
                   attention: Attention = mha_qkv):
    """Cross-modal linear probe (reference train_CMLP,
    utils/training.py:164-293; ``swat_tpu.train.steps.make_cmlp_step``):
    the probe's image features, as ``make_probing_step`` makes them, joined
    by the batch's 'text_features' (prompt embeddings) and their
    'text_labels'; the loss takes no source flag (the text rows have
    none)."""

    def step(state: TrainState, batch, draws: StepDraws) -> torch.Tensor:
        batch = batch_to_device(batch, state.head.device)
        with span("train.forward"):
            feats = torch.cat([_frozen_features(state, batch, draws,
                                                pre_extracted, image_size,
                                                attention),
                               batch["text_features"]])
            labels = torch.cat([batch["labels"], batch["text_labels"]])
            logits = (head_logits(state.head, feats)
                      * torch.exp(state.logit_scale))
            val = loss(logits, labels, None)
        return _update(state, val)

    return step


def make_flyp_loss(loss: LossFn = cross_entropy, image_size: int = 224,
                   attention: Attention = mha_qkv):
    """flyp_loss(state, batch, draws) -> FLYP's loss on a batch already on
    the device (reference train_flyp, utils/training.py:415-552;
    ``swat_tpu.train.steps.make_flyp_step``'s loss): the batch's augmented
    images through the image tower and its 'prompt_tokens' (one prompt of
    each sample's class) through the text tower, causal, both with a graph
    and through the attention kernels; logits exp(logit_scale) * img .
    txt^T in fp32 (no TF32, the JAX package's precision="highest"); the
    mean of the image->text and text->image losses against the
    diagonal."""

    def flyp_loss(state: TrainState, batch, draws: StepDraws):
        img = encode_train(state, _train_images(batch, draws, image_size),
                           attention)
        txt = on_rows(_mesh_of(state), lambda t: state.model.encode_text(
            t, normalize=True, attention=attention), batch["prompt_tokens"])
        logits = torch.exp(state.logit_scale) * (img @ txt.t())
        labels = torch.arange(logits.shape[0], device=logits.device)
        source = batch["source"]
        return 0.5 * (loss(logits, labels, source)
                      + loss(logits.t(), labels, source))

    return flyp_loss


def make_flyp_step(loss: LossFn = cross_entropy, image_size: int = 224,
                   attention: Attention = mha_qkv):
    """FLYP contrastive finetuning of both towers: ``make_flyp_loss``'s
    loss, its backward, one update."""
    return _loss_step(make_flyp_loss(loss, image_size, attention))


def make_multitask_loss(loss: LossFn = cross_entropy,
                        dataset_wd: float = 1.0, image_size: int = 224,
                        attention: Attention = mha_qkv):
    """multitask_loss(state, batch, draws) -> finetune-multitask's loss on
    a batch already on the device (reference train_ce_multitask,
    utils/training.py:990-1111; ``swat_tpu.train.steps.make_multitask_step``'s
    loss): the class head's logits scaled by exp(logit_scale) under the
    run's loss, plus ``dataset_wd`` x the plain CE of the state's binary
    dataset head against the batch's source flag; the dataset logits are
    left unscaled, as the reference comments the scaling out
    (:1035-1036)."""

    def multitask_loss(state: TrainState, batch, draws: StepDraws):
        feats = encode_train(state, _train_images(batch, draws, image_size),
                             attention)
        logits = head_logits(state.head, feats) * torch.exp(state.logit_scale)
        ds_logits = head_logits(state.dataset_head, feats)
        return (loss(logits, batch["labels"], batch["source"])
                + dataset_wd * cross_entropy(ds_logits, batch["source"], None))

    return multitask_loss


def make_dataset_cls_loss(loss: LossFn = cross_entropy,
                          image_size: int = 224,
                          attention: Attention = mha_qkv):
    """dataset_cls_loss(state, batch, draws) -> dataset-cls's loss on a
    batch already on the device (reference train_dataset_cls,
    utils/training.py:572-685; ``swat_tpu.train.steps.make_dataset_cls_step``'s
    loss): a binary head's logits scaled by exp(logit_scale), the batch's
    source flag as the label, no source weighting."""

    def dataset_cls_loss(state: TrainState, batch, draws: StepDraws):
        feats = encode_train(state, _train_images(batch, draws, image_size),
                             attention)
        logits = head_logits(state.head, feats) * torch.exp(state.logit_scale)
        return loss(logits, batch["source"], None)

    return dataset_cls_loss


def make_multitask_step(loss: LossFn = cross_entropy, dataset_wd: float = 1.0,
                        image_size: int = 224,
                        attention: Attention = mha_qkv):
    """finetune-multitask: ``make_multitask_loss``'s loss, one update."""
    return _loss_step(make_multitask_loss(loss, dataset_wd, image_size,
                                          attention))


def make_dataset_cls_step(loss: LossFn = cross_entropy,
                          image_size: int = 224,
                          attention: Attention = mha_qkv):
    """dataset-cls: ``make_dataset_cls_loss``'s loss, one update."""
    return _loss_step(make_dataset_cls_loss(loss, image_size, attention))


def fixmatch_views(batch, draws: FixmatchDraws, image_size: int = 224):
    """The unlabeled batch's two views, normalized: weak = random-resized
    crop + flip, strong = random-resized crop + flip + RandAugment(2, 10)
    with a cutout of image_size // 2 (reference TransformFixMatch,
    utils/extras.py:41-63), from its canvases; or its pre-augmented
    'images_w' / 'images_s'."""
    if "canvases_u" not in batch:
        return batch["images_w"], batch["images_s"]
    canvases = batch["canvases_u"]

    def view(crops):
        return aug.hflip(aug.random_resized_crop(canvases, crops.boxes,
                                                 image_size), crops.flips)

    strong = rand_augment(view(draws.strong), draws.rand_augment,
                          cutout=image_size // 2)
    return (aug.normalize_float_pixels(view(draws.weak)),
            aug.normalize_float_pixels(strong))


def make_fixmatch_loss(threshold: float = 0.95, lambda_u: float = 1.0,
                       image_size: int = 224,
                       attention: Attention = mha_qkv):
    """fixmatch_loss(state, batch, draws) -> (loss, mask rate, loss_u) on a
    batch already on the device (reference train_fixmatch,
    utils/training.py:820-983; ``swat_tpu.train.steps.make_fixmatch_step``'s
    loss): the labeled images, the weak and the strong view through the
    image tower in one forward ([l; w; s]); unscaled head logits; the plain
    CE of the labeled rows plus ``lambda_u`` x the mean over the unlabeled
    rows of the strong view's CE against the weak view's argmax, masked by
    max softmax(weak) >= ``threshold``, the weak view taking no gradient.
    logit_scale is never read."""

    def fixmatch_loss(state: TrainState, batch, draws: FixmatchDraws):
        images_l = _train_images(batch, draws, image_size)
        images_w, images_s = fixmatch_views(batch, draws, image_size)
        n_l = images_l.shape[0]
        # one forward, so one BatchNorm batch on RN50 (swat_tpu's too)
        feats = encode_train(state, torch.cat([images_l, images_w, images_s]),
                             attention)
        logits = head_logits(state.head, feats)
        logits_w, logits_s = logits[n_l:].chunk(2)
        loss_l = cross_entropy(logits[:n_l], batch["labels"], None)
        probs_w = torch.softmax(logits_w.detach(), dim=-1)
        max_p, targets = probs_w.amax(dim=-1), probs_w.argmax(dim=-1)
        mask = (max_p >= threshold).float()
        per = cross_entropy.per_sample(logits_s, targets)
        loss_u = (per * mask).mean()
        return loss_l + lambda_u * loss_u, mask.mean(), loss_u

    return fixmatch_loss


def make_fixmatch_step(threshold: float = 0.95, lambda_u: float = 1.0,
                       image_size: int = 224,
                       attention: Attention = mha_qkv, aux: bool = False):
    """FixMatch: ``make_fixmatch_loss``'s loss, its backward, one update ->
    the loss, or with ``aux`` (loss, mask rate, loss_u), all 0-d tensors on
    the device, not synchronized."""
    fixmatch_loss = make_fixmatch_loss(threshold, lambda_u, image_size,
                                       attention)

    def step(state: TrainState, batch, draws: FixmatchDraws):
        batch = batch_to_device(batch, state.head.device)
        with span("train.forward"):
            val, mask_rate, loss_u = fixmatch_loss(state, batch, draws)
        val = _update(state, val)
        if aux:
            return val, mask_rate, loss_u.detach()
        return val

    return step
