"""Stage orchestration: zero-shot, stage 1 and stage 2 (counterpart of
``swat_tpu/train/stages.py:131-455,520-788,903-1177,1206-1255``).

``SwatPipeline`` builds the towers from an OpenCLIP checkpoint, encodes the
class prompts with the text tower and makes the zero-shot head from the
prompt means.  ``--method zeroshot`` validates the test split and prints
the reference's zero-shot summary line.  ``--method finetune``, the
single-loader mixes (cutmix, mixup, resizemix, saliencymix, attentivemix),
the twin-loader methods (finetune-mixed, cutmix-fs, mixup-fs, CMO), the
linear probes (probing, REAL-Linear and CMLP, on pre-extracted features or
streamed; CMLP joins a batch of prompt embeddings to each, ``--use_attribute``
adds the attribute prompts), FLYP (both towers, streaming; its head
rebuilt from the text tower on each validating epoch; ``--locked_text``,
``--lr_projector``), finetune-multitask (a second, binary dataset head,
both heads validated every epoch) and fixmatch (its epochs over the
unlabeled split, the labeled split cycled beside it, validated on the test
split) run stage 1: the epochs (streaming or resident), WiSE-FT, feature
re-extraction with the best weights, test scores, tau-normalization and the
stage-1 bundle.  dataset-cls trains a binary head to tell few-shot from
retrieved images, validates on the split with the source flag as the
label, and ends after its epochs, with no summary row.
``--accum``, ``--remat``, ``--optim SGD`` and ``--utrain`` (pseudo-labeled
samples appended to the train split) apply as in ``swat_tpu``.
Stage 2 starts from that bundle (or from ``--stage1_model_path`` with
``--skip_stage1``): probing on the few-shot train-transform snapshot's
features, then few-shot finetuning; the 11-field summary line follows.
``--model_path`` warm-starts stage 1, ``--save_ckpt`` / ``--resume`` write
and restore train checkpoints, and ``--test_imagenet_ood`` sweeps the
ImageNet OOD suite (``eval/ood.py``) with the most downstream bundle that
ran.  ``--checkpoint_path`` takes an OpenCLIP ``.pt`` or a ``cli.convert``
bundle, fp32 or int8; an int8 one gives the model the int8 layout
(``CLIPModel.int8_``), for inference only.  ``--trace_dir`` runs the
whole of ``SwatPipeline.run`` under ``torch.profiler``
(``utils/profiling.maybe_trace``) and writes one Chrome trace a rank there.

Under a launcher (``torch.distributed.run``) the pipeline starts the
process group (``core.distributed``) and runs data-parallel over a
``--mesh_data x --mesh_model`` mesh of the processes (``core/mesh.py``):
each rank decodes its rows of every batch, the towers encode them, the
features and gradients are gathered and summed, and every rank holds the
numbers one device computes.  As in ``swat_tpu``'s CLI the towers are not
sharded by ``--mesh_model``: the ranks of a model group compute the same
rows (tensor parallelism is the library's, ``models/clip.py``).  Rank 0
alone writes the log, ``loss.csv``, the feature and prompt caches, the
score files and the bundles, and prints the summary line; the others wait
at a barrier and read what it wrote.  Without a launcher and with the
default ``--mesh_data -1 --mesh_model 1`` there is no process group and
no mesh.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from swat_tpu_torch.core.distributed import (local_device,
                                             maybe_initialize_distributed)
from swat_tpu_torch.core.mesh import MeshSpec, active, create_mesh
from swat_tpu_torch.data import prompts as P
from swat_tpu_torch.data.splits import (Sample, class_counts,
                                        read_pseudo_split, read_split)
from swat_tpu_torch.utils.logging import set_logger
from swat_tpu_torch.utils.profiling import maybe_trace
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from swat_tpu_torch.data.features import (encode_prompts,
                                          extract_image_features,
                                          extract_or_load,
                                          feature_cache_path,
                                          make_text_encoder,
                                          params_fingerprint)
from swat_tpu_torch.data.pipeline import (CyclingLoader, EvalLoader,
                                          FeatureBatches, TrainLoader,
                                          TrainSnapshotLoader,
                                          WeightedSampler,
                                          WeightedTrainLoader)
from swat_tpu_torch.data.transforms import CANVAS_SIZE
from swat_tpu_torch.eval.heatmap import (clip_attention_heatmap,
                                         clip_text_heatmap)
from swat_tpu_torch.eval.metrics import calculate_scores
from swat_tpu_torch.eval.ood import test_imagenet_ood
from swat_tpu_torch.eval.resident import ResidentEval, make_scan_eval
from swat_tpu_torch.eval.validate import (Evaluator, validate_features,
                                          validate_multitask)
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.models.head import (init_head_from_prompts,
                                        init_head_random, tau_normalize,
                                        wise_ft_head, wise_ft_params)
from swat_tpu_torch.models.loader import (jax_params_from_state_dict,
                                          load_torch_checkpoint,
                                          state_dict_from_jax_params)
from swat_tpu_torch.models.tokenizer import get_tokenizer
from swat_tpu_torch.train.checkpoint import (best_model_path,
                                             load_best_model,
                                             save_best_model,
                                             save_test_scores)
from swat_tpu_torch.train.losses import set_loss
from swat_tpu_torch.train.resident import (ResidentData, epoch_permutation,
                                           make_resident_epoch,
                                           twin_permutation)
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import (ACCUM_METHODS, FROZEN_STEP_METHODS,
                                        RESIDENT_METHODS, STEP_METHODS,
                                        TWIN_METHODS, check_accum,
                                        make_ce_step,
                                        make_cmlp_step, make_dataset_cls_step,
                                        make_fixmatch_step, make_flyp_step,
                                        make_mixing_step, make_multitask_step,
                                        make_probing_step, make_sampler)
from swat_tpu_torch.train.trainer import compose_twin, train_loop


def resolve_device(name: str) -> torch.device:
    """The run's device, ``cuda:LOCAL_RANK`` under a launcher; 'cuda'
    without a usable GPU raises."""
    device = local_device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda requested but no CUDA device is available; pass "
            "--device cpu to run the plain PyTorch path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return device


def _pick_accum(combined_bsz: int, target_micro: int = 32):
    """Smallest divisor of the encode batch giving microbatch <= target."""
    lo = max(2, -(-combined_bsz // target_micro))
    for d in range(lo, combined_bsz + 1):
        if combined_bsz % d == 0 and combined_bsz // d <= target_micro:
            return d
    return None


def auto_memory_policy(model_cfg: str, remat, accum: int, bsz: int,
                       n_devices: int, method: str):
    """The effective (remat, accum) of a run, ``swat_tpu``'s decision on
    the same inputs (``stages.auto_memory_policy``), so that both packages
    train the same microbatches.  Only ViT-L/14 at bsz >= 64 on one device
    with neither --remat nor an accum whose microbatch is under 64 images
    is touched: the microbatch-decomposable methods (ACCUM_METHODS) get
    accumulation to microbatches of <= 32 images (``_pick_accum`` over the
    encode batch, doubled for finetune-mixed's joined twin), the others
    full remat; an explicit accum that leaves >= 64 images a microbatch
    gets full remat on top.  ``swat_tpu`` measured the need on its own
    accelerator.  An H100 does not need it: L/14's cutmix step at bsz 64
    peaks at 34.7 GiB fp32, 24.5 GiB bf16 without it on an NVIDIA H100 80GB
    HBM3 (700 W; ``chip_smoke.py``'s ``[l14-memory]``), where the picked
    ``--accum 2`` costs 1.4-1.6 % of the fp32 step and 31-49 % of the bf16
    one (the host; three calls); the decision stays ``swat_tpu``'s so that
    both packages train the same microbatches."""
    if not ("vitl14" in model_cfg and bsz >= 64 and n_devices == 1):
        return remat, accum
    if remat:
        return remat, accum
    combined = bsz * (2 if method == "finetune-mixed" else 1)
    if accum > 1:
        if combined // accum >= 64:
            return "full", accum
        return remat, accum
    if method in ACCUM_METHODS:
        picked = _pick_accum(combined)
        if picked is not None:
            return False, picked
    return "full", accum


class SwatPipeline:
    """Holds the model, prompts, head and eval engines for one run."""

    def __init__(self, cfg: RunConfig):
        self.cfg = cfg.derived()
        cfg = self.cfg
        self.device = resolve_device(cfg.device)
        started = maybe_initialize_distributed(device=self.device.type)
        world = dist.get_world_size() if started else 1
        self.main = not started or dist.get_rank() == 0
        self.logger, self.loss_logger = set_logger(cfg, main=self.main)
        logger = self.logger
        if started:
            logger.info(f"Process group: backend {dist.get_backend()}, "
                        f"{world} process(es), rank {dist.get_rank()}")
        # the mesh of every process; one without a launcher only when a
        # mesh was asked for (it then warns and holds the one process)
        self.mesh = None
        if started or (cfg.mesh_data, cfg.mesh_model) not in ((-1, 1),
                                                               (1, 1)):
            self.mesh = create_mesh(MeshSpec(cfg.mesh_data, cfg.mesh_model),
                                    logger=logger)
        if active(self.mesh) is not None:
            logger.info(f"Data-parallel over {self.mesh.data} x "
                        f"{self.mesh.model} ranks ({world} processes)")
            if cfg.bsz % self.mesh.data:
                raise ValueError(
                    f"--bsz {cfg.bsz} is not divisible by the data axis "
                    f"({self.mesh.data} ranks)")

        self.model_cfg = get_model_config(cfg.model_cfg)
        self.precision = (FP32_PRECISION if cfg.compute_dtype == "float32"
                          else DEFAULT_PRECISION)
        self.precision.apply_backend_flags()
        remat, accum = auto_memory_policy(cfg.model_cfg, cfg.remat,
                                          cfg.accum, cfg.bsz, world,
                                          cfg.method)
        if (remat, accum) != (cfg.remat, cfg.accum):
            logger.warning(
                f"{cfg.model_cfg} at bsz {cfg.bsz} on one device: "
                f"auto-enabling remat={remat!r}, accum={accum} (swat_tpu's "
                "memory policy, kept so that both packages train the same "
                "microbatches). Pass --remat/--accum explicitly to "
                "override.")
            self.cfg = dataclasses.replace(self.cfg, accum=accum)
            cfg = self.cfg
        self.model = CLIPModel(self.model_cfg, precision=self.precision,
                               remat=remat)

        # ---- pretrained weights (reference set_model, utils/models.py:11)
        if cfg.checkpoint_path:
            state_dict, _ = load_torch_checkpoint(cfg.checkpoint_path)
            self.model.load_weights(state_dict)
            logger.info(f"Loaded model: {cfg.model_cfg} from "
                        f"{cfg.checkpoint_path}")
        else:
            self.model.init_random(torch.Generator().manual_seed(0))
            logger.info(
                f"WARNING: no checkpoint_path; {cfg.model_cfg} initialized "
                "randomly (smoke-test mode)")
        self.model.to(self.device).eval().requires_grad_(False)
        # the pretrained weights: WiSE-FT's other end, and the template of
        # the bundles that hold part of a model
        self.zeroshot_state = {k: v.detach().clone()
                               for k, v in self.model.state_dict().items()}

        self.tokenizer = get_tokenizer(
            cfg.bpe_path, vocab_size=self.model_cfg.text.vocab_size)

        # ---- prompts (reference set_prompt, utils/prompt.py:71-80)
        self.prompt_tensors = self._build_prompts()
        # CMLP --use_attribute's text bank, encoded by the pretrained text
        # tower whatever --model_path loads later, as swat_tpu encodes it
        self.attribute_tensors = (
            self._encode_attribute_prompts()
            if cfg.method == "CMLP" and cfg.use_attribute else None)

        # ---- classifier head (reference set_classifier,
        # utils/models.py:22-43)
        # dataset-cls: a random binary head whatever --cls_init says; the
        # random heads are swat_tpu's draws from PRNGKey(training_seed)
        if cfg.method == "dataset-cls":
            head = init_head_random(cfg.training_seed, 2,
                                    self.model_cfg.embed_dim, self.device)
        elif cfg.cls_init in ("REAL-Prompt", "REAL-Linear", "text"):
            head = init_head_from_prompts(
                P.class_embedding_matrix(self.prompt_tensors), self.device)
            logger.info("Initialized classifier head with text embedding. "
                        f"weights.shape: {tuple(head.shape)}")
        elif cfg.cls_init == "random":
            head = init_head_random(cfg.training_seed, cfg.num_classes,
                                    self.model_cfg.embed_dim, self.device)
        else:
            raise NotImplementedError(cfg.cls_init)
        self.zeroshot_head = head

        self.evaluator = Evaluator(cfg.num_classes, loss=self._loss(),
                                   device=self.device, mesh=self.mesh)
        self._resident_eval_cache: Dict[str, Optional[ResidentEval]] = {}
        self._scan_eval = None

    # ------------------------------------------------------------------
    # helpers

    def _loss(self, cfg: Optional[RunConfig] = None):
        cfg = cfg or self.cfg
        cls_num_list = None
        if cfg.loss_name == "BalancedSoftmax":
            samples = read_split(cfg.dataset_root, cfg.train_split)
            cls_num_list = class_counts(samples, cfg.num_classes)
        return set_loss(cfg.loss_name, fewshot_weight=cfg.fewshot_weight,
                        focal_alpha=cfg.focal_alpha,
                        focal_gamma=cfg.focal_gamma,
                        cls_num_list=cls_num_list)

    def _build_prompts(self):
        """The class prompts' embeddings (cached); their token rows stay on
        the pipeline as ``tokenized_prompts`` (FLYP's batches and head)."""
        cfg = self.cfg
        metrics = P.load_class_metrics(cfg.metrics_file)
        self.logger.info(f"Loaded metrics from: {cfg.metrics_file}")
        text_prompts = P.make_prompts(metrics, cfg.dataset, cfg.prompt_name)
        tokenized = P.tokenize_prompts(
            text_prompts, self.tokenizer,
            self.model_cfg.text.context_length)
        self.tokenized_prompts = tokenized
        # the JAX package's cache path: the two packages read each other's
        # prompt tensors unless --recal_prompt
        cache = os.path.join(
            cfg.dataset_root, "prompts",
            f"{cfg.dataset}_{cfg.model_cfg}_{cfg.prompt_name}"
            "_prompt_tensors.npz")
        self._barrier()
        if not cfg.recal_prompt and os.path.exists(cache):
            tensors = P.load_prompt_tensors(cache)
            self.logger.info(f"Loaded prompt tensors from {cache}")
        else:
            tensors = encode_prompts(make_text_encoder(self.model, self.mesh),
                                     tokenized)
            if self.main:
                P.save_prompt_tensors(cache, tensors)
                self.logger.info(f"Saved prompt tensors to {cache}")
            self._barrier()
        return tensors

    def _barrier(self) -> None:
        """Under a mesh, the other ranks wait here for what rank 0 wrote."""
        if self.mesh is not None:
            self.mesh.barrier()

    def _samples(self, split):
        return read_split(self.cfg.dataset_root, split)

    def _train_samples(self, cfg: RunConfig):
        """The train split, with --utrain's pseudo-labeled samples appended
        (reference utils/dataloader.py:188-202, inat_dataset.py:26-32)."""
        samples = self._samples(cfg.train_split)
        if cfg.utrain:
            pseudo = read_pseudo_split(cfg.utrain)
            self.logger.info(
                f"Load utrain data with pseudo-labels from: {cfg.utrain} "
                f"({len(pseudo)} samples)")
            samples = samples + pseudo
        return samples

    def _eval_loader(self, split, bsz: int = 128):
        return EvalLoader(self._samples(split), batch_size=bsz,
                          n_px=self.model_cfg.vision.image_size,
                          num_workers=self.cfg.num_workers, mesh=self.mesh)

    def _resident_eval_for(self, split) -> Optional[ResidentEval]:
        """ResidentEval for a split when enabled and within budget;
        cached per split."""
        cfg = self.cfg
        if cfg.resident == "off":
            return None
        tag = str(split)
        if tag in self._resident_eval_cache:
            return self._resident_eval_cache[tag]
        samples = self._samples(split)
        n_px = self.model_cfg.vision.image_size
        est = len(samples) * n_px * n_px * 3
        if cfg.resident != "on" and est > cfg.resident_budget_bytes:
            self._resident_eval_cache[tag] = None
            return None
        ev = ResidentEval.from_samples(samples, self.device, n_px=n_px,
                                       num_workers=cfg.num_workers,
                                       mesh=self.mesh)
        if self._scan_eval is None:
            self._scan_eval = make_scan_eval(cfg.num_classes,
                                             loss=self._loss())
        self._resident_eval_cache[tag] = ev
        return ev

    def _validate_images(self, model, head, logit_scale, split,
                         return_confusion=False, bsz=128):
        ev = self._resident_eval_for(split)
        if ev is not None:
            acc, loss, cm = self._scan_eval(model, head, logit_scale, ev)
            return acc, loss, (cm if return_confusion else None)
        return self.evaluator.validate(
            model, head, logit_scale, self._eval_loader(split, bsz=bsz),
            return_confusion=return_confusion)

    def _cached_extract(self, cfg: RunConfig, fingerprint: str,
                        split_tag: str, loader_fn, samples):
        """Features of the model's current weights, whose
        ``params_fingerprint`` is ``fingerprint``, through the persistent
        cache under ``<dataset_root>/pre_extracted/`` (the JAX package's
        file names: dataset, model config, split tag, the weights' and the
        split's digests, ``samples`` being the split); ``--recal_fea``
        extracts anew."""
        h = hashlib.sha1()
        for smp in samples:
            h.update(f"{smp.path}|{smp.label}|{smp.is_fewshot};".encode())
        path = feature_cache_path(
            os.path.join(cfg.dataset_root, "pre_extracted"), cfg.dataset,
            cfg.model_cfg, split_tag,
            extra=f"{fingerprint}_{h.hexdigest()[:8]}")

        def extract():
            t0 = time.perf_counter()
            feats = extract_image_features(self.model, loader_fn(),
                                           self.mesh)
            secs = time.perf_counter() - t0
            n = len(feats["labels"])
            self.logger.info(
                f"Extracted {split_tag} features: {n} images in {secs:.3f} s "
                f"({n / max(secs, 1e-9):.1f} images/s, decode included, "
                f"{self.device})")
            return feats

        self._barrier()
        feats = extract_or_load(path, cfg.recal_fea, extract,
                                logger=self.logger, save=self.main)
        self._barrier()
        return feats

    def _save_best_model(self, output_dir: str, stage: int, **kw) -> str:
        """``save_best_model`` on rank 0, then the barrier -> the bundle's
        path on every rank."""
        if self.main:
            path = save_best_model(output_dir, stage, **kw)
        else:
            path = best_model_path(output_dir, stage,
                                   kw["best_records"].get("best_epoch", -1))
        self._barrier()
        return path

    def _load_ckpt(self, path: str):
        """A stage bundle or warm-start file -> (JAX param tree, head on
        the device, logit_scale, meta); the pretrained weights and the
        prompt head fill in what a partial file lacks."""
        template = jax_params_from_state_dict(self.zeroshot_state)[0]
        params, head, logit_scale, meta = load_best_model(
            path, template, self.zeroshot_head.cpu().numpy())
        head = torch.from_numpy(np.array(head, np.float32)).to(self.device)
        return params, head, logit_scale, meta

    def _load_params(self, params) -> None:
        """Loads a JAX param tree (fp32, or int8 from ``quant.quantize_tree``)
        into the shared model (its own, unused logit_scale kept)."""
        self.model.load_weights(state_dict_from_jax_params(
            params, self.model.logit_scale.item()))

    # ------------------------------------------------------------------
    # zero-shot (reference run_zeroshot, utils/training.py:23-44)

    def run_zeroshot(self) -> float:
        """Zero-shot test accuracy of the pretrained towers with the
        prompt-built head."""
        t0 = time.perf_counter()
        acc, _, _ = self._validate_images(
            self.model, self.zeroshot_head, float(np.log(100.0)),
            self.cfg.test_split)
        secs = time.perf_counter() - t0
        n = len(self._samples(self.cfg.test_split))
        self.logger.info(f"Zero-shot validate: {n} images in {secs:.3f} s "
                         f"({n / secs:.1f} images/s, decode included, "
                         f"{self.device})")
        self.logger.info(f"+++++ Zero-shot Test Acc: {round(acc, 3)}")
        return acc

    # ------------------------------------------------------------------
    # stage-1 training (reference main.py:236-327)

    def train_method(self, cfg: RunConfig, head: torch.Tensor):
        """The epochs of ``cfg.method`` (finetune, a mix, a twin-loader
        method, a probe, FLYP, finetune-multitask, dataset-cls or fixmatch)
        from the model's current weights and ``head`` -> (final state,
        BestSnapshot)."""
        method = cfg.method
        logger = self.logger
        loss = self._loss(cfg)
        image_size = self.model_cfg.vision.image_size
        samples = self._train_samples(cfg)
        frozen = method in FROZEN_STEP_METHODS
        if method not in STEP_METHODS:
            raise NotImplementedError(f"Method {method} not implemented.")
        if cfg.accum > 1 and method not in ACCUM_METHODS:
            raise ValueError(
                f"--accum only supports the CE/mixing methods, not "
                f"{method!r} (FLYP's contrastive loss couples the whole "
                "batch; frozen-encoder methods don't need it)")
        check_accum(self.model, cfg.accum)
        data = active(self.mesh)
        if data is not None and cfg.accum > 1 and (
                cfg.bsz % cfg.accum or (cfg.bsz // cfg.accum) % data.data):
            raise ValueError(
                f"--accum {cfg.accum} cuts --bsz {cfg.bsz} into microbatches "
                f"that the data axis ({data.data} ranks) does not divide")

        if frozen:
            # val / test features of the eval transform are deterministic,
            # so every validation reuses them in both pre_extracted modes.
            # The train side follows the reference: pre_extracted=False
            # (the parser's default) streams images with fresh train
            # augmentation every step; pre_extracted=True extracts one
            # train-transform snapshot, cached across runs
            fingerprint = params_fingerprint(
                jax_params_from_state_dict(self.model.state_dict())[0])
            if cfg.pre_extracted:
                snap_mode = "eval" if cfg.aug_mode == "eval" else "train"
                train_feats = self._cached_extract(
                    cfg, fingerprint,
                    "train_trainaug" if snap_mode == "train"
                    else "train_evalaug",
                    lambda: TrainSnapshotLoader(
                        samples, 256, image_size, cfg.num_workers,
                        seed=cfg.training_seed, mode=snap_mode,
                        mesh=self.mesh),
                    samples=samples)
                train_loader = FeatureBatches(
                    train_feats["image_features"], train_feats["labels"],
                    batch_size=cfg.bsz, shuffle=True, drop_last=True,
                    seed=cfg.training_seed,
                    source=train_feats.get("source"))
            else:
                train_loader = TrainLoader(
                    samples, batch_size=cfg.bsz, seed=cfg.training_seed,
                    mode=cfg.aug_mode, n_px=image_size,
                    num_workers=cfg.num_workers, mesh=self.mesh)
            feats = {}
            for tag, split in (("val", cfg.val_split),
                               ("test", cfg.test_split)):
                smp = self._samples(split)
                feats[tag] = self._cached_extract(
                    cfg, fingerprint, tag,
                    lambda smp=smp: EvalLoader(smp, 256, image_size,
                                               cfg.num_workers, self.mesh),
                    samples=smp)
        else:
            train_loader = TrainLoader(
                samples, batch_size=cfg.bsz, seed=cfg.training_seed,
                mode=cfg.aug_mode, n_px=image_size,
                num_workers=cfg.num_workers,
                tokenized_prompts=(self.tokenized_prompts
                                   if method == "FLYP" else None),
                mesh=self.mesh)

        # the twin-loader methods' second batch: for CMO the train split
        # drawn with inverse class frequencies, else the few-shot split
        # (reference get_retrieve_fewshot_dataloader,
        # utils/dataloader.py:138-165).  mixup-fs takes one of the two
        # batches whole and CMO pastes row into row, so their twin is as
        # large as the batch; the joining methods take bsz * fewshot_ratio
        twin_loader = None
        twin_bsz = (cfg.bsz if method in ("mixup-fs", "CMO")
                    else max(1, int(cfg.bsz * cfg.fewshot_ratio)))
        if method == "CMO":
            twin_loader = WeightedTrainLoader(
                samples, cfg.num_classes, cfg.cmo_alpha, batch_size=twin_bsz,
                seed=cfg.training_seed, mode=cfg.aug_mode, n_px=image_size,
                num_workers=cfg.num_workers, mesh=self.mesh)
        elif method in TWIN_METHODS:
            twin_loader = TrainLoader(
                self._samples(cfg.fewshot_data), batch_size=twin_bsz,
                seed=cfg.training_seed + 7, mode=cfg.aug_mode,
                n_px=image_size, num_workers=cfg.num_workers, mesh=self.mesh)

        # the resident path: the split's uint8 canvases on the device (and
        # the twin's: the few-shot split, or CMO's train split, the same
        # canvases)
        resident_data = resident_twin = None
        if (cfg.resident != "off" and cfg.aug_mode == "canvas"
                and method in RESIDENT_METHODS):
            twin_samples = []
            if method == "CMO":
                twin_samples = samples
            elif method in TWIN_METHODS:
                twin_samples = self._samples(cfg.fewshot_data)
            est = (len(samples) + len(twin_samples)) * CANVAS_SIZE \
                * CANVAS_SIZE * 3
            if cfg.resident == "on" or est <= cfg.resident_budget_bytes:
                resident_data = ResidentData.from_samples(
                    samples, self.device, num_workers=cfg.num_workers,
                    mesh=self.mesh)
                if method == "CMO":
                    resident_twin = resident_data
                elif twin_samples:
                    resident_twin = ResidentData.from_samples(
                        twin_samples, self.device,
                        num_workers=cfg.num_workers, mesh=self.mesh)
                logger.info(
                    f"Resident train data: {len(samples)}"
                    f"{' + ' + str(len(twin_samples)) if twin_samples else ''}"
                    f" canvases ({est / 1e9:.2f} GB) on device; resident "
                    "epochs.")

        u_loader = None
        if method == "fixmatch":
            # the epoch iterates the unlabeled loader (reference
            # train_fixmatch, utils/training.py:869-876), always on canvases:
            # the LR schedule spans its steps, so it is built first
            u_loader = TrainLoader(
                self._samples(cfg.unlabeled_data),
                batch_size=cfg.bsz * cfg.mu, seed=cfg.training_seed,
                mode="canvas", n_px=image_size, num_workers=cfg.num_workers,
                mesh=self.mesh)
            steps_per_epoch = len(u_loader)
        else:
            steps_per_epoch = len(train_loader)
        total_iter = steps_per_epoch * max(cfg.epochs, 1)

        # dataset-cls needs a binary head (reference set_classifier,
        # utils/models.py:24-27), multitask a second one for the source flag
        dim = self.model_cfg.embed_dim
        if method == "dataset-cls" and head.shape[0] != 2:
            head = init_head_random(cfg.training_seed, 2, dim, self.device)
        dataset_head = (init_head_random(cfg.training_seed + 1, 2, dim,
                                         self.device)
                        if method == "finetune-multitask" else None)
        state = create_train_state(
            self.model, head, method, lr_classifier=cfg.lr_classifier,
            lr_backbone=cfg.lr_backbone, total_iter=total_iter, wd=cfg.wd,
            optim_type=cfg.optim, lr_projector=cfg.lr_projector,
            temperature=cfg.temperature, locked_text=cfg.locked_text,
            dataset_head=dataset_head, mesh=self.mesh)

        heatmap_fn = (self._heatmap_fn() if method == "attentivemix"
                      else None)

        def make_step(aug_dtype, accum):
            if method == "CMLP":
                return make_cmlp_step(loss, cfg.pre_extracted, image_size)
            if frozen:
                return make_probing_step(loss, cfg.pre_extracted, image_size)
            if method == "FLYP":
                return make_flyp_step(loss, image_size)
            if method == "finetune-multitask":
                return make_multitask_step(loss, cfg.dataset_wd, image_size)
            if method == "dataset-cls":
                return make_dataset_cls_step(loss, image_size)
            if method == "fixmatch":
                return make_fixmatch_step(cfg.threshold, cfg.lambda_u,
                                          image_size)
            if method in ("finetune", "finetune-mixed"):
                return make_ce_step(loss, image_size, aug_dtype,
                                    concat_fs=method == "finetune-mixed",
                                    accum=accum)
            return make_mixing_step(method, loss, heatmap_fn=heatmap_fn,
                                    image_size=image_size,
                                    aug_dtype=aug_dtype, accum=accum)

        sample = make_sampler(method,
                              mixup_alpha=cfg.mixup_alpha,
                              cutmix_beta=cfg.cutmix_beta,
                              mix_prob=cfg.mix_prob, image_size=image_size)

        if twin_loader is not None:
            twin_cycler = CyclingLoader(twin_loader)

            def train_batches():
                return compose_twin(iter(train_loader), twin_cycler)
        elif method == "fixmatch":
            # the labeled loader cycles beside the unlabeled one, whose
            # canvases ride under *_u keys
            labeled = CyclingLoader(train_loader)

            def train_batches():
                for ub in u_loader:
                    yield dict(labeled.next(), canvases_u=ub["canvases"],
                               valid_hw_u=ub["valid_hw"])
        elif method == "CMLP":
            # a batch of the flattened prompt bank joins each batch
            # (swat_tpu/train/stages.py:546-567, :634-641)
            bank = (self.attribute_tensors if cfg.use_attribute
                    else self.prompt_tensors)
            text_cycler = CyclingLoader(FeatureBatches(
                *flatten_prompt_bank(bank), batch_size=cfg.bsz,
                shuffle=True, drop_last=True, seed=cfg.training_seed))

            def train_batches():
                for batch in train_loader:
                    text = text_cycler.next()
                    yield dict(batch, text_features=text["features"],
                               text_labels=text["labels"])
        else:
            def train_batches():
                return iter(train_loader)

        if frozen:
            def validate_fn(state):
                f = feats["val"]
                return validate_features(
                    state.head.detach(), state.logit_scale.item(),
                    f["image_features"], f["labels"], cfg.num_classes, loss,
                    source=f.get("source"))

            def test_fn(state):
                f = feats["test"]
                acc, _, _ = validate_features(
                    state.head.detach(), state.logit_scale.item(),
                    f["image_features"], f["labels"], cfg.num_classes, loss,
                    source=f.get("source"))
                return acc
        elif method == "dataset-cls":
            # predictions against the source flag (reference
            # validate_dataset, testing.py:280-364)
            def flagged(split):
                return EvalLoader([Sample(s.path, s.is_fewshot, s.is_fewshot)
                                   for s in self._samples(split)], 128,
                                  image_size, cfg.num_workers, self.mesh)

            def validate_fn(state):
                return self.evaluator.validate(
                    state.model, state.head.detach(),
                    state.logit_scale.item(), flagged(cfg.val_split),
                    return_confusion=True)

            def test_fn(state):
                acc, _, _ = self.evaluator.validate(
                    state.model, state.head.detach(),
                    state.logit_scale.item(), flagged(cfg.test_split))
                return acc
        elif method == "finetune-multitask":
            # both heads over one pass (reference validate_multitask,
            # testing.py:189-278)
            def both(state, split, tag):
                acc, vloss, cm, d_acc, _ = validate_multitask(
                    self.evaluator, state.model, state.head.detach(),
                    state.dataset_head.detach(), state.logit_scale.item(),
                    self._eval_loader(split), loss)
                logger.info(f"Dataset {tag} Acc: {round(d_acc, 3)}")
                return acc, vloss, cm

            def validate_fn(state):
                return both(state, cfg.val_split, "Val")

            def test_fn(state):
                return both(state, cfg.test_split, "Test")[0]
        else:
            # fixmatch validates on the test split (reference :922-924)
            val_split = (cfg.test_split if method == "fixmatch"
                         else cfg.val_split)

            def validate_fn(state):
                return self._validate_images(
                    state.model, state.head.detach(),
                    state.logit_scale.item(), val_split,
                    return_confusion=True)

            def test_fn(state):
                acc, _, _ = self._validate_images(
                    state.model, state.head.detach(),
                    state.logit_scale.item(), cfg.test_split)
                return acc

        epoch_runner = None
        if resident_data is not None:
            if cfg.accum > 1:
                logger.info(
                    f"--accum {cfg.accum} applies to streaming epochs only: "
                    "the resident epochs train whole batches, as swat_tpu's "
                    "scan epoch does")
            # the resample follows the compute policy here, as in the JAX
            # package's resident epoch: bf16 under bf16, fp32 otherwise
            run_epoch = make_resident_epoch(
                make_step(self.precision.compute_dtype, 1), sample)
            perm_rng = np.random.default_rng(cfg.training_seed)
            cmo_probs = (WeightedSampler(samples, cfg.num_classes,
                                         cfg.cmo_alpha).p
                         if method == "CMO" else None)

            def epoch_runner(state, epoch, rng):
                perm = epoch_permutation(perm_rng, resident_data.n, cfg.bsz)
                if resident_twin is None:
                    return run_epoch(state, resident_data, perm, rng)
                # drawn after the epoch's permutation, from the same
                # generator (swat_tpu/train/stages.py:763-779)
                tperm = twin_permutation(perm_rng, resident_twin.n,
                                         perm.shape[0], twin_bsz, cmo_probs)
                return run_epoch(state, resident_data, perm, rng,
                                 resident_twin, tperm)

        return train_loop(
            cfg=cfg, state=state, step_fn=make_step(torch.float32, cfg.accum),
            sample_fn=sample, train_batches=train_batches,
            steps_per_epoch=steps_per_epoch, validate_fn=validate_fn,
            test_fn=test_fn, logger=logger, loss_logger=self.loss_logger,
            epoch_runner=epoch_runner,
            ckpt_dir=os.path.join(cfg.output_dir, "model_ckpts"),
            post_epoch=self._flyp_post_epoch if method == "FLYP" else None,
            mesh=self.mesh)

    def _encode_attribute_prompts(self):
        """The attribute-augmented class prompts of
        ``<dataset_root>/prompts/visual-attrs-<dataset>.json`` (reference
        set_text_dataloader, utils/dataloader.py:257-266), encoded by the
        model's text tower -> class id -> {'all', 'mean'}."""
        cfg = self.cfg
        path = os.path.join(cfg.dataset_root, "prompts",
                            f"visual-attrs-{cfg.dataset}.json")
        with open(path) as f:
            attributes = json.load(f)
        prompts = P.make_attribute_prompts(
            P.load_class_metrics(cfg.metrics_file), cfg.dataset, attributes,
            cfg.prompt_name)
        tokenized = P.tokenize_prompts(prompts, self.tokenizer,
                                       self.model_cfg.text.context_length)
        self.logger.info(f"CMLP: attribute prompts from {path}")
        return encode_prompts(make_text_encoder(self.model, self.mesh),
                              tokenized)

    def _flyp_post_epoch(self, state, epoch: int) -> None:
        """FLYP's head, rebuilt in place from the trained text tower
        (reference build_classifier_head, utils/models.py:75-82;
        ``swat_tpu``'s ``_flyp_post_epoch``)."""
        tensors = encode_prompts(make_text_encoder(state.model, state.mesh),
                                 self.tokenized_prompts)
        with torch.no_grad():
            state.head.copy_(torch.from_numpy(
                P.class_embedding_matrix(tensors)))

    def _heatmap_fn(self):
        """CLIP heatmap for attentivemix, the replacement for the
        reference's external GEM model (main.py:22,
        utils/training.py:2672).

        Honors --attentive_name (reference :2717-2731): each image is
        localized with its own class's text, 'c-name' (common name),
        's-name' (species) or 'general' (the reference hardcodes the word
        'bird', :2724-2725), encoded ONCE by the frozen initial text tower
        into a [C, D] bank.  Falls back to class-token self-relevance when
        no class names can be built from the metrics file."""
        bank = self._attentive_text_bank()
        if bank is None:

            def fn(model, images, labels):
                return clip_attention_heatmap(model, images)
        else:
            self.logger.info(
                f"attentivemix: text-conditioned heatmaps "
                f"({self.cfg.attentive_name}, {bank.shape[0]} classes)")

            def fn(model, images, labels):
                return clip_text_heatmap(model, images, bank[labels])

        return fn

    def _attentive_text_bank(self) -> Optional[torch.Tensor]:
        """[num_classes, D] normalized localization-text embeddings in
        class order on the device, or None when the metrics file lacks
        usable names."""
        cfg = self.cfg
        try:
            metrics = P.load_class_metrics(cfg.metrics_file)
        except (OSError, ValueError, KeyError):
            return None
        # the bank is indexed by label inside the step: sparse or
        # off-by-one ids would misalign classes, so require exactly
        # 0..num_classes-1
        try:
            ids = {int(k) for k in metrics}
        except ValueError:
            return None
        if ids != set(range(cfg.num_classes)):
            self.logger.warning(
                "attentivemix: metrics class ids are not contiguous "
                "0..num_classes-1; falling back to self-relevance "
                "heatmaps")
            return None
        texts = {}
        for class_id in sorted(metrics, key=int):
            entry = metrics[class_id]
            if cfg.attentive_name == "general":
                name = "bird"   # hardcoded in the reference, :2724-2725
            elif cfg.attentive_name == "s-name":
                name = (entry.get("species")
                        or entry.get("most_common_name")
                        or entry.get("name"))
            else:   # 'c-name' (default)
                name = (entry.get("common_name")
                        or entry.get("most_common_name")
                        or entry.get("name"))
            if isinstance(name, list):
                name = name[0] if name else None
            if not isinstance(name, str) or not name:
                return None
            texts[class_id] = [name]
        tokenized = P.tokenize_prompts(texts, self.tokenizer,
                                       self.model_cfg.text.context_length)
        tensors = encode_prompts(make_text_encoder(self.model, self.mesh),
                                 tokenized)
        return torch.from_numpy(np.stack(
            [np.asarray(tensors[cid]["mean"])
             for cid in sorted(tensors, key=int)])).to(self.device)

    # ------------------------------------------------------------------
    # WiSE-FT (reference run_wsft_alpha, main.py:132-195)

    def run_wsft_alpha(self, cfg: RunConfig, best_trainable: dict,
                       alphas=(0.5,)):
        """Interpolates head and backbone with the zero-shot ones, loads
        each blend into the model and validates it -> (best backbone state
        dict, best head, its test acc)."""
        logger = self.logger
        best_alpha, best_val, best_test = 0.0, -1.0, -1.0
        best_backbone, best_head = None, None
        logit_scale = float(best_trainable["logit_scale"])
        for alpha in alphas:
            w_head = wise_ft_head(best_trainable["head"], self.zeroshot_head,
                                  alpha)
            if cfg.freeze_visual:
                w_backbone = best_trainable["model"]
            else:
                w_backbone = wise_ft_params(best_trainable["model"],
                                            self.zeroshot_state, alpha)
            self.model.load_state_dict(w_backbone)
            val_acc, _, _ = self._validate_images(
                self.model, w_head, logit_scale, cfg.val_split)
            test_acc, _, _ = self._validate_images(
                self.model, w_head, logit_scale, cfg.test_split)
            logger.info(f"Alpha:{round(alpha, 3)}, "
                        f"Val Acc: {round(val_acc, 3)}, "
                        f"Test Acc: {round(test_acc, 3)}")
            if val_acc > best_val:
                best_val, best_test, best_alpha = val_acc, test_acc, alpha
                best_backbone, best_head = w_backbone, w_head
        logger.info(f"+++++ Best Alpha: {round(best_alpha, 2)}, "
                    f"Val Acc: {round(best_val, 3)}, "
                    f"Test Acc: {round(best_test, 3)}")
        return best_backbone, best_head, best_test

    # ------------------------------------------------------------------
    # tau normalization (reference run_tau_normalization, main.py:27-73)

    def run_tau_normalization(self, cfg: RunConfig, head: torch.Tensor,
                              val_feats, test_feats, logit_scale: float):
        logger = self.logger
        best_tau, best_val, best_test = 0.0, 0.0, 0.0
        best_tau_head = head
        loss = self._loss(cfg)
        for tau in np.arange(0.0, 2.2, 0.2):
            tau_head = tau_normalize(head, float(tau))
            val_acc, _, _ = validate_features(
                tau_head, logit_scale, val_feats["image_features"],
                val_feats["labels"], cfg.num_classes, loss)
            test_acc, _, _ = validate_features(
                tau_head, logit_scale, test_feats["image_features"],
                test_feats["labels"], cfg.num_classes, loss)
            logger.info(f"Tau: {round(tau, 2)}, "
                        f"Val Acc: {round(val_acc, 3)}, "
                        f"Test Acc: {round(test_acc, 3)}")
            if val_acc > best_val:
                best_tau, best_val, best_test = tau, val_acc, test_acc
                best_tau_head = tau_head
        logger.info(f"+++++ Best Tau: {round(best_tau, 1)}, "
                    f"Val Acc: {round(best_val, 3)}, "
                    f"Test Acc: {round(best_test, 3)}")
        return best_tau_head, best_tau, best_test

    # ------------------------------------------------------------------
    # stage 1 (reference run_stage1_finetuning, main.py:198-398)

    def run_stage1(self) -> Tuple[float, Optional[str], float]:
        cfg = self.cfg
        logger = self.logger
        # --model_path is loaded before the zero-shot check, as the
        # reference loads it (main.py:215-221): the check reports the
        # loaded weights, with the prompt-built head
        head = self.zeroshot_head
        if cfg.model_path:
            params, head, _, _ = self._load_ckpt(cfg.model_path)
            self._load_params(params)
            logger.info(f"Loaded model_path: {cfg.model_path}")
        zs_acc = None
        if cfg.check_zeroshot or cfg.method == "zeroshot":
            logger.info("Check Zero-shot Acc ......")
            zs_acc = self.run_zeroshot()
        if cfg.zeroshot_only or cfg.method == "zeroshot":
            summary = (f"{cfg.dataset},{cfg.method},{cfg.data_source},"
                       f"{cfg.cls_init},{cfg.shots},{cfg.seed},"
                       f"{cfg.retrieval_split},{round(zs_acc, 1)}")
            logger.info(summary)
            if self.main:
                print(summary)
            return zs_acc, None, -1.0

        if cfg.skip_stage1:
            logger.info("Skip stage 1 finetuning.")
            return -1.0, cfg.stage1_model_path, -1.0

        _, best = self.train_method(cfg, head)
        if cfg.method == "dataset-cls":
            return -1.0, None, -1.0
        best_trainable = best.trainable

        # ---- WiSE-FT
        wsft_backbone = wsft_head = None
        wsft_test_acc = -1.0
        if not cfg.no_wsft:
            logger.info("Checking WSFT ......")
            wsft_backbone, wsft_head, wsft_test_acc = self.run_wsft_alpha(
                cfg, best_trainable, alphas=(cfg.alpha,))

        # ---- re-extract features with the best model for tau and test
        best_params = best_trainable["model"]
        best_head = best_trainable["head"]
        logit_scale = float(best_trainable["logit_scale"])
        self.model.load_state_dict(best_params)
        val_feats = extract_image_features(
            self.model, self._eval_loader(cfg.val_split, 256), self.mesh)
        test_feats = extract_image_features(
            self.model, self._eval_loader(cfg.test_split, 256), self.mesh)
        logger.info("Extracted val, test features for fast testing "
                    "after training.")

        loss = self._loss(cfg)
        test_acc, _, test_cm = validate_features(
            best_head, logit_scale, test_feats["image_features"],
            test_feats["labels"], cfg.num_classes, loss)
        scores = calculate_scores(test_cm)
        logger.info(f"+++++ Test Acc: {round(test_acc, 3)}")
        if self.main:
            save_test_scores(scores, test_cm, cfg.output_dir, "test", stage=1)

        # ---- tau normalization.  With --no_tau unset but --tau_norm off
        # the reference still stores a copy of the best head with
        # tau = 0.0 / acc = 0.0 in the bundle (main.py:29-32,73)
        best_tau_head, best_tau, best_tau_test_acc = None, -1, -1.0
        if not cfg.no_tau:
            if cfg.tau_norm:
                logger.info("Check Tau Normalization ......")
                best_tau_head, best_tau, best_tau_test_acc = (
                    self.run_tau_normalization(cfg, best_head, val_feats,
                                               test_feats, logit_scale))
            else:
                best_tau_head = best_head.clone()
                best_tau, best_tau_test_acc = 0.0, 0.0

        path = self._save_best_model(
            cfg.output_dir, 1, best_records=best.records,
            model_params=best_params, head=best_head,
            logit_scale=best_trainable["logit_scale"], test_acc=test_acc,
            best_tau=best_tau, best_tau_test_acc=best_tau_test_acc,
            wsft_test_acc=wsft_test_acc, best_tau_head=best_tau_head,
            wsft_backbone=wsft_backbone, wsft_head=wsft_head)
        logger.info(f"Stage 1 Best Model saved to: {path}")
        return test_acc, path, wsft_test_acc

    # ------------------------------------------------------------------
    # stage-2 probing (reference run_stage2_probing, main.py:402-474)

    def run_stage2_probing(self, stage1_path: str) -> Tuple[float, str]:
        """10 epochs of the head alone, from the stage-1 bundle, on the
        few-shot split's train-transform snapshot features, logit_scale
        back at ln 100 -> (test acc, the stage-2 bundle)."""
        cfg = self.cfg
        logger = self.logger
        logger.info("Run stage 2 classifier retraining ......")
        params, head, _, _ = self._load_ckpt(stage1_path)
        self._load_params(params)
        stage2 = dataclasses.replace(
            cfg, method="probing", pre_extracted=True, freeze_visual=True,
            epochs=10, early_stop=False, data_source="fewshot", accum=1)
        n_px = self.model_cfg.vision.image_size
        fingerprint = params_fingerprint(params)

        # the few-shot train features through the train transform, one
        # snapshot an image, extracted as the reference's
        # extract_train_dataloader does (main.py:413-415,
        # utils/dataloader.py:278-287): shuffled, drop-last, batch 128
        fs_smp = self._samples(cfg.fewshot_data)
        snap_mode = "eval" if cfg.aug_mode == "eval" else "train"
        train_feats = self._cached_extract(
            cfg, fingerprint,
            "fsprobe_trainaug" if snap_mode == "train" else "fsprobe_evalaug",
            lambda: TrainSnapshotLoader(fs_smp, 128, n_px, cfg.num_workers,
                                        seed=cfg.training_seed,
                                        shuffle_drop_bsz=128,
                                        mode=snap_mode, mesh=self.mesh),
            samples=fs_smp)
        test_smp = self._samples(cfg.test_split)
        test_feats = self._cached_extract(
            cfg, fingerprint, "test",
            lambda: EvalLoader(test_smp, 256, n_px, cfg.num_workers,
                               self.mesh),
            samples=test_smp)

        loss = self._loss(stage2)
        train_loader = FeatureBatches(
            train_feats["image_features"], train_feats["labels"],
            batch_size=stage2.bsz, shuffle=True, drop_last=True,
            seed=stage2.training_seed)
        # logit_scale is back at ln(100): the reference re-runs set_params
        # with method='probing' (main.py:429)
        state = create_train_state(
            self.model, head, "probing",
            lr_classifier=stage2.lr_classifier,
            lr_backbone=stage2.lr_backbone,
            total_iter=len(train_loader) * stage2.epochs, wd=stage2.wd,
            optim_type=stage2.optim, mesh=self.mesh)

        def validate_fn(state):
            return validate_features(
                state.head.detach(), state.logit_scale.item(),
                train_feats["image_features"], train_feats["labels"],
                stage2.num_classes, loss)

        def test_fn(state):
            acc, _, _ = validate_features(
                state.head.detach(), state.logit_scale.item(),
                test_feats["image_features"], test_feats["labels"],
                stage2.num_classes, loss)
            return acc

        _, best = train_loop(
            cfg=stage2, state=state, step_fn=make_probing_step(loss, True),
            sample_fn=make_sampler("probing"),
            train_batches=lambda: iter(train_loader),
            steps_per_epoch=len(train_loader), validate_fn=validate_fn,
            test_fn=test_fn, logger=logger, loss_logger=self.loss_logger,
            mesh=self.mesh)

        best_head = best.trainable["head"]
        best_scale = float(best.trainable["logit_scale"])
        test_acc, _, test_cm = validate_features(
            best_head, best_scale, test_feats["image_features"],
            test_feats["labels"], stage2.num_classes, loss)
        logger.info(f"+++++ stage 2 Test Acc: {round(test_acc, 3)}")
        if self.main:
            save_test_scores(calculate_scores(test_cm), test_cm,
                             cfg.output_dir, "test", stage=2)
        path = self._save_best_model(
            cfg.output_dir, 2, best_records=best.records,
            model_params=best.trainable["model"], head=best_head,
            logit_scale=best.trainable["logit_scale"], test_acc=test_acc)
        return test_acc, path

    # ------------------------------------------------------------------
    # stage-2 few-shot finetuning (reference run_stage2_FSFT,
    # main.py:478-540)

    def run_stage2_fsft(self, stage1_path: str) -> Tuple[float, str]:
        """10 epochs of finetune on the few-shot split, from the stage-1
        bundle (not from what probing or WiSE-FT left in the model) ->
        (test acc, the stage-3 bundle)."""
        cfg = self.cfg
        logger = self.logger
        logger.info("Run stage 2 few-shot finetuning ......")
        params, head, _, _ = self._load_ckpt(stage1_path)
        self._load_params(params)
        stage2 = dataclasses.replace(
            cfg, method="finetune", pre_extracted=False, freeze_visual=False,
            epochs=10, early_stop=False, save_ckpt=False,
            data_source="fewshot")
        _, best = self.train_method(stage2, head)
        self.model.load_state_dict(best.trainable["model"])
        best_head = best.trainable["head"]
        best_scale = float(best.trainable["logit_scale"])
        test_acc, _, test_cm = self._validate_images(
            self.model, best_head, best_scale, cfg.test_split,
            return_confusion=True)
        logger.info(f"+++++ Stage 2 FSFT Test Acc: {round(test_acc, 3)}")
        if self.main:
            save_test_scores(calculate_scores(test_cm), test_cm,
                             cfg.output_dir, "test", stage=3)
        path = self._save_best_model(
            cfg.output_dir, 3, best_records=best.records,
            model_params=best.trainable["model"], head=best_head,
            logit_scale=best.trainable["logit_scale"], test_acc=test_acc)
        return test_acc, path

    # ------------------------------------------------------------------
    # ImageNet OOD sweep (reference main.py:599-602, testing.py:22-72)

    def run_ood(self, model_path: Optional[str] = None) -> Dict[str, float]:
        """The 4-dataset OOD sweep (``swat_tpu``'s ``run_ood``).  The
        reference passes the live model after run_stage2_FSFT
        (main.py:599-602), which by then holds the stage-2 FSFT weights, so
        callers pass the most downstream stage bundle that ran (FSFT > LP >
        stage 1); without one, the pretrained weights and the prompt head."""
        head = self.zeroshot_head
        if model_path:
            params, head, _, _ = self._load_ckpt(model_path)
            self._load_params(params)
        else:
            self.model.load_state_dict(self.zeroshot_state)

        def make_loader(samples):
            return EvalLoader(samples, batch_size=256,
                              n_px=self.model_cfg.vision.image_size,
                              num_workers=self.cfg.num_workers,
                              mesh=self.mesh)

        return test_imagenet_ood(
            self.evaluator, self.model, head, None, self.cfg.dataset_path,
            make_loader, self.logger)

    # ------------------------------------------------------------------
    # full run (reference __main__, main.py:544-606)

    def _check_runnable(self) -> None:
        """Raise before any work for a run that cannot run."""
        cfg = self.cfg
        if cfg.method == "zeroshot" or cfg.zeroshot_only:
            return
        if (not cfg.skip_stage1 and cfg.loss_name == "WeightedCE"
                and cfg.method in ("CMLP", "dataset-cls")):
            # swat_tpu fails inside its first step there (ROADMAP Queue C)
            raise ValueError(
                f"--method {cfg.method} cannot take --loss_name WeightedCE: "
                "its loss gets no source flag to weight by")

    def run(self) -> str:
        self._check_runnable()
        rank = dist.get_rank() if dist.is_initialized() else 0
        with maybe_trace(self.cfg.trace_dir, self.device, rank):
            return self._run_impl()

    def _run_impl(self) -> str:
        cfg = self.cfg
        logger = self.logger
        start = time.time()
        t0 = time.perf_counter()
        stage1_acc, stage1_path, wsft_acc = self.run_stage1()
        if cfg.zeroshot_only or cfg.method == "zeroshot":
            return ""
        if cfg.method == "dataset-cls":
            # the reference exits right after train_dataset_cls
            # (main.py:329-330): no stage 2 and no summary row
            logger.info("dataset-cls run complete (no summary row; "
                        "reference exits after training).")
            return ""
        logger.info(f"Stage 1 wall time: {time.perf_counter() - t0:.3f} s")
        stage2_lp_acc = stage2_fsft_acc = -1.0
        ood_path = stage1_path
        if not cfg.skip_stage2 and stage1_path:
            t0 = time.perf_counter()
            stage2_lp_acc, lp_path = self.run_stage2_probing(stage1_path)
            logger.info("Stage 2 probing wall time: "
                        f"{time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            stage2_fsft_acc, fsft_path = self.run_stage2_fsft(stage1_path)
            logger.info("Stage 2 FSFT wall time: "
                        f"{time.perf_counter() - t0:.3f} s")
            ood_path = fsft_path or lp_path or stage1_path
        else:
            logger.info("Skip stage 2.")
        logger.info(
            f"Total time: {round((time.time() - start) / 60, 1)} mins.")
        if cfg.test_imagenet_ood:
            logger.info("Test ImageNet OOD ......")
            self.run_ood(ood_path)
        summary = (f"{cfg.dataset},{cfg.method},{cfg.data_source},"
                   f"{cfg.cls_init},{cfg.shots},{cfg.seed},"
                   f"{cfg.retrieval_split},{round(stage1_acc, 1)},"
                   f"{round(wsft_acc, 1)},{round(stage2_lp_acc, 1)},"
                   f"{round(stage2_fsft_acc, 1)}")
        logger.info(summary)
        if self.main:
            print(summary)
        return summary


def flatten_prompt_bank(prompt_tensors) -> Tuple[np.ndarray, np.ndarray]:
    """Every prompt embedding and its class label, the classes in integer
    order (reference TextTensorDataset,
    utils/datasets/dataset_utils.py:258-279; ``swat_tpu``'s
    ``_flatten_prompt_bank``)."""
    feats, labels = [], []
    for cid in sorted(prompt_tensors, key=int):
        f = np.asarray(prompt_tensors[cid]["all"])
        feats.append(f)
        labels.append(np.full(f.shape[0], int(cid), np.int32))
    return np.concatenate(feats, 0), np.concatenate(labels, 0)
