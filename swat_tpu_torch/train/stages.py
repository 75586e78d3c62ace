"""Stage orchestration: zero-shot, stage 1 and stage 2 (counterpart of
``swat_tpu/train/stages.py:131-455,520-788,903-1177,1206-1255``).

``SwatPipeline`` builds the towers from an OpenCLIP checkpoint, encodes the
class prompts with the text tower and makes the zero-shot head from the
prompt means.  ``--method zeroshot`` validates the test split and prints
the reference's zero-shot summary line.  ``--method finetune``, the
single-loader mixes (cutmix, mixup, resizemix, saliencymix, attentivemix)
and linear probing (on pre-extracted features or streamed) run stage 1:
the epochs (streaming or resident), WiSE-FT, feature re-extraction with
the best weights, test scores, tau-normalization and the stage-1 bundle.
Stage 2 starts from that bundle (or from ``--stage1_model_path`` with
``--skip_stage1``): probing on the few-shot train-transform snapshot's
features, then few-shot finetuning; the 11-field summary line follows.  ``--model_path`` warm-starts stage 1,
``--save_ckpt`` / ``--resume`` write and restore train checkpoints.  The
other methods and options raise NotImplementedError naming their ROADMAP
item.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from swat_tpu_torch.data import prompts as P
from swat_tpu_torch.data.splits import class_counts, read_split
from swat_tpu_torch.utils.logging import set_logger
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from swat_tpu_torch.data.features import (encode_prompts,
                                          extract_image_features,
                                          extract_or_load,
                                          feature_cache_path,
                                          make_text_encoder,
                                          params_fingerprint)
from swat_tpu_torch.data.pipeline import (EvalLoader, FeatureBatches,
                                          TrainLoader, TrainSnapshotLoader)
from swat_tpu_torch.data.transforms import CANVAS_SIZE
from swat_tpu_torch.eval.heatmap import (clip_attention_heatmap,
                                         clip_text_heatmap)
from swat_tpu_torch.eval.metrics import calculate_scores
from swat_tpu_torch.eval.resident import ResidentEval, make_scan_eval
from swat_tpu_torch.eval.validate import Evaluator, validate_features
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.models.head import (init_head_from_prompts,
                                        init_head_random, tau_normalize,
                                        wise_ft_head, wise_ft_params)
from swat_tpu_torch.models.loader import (jax_params_from_state_dict,
                                          load_torch_checkpoint,
                                          state_dict_from_jax_params)
from swat_tpu_torch.models.tokenizer import get_tokenizer
from swat_tpu_torch.train.checkpoint import (load_best_model,
                                             save_best_model,
                                             save_test_scores)
from swat_tpu_torch.train.losses import set_loss
from swat_tpu_torch.train.resident import (ResidentData, epoch_permutation,
                                           make_resident_epoch)
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import (RESIDENT_METHODS, STEP_METHODS,
                                        make_ce_step, make_mixing_step,
                                        make_probing_step, make_sampler)
from swat_tpu_torch.train.trainer import train_loop


def resolve_device(name: str) -> torch.device:
    """The run's device; 'cuda' without a usable GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda requested but no CUDA device is available; pass "
            "--device cpu to run the plain PyTorch path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return device


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to swat_tpu_torch yet (see ROADMAP, {item}); "
        "run it with swat_tpu")


class SwatPipeline:
    """Holds the model, prompts, head and eval engines for one run."""

    def __init__(self, cfg: RunConfig):
        self.cfg = cfg.derived()
        cfg = self.cfg
        if cfg.mesh_data not in (1, -1) or cfg.mesh_model not in (1, -1):
            raise _not_ported("a device mesh (--mesh_data/--mesh_model)",
                              "Queue A item 10")
        if cfg.trace_dir:
            raise _not_ported("--trace_dir", "Queue A item 11")
        self.device = resolve_device(cfg.device)
        self.logger, self.loss_logger = set_logger(cfg)
        logger = self.logger

        self.model_cfg = get_model_config(cfg.model_cfg)
        self.precision = (FP32_PRECISION if cfg.compute_dtype == "float32"
                          else DEFAULT_PRECISION)
        self.precision.apply_backend_flags()
        self.model = CLIPModel(self.model_cfg, precision=self.precision)

        # ---- pretrained weights (reference set_model, utils/models.py:11)
        if cfg.checkpoint_path:
            state_dict, _ = load_torch_checkpoint(cfg.checkpoint_path)
            self.model.load_state_dict(state_dict)
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

        # ---- classifier head (reference set_classifier,
        # utils/models.py:22-43)
        if cfg.method == "dataset-cls":
            raise _not_ported("--method dataset-cls", "Queue A item 6")
        if cfg.cls_init in ("REAL-Prompt", "REAL-Linear", "text"):
            head = init_head_from_prompts(
                P.class_embedding_matrix(self.prompt_tensors), self.device)
            logger.info("Initialized classifier head with text embedding. "
                        f"weights.shape: {tuple(head.shape)}")
        elif cfg.cls_init == "random":
            head = init_head_random(
                torch.Generator().manual_seed(cfg.training_seed),
                cfg.num_classes, self.model_cfg.embed_dim, self.device)
        else:
            raise NotImplementedError(cfg.cls_init)
        self.zeroshot_head = head

        self.evaluator = Evaluator(cfg.num_classes, loss=self._loss(),
                                   device=self.device)
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
        cfg = self.cfg
        metrics = P.load_class_metrics(cfg.metrics_file)
        self.logger.info(f"Loaded metrics from: {cfg.metrics_file}")
        text_prompts = P.make_prompts(metrics, cfg.dataset, cfg.prompt_name)
        tokenized = P.tokenize_prompts(
            text_prompts, self.tokenizer,
            self.model_cfg.text.context_length)
        # the JAX package's cache path: the two packages read each other's
        # prompt tensors unless --recal_prompt
        cache = os.path.join(
            cfg.dataset_root, "prompts",
            f"{cfg.dataset}_{cfg.model_cfg}_{cfg.prompt_name}"
            "_prompt_tensors.npz")
        if not cfg.recal_prompt and os.path.exists(cache):
            tensors = P.load_prompt_tensors(cache)
            self.logger.info(f"Loaded prompt tensors from {cache}")
        else:
            tensors = encode_prompts(make_text_encoder(self.model), tokenized)
            P.save_prompt_tensors(cache, tensors)
            self.logger.info(f"Saved prompt tensors to {cache}")
        return tensors

    def _samples(self, split):
        return read_split(self.cfg.dataset_root, split)

    def _eval_loader(self, split, bsz: int = 128):
        return EvalLoader(self._samples(split), batch_size=bsz,
                          n_px=self.model_cfg.vision.image_size,
                          num_workers=self.cfg.num_workers)

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
                                       num_workers=cfg.num_workers)
        if self._scan_eval is None:
            self._scan_eval = make_scan_eval(cfg.num_classes,
                                             loss=self._loss())
        self._resident_eval_cache[tag] = ev
        return ev

    def _validate_images(self, model, head, logit_scale, split,
                         return_confusion=False):
        ev = self._resident_eval_for(split)
        if ev is not None:
            acc, loss, cm = self._scan_eval(model, head, logit_scale, ev)
            return acc, loss, (cm if return_confusion else None)
        return self.evaluator.validate(
            model, head, logit_scale, self._eval_loader(split),
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
            feats = extract_image_features(self.model, loader_fn())
            secs = time.perf_counter() - t0
            n = len(feats["labels"])
            self.logger.info(
                f"Extracted {split_tag} features: {n} images in {secs:.3f} s "
                f"({n / max(secs, 1e-9):.1f} images/s, decode included, "
                f"{self.device})")
            return feats

        return extract_or_load(path, cfg.recal_fea, extract,
                               logger=self.logger)

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
        """Loads a JAX param tree into the shared model (its own, unused
        logit_scale kept)."""
        self.model.load_state_dict(state_dict_from_jax_params(
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
        """The epochs of ``cfg.method`` (finetune, a single-loader mix or
        a probe) from the model's current weights and ``head`` -> (final
        state, BestSnapshot)."""
        method = cfg.method
        logger = self.logger
        loss = self._loss(cfg)
        image_size = self.model_cfg.vision.image_size
        samples = self._samples(cfg.train_split)
        frozen = method == "probing"

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
                        seed=cfg.training_seed, mode=snap_mode),
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
                    num_workers=cfg.num_workers)
            feats = {}
            for tag, split in (("val", cfg.val_split),
                               ("test", cfg.test_split)):
                smp = self._samples(split)
                feats[tag] = self._cached_extract(
                    cfg, fingerprint, tag,
                    lambda smp=smp: EvalLoader(smp, 256, image_size,
                                               cfg.num_workers),
                    samples=smp)
        else:
            train_loader = TrainLoader(
                samples, batch_size=cfg.bsz, seed=cfg.training_seed,
                mode=cfg.aug_mode, n_px=image_size,
                num_workers=cfg.num_workers)

        # the resident path: the split's uint8 canvases on the device
        resident_data = None
        if (cfg.resident != "off" and cfg.aug_mode == "canvas"
                and method in RESIDENT_METHODS):
            est = len(samples) * CANVAS_SIZE * CANVAS_SIZE * 3
            if cfg.resident == "on" or est <= cfg.resident_budget_bytes:
                resident_data = ResidentData.from_samples(
                    samples, self.device, num_workers=cfg.num_workers)
                logger.info(f"Resident train data: {len(samples)} canvases "
                            f"({est / 1e9:.2f} GB) on device; resident "
                            "epochs.")

        steps_per_epoch = len(train_loader)
        total_iter = steps_per_epoch * max(cfg.epochs, 1)
        state = create_train_state(
            self.model, head, method, lr_classifier=cfg.lr_classifier,
            lr_backbone=cfg.lr_backbone, total_iter=total_iter, wd=cfg.wd,
            optim_type=cfg.optim, temperature=cfg.temperature)

        heatmap_fn = (self._heatmap_fn() if method == "attentivemix"
                      else None)

        def make_step(aug_dtype):
            if frozen:
                return make_probing_step(loss, cfg.pre_extracted, image_size)
            if method == "finetune":
                return make_ce_step(loss, image_size, aug_dtype)
            return make_mixing_step(method, loss, heatmap_fn=heatmap_fn,
                                    image_size=image_size,
                                    aug_dtype=aug_dtype)

        sample = make_sampler("probing" if frozen else method,
                              mixup_alpha=cfg.mixup_alpha,
                              cutmix_beta=cfg.cutmix_beta,
                              mix_prob=cfg.mix_prob, image_size=image_size)

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
        else:
            def validate_fn(state):
                return self._validate_images(
                    state.model, state.head.detach(),
                    state.logit_scale.item(), cfg.val_split,
                    return_confusion=True)

            def test_fn(state):
                acc, _, _ = self._validate_images(
                    state.model, state.head.detach(),
                    state.logit_scale.item(), cfg.test_split)
                return acc

        epoch_runner = None
        if resident_data is not None:
            # the resample follows the compute policy here, as in the JAX
            # package's resident epoch: bf16 under bf16, fp32 otherwise
            run_epoch = make_resident_epoch(
                make_step(self.precision.compute_dtype), sample)
            perm_rng = np.random.default_rng(cfg.training_seed)

            def epoch_runner(state, epoch, rng):
                perm = epoch_permutation(perm_rng, resident_data.n, cfg.bsz)
                return run_epoch(state, resident_data, perm, rng)

        return train_loop(
            cfg=cfg, state=state, step_fn=make_step(torch.float32),
            sample_fn=sample, train_batches=lambda: iter(train_loader),
            steps_per_epoch=steps_per_epoch, validate_fn=validate_fn,
            test_fn=test_fn, logger=logger, loss_logger=self.loss_logger,
            epoch_runner=epoch_runner,
            ckpt_dir=os.path.join(cfg.output_dir, "model_ckpts"))

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
        tensors = encode_prompts(make_text_encoder(self.model), tokenized)
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
            print(summary)
            return zs_acc, None, -1.0

        if cfg.skip_stage1:
            logger.info("Skip stage 1 finetuning.")
            return -1.0, cfg.stage1_model_path, -1.0

        _, best = self.train_method(cfg, head)
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
            self.model, self._eval_loader(cfg.val_split, 256))
        test_feats = extract_image_features(
            self.model, self._eval_loader(cfg.test_split, 256))
        logger.info("Extracted val, test features for fast testing "
                    "after training.")

        loss = self._loss(cfg)
        test_acc, _, test_cm = validate_features(
            best_head, logit_scale, test_feats["image_features"],
            test_feats["labels"], cfg.num_classes, loss)
        scores = calculate_scores(test_cm)
        logger.info(f"+++++ Test Acc: {round(test_acc, 3)}")
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

        path = save_best_model(
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
                                        mode=snap_mode),
            samples=fs_smp)
        test_smp = self._samples(cfg.test_split)
        test_feats = self._cached_extract(
            cfg, fingerprint, "test",
            lambda: EvalLoader(test_smp, 256, n_px, cfg.num_workers),
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
            optim_type=stage2.optim)

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
            test_fn=test_fn, logger=logger, loss_logger=self.loss_logger)

        best_head = best.trainable["head"]
        best_scale = float(best.trainable["logit_scale"])
        test_acc, _, test_cm = validate_features(
            best_head, best_scale, test_feats["image_features"],
            test_feats["labels"], stage2.num_classes, loss)
        logger.info(f"+++++ stage 2 Test Acc: {round(test_acc, 3)}")
        save_test_scores(calculate_scores(test_cm), test_cm, cfg.output_dir,
                         "test", stage=2)
        path = save_best_model(
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
        save_test_scores(calculate_scores(test_cm), test_cm, cfg.output_dir,
                         "test", stage=3)
        path = save_best_model(
            cfg.output_dir, 3, best_records=best.records,
            model_params=best.trainable["model"], head=best_head,
            logit_scale=best.trainable["logit_scale"], test_acc=test_acc)
        return test_acc, path

    # ------------------------------------------------------------------
    # full run (reference __main__, main.py:544-606)

    def _check_ported(self) -> None:
        """Raise before any work for the parts of a run that are not
        ported yet."""
        cfg = self.cfg
        if cfg.method == "zeroshot" or cfg.zeroshot_only:
            return
        if not cfg.skip_stage1 and cfg.method not in STEP_METHODS:
            raise _not_ported(f"--method {cfg.method} training",
                              "Queue A item 6")
        if cfg.utrain:
            raise _not_ported("--utrain pseudo-labeled data",
                              "Queue A item 6")
        if cfg.accum > 1 or cfg.remat:
            raise _not_ported("--accum > 1 and --remat in training",
                              "Queue A item 6")
        if cfg.test_imagenet_ood:
            raise _not_ported("--test_imagenet_ood", "Queue A item 8")

    def run(self) -> str:
        self._check_ported()
        cfg = self.cfg
        logger = self.logger
        start = time.time()
        t0 = time.perf_counter()
        stage1_acc, stage1_path, wsft_acc = self.run_stage1()
        if cfg.zeroshot_only or cfg.method == "zeroshot":
            return ""
        logger.info(f"Stage 1 wall time: {time.perf_counter() - t0:.3f} s")
        stage2_lp_acc = stage2_fsft_acc = -1.0
        if not cfg.skip_stage2 and stage1_path:
            t0 = time.perf_counter()
            stage2_lp_acc, _ = self.run_stage2_probing(stage1_path)
            logger.info("Stage 2 probing wall time: "
                        f"{time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            stage2_fsft_acc, _ = self.run_stage2_fsft(stage1_path)
            logger.info("Stage 2 FSFT wall time: "
                        f"{time.perf_counter() - t0:.3f} s")
        else:
            logger.info("Skip stage 2.")
        logger.info(
            f"Total time: {round((time.time() - start) / 60, 1)} mins.")
        summary = (f"{cfg.dataset},{cfg.method},{cfg.data_source},"
                   f"{cfg.cls_init},{cfg.shots},{cfg.seed},"
                   f"{cfg.retrieval_split},{round(stage1_acc, 1)},"
                   f"{round(wsft_acc, 1)},{round(stage2_lp_acc, 1)},"
                   f"{round(stage2_fsft_acc, 1)}")
        logger.info(summary)
        print(summary)
        return summary
