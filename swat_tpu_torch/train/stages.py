"""Stage orchestration: zero-shot and stage 1 (counterpart of
``swat_tpu/train/stages.py:131-385,390-788,903-1050,1206-1255``).

``SwatPipeline`` builds the towers from an OpenCLIP checkpoint, encodes the
class prompts with the text tower and makes the zero-shot head from the
prompt means.  ``--method zeroshot`` validates the test split and prints
the reference's zero-shot summary line.  ``--method cutmix`` / ``finetune``
run stage 1: the finetune epochs (streaming or resident), WiSE-FT, feature
re-extraction with the best weights, test scores, tau-normalization and the
stage-1 bundle, then the 11-field summary line with the stage-2 fields at
-1.0 (``--skip_stage2``).  Stage 2, the other methods and the other stage
options raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from swat_tpu.data import prompts as P
from swat_tpu.data.splits import class_counts, read_split
from swat_tpu.utils.logging import set_logger
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from swat_tpu_torch.data.features import (encode_prompts,
                                          extract_image_features,
                                          make_text_encoder)
from swat_tpu_torch.data.pipeline import EvalLoader, TrainLoader
from swat_tpu_torch.data.transforms import CANVAS_SIZE
from swat_tpu_torch.eval.metrics import calculate_scores
from swat_tpu_torch.eval.resident import ResidentEval, make_scan_eval
from swat_tpu_torch.eval.validate import Evaluator, validate_features
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.models.head import (init_head_from_prompts,
                                        init_head_random, tau_normalize,
                                        wise_ft_head, wise_ft_params)
from swat_tpu_torch.models.loader import load_torch_checkpoint
from swat_tpu_torch.models.tokenizer import get_tokenizer
from swat_tpu_torch.train.checkpoint import save_best_model, save_test_scores
from swat_tpu_torch.train.losses import set_loss
from swat_tpu_torch.train.resident import (ResidentData, epoch_permutation,
                                           make_resident_epoch)
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import (MIX_METHODS, make_ce_step,
                                        make_mixing_step, make_sampler)
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
        if cfg.model_path:
            raise _not_ported("--model_path warm starts", "Queue A item 4")
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
        # the pretrained weights, kept for WiSE-FT before training moves
        # the model (taken in run_stage1)
        self.zeroshot_state: Optional[Dict[str, torch.Tensor]] = None

        self.evaluator = Evaluator(cfg.num_classes, loss=self._loss(),
                                   device=self.device)
        self._resident_eval_cache: Dict[str, Optional[ResidentEval]] = {}
        self._scan_eval = None

    # ------------------------------------------------------------------
    # helpers

    def _loss(self):
        cfg = self.cfg
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
        """The finetune epochs of ``cfg.method`` (cutmix or finetune) from
        the model's current weights and ``head`` -> (final state,
        BestSnapshot)."""
        method = cfg.method
        logger = self.logger
        loss = self._loss()
        image_size = self.model_cfg.vision.image_size
        samples = self._samples(cfg.train_split)
        train_loader = TrainLoader(
            samples, batch_size=cfg.bsz, seed=cfg.training_seed,
            mode=cfg.aug_mode, n_px=image_size, num_workers=cfg.num_workers)

        # the resident path: the split's uint8 canvases on the device
        resident_data = None
        if cfg.resident != "off" and cfg.aug_mode == "canvas":
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

        def make_step(aug_dtype):
            if method == "finetune":
                return make_ce_step(loss, image_size, aug_dtype)
            return make_mixing_step(method, loss, image_size=image_size,
                                    aug_dtype=aug_dtype)

        sample = make_sampler(method, cutmix_beta=cfg.cutmix_beta,
                              mix_prob=cfg.mix_prob, image_size=image_size)

        def validate_fn(state):
            return self._validate_images(
                state.model, state.head.detach(), state.logit_scale.item(),
                cfg.val_split, return_confusion=True)

        def test_fn(state):
            acc, _, _ = self._validate_images(
                state.model, state.head.detach(), state.logit_scale.item(),
                cfg.test_split)
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
            epoch_runner=epoch_runner)

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
        loss = self._loss()
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

        self.zeroshot_state = {k: v.detach().clone()
                               for k, v in self.model.state_dict().items()}
        _, best = self.train_method(cfg, self.zeroshot_head)
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

        loss = self._loss()
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
    # full run (reference __main__, main.py:544-606)

    def _check_ported(self) -> None:
        """Raise before any work for the parts of a run that are not
        ported yet."""
        cfg = self.cfg
        if cfg.method == "zeroshot" or cfg.zeroshot_only:
            return
        if cfg.skip_stage1:
            raise _not_ported("--skip_stage1 (stage-2 from a stage-1 bundle)",
                              "Queue A item 4")
        if cfg.method not in MIX_METHODS:
            raise _not_ported(f"--method {cfg.method} training",
                              "Queue A item 6")
        if cfg.utrain:
            raise _not_ported("--utrain pseudo-labeled data",
                              "Queue A item 6")
        if cfg.accum > 1 or cfg.remat:
            raise _not_ported("--accum > 1 and --remat in training",
                              "Queue A item 6")
        if cfg.save_ckpt or cfg.resume:
            raise _not_ported("--save_ckpt / --resume", "Queue A item 4")
        if not cfg.skip_stage2:
            raise _not_ported("stage 2 (probing and few-shot finetuning); "
                              "pass --skip_stage2", "Queue A item 4")
        if cfg.test_imagenet_ood:
            raise _not_ported("--test_imagenet_ood", "Queue A item 8")

    def run(self) -> str:
        self._check_ported()
        cfg = self.cfg
        start = time.time()
        stage1_acc, _, wsft_acc = self.run_stage1()
        if cfg.zeroshot_only or cfg.method == "zeroshot":
            return ""
        self.logger.info("Skip stage 2.")
        self.logger.info(
            f"Total time: {round((time.time() - start) / 60, 1)} mins.")
        stage2_lp_acc = stage2_fsft_acc = -1.0
        summary = (f"{cfg.dataset},{cfg.method},{cfg.data_source},"
                   f"{cfg.cls_init},{cfg.shots},{cfg.seed},"
                   f"{cfg.retrieval_split},{round(stage1_acc, 1)},"
                   f"{round(wsft_acc, 1)},{round(stage2_lp_acc, 1)},"
                   f"{round(stage2_fsft_acc, 1)}")
        self.logger.info(summary)
        print(summary)
        return summary
