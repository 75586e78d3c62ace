"""Entry kind ``train_resident_resnet``: ``train_resident``'s job, SWAT's
stage-1 training on a resident train split, on a CLIP model with OpenAI's
modified ResNet image tower (RN50).

``Rows``, ``Program``, ``step`` and ``reference_inputs`` are
``train_resident``'s own.  Written here: ``build``, which builds the
program as ``train_resident.build`` does but from a ``ResNetConfig`` and
``portbench.weights_resnet``'s weights; ``first_steps`` and ``compare``,
``train_resident``'s with the BatchNorm running statistics besides: the
checked steps' change of each (the port folds them in the optimizer
update) against the reference's, channel by channel, as
``running_stats_gap``;
``follow_reference``, which follows the checked steps with
``reference/resnet.py``; and ``run``, a copy of ``train_resident.run``'s
set-up, window and traced stretches whose checked steps must advance the
program's count of batch-statistics BatchNorm calls
(``models/resnet.py::BN_BATCH_STATS``) by exactly one BatchNorm a
convolution a step, and whose facts give the convolutions' batch instead
of an attention shape.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import flops_resnet, harness, pools, weights, weights_resnet
from portbench.reference import resnet as ref_resnet
from portbench.reference.resnet import BNReadings
from portbench.reference.vit import Rounding

_base = harness.entry("train_resident")
Rows = _base.Rows
Program = _base.Program
step = _base.step
reference_inputs = _base.reference_inputs
TRACE_DRAWS_SEED = _base.TRACE_DRAWS_SEED
RUNNING_GAP = "running_stats_gap"


def clip_config(cfg: dict):
    """The program's ``CLIPConfig`` for a ResNet configuration file."""
    from swat_tpu_torch.models.configs import (CLIPConfig, ResNetConfig,
                                               TextConfig)

    v, t = cfg["vision_cfg"], cfg["text_cfg"]
    quick = cfg["quick_gelu"]
    return CLIPConfig(
        name=cfg["name"],
        vision=ResNetConfig(
            image_size=v["image_size"], width=v["width"],
            layers=tuple(v["layers"]),
            embed_dim=cfg["embed_dim"],
            heads=v["width"] * 32 // cfg["assumed"]["vision_head_width"],
            quick_gelu=quick),
        text=TextConfig(
            context_length=t["context_length"], vocab_size=t["vocab_size"],
            width=t["width"], layers=t["layers"], heads=t["heads"],
            embed_dim=cfg["embed_dim"], quick_gelu=quick))


def bn_batch_stats() -> int:
    """The program's count of train-mode BatchNorm calls."""
    from swat_tpu_torch.models import resnet

    if not hasattr(resnet, "BN_BATCH_STATS"):
        raise RuntimeError("the program keeps no BN_BATCH_STATS count in "
                           "models/resnet.py; this entry reads it")
    return resnet.BN_BATCH_STATS


def build(cell: harness.Cell, seed: int, device: torch.device) -> Program:
    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.train.losses import cross_entropy
    from swat_tpu_torch.train.resident import ResidentData, make_resident_epoch
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import make_mixing_step, make_sampler

    cfg, tr = cell.config, cell.traffic
    if tr["method"] != "cutmix":
        raise ValueError(f"the reference trains cutmix, not {tr['method']!r}")
    policy = harness.precision(tr["precision"])
    policy.apply_backend_flags()
    s = pools.streams(seed)
    with torch.device(device):
        model = CLIPModel(clip_config(cfg), precision=policy)
    model.load_state_dict(weights_resnet.make_weights(cfg, s.weights, device),
                          strict=True)
    pool = tr["pool"]
    head = weights.make_head(pool["classes"], cfg["embed_dim"], s.head, device)
    valid_hw, labels, source = pools.train_layout(pool, s.layout)
    canvases = pools.train_canvases(valid_hw, labels, pool["canvas"],
                                    s.pixels, device)
    data = ResidentData(canvases, valid_hw,
                        torch.from_numpy(labels).to(device),
                        torch.from_numpy(source).to(device))
    bsz, opt = tr["bsz"], tr["optimizer"]
    total_iter = (data.n // bsz) * opt["epochs"]
    state = create_train_state(
        model, head, tr["method"], lr_classifier=opt["lr_classifier"],
        lr_backbone=opt["lr_backbone"], total_iter=total_iter, wd=opt["wd"])
    size = cfg["vision_cfg"]["image_size"]
    run = make_resident_epoch(
        make_mixing_step(tr["method"], cross_entropy, image_size=size,
                         aug_dtype=policy.compute_dtype),
        make_sampler(tr["method"], mix_prob=tr["mix_prob"],
                     cutmix_beta=tr["cutmix_beta"], image_size=size))
    names = {id(p): n for n, p in model.named_parameters()}
    names[id(state.head)] = "head"
    names[id(state.logit_scale)] = "logit_scale"
    return Program(state, data, run, Rows(s.order, data.n, bsz),
                   np.random.default_rng(s.draws), names, total_iter)


def _running(prog: Program) -> Dict[str, torch.Tensor]:
    """A copy of the tower's BatchNorm running statistics, by name."""
    return {name: b.detach().clone()
            for name, b in prog.state.model.named_buffers()
            if name.endswith(ref_resnet.RUNNING)}


def first_steps(prog: Program, n: int
                ) -> Tuple[BNReadings, List[np.ndarray]]:
    """``train_resident.first_steps``, and the change of each running
    statistic over the checked steps."""
    start = _running(prog)
    readings, rows = _base.first_steps(prog, n)
    moved = {k: (b - start[k]).float().cpu()
             for k, b in _running(prog).items()}
    return BNReadings(readings.losses, readings.grad_norms,
                      readings.change_norms, moved), rows


def running_gaps(prog: BNReadings, ref: BNReadings) -> Dict[str, float]:
    """{running statistic: the norm of the program's change less the
    reference's, over the larger of the reference change's norm and the
    median one}; a statistic left unchanged reads at most 1."""
    odd = set(prog.running_change) ^ set(ref.running_change)
    if odd:
        raise ValueError("the program keeps other running statistics than "
                         f"the reference: {sorted(odd)}")
    size = {k: float(torch.linalg.vector_norm(r))
            for k, r in ref.running_change.items()}
    med = statistics.median(size.values())
    return {k: float(torch.linalg.vector_norm(prog.running_change[k] - r))
            / max(size[k], med) for k, r in ref.running_change.items()}


def compare(prog: BNReadings, ref: BNReadings,
            limits: dict) -> Dict[str, Tuple[float, float]]:
    """``train_resident.compare``'s numbers, and ``running_stats_gap``:
    the worst of ``running_gaps``, the running statistics' changes over
    the checked steps held as vectors, channel by channel, so that an
    error that keeps a change's norm shows too.  Running statistics left
    unchanged read 1.  Limits without the number (``calibrate.py``'s,
    which limit nothing) leave it unlimited."""
    checks = _base.compare(prog, ref, limits)
    gap = max(running_gaps(prog, ref).values())
    checks[RUNNING_GAP] = (gap, limits.get(RUNNING_GAP, math.inf))
    return checks


def follow_reference(cell: harness.Cell, seed: int, inputs, total_iter: int,
                     device: torch.device,
                     rounding: Rounding = Rounding()) -> BNReadings:
    s = pools.streams(seed)
    w = weights_resnet.make_weights(cell.config, s.weights, device)
    head = weights.make_head(cell.traffic["pool"]["classes"],
                             cell.config["embed_dim"], s.head, device)
    return ref_resnet.follow(cell.config, cell.traffic, w, head, *inputs,
                             np.random.default_rng(s.draws), total_iter,
                             rounding)


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, started: float) -> harness.Outcome:
    tr = cell.traffic
    counted = bn_batch_stats()
    prog = build(cell, seed, device)
    readings, rows = first_steps(prog, tr["checked_steps"])
    expected = flops_resnet.batch_norms(cell.config) * tr["checked_steps"]
    if bn_batch_stats() - counted != expected:
        raise RuntimeError(
            f"the checked steps made {bn_batch_stats() - counted} "
            f"batch-statistics BatchNorm calls, not {expected}")
    for _ in range(tr["warmup_steps"]):
        step(prog)
    torch.cuda.synchronize()
    setup_s = time.time() - started
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    marks = harness.Marks()
    losses = []
    marks.mark()
    t0 = time.perf_counter()
    while True:
        losses.append(step(prog))
        marks.mark()
        if time.perf_counter() - t0 >= seconds:
            break
    step_ms = marks.intervals_ms()
    window_peak = torch.cuda.max_memory_allocated()
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    bsz = tr["bsz"]
    images_per_s = len(step_ms) * bsz / (sum(step_ms) / 1e3)
    end_to_end = {
        "train_images_per_s": images_per_s,
        "train_step_ms_p95": float(np.percentile(step_ms, 95)),
        "peak_mem_gib": window_peak / 2 ** 30,
        "setup_s": setup_s,
    }
    stretches = None
    if traced:
        draws = np.random.default_rng(TRACE_DRAWS_SEED)
        stretches = harness.profiled(lambda: step(prog, draws),
                                     tr["trace_steps"], "portbench.step")

    inputs = reference_inputs(prog, rows)
    total_iter = prog.total_iter
    del prog, losses
    gc.collect()
    torch.cuda.empty_cache()
    ref = follow_reference(cell, seed, inputs, total_iter, device)
    facts = {"images_per_s": images_per_s,
             "step_ms_p5": float(np.percentile(step_ms, 5)),
             "flops_per_image": flops_resnet.train_flops_per_image(
                 cell.config),
             "dtype": tr["precision"],
             "batch": bsz}
    return harness.Outcome(len(step_ms), failed, end_to_end,
                           compare(readings, ref, cell.limits),
                           max(setup_peak, window_peak), stretches, facts)
