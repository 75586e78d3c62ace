"""Entry kind ``train_resident``: SWAT's stage-1 training on a resident
train split, through the port's epoch function one step a call.

Set-up builds the model on the device, loads the seed's weights
(``portbench.weights``), makes the resident pool of uint8 canvases
(``portbench.pools``), the train state (AdamW) and
``train.resident.make_resident_epoch(make_mixing_step(method),
make_sampler(method))``, as the port's CLI builds them for a resident
epoch.  Every step is ``run(state, data, perm[i:i + 1], draws)`` over the
rows of ``epoch_permutation``.  The first ``checked_steps`` steps are read
for the comparison (their losses, the first gradient from AdamW's state,
the trained leaves' change), then ``warmup_steps`` more settle the
allocator, then the window: CUDA events at every step boundary and no host
sync until it ends.  A traced run adds two profiled stretches of
``trace_steps`` steps (``harness.profiled``), each step in a
``portbench.step`` span.  Then the
program is freed and the plain reference follows the checked steps.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import flops, harness, pools, weights
from portbench.reference import train as ref_train
from portbench.reference.vit import Rounding

# the profiled stretch draws its crops and gates from this fixed seed, so
# its launches a step repeat from run to run
TRACE_DRAWS_SEED = 0


class Rows:
    """Batches of rows in the order of successive epoch permutations."""

    def __init__(self, seq: np.random.SeedSequence, n: int, bsz: int):
        from swat_tpu_torch.train.resident import epoch_permutation

        self._perm = epoch_permutation
        self.rng = np.random.default_rng(seq)
        self.n, self.bsz = n, bsz
        self.perm = np.zeros((0, bsz), np.int64)
        self.at = 0

    def next(self) -> np.ndarray:
        """-> [1, bsz] row indices, a slice of the epoch's permutation."""
        if self.at == len(self.perm):
            self.perm = self._perm(self.rng, self.n, self.bsz)
            self.at = 0
        self.at += 1
        return self.perm[self.at - 1:self.at]


@dataclasses.dataclass
class Program:
    state: object
    data: object
    run: object
    rows: Rows
    draws: np.random.Generator
    names: Dict[int, str]
    total_iter: int


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
        model = CLIPModel(harness.clip_config(cfg), precision=policy)
    model.load_state_dict(weights.make_weights(cfg, s.weights, device))
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


def step(prog: Program, draws: Optional[np.random.Generator] = None):
    return prog.run(prog.state, prog.data, prog.rows.next(),
                    prog.draws if draws is None else draws)


def _trained(prog: Program):
    for group in prog.state.optimizer.param_groups:
        for p in group["params"]:
            yield prog.names[id(p)], p, group


def first_steps(prog: Program, n: int
                ) -> Tuple[ref_train.Readings, List[np.ndarray]]:
    """The checked steps through the window's own call -> their readings
    and the rows each step trained on."""
    start = {name: p.detach().clone() for name, p, _ in _trained(prog)}
    losses, rows, grad_norms = [], [], {}
    for t in range(n):
        idx = prog.rows.next()
        rows.append(idx[0].copy())
        losses.append(prog.run(prog.state, prog.data, idx, prog.draws))
        if t == 0:
            # AdamW's first moment after one step is (1 - beta1) * g
            opt = prog.state.optimizer
            grad_norms = ref_train.norms(
                (name, opt.state[p]["exp_avg"] / (1 - group["betas"][0])
                 if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p))
                for name, p, group in _trained(prog))
    change = ref_train.norms((name, p.detach() - start[name])
                             for name, p, _ in _trained(prog))
    return ref_train.Readings([float(v) for v in losses], grad_norms,
                              change), rows


def reference_inputs(prog: Program, rows: List[np.ndarray]):
    """The checked steps' canvases, valid regions and labels, copied out of
    the pool before the program is freed."""
    data = prog.data
    at = [torch.as_tensor(r, device=data.canvases.device) for r in rows]
    return ([data.canvases[i].clone() for i in at],
            [data.valid_hw[r] for r in rows],
            [data.labels[i].clone() for i in at])


def follow_reference(cell: harness.Cell, seed: int, inputs, total_iter: int,
                     device: torch.device,
                     rounding: Rounding = Rounding()) -> ref_train.Readings:
    s = pools.streams(seed)
    w = weights.make_weights(cell.config, s.weights, device)
    head = weights.make_head(cell.traffic["pool"]["classes"],
                             cell.config["embed_dim"], s.head, device)
    return ref_train.follow(cell.config, cell.traffic, w, head, *inputs,
                            np.random.default_rng(s.draws), total_iter,
                            rounding)


def compare(prog: ref_train.Readings, ref: ref_train.Readings,
            limits: dict) -> Dict[str, Tuple[float, float]]:
    """The numbers compared, each beside its limit: the worst step's loss
    gap; the worst leaf's gap of first-gradient norms; the worst leaf's gap
    of change norms over the checked steps, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's.  A leaf's
    gap is over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    odd = set(prog.grad_norms) ^ set(ref.grad_norms)
    if odd:
        raise ValueError("the program trains other leaves than the "
                         f"reference: {sorted(odd)}")
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses))
    med_g = statistics.median(ref.grad_norms.values())
    grad = max(abs(prog.grad_norms[k] - g) / max(g, med_g)
               for k, g in ref.grad_norms.items())
    moving = [k for k, g in ref.grad_norms.items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref.change_norms[k] for k in moving)
    change = max(abs(prog.change_norms[k] - ref.change_norms[k])
                 / max(ref.change_norms[k], med_c) for k in moving)
    return {"loss_gap": (loss, limits["loss_gap"]),
            "grad_norm_gap": (grad, limits["grad_norm_gap"]),
            "change_norm_gap": (change, limits["change_norm_gap"])}


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, started: float) -> harness.Outcome:
    tr = cell.traffic
    prog = build(cell, seed, device)
    readings, rows = first_steps(prog, tr["checked_steps"])
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
    t = flops.vision(cell.config)
    facts = {"images_per_s": images_per_s,
             "step_ms_p5": float(np.percentile(step_ms, 5)),
             "flops_per_image": flops.train_flops_per_image(cell.config),
             "dtype": tr["precision"],
             "attention": (bsz, t["tokens"], t["heads"],
                           t["width"] // t["heads"])}
    return harness.Outcome(len(step_ms), failed, end_to_end,
                           compare(readings, ref, cell.limits),
                           max(setup_peak, window_peak), stretches, facts)
