"""The epoch loop with best-model tracking (counterpart of
``swat_tpu/train/trainer.py:32-216``), with the reference's semantics:

* validation every epoch only for the methods in VALIDATE_EVERY_EPOCH,
  else only on ``--early_stop`` epochs or the last one;
* the best snapshot when ``val_acc >= best_val_acc`` (ties move forward),
  taken only on those snapshot epochs;
* one loss.csv row and one log line per epoch, with -1 before the first
  validation; the line's img/s is a ``StepMeter`` reset at the top of the
  epoch and ticked after its loss.csv row, so it counts the whole epoch,
  validation and test pass included, as ``swat_tpu``'s;
* profiler spans (``utils.profiling.span``, recorded under
  ``--trace_dir``): ``train.epoch`` around an epoch's training,
  ``train.step`` around each step with ``train.batch`` (the wait for the
  loader, the mesh's gather) and ``train.draws`` in it, then
  ``train.validate`` (the post-epoch hook and the validation) and
  ``train.test``;
* ``--stop_epochs`` breaks early; ``--epochs 0`` snapshots the initial
  weights;
* ``--save_ckpt`` writes a train checkpoint when ``epoch % save_freq == 0``
  and at the last epoch; ``--resume`` restores the newest one (by mtime)
  and goes on at the epoch after it, its iteration count from the
  checkpoint's step.  The per-run draws start again from
  ``--training_seed``, as the JAX key does.

Under a data-parallel mesh every rank runs this loop with the same draws:
the loaders' local rows are gathered into the global batch before the
draws are made (``Mesh.gather_batch``), so every rank holds the global
loss and the same validation numbers.  Rank 0 alone writes the log lines,
``loss.csv`` and the train checkpoints (the others have neither handler
nor stream), and the others wait for a checkpoint at a barrier; ``--resume``
loads on every rank.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

from swat_tpu_torch.core.mesh import Mesh, active
from swat_tpu_torch.data.pipeline import local_keys
from swat_tpu_torch.eval.metrics import calculate_scores
from swat_tpu_torch.train.checkpoint import load_train_ckpt, save_train_ckpt
from swat_tpu_torch.train.state import TrainState
from swat_tpu_torch.utils.profiling import StepMeter, span

VALIDATE_EVERY_EPOCH = {
    "probing", "REAL-Linear", "finetune-mixed", "finetune-multitask",
    "mixup", "mixup-fs", "cutmix-fs", "resizemix", "attentivemix",
}


@dataclasses.dataclass
class BestSnapshot:
    trainable: Any = None     # {'model': state dict, 'head', 'logit_scale'}
    records: Dict = dataclasses.field(default_factory=dict)
    val_acc: float = -1.0


def snapshot_trainable(state: TrainState) -> dict:
    """A cloned copy of the trainable set, on its device (the reference
    deep-copies the model per improvement, utils/training.py:1514-1515)."""
    return {"model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "head": state.head.detach().clone(),
            "logit_scale": state.logit_scale.detach().clone()}


def try_resume(state: TrainState, ckpt_dir: str, logger):
    """Loads the newest train checkpoint in ckpt_dir into ``state`` ->
    the epoch it completed, or 0 when there is none (the file name holds
    it: ``ckpt_ep{E}_it{I}.msgpack``)."""
    paths = glob.glob(os.path.join(ckpt_dir, "ckpt_ep*_it*.msgpack"))
    if not paths:
        return 0
    latest = max(paths, key=os.path.getmtime)
    m = re.search(r"ckpt_ep(\d+)_it(\d+)", latest)
    epoch = int(m.group(1)) if m else 0
    load_train_ckpt(latest, state)
    logger.info(f"Resumed from {latest} (epoch {epoch}, iter {state.step})")
    return epoch


def compose_twin(primary: Iterable[dict], twin_cycler, suffix: str = "_fs"):
    """Merges each primary batch with the next batch of the cycled second
    loader, its keys under ``suffix`` (the reference two-loader pattern,
    utils/training.py:724-737)."""
    for batch in primary:
        twin = twin_cycler.next()
        merged = dict(batch)
        merged.update({f"{k}{suffix}": v for k, v in twin.items()})
        yield merged


def train_loop(*, cfg, state: TrainState, step_fn: Callable,
               sample_fn: Callable,
               train_batches: Callable[[], Iterable[dict]],
               steps_per_epoch: int, validate_fn: Callable,
               test_fn: Callable, logger, loss_logger=None,
               epoch_runner: Optional[Callable] = None,
               ckpt_dir: Optional[str] = None,
               post_epoch: Optional[Callable] = None,
               mesh: Optional[Mesh] = None):
    """Runs cfg.epochs epochs -> (final state, BestSnapshot).

    ``step_fn(state, batch, draws)`` updates the state in place;
    ``sample_fn(rng, batch)`` draws each step's random inputs from one
    generator seeded from ``--training_seed``.  ``epoch_runner(state,
    epoch, rng) -> mean loss`` replaces the per-batch loop for resident
    data.  ``ckpt_dir``: where --save_ckpt writes and --resume reads.
    ``post_epoch(state, epoch)`` (FLYP's head rebuild) updates the state in
    place on the validating epochs only, before the validation, as the
    reference's train_flyp does (utils/training.py:488-490).  ``mesh``:
    the loaders yield this rank's rows, gathered here into the global
    batch."""
    every_epoch = cfg.method in VALIDATE_EVERY_EPOCH
    main = mesh is None or mesh.is_main
    data_mesh = active(mesh)
    # the draws' own stream: the loaders shuffle with default_rng(seed)
    rng = np.random.default_rng([cfg.training_seed, 1])

    best = BestSnapshot()
    num_iter = 0
    val_acc, val_loss, test_acc = -1.0, -1.0, -1.0
    start_epoch = 1
    if cfg.resume and ckpt_dir:
        resumed = try_resume(state, ckpt_dir, logger)
        if resumed:
            start_epoch = resumed + 1
            num_iter = state.step
    meter = StepMeter()
    for epoch in range(start_epoch, cfg.epochs + 1):
        meter.reset()
        with span("train.epoch"):
            if epoch_runner is not None:
                avg_loss = epoch_runner(state, epoch, rng)
                num_iter += steps_per_epoch
                train_loss_sum = float(avg_loss) * steps_per_epoch
            else:
                # losses stay on the device until the epoch ends: a host sync
                # per step would stall the launch queue
                epoch_losses = []
                batches = iter(train_batches())
                while True:
                    # the wait for the loader is the step's train.batch, so
                    # the call that finds it empty opens one more train.step
                    with span("train.step"):
                        with span("train.batch"):
                            batch = next(batches, None)
                            if batch is not None and data_mesh is not None:
                                batch = data_mesh.gather_batch(
                                    batch, state.head.device,
                                    local_keys(batch))
                        if batch is None:
                            break
                        num_iter += 1
                        with span("train.draws"):
                            draws = sample_fn(rng, batch)
                        epoch_losses.append(step_fn(state, batch, draws))
                train_loss_sum = (float(sum(epoch_losses[1:], epoch_losses[0]))
                                  if epoch_losses else 0.0)

        snapshot_epoch = cfg.early_stop or epoch == cfg.epochs
        if every_epoch or snapshot_epoch:
            with span("train.validate"):
                if post_epoch is not None:
                    post_epoch(state, epoch)
                val_acc, val_loss, cm = validate_fn(state)
            scores = calculate_scores(cm) if cm is not None else {}
            if snapshot_epoch and val_acc >= best.val_acc:
                best.val_acc = val_acc
                best.trainable = snapshot_trainable(state)
                best.records = {
                    "best_val_acc": val_acc,
                    "best_logit_scale": state.logit_scale.item(),
                    "best_epoch": epoch,
                    "best_iter": num_iter,
                    "best_scores": scores,
                    "best_confusion_matrix": cm,
                }
            with span("train.test"):
                test_acc = test_fn(state)

        train_loss_avg = train_loss_sum / max(steps_per_epoch, 1)
        if loss_logger is not None:
            loss_logger.write(
                f"{epoch},{num_iter},{round(train_loss_avg, 6)},"
                f"{round(val_loss, 6)},{round(val_acc, 6)},"
                f"{round(test_acc, 6)}\n")
            loss_logger.flush()
        meter.tick(steps_per_epoch * cfg.bsz)
        logger.info(
            f"Epoch {epoch}, Iter {num_iter}, "
            f"Trn Loss: {round(train_loss_avg, 6)}, "
            f"Val Loss: {round(val_loss, 6)}, "
            f"Val Acc: {round(val_acc, 3)}, Test Acc: {round(test_acc, 3)}, "
            f"{meter.items_per_sec:.0f} img/s")
        # save_freq counts epochs, as the reference documents it
        # (utils/parser.py:141; its code tests num_iter, a bug)
        if cfg.save_ckpt and ckpt_dir and (
                epoch % cfg.save_freq == 0 or epoch == cfg.epochs):
            if main:
                path = save_train_ckpt(ckpt_dir, f"ep{epoch}_it{num_iter}",
                                       state, best.records)
                logger.info(f"Model ckpt saved to: {path}")
            if mesh is not None:
                mesh.barrier()
        if epoch == cfg.stop_epochs:
            break

    if best.trainable is None:  # epochs == 0: keep the current weights
        logger.info("No training epochs ran; snapshotting current weights "
                    f"(val_acc {round(val_acc, 3)} recorded as best)")
        best.trainable = snapshot_trainable(state)
        best.records = {"best_val_acc": val_acc, "best_epoch": -1,
                        "best_iter": num_iter, "best_scores": {},
                        "best_confusion_matrix": None,
                        "best_logit_scale": state.logit_scale.item()}
    logger.info(
        f"Training done. Best val Acc: {round(best.val_acc, 3)} at epoch "
        f"{best.records.get('best_epoch', -1)}, "
        f"iter {best.records.get('best_iter', -1)}")
    return state, best

