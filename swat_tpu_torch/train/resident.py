"""Resident-dataset epochs (counterpart of
``swat_tpu/train/scan_loop.py:43-201`` and the twin permutations of
``swat_tpu/train/stages.py:747-779``).

SWAT's few-shot and retrieved splits are small (10^2-10^5 images), so the
whole train split fits in device memory as uint8 canvases.  An epoch then
gathers each batch from the resident tensors by index instead of decoding
and uploading it.  The JAX package runs the epoch as one ``lax.scan``; here
it is a Python loop of the same step body as the streaming path
(``steps.make_mix_fn`` + ``steps.make_encode_loss``), with the losses kept
on the device until the epoch ends.  The batch order is the JAX package's
(``epoch_permutation`` from ``np.random.default_rng(training_seed)``).
A twin method's epoch gathers its second batch from a second resident
split (the few-shot split; CMO's: the train split) by a twin permutation
drawn from the same generator after the epoch's (``twin_permutation``).
The resident epoch takes no ``--accum``: it trains whole batches, as
``swat_tpu``'s scan epoch does.  Its steps are the streaming steps, so an
RN50 epoch folds each step's BN statistics after the step's update
(``scan_loop.py:140-150``), through ``TrainState.apply_update``.

Under a data-parallel mesh the split is sharded by
``core.mesh.resident_sharding``: each rank decodes and holds its
contiguous rows (the whole split on every rank when the data axis does not
divide it), and a step's batch is assembled from the ranks that hold its
rows by one all-reduce of the rows each contributes.  Labels, source and
valid_hw are small and held whole on every rank, where the draws are made.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from swat_tpu_torch.core.mesh import Mesh, active, resident_sharding
from swat_tpu_torch.data.splits import Sample
from swat_tpu_torch.data.pipeline import train_canvases
from swat_tpu_torch.train.state import TrainState
from swat_tpu_torch.utils.profiling import span


class ResidentData:
    """A train split on the device: uint8 canvases [N, C, C, 3], labels
    and source; valid_hw [N, 2] stays on the host, where the crops are
    drawn.  With a ``mesh`` and ``shard`` (this rank's rows, from
    ``resident_sharding``) the canvases are those rows alone."""

    def __init__(self, canvases: torch.Tensor, valid_hw: np.ndarray,
                 labels: torch.Tensor, source: torch.Tensor,
                 mesh: Optional[Mesh] = None,
                 shard: Optional[slice] = None):
        self.canvases = canvases
        self.valid_hw = valid_hw
        self.labels = labels
        self.source = source
        self.n = int(labels.shape[0])
        self.mesh = active(mesh) if shard is not None else None
        self.shard = shard

    @classmethod
    def from_samples(cls, samples: Sequence[Sample], device: torch.device,
                     num_workers: int = 16,
                     mesh: Optional[Mesh] = None) -> "ResidentData":
        shard = resident_sharding(mesh, len(samples))
        mine = samples if shard is None else samples[shard]
        canvases, valid_hw = train_canvases(mine, num_workers)
        canvases = torch.from_numpy(canvases).to(device)
        valid_hw = np.asarray(valid_hw, np.int32)
        if shard is not None:
            valid_hw = mesh.gather(torch.from_numpy(valid_hw).to(
                device)).cpu().numpy()
        labels = np.asarray([s.label for s in samples], np.int64)
        source = np.asarray([s.is_fewshot for s in samples], np.int64)
        return cls(canvases, valid_hw, torch.from_numpy(labels).to(device),
                   torch.from_numpy(source).to(device), mesh, shard)

    def batch(self, idx: np.ndarray) -> dict:
        """The batch at rows ``idx``: device tensors, host valid_hw.  A
        sharded split's canvases come from the ranks that hold them: each
        fills the rows it holds, zeros elsewhere, and one all-reduce sums
        them."""
        at = torch.as_tensor(idx, device=self.canvases.device)
        if self.mesh is None:
            canvases = self.canvases[at]
        else:
            start, stop = self.shard.start, self.shard.stop
            held = (at >= start) & (at < stop)
            canvases = self.canvases.new_zeros(
                (len(idx),) + tuple(self.canvases.shape[1:]))
            canvases[held] = self.canvases[at[held] - start]
            self.mesh.all_reduce(canvases)
        return {"canvases": canvases, "valid_hw": self.valid_hw[idx],
                "labels": self.labels[at], "source": self.source[at]}


def epoch_permutation(rng: np.random.Generator, n: int,
                      batch_size: int) -> np.ndarray:
    """[steps, batch_size] shuffled indices, drop-last."""
    order = rng.permutation(n)
    steps = n // batch_size
    return order[: steps * batch_size].reshape(steps, batch_size).astype(
        np.int64)


def twin_permutation(rng: np.random.Generator, n: int, steps: int,
                     twin_bsz: int,
                     probs: Optional[np.ndarray] = None) -> np.ndarray:
    """[steps, twin_bsz] rows of the twin split for one epoch: drawn with
    replacement by ``probs`` (CMO's inverse class frequencies), else
    successive permutations of the split joined and cut, as a cycling
    few-shot loader would serve them."""
    if probs is not None:
        return rng.choice(n, size=(steps, twin_bsz), replace=True,
                          p=probs).astype(np.int64)
    need = steps * twin_bsz
    reps = []
    while sum(len(r) for r in reps) < need:
        reps.append(rng.permutation(n))
    return np.concatenate(reps)[:need].reshape(steps, twin_bsz).astype(
        np.int64)


def make_resident_epoch(step_fn: Callable, sample_fn: Callable):
    """run(state, data, perm, rng[, twin, twin_perm]) -> mean loss over the
    epoch's steps (a 0-d device tensor); ``rng`` draws each step's crops
    and mix.  With ``twin``, step i's batch carries the twin split's rows
    ``twin_perm[i]`` under *_fs keys.  Each step is a ``train.step`` span
    holding ``train.batch`` (the gathers), ``train.draws`` and the step's
    own phases (``steps._make_step``)."""

    def run(state: TrainState, data: ResidentData, perm: np.ndarray,
            rng: np.random.Generator, twin: Optional[ResidentData] = None,
            twin_perm: Optional[np.ndarray] = None) -> torch.Tensor:
        loss_sum = None
        for i, idx in enumerate(perm):
            with span("train.step"):
                with span("train.batch"):
                    batch = data.batch(idx)
                    if twin is not None:
                        batch.update({f"{k}_fs": v for k, v in
                                      twin.batch(twin_perm[i]).items()})
                with span("train.draws"):
                    draws = sample_fn(rng, batch)
                val = step_fn(state, batch, draws)
                loss_sum = val if loss_sum is None else loss_sum + val
        return loss_sum / perm.shape[0]

    return run
