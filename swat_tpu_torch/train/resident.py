"""Resident-dataset epochs (counterpart of
``swat_tpu/train/scan_loop.py:43-201``).

SWAT's few-shot and retrieved splits are small (10^2-10^5 images), so the
whole train split fits in device memory as uint8 canvases.  An epoch then
gathers each batch from the resident tensors by index instead of decoding
and uploading it.  The JAX package runs the epoch as one ``lax.scan``; here
it is a Python loop of the same step body as the streaming path
(``steps.make_mix_fn`` + ``steps.make_encode_loss``), with the losses kept
on the device until the epoch ends.  The batch order is the JAX package's
(``epoch_permutation`` from ``np.random.default_rng(training_seed)``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from swat_tpu_torch.data.splits import Sample
from swat_tpu_torch.data.pipeline import train_canvases
from swat_tpu_torch.train.state import TrainState


class ResidentData:
    """A train split on the device: uint8 canvases [N, C, C, 3], labels
    and source; valid_hw [N, 2] stays on the host, where the crops are
    drawn."""

    def __init__(self, canvases: torch.Tensor, valid_hw: np.ndarray,
                 labels: torch.Tensor, source: torch.Tensor):
        self.canvases = canvases
        self.valid_hw = valid_hw
        self.labels = labels
        self.source = source
        self.n = int(canvases.shape[0])

    @classmethod
    def from_samples(cls, samples: Sequence[Sample], device: torch.device,
                     num_workers: int = 16) -> "ResidentData":
        canvases, valid_hw = train_canvases(samples, num_workers)
        labels = np.asarray([s.label for s in samples], np.int64)
        source = np.asarray([s.is_fewshot for s in samples], np.int64)
        return cls(torch.from_numpy(canvases).to(device),
                   np.asarray(valid_hw, np.int32),
                   torch.from_numpy(labels).to(device),
                   torch.from_numpy(source).to(device))

    def batch(self, idx: np.ndarray) -> dict:
        """The batch at rows ``idx``: device tensors, host valid_hw."""
        at = torch.as_tensor(idx, device=self.canvases.device)
        return {"canvases": self.canvases[at], "valid_hw": self.valid_hw[idx],
                "labels": self.labels[at], "source": self.source[at]}


def epoch_permutation(rng: np.random.Generator, n: int,
                      batch_size: int) -> np.ndarray:
    """[steps, batch_size] shuffled indices, drop-last."""
    order = rng.permutation(n)
    steps = n // batch_size
    return order[: steps * batch_size].reshape(steps, batch_size).astype(
        np.int64)


def make_resident_epoch(step_fn: Callable, sample_fn: Callable):
    """run(state, data, perm, rng) -> mean loss over the epoch's steps (a
    0-d device tensor); ``rng`` draws each step's crops and mix."""

    def run(state: TrainState, data: ResidentData, perm: np.ndarray,
            rng: np.random.Generator) -> torch.Tensor:
        loss_sum = None
        for idx in perm:
            batch = data.batch(idx)
            val = step_fn(state, batch, sample_fn(rng, batch))
            loss_sum = val if loss_sum is None else loss_sum + val
        return loss_sum / perm.shape[0]

    return run
