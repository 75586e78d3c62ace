"""Faults planted in the program under a run, for the readings the limits
are set from (``calibrate.py``) and for the tests that see ``correct``
come out false.  Each is a context manager that patches one function of
the program and restores it on exit.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def state_unchanged():
    """A train step that leaves the weights as they were: the update only
    counts the step."""
    from swat_tpu_torch.train.state import TrainState

    def apply_update(self):
        self.bn_updates = None
        self.step += 1

    return patched(TrainState, "apply_update", apply_update)


def half_batch_loss():
    """The train step's loss over the first half of the batch alone."""
    from swat_tpu_torch.train import steps

    real = steps.mix_criterion

    def loss(fn, logits, y_a, y_b, lam, lam_vec, source):
        h = logits.shape[0] // 2
        return real(fn, logits[:h], y_a[:h], y_b[:h], lam,
                    None if lam_vec is None else lam_vec[:h], source[:h])

    return patched(steps, "mix_criterion", loss)


TRAIN = {"state_unchanged": state_unchanged,
         "half_batch": half_batch_loss}
