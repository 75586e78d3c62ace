# Copied from swat_tpu/utils/profiling.py, with maybe_trace on torch.profiler; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Profiling & tracing hooks.

``maybe_trace`` runs a ``torch.profiler`` trace over a block when a
directory is given (``--trace_dir``, around the whole ``SwatPipeline.run``
as in ``swat_tpu``) and is a no-op otherwise.  The host's operators are
always recorded, the card's kernels too when the run's device is a GPU.  On
exit the trace is written as ``<trace_dir>/rank<R>.<pid>.pt.trace.json``
(one file per rank under a launcher), a Chrome trace that Perfetto
(ui.perfetto.dev) and TensorBoard's PyTorch profiler plugin open; it takes
the place of ``swat_tpu``'s XPlane dump.  ``StepMeter`` is the wall-clock
throughput meter the trainer logs per epoch (images/s)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

TRACE_SUFFIX = ".pt.trace.json"


def trace_path(trace_dir: str, rank: int = 0) -> str:
    """Where the trace of this process (rank ``rank``) goes."""
    return os.path.join(trace_dir, f"rank{rank}.{os.getpid()}{TRACE_SUFFIX}")


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], device=None,
                rank: int = 0) -> Iterator[None]:
    """torch.profiler trace when a directory is given, no-op otherwise.

    ``device``: the run's device (a ``torch.device`` or its name); a CUDA
    device adds the card's activity.  Before the trace starts, the CUDA
    context exists and the kernels' library is built and loaded, so that
    neither lands inside the trace; before it stops, the card has finished
    every kernel that was launched inside it."""
    if not trace_dir:
        yield
        return
    import torch

    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        from swat_tpu_torch.kernels import _build

        activities.append(ProfilerActivity.CUDA)
        torch.cuda.init()
        torch.cuda.synchronize(device)
        _build.load()
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(trace_path(trace_dir, rank))


class StepMeter:
    """Windowed wall-clock throughput meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._items = 0
        self._steps = 0

    def tick(self, items: int):
        self._items += items
        self._steps += 1

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def items_per_sec(self) -> float:
        return self._items / max(self.elapsed, 1e-9)

    @property
    def ms_per_step(self) -> float:
        return self.elapsed / max(self._steps, 1) * 1000.0
