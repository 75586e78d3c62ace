"""The program's own spans in a profiled stretch, and what happened inside
them: ``train.step`` and its six phases (``swat_tpu_torch.utils.profiling
.span``, opened by ``train/resident.py`` and ``train/steps.py``), the
device ms of the kernels each phase launched, and the blocking CUDA calls
each step made.

Everything here reads the operator stretch (``Reading.ops``): the stretch
profiled with CUDA activity alone records the runtime calls but none of
the program's ``record_function`` ranges.  The spans, the runtime calls
and the kernels' launches are on the trace's one host clock.

A kernel belongs to a phase when the runtime call that launched it lies
in that phase's interval, on any host thread of the process: autograd
launches the backward's kernels from its own device thread while
``train.backward`` is open on the stepping thread.  A blocking call counts
when it lies inside a ``train.step`` on the stepping thread, so the
harness's synchronize that closes the stretch, outside every step, does
not.  A trace without the program's spans reads None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from portbench.layers import Reading
from portbench.trace import Op, Trace

STEP = "train.step"
PHASES = ("train.batch", "train.draws", "train.augment", "train.forward",
          "train.backward", "train.optimizer")
# calls that return only once the device has caught up: the synchronizes
# of both CUDA APIs (cuda*, cu*), and their copies that are not Async (a
# pageable upload with non_blocking=False is an Async copy and a stream
# synchronize)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cuStreamSynchronize", "cuCtxSynchronize",
         "cuEventSynchronize")
COPIES = ("cudaMemcpy", "cuMemcpy")


def blocking(name: str) -> bool:
    return name.startswith(SYNCS) or (name.startswith(COPIES)
                                      and "Async" not in name)


def steps(trace: Trace) -> List[Op]:
    return trace.spans(STEP)


def waits(trace: Trace) -> Optional[List[Tuple[Op, str]]]:
    """The blocking calls on the stepping thread inside a ``train.step``,
    in time order, each with its innermost ``train.*`` span's name; None
    without program spans."""
    outer = steps(trace)
    if not outer:
        return None
    tid = outer[0].tid
    program = [o for o in trace.host
               if o.tid == tid and o.name.startswith("train.")]
    out = []
    for call in sorted(trace.launch_of.values(), key=lambda o: o.ts):
        if call.tid != tid or not blocking(call.name):
            continue
        around = [o for o in program if o.ts <= call.ts <= o.end]
        if any(o.name == STEP for o in around):
            out.append((call, max(around, key=lambda o: o.ts).name))
    return out


def phase_kernels(trace: Trace, phase: str) -> Optional[List[Op]]:
    """The kernels launched, from any thread, while a ``phase`` span was
    open; None if the trace has no such span."""
    spans = sorted(trace.spans(phase), key=lambda o: o.ts)
    if not spans:
        return None
    starts = [o.ts for o in spans]
    out = []
    for k in trace.kernels:
        launch = trace.launch_of.get(k.corr)
        if launch is None:
            continue
        # one phase's spans follow each other on one thread: only the
        # latest that started before the launch can hold it
        i = bisect.bisect_right(starts, launch.ts) - 1
        if i >= 0 and launch.ts <= spans[i].end:
            out.append(k)
    return out


def host_syncs_per_step(m: Reading) -> Optional[float]:
    w = waits(m.ops.trace)
    return None if w is None else len(w) / len(steps(m.ops.trace))


def host_wait_ms(m: Reading) -> Optional[float]:
    """The blocking calls' summed host ms a step."""
    w = waits(m.ops.trace)
    if w is None:
        return None
    return sum(call.dur for call, _ in w) / 1e3 / len(steps(m.ops.trace))


def phase_ms(m: Reading, phase: str) -> Optional[float]:
    """Device ms a step of the kernels ``phase`` launched."""
    trace = m.ops.trace
    kernels = phase_kernels(trace, phase) if steps(trace) else None
    if kernels is None:
        return None
    return sum(k.dur for k in kernels) / 1e3 / len(steps(trace))
