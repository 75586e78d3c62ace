"""The five readers of the program's spans (``portbench/spans.py``) over
hand-built Chrome traces: two steps, each with its six phases on the
stepping thread, kernels launched from it and from autograd's thread, and
blocking calls inside the steps, between them and after the stretch."""

import pytest

from portbench import harness, layers, spans
from portbench.trace import Trace

STEP_US = 1000.0
# each phase's interval within a step, in microseconds from its start
PHASES = {"train.batch": (10, 100), "train.draws": (100, 150),
          "train.augment": (150, 300), "train.forward": (300, 500),
          "train.backward": (500, 800), "train.optimizer": (800, 990)}
MAIN, AUTOGRAD = 11, 12


class Events:
    """A Chrome trace's events, with runtime calls tied to kernels by
    their correlation ids."""

    def __init__(self):
        self.events = []
        self.corr = 0

    def span(self, name, ts, dur, tid=MAIN):
        self.events.append({"ph": "X", "cat": "user_annotation",
                            "name": name, "ts": ts, "dur": dur, "tid": tid})

    def call(self, name, ts, dur=2.0, tid=MAIN):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": name,
                            "ts": ts, "dur": dur, "tid": tid,
                            "args": {"correlation": self.corr}})
        return self.corr

    def kernel(self, launched_at, dur, tid=MAIN):
        corr = self.call("cudaLaunchKernel", launched_at, tid=tid)
        self.events.append({"ph": "X", "cat": "kernel", "name": "k",
                            "ts": launched_at + 5, "dur": dur, "tid": 7,
                            "args": {"correlation": corr}})


def _reading(ev: Events, steps: int = 2) -> layers.Reading:
    trace = Trace(ev.events)
    stretch = harness.Stretch(trace, steps, 1.0, [1.0] * steps, MAIN)
    return layers.Reading(stretch, stretch, {}, {})


def _two_steps(program_spans: bool = True) -> Events:
    """Two steps: 10 us of kernels in the augment, 20 in the forward, 40
    in the backward (launched from autograd's thread), 5 in the
    optimizer, a step; two stream synchronizes a step (one in the batch,
    one in the augment, 30 us each) beside an Async copy that does not
    block.  Outside the steps: a synchronize between them, and the
    harness's device synchronize after the stretch."""
    ev = Events()
    for s in range(2):
        t0 = 100.0 + s * 2 * STEP_US
        ev.span("portbench.step", t0 - 5, STEP_US + 10)
        if program_spans:
            ev.span("train.step", t0, STEP_US)
            for name, (a, b) in PHASES.items():
                ev.span(name, t0 + a, b - a)
        ev.call("cudaMemcpyAsync", t0 + 20)
        ev.call("cudaStreamSynchronize", t0 + 25, dur=30.0)
        ev.kernel(t0 + 160, 10.0)
        ev.call("cudaMemcpyAsync", t0 + 170)
        ev.call("cudaStreamSynchronize", t0 + 175, dur=30.0)
        ev.kernel(t0 + 310, 20.0)
        ev.kernel(t0 + 700, 40.0, tid=AUTOGRAD)
        ev.call("cudaStreamSynchronize", t0 + 710, tid=AUTOGRAD)
        ev.kernel(t0 + 900, 5.0)
        ev.call("cudaStreamSynchronize", t0 + STEP_US + 200, dur=500.0)
    ev.call("cudaDeviceSynchronize", 5000.0, dur=800.0)
    return ev


def _read(metric, reading):
    return harness.reader(metric).read(reading)


def test_waits_count_blocking_calls_inside_steps_on_the_stepping_thread():
    """Two blocking calls a step, 30 us each: not the Async copies, not
    the autograd thread's call, not the synchronize between the steps nor
    the one that closes the stretch."""
    m = _reading(_two_steps())
    assert _read("host_syncs_per_step.train", m) == 2.0
    assert _read("host_wait_ms.host_paced", m) == pytest.approx(0.060)
    w = spans.waits(m.ops.trace)
    assert [(c.name, inner) for c, inner in w] == [
        ("cudaStreamSynchronize", "train.batch"),
        ("cudaStreamSynchronize", "train.augment")] * 2


@pytest.mark.parametrize("metric,ms", [("augment_ms", 0.010),
                                       ("fwd_ms", 0.020), ("bwd_ms", 0.040)])
def test_phase_ms_finds_kernels_by_launch_time_on_any_thread(metric, ms):
    """A kernel launched from autograd's thread while ``train.backward``
    is open counts toward bwd_ms; each phase's kernels, a step."""
    assert _read(metric + ".train", _reading(_two_steps())) == \
        pytest.approx(ms)


def test_phases_and_the_optimizer_cover_every_kernel():
    m = _reading(_two_steps())
    found = sum(len(spans.phase_kernels(m.ops.trace, p)) for p in PHASES)
    assert found == len(m.ops.trace.kernels) == 8


@pytest.mark.parametrize("metric", ["host_syncs_per_step", "host_wait_ms",
                                    "augment_ms", "fwd_ms", "bwd_ms"])
def test_a_trace_without_program_spans_reads_none(metric):
    assert _read(metric + ".train",
                 _reading(_two_steps(program_spans=False))) is None


@pytest.mark.parametrize("name,blocks", [
    ("cudaStreamSynchronize", True), ("cudaDeviceSynchronize", True),
    ("cudaEventSynchronize", True), ("cudaMemcpy", True),
    ("cudaMemcpy2D", True), ("cuMemcpyDtoH_v2", True),
    ("cuStreamSynchronize", True), ("cudaMemcpyAsync", False),
    ("cudaMemcpy2DAsync", False), ("cudaLaunchKernel", False),
    ("cudaStreamWaitEvent", False)])
def test_blocking_calls_by_name(name, blocks):
    assert spans.blocking(name) is blocks
