"""The RN50 cell's pieces: the control and the planted faults, those of
the BatchNorm running statistics among them, come out not correct on the
``train_resident_resnet`` entry under the cell's limits, which name every
number it compares, a whole fp32 run comes out correct, the three readers of the
ResNet tower read a hand-built trace, the configuration builds the tower
the port registers, and the new reference keeps the import rules.  A
tiny RN (``data/tiny_rn.json``) on the CPU."""

import os
import time

import pytest

from conftest import HERE
from portbench import faults, flops_resnet, harness, layers, layers_resnet
from portbench.reference.vit import Rounding
from portbench.trace import Trace
from test_portbench_imports import _imports

SEED = 2 ** 31 + 29
CELL = "rn50-cutmix-bf16-b256"


def tiny_rn_cell(limits_of: str, **changes) -> harness.Cell:
    data = os.path.join(HERE, "data")
    tr = dict(harness.load_json(os.path.join(data, "tiny_train.json")),
              entry="train_resident_resnet", **changes)
    return harness.Cell("tiny_rn", 1,
                        harness.load_json(os.path.join(data, "tiny_rn.json")),
                        tr, harness.cell(limits_of).limits)


def test_control_is_not_correct(cpu):
    cell = tiny_rn_cell(CELL, precision="bfloat16")
    entry = harness.entry("train_resident_resnet")
    prog = entry.build(cell, SEED, cpu)
    _, rows = entry.first_steps(prog, 3)
    inputs = entry.reference_inputs(prog, rows)
    ref = entry.follow_reference(cell, SEED, inputs, prog.total_iter, cpu)
    low = entry.follow_reference(cell, SEED, inputs, prog.total_iter, cpu,
                                 Rounding("fp8"))
    checks = entry.compare(low, ref, cell.limits)
    assert any(v > limit for v, limit in checks.values()), checks


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_planted_fault_is_not_correct(fault, run_on_cpu):
    cell = tiny_rn_cell(CELL)
    with faults.TRAIN[fault]():
        out = harness.entry("train_resident_resnet").run(
            cell, SEED, 0.2, False, run_on_cpu, time.time())
    assert not out.correct, out.checks


def fold_skipped():
    """The optimizer update leaves the running statistics as they were."""
    from swat_tpu_torch.train import state

    return faults.patched(state, "fold_bn_updates",
                          lambda updates, momentum=0.1: None)


def fold_at_momentum_0_01():
    """The running statistics folded at momentum 0.01 (Flax's 0.99 read
    the other way) instead of 0.1."""
    from swat_tpu_torch.train import state

    real = state.fold_bn_updates
    return faults.patched(state, "fold_bn_updates",
                          lambda updates, momentum=0.1: real(updates, 0.01))


@pytest.mark.parametrize("fault", [fold_skipped, fold_at_momentum_0_01],
                         ids=lambda f: f.__name__)
def test_planted_running_stats_fault_is_not_correct(fault, run_on_cpu):
    """Only the running statistics are wrong, and ``running_stats_gap``
    sees it."""
    cell = tiny_rn_cell(CELL)
    with fault():
        out = harness.entry("train_resident_resnet").run(
            cell, SEED, 0.2, False, run_on_cpu, time.time())
    value, limit = out.checks["running_stats_gap"]
    assert value > limit and not out.correct, out.checks


def test_cell_limits_name_every_number_compared(cpu):
    cell = tiny_rn_cell(CELL)
    entry = harness.entry("train_resident_resnet")
    prog = entry.build(cell, SEED, cpu)
    readings, rows = entry.first_steps(prog, 1)
    checks = entry.compare(readings, readings, cell.limits)
    assert set(checks) == set(cell.limits)
    assert all(v == 0 for v, _ in checks.values())


def test_fp32_run_comes_out_correct(run_on_cpu):
    """A whole run under the fp32 policy, held to the fp32 cell's gradient
    and change limits and to losses and running statistics within 1e-5:
    the two BatchNorms take their statistics by other sums, a few fp32
    ulps apart."""
    cell = tiny_rn_cell("vitb32-cutmix-fp32-b256")
    cell.limits = dict(cell.limits, loss_gap=1e-5, running_stats_gap=1e-5)
    out = harness.entry("train_resident_resnet").run(
        cell, SEED, 0.2, False, run_on_cpu, time.time())
    assert out.attempted >= 1 and out.failed == 0
    assert out.correct, out.checks
    assert "attention" not in out.facts and out.facts["batch"] == 8


def test_config_builds_the_registered_tower():
    from swat_tpu_torch.models.configs import get_model_config

    cfg = harness.cell(CELL).config
    built = harness.entry("train_resident_resnet").clip_config(cfg)
    registered = get_model_config(cfg["name"])
    assert built.vision == registered.vision
    assert built.text == registered.text


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(harness.BENCH_DIR, "reference", "resnet.py")
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & (set(harness.FORBIDDEN) | {"swat_tpu_torch"})


MAIN, AUTOGRAD, STEPS = 11, 12, 2


class Events:
    def __init__(self):
        self.events, self.corr = [], 0

    def host(self, name, ts, dur, tid=MAIN, cat="cpu_op"):
        self.events.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                            "dur": dur, "tid": tid})

    def kernel(self, launched_at, dur, tid=MAIN):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime",
                            "name": "cudaLaunchKernel", "ts": launched_at,
                            "dur": 2.0, "tid": tid,
                            "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": "kernel", "name": "k",
                            "ts": launched_at + 5, "dur": dur, "tid": 7,
                            "args": {"correlation": self.corr}})


def _trace(program: bool = True) -> Events:
    """Two steps, each: a forward convolution (aten::conv2d holding
    aten::convolution holding aten::cudnn_convolution) with a 100 us and
    a 20 us kernel, a BatchNorm span with a 30 us kernel, an elementwise
    kernel outside both, and on autograd's thread two BatchNorm backward
    spans, one after the other (50 us and 10 us), and a convolution
    backward (200 us)."""
    ev = Events()
    for s in range(STEPS):
        t0 = 1000.0 * s
        ev.host("aten::conv2d", t0, 60)
        ev.host("aten::convolution", t0 + 1, 58)
        ev.host("aten::cudnn_convolution", t0 + 2, 56)
        ev.kernel(t0 + 10, 100.0)
        ev.kernel(t0 + 30, 20.0)
        if program:
            ev.host("resnet.bn", t0 + 70, 40, cat="user_annotation")
            ev.host("resnet.bn_backward", t0 + 300, 20, tid=AUTOGRAD,
                    cat="user_annotation")
            ev.host("resnet.bn_backward", t0 + 325, 20, tid=AUTOGRAD,
                    cat="user_annotation")
        ev.kernel(t0 + 80, 30.0)
        ev.kernel(t0 + 150, 7.0)
        ev.kernel(t0 + 310, 50.0, tid=AUTOGRAD)
        ev.kernel(t0 + 330, 10.0, tid=AUTOGRAD)
        ev.host("aten::convolution_backward", t0 + 400, 50, tid=AUTOGRAD)
        ev.kernel(t0 + 410, 200.0, tid=AUTOGRAD)
    return ev


def _reading(ev: Events, cfg: dict, facts: dict) -> layers.Reading:
    stretch = harness.Stretch(Trace(ev.events), STEPS, 1.0, [1.0] * STEPS,
                              MAIN)
    return layers.Reading(stretch, stretch, facts, cfg)


def test_readers_on_a_hand_built_trace():
    cfg = harness.cell(CELL).config
    m = _reading(_trace(), cfg, {"batch": 256, "dtype": "bfloat16"})
    read = {q: harness.reader(q + ".train").read(m)
            for q in ("conv_ms", "conv_roofline", "bn_ms")}
    assert read["conv_ms"] == pytest.approx(0.320)
    assert read["bn_ms"] == pytest.approx(0.090)
    bound = flops_resnet.conv_train_bound_s(cfg, 256, "bfloat16")
    assert read["conv_roofline"] == pytest.approx(100 * bound / 320e-6)
    assert len(layers_resnet.conv_kernels(m)) == 3 * STEPS


def test_readers_read_none_without_what_they_read():
    ev = Events()
    ev.kernel(10.0, 5.0)
    m = _reading(ev, harness.cell(CELL).config,
                 {"batch": 256, "dtype": "bfloat16"})
    assert all(harness.reader(q).read(m) is None
               for q in ("conv_ms.train", "conv_roofline.train",
                         "bn_ms.train"))
    # spans gone, the convolutions still read
    m = _reading(_trace(program=False), harness.cell(CELL).config,
                 {"batch": 256, "dtype": "bfloat16"})
    assert harness.reader("bn_ms.train").read(m) is None
    assert harness.reader("conv_ms.train").read(m) == pytest.approx(0.320)
