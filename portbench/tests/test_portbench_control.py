"""The control and the planted faults come out not correct.

The control is the plain reference computed in the next precision below
the cell's, put in the program's place: fp8 products for a bf16 cell,
TF32 for the fp32 one.  Each fault is planted in the program under a whole
run of its entry (``portbench/faults.py``).  A tiny ViT on the CPU, held
to the real cells' limits."""

import time

import pytest

from conftest import tiny_cell
from portbench import faults, harness
from portbench.reference.vit import Rounding

SEED = 2 ** 31 + 23


@pytest.mark.parametrize("limits_of,precision,mode", [
    ("vitb32-cutmix-bf16-b256", "bfloat16", "fp8"),
    ("vitl14-cutmix-bf16-b64", "bfloat16", "fp8"),
    ("vitb32-cutmix-fp32-b256", "float32", "tf32")])
def test_train_control_is_not_correct(limits_of, precision, mode, cpu):
    cell = tiny_cell("tiny_train", limits_of, precision=precision)
    entry = harness.entry("train_resident")
    prog = entry.build(cell, SEED, cpu)
    _, rows = entry.first_steps(prog, 3)
    inputs = entry.reference_inputs(prog, rows)
    ref = entry.follow_reference(cell, SEED, inputs, prog.total_iter, cpu)
    low = entry.follow_reference(cell, SEED, inputs, prog.total_iter, cpu,
                                 Rounding(mode))
    checks = entry.compare(low, ref, cell.limits)
    assert any(v > limit for v, limit in checks.values()), checks


@pytest.mark.parametrize("traffic,limits_of,fault", [
    ("tiny_train", "vitb32-cutmix-fp32-b256", name)
    for name in faults.TRAIN])
def test_planted_fault_is_not_correct(traffic, limits_of, fault, run_on_cpu):
    cell = tiny_cell(traffic, limits_of)
    with faults.TRAIN[fault]():
        out = harness.entry(cell.traffic["entry"]).run(
            cell, SEED, 0.2, False, run_on_cpu, time.time())
    assert not out.correct, out.checks
