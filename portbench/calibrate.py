"""The readings the limits of a cell's comparison are set from, at the
cell's own size, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--controls 3] [--faults 3]

For each seed: the program's checked steps against the plain reference,
the lower reading.  For the first ``--controls`` seeds the control against
the same reference: the reference with TF32 products for an fp32 cell and
fp8 products for a bf16 one.  For the first ``--faults`` seeds the program
with half of each batch left out of the loss, against the same reference.
One JSON line a reading; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from portbench import faults, harness  # noqa: E402
from portbench.reference.vit import Rounding  # noqa: E402

NO_LIMITS = {"loss_gap": math.inf, "grad_norm_gap": math.inf,
             "change_norm_gap": math.inf}
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _values(checks) -> dict:
    return {k: v for k, (v, _) in checks.items()}


def train_readings(cell, entry, seed, device, control: bool, fault: bool):
    def program():
        prog = entry.build(cell, seed, device)
        readings, rows = entry.first_steps(prog, cell.traffic["checked_steps"])
        inputs = entry.reference_inputs(prog, rows)
        total = prog.total_iter
        del prog
        _free()
        return readings, inputs, total

    readings, inputs, total = program()
    ref = entry.follow_reference(cell, seed, inputs, total, device)
    yield "program", _values(entry.compare(readings, ref, NO_LIMITS))
    if control:
        mode = CONTROL[cell.traffic["precision"]]
        low = entry.follow_reference(cell, seed, inputs, total, device,
                                     Rounding(mode))
        yield "control_" + mode, _values(entry.compare(low, ref, NO_LIMITS))
    if fault:
        with faults.half_batch_loss():
            readings, _, _ = program()
        yield "fault_half_batch", _values(entry.compare(readings, ref,
                                                        NO_LIMITS))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.cell(args.workload)
    entry = harness.entry(cell.traffic["entry"])
    lines = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for what, values in train_readings(cell, entry, seed, device,
                                     i < args.controls, i < args.faults):
            line = {"cell": cell.name, "seed": seed, "what": what, **values}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
