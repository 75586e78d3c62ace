"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit.  The line before it names the card.  The numbers compared are also
the last lines of standard error.  The run exits with an error, and prints
no result, without a CUDA device for every chip the cell asks for, or when
a module of JAX or of ``swat_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _per_layer(bench: dict, cell, outcome) -> dict:
    from portbench import harness, layers

    reading = layers.Reading(*outcome.stretches, outcome.facts, cell.config)
    out = {}
    for metric in bench["per_layer"]:
        if cell.name not in metric.get("workloads", [cell.name]):
            continue
        value = harness.reader(metric["name"]).read(reading)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def _end_to_end(bench: dict, cell, outcome) -> dict:
    """The cell's end-to-end metrics, each the entry's value of its
    quantity (``harness.quantity``)."""
    from portbench import harness

    out = {}
    for metric in bench["end_to_end"]:
        if cell.name in metric.get("workloads", [cell.name]):
            value = outcome.end_to_end[harness.quantity(metric["name"])]
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import harness

    started = harness.process_start()
    import torch

    bench = harness.manifest()
    cell = harness.cell(args.workload, bench)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {have}; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    traced = bool(args.trace)
    outcome = harness.entry(cell.traffic["entry"]).run(
        cell, args.seed, args.seconds, traced, device, started)

    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: modules of {harness.FORBIDDEN} loaded: {loaded}; "
              "no result", file=sys.stderr)
        return 3
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed,
              "metrics": (_per_layer(bench, cell, outcome) if traced
                          else _end_to_end(bench, cell, outcome)),
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips,
                         "memory_peak_bytes": outcome.memory_peak_bytes}}
    if traced:
        dev, ops = outcome.stretches
        result["device"].update(busy_s=dev.trace.busy_s(),
                                window_s=dev.window_s)
        result["breakdown"] = {"device_ops": dev.trace.top_device_ops(),
                               "idle_gaps": ops.trace.idle_gaps(ops.tid)}
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, (v, limit) in outcome.checks.items()}
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, power.limit "
          f"{harness.smi('power.limit')}, clocks.sm "
          f"{harness.smi('clocks.sm')}")
    for name, (v, limit) in outcome.checks.items():
        print(f"check {name} {v!r} limit {limit!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
