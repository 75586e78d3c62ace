"""The harness's plumbing: it finds a cell's files by name, builds the
program's model configuration from a configuration file, times a window,
and carries a run's outcome to the result line.

Nothing here is particular to one configuration, traffic mix or metric:
those are files of their own (``README.md``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "swat_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One cell: its names and the files found by them."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or manifest()
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == spec["config"])
    return Cell(name, spec["chips"],
                load_json(os.path.join(ROOT, cfg["file"])),
                load_json(os.path.join(BENCH_DIR, "traffic",
                                       spec["traffic"] + ".json")),
                load_json(os.path.join(BENCH_DIR, "limits", name + ".json")))


def _load(path: str, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[label] = module
    spec.loader.exec_module(module)
    return module


def entry(kind: str) -> ModuleType:
    return _load(os.path.join(BENCH_DIR, "entries", kind + ".py"),
                 "portbench_entry_" + kind)


def quantity(metric: str) -> str:
    """What a metric measures: its name up to the first dot.  One quantity
    that moves two end-to-end metrics, or is held to two bounds, is a
    metric of each name (``gemm_ms.train``, ``gemm_ms.host_paced``)."""
    return metric.split(".", 1)[0]


def reader(metric: str) -> ModuleType:
    """The per-layer metric's reader, ``metrics/<quantity>.py``."""
    q = quantity(metric)
    return _load(os.path.join(BENCH_DIR, "metrics", q + ".py"),
                 "portbench_metric_" + q.replace("-", "_"))


def clip_config(cfg: dict):
    """The program's ``CLIPConfig`` for a ViT configuration file."""
    from swat_tpu_torch.models.configs import (CLIPConfig, TextConfig,
                                               VisionConfig)

    v, t = cfg["vision_cfg"], cfg["text_cfg"]
    quick = cfg["quick_gelu"]
    return CLIPConfig(
        name=cfg["name"],
        vision=VisionConfig(
            image_size=v["image_size"], patch_size=v["patch_size"],
            width=v["width"], layers=v["layers"],
            heads=v["width"] // cfg["assumed"]["vision_head_width"],
            embed_dim=cfg["embed_dim"], quick_gelu=quick),
        text=TextConfig(
            context_length=t["context_length"], vocab_size=t["vocab_size"],
            width=t["width"], layers=t["layers"], heads=t["heads"],
            embed_dim=cfg["embed_dim"], quick_gelu=quick))


def precision(name: str):
    """The program's precision policy of a traffic mix's 'precision'."""
    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION

    policies = {"float32": FP32_PRECISION, "bfloat16": DEFAULT_PRECISION}
    if name not in policies:
        raise ValueError(f"unknown precision {name!r}")
    return policies[name]


class Marks:
    """Boundaries of a window: CUDA events recorded on the current stream,
    read after the window without a sync inside it."""

    def __init__(self):
        self.marks: List[Any] = []

    def mark(self) -> None:
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append(ev)

    def intervals_ms(self) -> List[float]:
        """The time between consecutive marks, after the device is done."""
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]


@dataclasses.dataclass
class Stretch:
    """A profiled stretch of a traced run: its trace, how many steps it
    ran, its length by CUDA events, each call's host ms, and the host thread
    that drove it (None where the host was not traced)."""
    trace: Any
    steps: int
    window_s: float
    host_ms: List[float]
    tid: Optional[int]


def profiled(call: Callable[[], Any], steps: int,
             span: str) -> Tuple[Stretch, Stretch]:
    """Two profiled stretches of ``steps`` calls, each after a sync and
    between CUDA events: the device's, with CUDA activity alone, so that
    the profiler costs the host little; and the operators', with the host's
    operators too, each call in a ``span`` range.  The Chrome traces go to
    a temporary directory under TMPDIR and are deleted once read."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.trace import Trace

    out = []
    for activities in ([ProfilerActivity.CUDA],
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        host_ms = []
        with profile(activities=activities) as prof:
            begin.record()
            for _ in range(steps):
                t0 = time.perf_counter()
                with record_function(span):
                    call()
                host_ms.append((time.perf_counter() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            trace = Trace.load(path)
        spans = trace.spans(span)
        out.append(Stretch(trace, steps, begin.elapsed_time(end) / 1e3,
                           host_ms, spans[0].tid if spans else None))
    return out[0], out[1]


@dataclasses.dataclass
class Outcome:
    """What an entry hands back: the counts, the end-to-end values, the
    numbers compared with their limits, the peak, and with ``--trace 1``
    the profiled stretches (``profiled``) and what the readers need
    besides."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    stretches: Optional[Tuple[Stretch, Stretch]] = None
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            v == v and v <= limit for v, limit in self.checks.values())


def process_start() -> float:
    """The wall-clock time this process started, from /proc."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


def smi(query: str) -> str:
    """One ``nvidia-smi`` reading of the first card, or 'unknown'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else "unknown"


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)
