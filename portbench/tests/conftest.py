"""Shared helpers of the benchmark's CPU tests: the repository on the path,
two threads, tiny cells built from ``data/``, and host-clock stand-ins for
the CUDA calls of a whole run."""

import os
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import torch  # noqa: E402

from portbench import harness  # noqa: E402

torch.set_num_threads(2)


def tiny_cell(traffic: str, limits_of: str, **changes) -> harness.Cell:
    """A tiny ViT under ``data/<traffic>.json`` (fields replaced by
    ``changes``), held to the limits of the benchmark's cell
    ``limits_of``."""
    data = os.path.join(HERE, "data")
    tr = dict(harness.load_json(os.path.join(data, traffic + ".json")),
              **changes)
    return harness.Cell("tiny", 1,
                        harness.load_json(os.path.join(data, "tiny_vit.json")),
                        tr, harness.cell(limits_of).limits)


@pytest.fixture
def cpu():
    return torch.device("cpu")


class _HostEvent:
    """``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def run_on_cpu(monkeypatch, cpu):
    """The CPU device, with the CUDA calls an entry's ``run`` makes
    (events, syncs, the memory peak) standing in on the host, so that a
    test drives a whole run past the harness's look for a card."""
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    return cpu
