"""No module under portbench/ imports JAX or swat_tpu (top-level names
compared whole: swat_tpu_torch begins with swat_tpu), the reference imports
nothing of the program, and a run without a CUDA device prints no result."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

SOURCES = sorted(
    os.path.join(d, f) for d, _, files in os.walk(harness.BENCH_DIR)
    for f in files if f.endswith(".py"))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, harness.BENCH_DIR)
                              for p in SOURCES])
def test_no_forbidden_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    if os.sep + "reference" + os.sep in path:
        assert "swat_tpu_torch" not in tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "swat_tpu_torch_probe", sys)
    assert "swat_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "swat_tpu.probe", sys)
    assert "swat_tpu.probe" in harness.forbidden_modules()


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", "vitb32-cutmix-bf16-b256", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
