"""BENCHMARK.json and every file it names load by name and keep to the
benchmark's rules of names, units and keys."""

import os
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    c = harness.cell(cell)
    assert c.chips == 1
    harness.entry(c.traffic["entry"])
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_loads_by_name(metric):
    assert callable(harness.reader(metric).read)


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        seen = [x["name"] for x in group]
        assert len(seen) == len(set(seen))
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert harness.load_json(os.path.join(harness.ROOT, c["file"]))[
            "reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


def _cells_of(metric):
    return set(metric.get("workloads", CELLS))


def test_every_moved_metric_is_reported_in_the_cells_of_its_mover():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert _cells_of(m) <= _cells_of(e2e[m["moves"]]), m["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in _cells_of(m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_registered_model(config):
    """The configuration files build the towers the port registers under
    the same names."""
    from swat_tpu_torch.models.configs import get_model_config

    spec = next(c for c in BENCH["configs"] if c["name"] == config)
    built = harness.clip_config(harness.load_json(
        os.path.join(harness.ROOT, spec["file"])))
    registered = get_model_config(config)
    assert built.vision == registered.vision
    assert built.text == registered.text
