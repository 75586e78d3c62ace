"""The port's reproduction runbook (swat_tpu_torch/cli/repro.py) against
swat_tpu.cli.repro on the same synthetic assets (the ones of
tests/test_repro.py): the preflight's failure modes print swat_tpu's
lines, the dry-run plan is swat_tpu's once the port's rate tables are
swat_tpu's, ``--execute --device cpu`` writes swat_tpu's zero-shot row and
ft-fewshot row keys, its score section is swat_tpu.analysis.results' over
the port's CSVs, and ``--device cuda`` without a GPU raises."""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image
from torch_oracle_lib import make_oracle_sd
from torch_port_lib import TORCH_THREADS

import swat_tpu_torch.analysis
from swat_tpu.analysis import results as jax_results
from swat_tpu.cli import repro as jax_repro
from swat_tpu.data import registry as jax_registry
from swat_tpu_torch.cli import repro
from swat_tpu_torch.data import registry

torch.set_num_threads(TORCH_THREADS)

DS = "semi-aves"          # a paper dataset, so the scoring engages
NUM_CLASSES = 3


@pytest.fixture(scope="module", autouse=True)
def register():
    saved = [(m, m.NUM_CLASSES_DICT[DS]) for m in (jax_registry, registry)]
    for m, _ in saved:
        m.NUM_CLASSES_DICT[DS] = NUM_CLASSES
    yield
    for m, n in saved:
        m.NUM_CLASSES_DICT[DS] = n


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """tests/test_repro.py's assets: a test_tiny checkpoint and a 3-class
    semi-aves with a 4-shot seed-1 split, a test split, a retrieved split
    and the metrics json."""
    box = tmp_path_factory.mktemp("repro")
    root = box / "data" / DS
    os.makedirs(root / "imgs")
    sd = make_oracle_sd(seed=3, w=64, layers=2, embed=32, patch=8,
                        img=32, ctx=16, vocab=512, text_w=32,
                        text_layers=2)
    torch.save(sd, box / "ckpt.pt")
    rng = np.random.default_rng(0)
    colors = np.asarray([[220, 40, 40], [40, 220, 40], [40, 40, 220]])

    def split(name, n, fs, pre):
        lines = []
        for c in range(NUM_CLASSES):
            for i in range(n):
                fn = f"imgs/{pre}_{c}_{i}.jpg"
                arr = (colors[c] + rng.integers(-30, 30, (36, 40, 3))
                       ).clip(0, 255).astype(np.uint8)
                Image.fromarray(arr).save(root / fn)
                lines.append(f"{fn} {c} {fs}")
        (root / name).write_text("\n".join(lines) + "\n")

    split("fewshot4_seed1.txt", 4, 1, "fs")
    split("test.txt", 5, 0, "te")
    split("T2T30.txt", 6, 0, "rt")
    metrics = {str(c): {"name": f"c{c}", "most_common_name": f"thing {c}",
                        "alternates": {}} for c in range(NUM_CLASSES)}
    (root / f"{DS}_metrics-LAION400M.json").write_text(json.dumps(metrics))
    return box


def _args(box, out, *extra):
    return ["--checkpoint", str(box / "ckpt.pt"), "--model_cfg", "test_tiny",
            "--dataset_path", str(box / "data"),
            "--retrieved_path", str(box / "data"),
            "--retrieval_split", "T2T30.txt", "--datasets", DS,
            "--shots", "4", "--seeds", "1", "--allow_hash_tokenizer",
            "--bsz", "12", "--out", str(out), *extra]


def _run(module, argv):
    """module.run(argv) -> (exit code, stdout)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = module.run(argv)
    return rc, buf.getvalue()


def _both(assets, tmp_path, *extra, drop=None):
    """The same arguments through swat_tpu's runbook and the port's (on the
    CPU) -> ((rc, out) of swat_tpu, (rc, out) of the port)."""
    def argv(out):
        return [a for a in _args(assets, tmp_path / out, *extra) if a != drop]

    return (_run(jax_repro, argv("jax")),
            _run(repro, argv("port") + ["--device", "cpu"]))


MISSING = {
    "checkpoint": (("--checkpoint", "nope.pt"), None, "nope.pt' not found"),
    "hash_tokenizer": ((), "--allow_hash_tokenizer", "hash fallback"),
    "fewshot_split": (("--seeds", "2"), None, "fewshot4_seed2.txt"),
}


@pytest.mark.parametrize("mode", sorted(MISSING))
def test_preflight_failures_match_swat_tpu(assets, tmp_path, mode):
    """Each missing-asset mode: exit 1 and swat_tpu's lines, the preflight's
    checks and the failure list alike (the checkpoint encoded on the CPU by
    the port's towers)."""
    extra, drop, needle = MISSING[mode]
    if extra and extra[0] == "--checkpoint":
        extra = (extra[0], str(tmp_path / extra[1]))
    (jrc, jout), (rc, out) = _both(assets, tmp_path, *extra, drop=drop)
    assert rc == jrc == 1
    assert needle in out
    assert out == jout


def _plan(out):
    lines = out[out.index("== plan =="):].splitlines()
    total = next(i for i, ln in enumerate(lines) if "TOTAL ~" in ln)
    return lines[:total], lines[total]


def test_dry_run_plan_matches_swat_tpu_under_its_rates(assets, tmp_path,
                                                       monkeypatch):
    """Only the rate tables differ: under swat_tpu's the plan's per-run
    lines and its total are swat_tpu's; the footer names the card that the
    port's rates were measured on."""
    monkeypatch.setattr(repro, "TRAIN_RATE", dict(jax_repro.TRAIN_RATE))
    monkeypatch.setattr(repro, "EVAL_RATE", dict(jax_repro.EVAL_RATE))
    (jrc, jout), (rc, out) = _both(assets, tmp_path, "--configs",
                                   *repro.CONFIGS)
    assert rc == jrc == 0
    (jlines, jtotal), (lines, total) = _plan(jout), _plan(out)
    assert lines == jlines and len(lines) == 1 + len(repro.CONFIGS)
    assert total.split(" h on one ")[0] == jtotal.split(" h on one ")[0]
    assert total.endswith(f"h on one {repro.RATE_CARD} (5 runs; rates: "
                          "PERF.md §5)")
    assert out.rstrip().endswith("dry run only — pass --execute to run the "
                                 "sweep")
    assert out[:out.index("== plan ==")] == jout[:jout.index("== plan ==")]


def _rows(path):
    with open(path) as f:
        return f.read().strip().splitlines()


def _score(out):
    return out[out.index("== score vs paper =="):]


def test_execute_chain_matches_swat_tpu(assets, tmp_path, monkeypatch):
    """--execute with zeroshot and ft-fewshot for one epoch: the zero-shot
    row is swat_tpu's; the ft-fewshot row's keys (its first seven fields)
    are swat_tpu's, its accuracies come from other augmentation draws; the
    score section is swat_tpu.analysis.results' over the port's CSVs."""
    (jrc, jout), (rc, out) = _both(
        assets, tmp_path, "--configs", "zeroshot", "ft-fewshot",
        "--epochs_override", "1", "--execute")
    assert rc == jrc == 0, out[-2000:]
    port, jax = tmp_path / "port", tmp_path / "jax"
    zs, jzs = (_rows(p / f"zeroshot_{DS}.csv") for p in (port, jax))
    assert zs[0] == repro.CSV_HEADER == jax_repro.CSV_HEADER
    assert zs == jzs and len(zs) == 2
    ft, jft = (_rows(p / f"ft-fewshot_{DS}.csv") for p in (port, jax))
    assert ft[0] == jft[0] and len(ft) == len(jft) == 2
    fields = ft[1].split(",")
    assert fields[:7] == jft[1].split(",")[:7] and len(fields) == 11
    assert all(0 <= float(a) <= 100 for a in fields[7:9])
    assert fields[9:] == ["-1.0", "-1.0"]
    assert f"[zeroshot/{DS}/4shot/seed1] {zs[1]} " in out
    # swat_tpu's results module in the port's SCORE step, over its CSVs
    monkeypatch.setitem(sys.modules, "swat_tpu_torch.analysis.results",
                        jax_results)
    monkeypatch.setattr(swat_tpu_torch.analysis, "results", jax_results,
                        raising=False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        repro.score(str(port), ["zeroshot", "ft-fewshot"], 0.5)
    assert _score(out) == buf.getvalue().lstrip("\n")
    assert "-- ft-fewshot (Stage1Acc vs table 'ft-fewshot', ±0.5) --" in out


def test_device_cuda_without_gpu_raises(assets, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro.run(_args(assets, tmp_path / "out", "--device", "cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro.run(_args(assets, tmp_path / "out"))        # the default
    assert not (tmp_path / "out").exists()
