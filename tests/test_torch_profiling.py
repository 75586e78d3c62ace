"""The port's profiling hooks (swat_tpu_torch/utils/profiling.py) against
swat_tpu's: ``maybe_trace`` is a no-op without a directory and writes a
torch.profiler Chrome trace with one; ``StepMeter`` and the trainer's use
of it give swat_tpu's numbers under one fake clock (so the epoch log's
img/s counts the whole epoch, validation included, in both packages); a
traced CLI run gives the untraced run's summary line and loss.csv."""

import glob
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch_port_lib import (DATASET, TORCH_THREADS, make_dataset,
                            random_state_dict, register_dataset,
                            summary_line)

from swat_tpu.train import trainer as jax_trainer
from swat_tpu.utils import profiling as jax_profiling
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train import trainer
from swat_tpu_torch.utils import profiling

torch.set_num_threads(TORCH_THREADS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_maybe_trace_none_is_a_no_op(tmp_path):
    """No directory: nothing is written, and nothing heavy is imported (a
    fresh interpreter holds no torch after the block)."""
    before = sorted(os.listdir(tmp_path))
    for trace_dir in (None, ""):
        with profiling.maybe_trace(trace_dir, "cpu"):
            pass
    assert sorted(os.listdir(tmp_path)) == before
    code = ("import sys\n"
            "from swat_tpu_torch.utils.profiling import maybe_trace\n"
            "with maybe_trace(None):\n"
            "    pass\n"
            "print('TORCH', 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "TORCH False" in out.stdout


def test_maybe_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    trace_dir = tmp_path / "trace"
    with profiling.maybe_trace(str(trace_dir), torch.device("cpu"), rank=3):
        x = torch.ones(8, 8) @ torch.ones(8, 8)
    assert float(x.sum()) == 512.0
    (path,) = glob.glob(str(trace_dir / "*"))
    assert path == profiling.trace_path(str(trace_dir), 3)
    assert path.endswith(profiling.TRACE_SUFFIX)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names
    # no card on a CPU run
    assert not any(e.get("cat") == "kernel" for e in events)


class FakeClock:
    """time.perf_counter for both profiling modules: it moves only when a
    test advances it."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def advance(self, secs):
        self.t += secs


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    for module in (profiling, jax_profiling):
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            perf_counter=fake.perf_counter))
    return fake


def test_step_meter_matches_swat_tpu(clock):
    meters = [profiling.StepMeter(), jax_profiling.StepMeter()]
    readings = [[] for _ in meters]
    for step, secs in enumerate((0.25, 1.5, 0.75)):
        clock.advance(secs)
        for m, r in zip(meters, readings):
            m.tick(32 * (step + 1))
            r.append((m.elapsed, m.items_per_sec, m.ms_per_step))
    clock.advance(2.0)
    for m, r in zip(meters, readings):
        m.reset()
        r.append((m.elapsed, m.items_per_sec, m.ms_per_step))
    assert readings[0] == readings[1]
    assert readings[0][2] == (2.5, 192 / 2.5, 2500 / 3)
    assert readings[0][3] == (0.0, 0.0, 0.0)


class Logger:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def _recording_meter(base, clock, calls):
    class Recording(base):
        def reset(self):
            calls.append(("reset", clock.t))
            super().reset()

        def tick(self, items):
            calls.append(("tick", items, clock.t))
            super().tick(items)

    return Recording


# steps, validation and test pass of a fake epoch, in fake seconds
STEP_SECS, VALIDATE_SECS, TEST_SECS = 0.5, 3.0, 2.0


def _loop_inputs(clock, method):
    cfg = types.SimpleNamespace(
        method=method, training_seed=1, epochs=3, early_stop=False, bsz=4,
        save_ckpt=False, save_freq=1, stop_epochs=-1, resume=False)
    batches = lambda: iter([{"i": 0}, {"i": 1}])  # noqa: E731

    def validate(state):
        clock.advance(VALIDATE_SECS)
        return 50.0, 0.75, None

    def test(state):
        clock.advance(TEST_SECS)
        return 40.0

    return cfg, batches, validate, test


def _run_jax_loop(clock, method, logger, loss_csv):
    cfg, batches, validate, test = _loop_inputs(clock, method)

    def step(state, batch, key):
        clock.advance(STEP_SECS)
        return state, 0.5

    state = types.SimpleNamespace(trainable={"w": np.zeros(2, np.float32)},
                                  logit_scale=np.float32(1.0))
    jax_trainer.train_loop(cfg=cfg, state=state, step_fn=step,
                           train_batches=batches, steps_per_epoch=2,
                           validate_fn=validate, test_fn=test,
                           logger=logger, loss_logger=loss_csv)


def _run_port_loop(clock, method, logger, loss_csv):
    cfg, batches, validate, test = _loop_inputs(clock, method)

    def step(state, batch, draws):
        clock.advance(STEP_SECS)
        return 0.5

    state = types.SimpleNamespace(model=torch.nn.Linear(2, 2),
                                  head=torch.zeros(2),
                                  logit_scale=torch.tensor(1.0))
    trainer.train_loop(cfg=cfg, state=state, step_fn=step,
                       sample_fn=lambda rng, batch: None,
                       train_batches=batches, steps_per_epoch=2,
                       validate_fn=validate, test_fn=test, logger=logger,
                       loss_logger=loss_csv)


@pytest.mark.parametrize("method", ["mixup", "cutmix"])
def test_trainer_meters_the_epoch_as_swat_tpu(clock, monkeypatch, tmp_path,
                                              method):
    """Both packages' train_loop with the same fake steps, validation and
    test pass under one fake clock: the meter is reset and ticked at the
    same moments with the same counts, so each epoch's log line (its img/s
    over the whole epoch, validation and test pass included) and loss.csv
    row are swat_tpu's.  mixup validates every epoch, cutmix only at the
    last."""
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(trainer, "StepMeter", _recording_meter(
        profiling.StepMeter, clock, calls["port"]))
    monkeypatch.setattr(jax_profiling, "StepMeter", _recording_meter(
        jax_profiling.StepMeter, clock, calls["jax"]))
    logs, rows = {}, {}
    for name, run in (("port", _run_port_loop), ("jax", _run_jax_loop)):
        clock.t = 100.0
        logs[name] = Logger()
        path = tmp_path / f"{name}.csv"
        with open(path, "w") as f:
            run(clock, method, logs[name], f)
        rows[name] = path.read_text()
    assert calls["port"] == calls["jax"]
    assert [c[0] for c in calls["port"]] == ["reset"] + ["reset",
                                                         "tick"] * 3
    epochs = [ln for ln in logs["port"].lines if ln.startswith("Epoch ")]
    assert epochs == [ln for ln in logs["jax"].lines
                      if ln.startswith("Epoch ")]
    assert len(epochs) == 3 and rows["port"] == rows["jax"]
    evals = VALIDATE_SECS + TEST_SECS
    for line, validated in zip(epochs, (method == "mixup", ) * 2 + (True,)):
        secs = 2 * STEP_SECS + (evals if validated else 0.0)
        assert line.endswith(f", {2 * 4 / secs:.0f} img/s"), line


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=6,
                                n_retrieved_per_class=6)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config("test_tiny"), seed=0), ckpt)
    yml = base / "config.yml"
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    yield str(yml), ckpt
    undo()


def _cli_run(yml, ckpt, folder, capsys, *extra):
    from swat_tpu_torch.cli.main import main

    main(["--dataset", DATASET, "--method", "cutmix", "--data_source",
          "fewshot+retrieved", "--retrieval_split", "T2T30.txt",
          "--model_cfg", "test_tiny", "--shots", "4", "--config_yml", yml,
          "--checkpoint_path", ckpt, "--num_workers", "2",
          "--folder", str(folder), "--mesh_data", "1", "--device", "cpu",
          "--recal_prompt", "--bsz", "4", "--epochs", "2", "--skip_stage2",
          *extra])
    (loss_csv,) = glob.glob(f"{folder}/**/loss.csv", recursive=True)
    with open(loss_csv) as f:
        return summary_line(capsys.readouterr().out), f.read()


def test_traced_cli_run_matches_the_untraced_one(setup, tmp_path, capsys):
    """A cutmix stage-1 run with --trace_dir --device cpu: the summary line
    and loss.csv of the same run without it, and one Chrome trace holding
    the run's host operators."""
    yml, ckpt = setup
    plain = _cli_run(yml, ckpt, tmp_path / "plain", capsys)
    trace_dir = tmp_path / "trace"
    traced = _cli_run(yml, ckpt, tmp_path / "traced", capsys,
                      "--trace_dir", str(trace_dir))
    assert traced == plain
    assert len(plain[1].splitlines()) == 3
    (path,) = glob.glob(str(trace_dir / f"rank0.*{profiling.TRACE_SUFFIX}"))
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
