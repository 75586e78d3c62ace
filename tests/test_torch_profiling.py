"""The port's profiling hooks (swat_tpu_torch/utils/profiling.py) against
swat_tpu's: ``maybe_trace`` is a no-op without a directory and writes a
torch.profiler Chrome trace with one; ``StepMeter`` and the trainer's use
of it give swat_tpu's numbers under one fake clock (so the epoch log's
img/s counts the whole epoch, validation included, in both packages); a
traced CLI run gives the untraced run's summary line and loss.csv, and
holds the epoch loop's spans.  ``span`` is the shared null context with
no profiler running, and a profiled resident cutmix step holds its phases
in order inside its ``train.step``; ``--accum 2`` a forward / backward
pair a microbatch."""

import contextlib
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
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train import trainer
from swat_tpu_torch.train.resident import ResidentData, make_resident_epoch
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import make_mixing_step, make_sampler
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


PHASES = ["train.batch", "train.draws", "train.augment", "train.forward",
          "train.backward", "train.optimizer"]


def test_span_without_a_profiler_is_the_shared_null_context():
    """No profiler: every span is one shared null context, and a span
    entered before a profiler starts records nothing in it; while one
    records, a span is a range of its own."""
    off = profiling.span("train.step")
    assert off is profiling.span("train.forward")
    assert isinstance(off, contextlib.nullcontext)
    with off:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            torch.ones(4).sum()
            with profiling.span("train.forward"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "train.step" not in names and names.count("train.forward") == 1
    assert profiling.span("train.step") is off


def _tiny_cutmix(accum=1):
    """A tiny ViT's cutmix state, step (``accum`` microbatches) and
    sampler, and a resident split of 8 canvases."""
    cfg = get_model_config("test_tiny")
    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(random_state_dict(cfg, seed=0))
    rng = np.random.default_rng(0)
    state = create_train_state(
        model, torch.from_numpy(rng.standard_normal(
            (3, cfg.embed_dim)).astype(np.float32)), "cutmix",
        total_iter=10)
    canvases = torch.from_numpy(rng.integers(0, 256, (8, 40, 40, 3),
                                             dtype=np.uint8))
    data = ResidentData(canvases, np.full((8, 2), 40, np.int32),
                        torch.from_numpy(rng.integers(0, 3, 8)),
                        torch.from_numpy(rng.integers(0, 2, 8)))
    return (state, make_mixing_step("cutmix", image_size=32, accum=accum),
            make_sampler("cutmix", mix_prob=1.0, image_size=32), data)


def _spans(prof):
    """The program's spans of a CPU profile -> [(name, start, end)] by
    start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("train.")),
                  key=lambda s: s[1])


def test_resident_step_spans_its_phases_in_order():
    """One resident cutmix step: one ``train.step``, enclosing each of
    the six phases once, in order, none overlapping the next."""
    state, step, sample, data = _tiny_cutmix()
    run = make_resident_epoch(step, sample)
    perm = np.arange(4, dtype=np.int64).reshape(1, 4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run(state, data, perm, np.random.default_rng(1))
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["train.step"] + PHASES
    _, start, end = spans[0]
    phases = spans[1:]
    assert all(start <= a <= b <= end for _, a, b in phases)
    assert all(b <= a2 for (_, _, b), (_, a2, _) in zip(phases, phases[1:]))


def test_accumulated_step_spans_a_pair_a_microbatch():
    """``accum=2``: the augment once, then a forward / backward pair for
    each microbatch, then the optimizer."""
    state, step, sample, data = _tiny_cutmix(accum=2)
    batch = data.batch(np.arange(4))
    draws = sample(np.random.default_rng(1), batch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch, draws)
    assert [s[0] for s in _spans(prof)] == [
        "train.augment", "train.forward", "train.backward", "train.forward",
        "train.backward", "train.optimizer"]


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
            r.append((m.elapsed, m.items_per_sec))
    clock.advance(2.0)
    for m, r in zip(meters, readings):
        m.reset()
        r.append((m.elapsed, m.items_per_sec))
    assert readings[0] == readings[1]
    assert readings[0][2] == (2.5, 192 / 2.5)
    assert readings[0][3] == (0.0, 0.0)


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


def test_streaming_loop_spans_each_step(clock):
    """The per-batch loop of ``train_loop``: three epochs of two batches
    give two ``train.step`` spans an epoch with their batch and draws, and
    one more each holding only the ``train.batch`` that found the loader
    empty; the last epoch is validated and tested."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run_port_loop(clock, "cutmix", Logger(), None)
    names = [s[0] for s in _spans(prof)]
    assert [names.count(n) for n in (
        "train.epoch", "train.step", "train.batch", "train.draws",
        "train.validate", "train.test")] == [3, 9, 9, 6, 1, 1]
    assert names[:4] == ["train.epoch", "train.step", "train.batch",
                         "train.draws"]


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
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    # two resident epochs of 7 steps, the last one validated and tested
    assert spans.count("train.epoch") == 2
    assert [spans.count(n) for n in ["train.step"] + PHASES] == [14] * 7
    assert spans.count("train.validate") == spans.count("train.test") == 1
