"""Stage 1 end to end on the CPU, lock-step: the same OpenCLIP-format
checkpoint and synthetic dataset (few-shot + retrieved split) through
swat_tpu's SwatPipeline, swat_tpu_torch's SwatPipeline and
swat_tpu_torch.cli.main, with --method cutmix --data_source
fewshot+retrieved --aug_mode eval --mix_prob 0 --epochs 2 --skip_stage2 in
fp32.  The eval preprocess on train batches and mix_prob 0 make the two
trajectories deterministic (no augmentation or mixing draws), so the
summary line, the loss.csv rows, the WiSE-FT and tau-norm accuracies and
the output files must agree."""

import json
import os

import numpy as np
import pytest
import torch
from torch_port_lib import (DATASET, RETRIEVAL_SPLIT, TORCH_THREADS,
                            make_dataset, random_state_dict,
                            register_dataset, run_kwargs, write_v2_tree)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.kernels import flash_attention as FA
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.checkpoint import load_bundle
from swat_tpu_torch.train.stages import SwatPipeline

torch.set_num_threads(TORCH_THREADS)

STAGE1 = dict(method="cutmix", data_source="fewshot+retrieved",
              retrieval_split=RETRIEVAL_SPLIT, aug_mode="eval", mix_prob=0.0,
              epochs=2, skip_stage2=True, compute_dtype="float32",
              lr_classifier=1e-2, lr_backbone=1e-4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10,
                                n_retrieved_per_class=10)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config("test_tiny"), seed=0), ckpt)
    yield dataset_path, ckpt
    undo()


def _summary(out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith(f"{DATASET},")]
    assert len(lines) == 1, out
    return lines[0]


def _rows(output_dir):
    with open(os.path.join(output_dir, "loss.csv")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "Epoch,Iter,Train_loss,Val_loss,Val_acc,Test_acc"
    return [[float(x) for x in ln.split(",")] for ln in lines[1:]]


def _bundle_meta(output_dir, suffix):
    names = [f for f in os.listdir(output_dir)
             if f.startswith("stage1_model") and f.endswith(suffix)]
    assert len(names) == 1, os.listdir(output_dir)
    with open(os.path.join(output_dir, names[0] + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_run(setup, tmp_path_factory):
    dataset_path, ckpt = setup
    folder = tmp_path_factory.mktemp("jax")
    cfg = JaxRunConfig(**run_kwargs(dataset_path, folder,
                                    checkpoint_path=ckpt, **STAGE1))
    pipe = JaxPipeline(cfg.derived())
    summary = pipe.run()
    pipe.loss_logger.close()
    return pipe.cfg.output_dir, summary


def _check_against_jax(jax_run, output_dir, summary):
    jax_dir, jax_summary = jax_run
    assert summary == jax_summary
    parts = summary.split(",")
    assert len(parts) == 11 and parts[1] == "cutmix"
    assert parts[9:] == ["-1.0", "-1.0"]

    # loss.csv: epoch, iter, and the validation columns exactly; the train
    # loss is a mean of fp32 losses summed in another order by another
    # framework's kernels (rtol 1e-4)
    got, ref = _rows(output_dir), _rows(jax_dir)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g[:2] == r[:2]
        assert g[2] == pytest.approx(r[2], rel=1e-4)
        assert g[3] == pytest.approx(r[3], rel=1e-4, abs=1e-6)
        assert g[4:] == r[4:]
    assert got[0][3:] == [-1.0, -1.0, -1.0]    # cutmix validates at the end

    # WiSE-FT, tau-norm and test accuracies, and the bundle's records
    g_meta = _bundle_meta(output_dir, ".msgpack")
    r_meta = _bundle_meta(jax_dir, ".msgpack")
    for key in ("best_val_acc", "best_epoch", "best_iter", "test_acc",
                "best_tau", "best_tau_test_acc", "wsft_test_acc"):
        assert g_meta[key] == pytest.approx(r_meta[key], abs=1e-6), key

    # the same output files, the bundle's .msgpack included
    assert sorted(os.listdir(output_dir)) == sorted(os.listdir(jax_dir))
    for name in ("stage1_test_scores.json", "stage1_val_scores_best.json"):
        with open(os.path.join(output_dir, name)) as f:
            g = json.load(f)
        with open(os.path.join(jax_dir, name)) as f:
            r = json.load(f)
        assert g == r, name
    for name in ("stage1_test_confusion_matrix.npy",
                 "stage1_val_confusion_matrix_best.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(output_dir, name)),
                                      np.load(os.path.join(jax_dir, name)))


def test_stage1_pipeline_matches_swat_tpu(setup, jax_run, tmp_path, capsys):
    dataset_path, ckpt = setup
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path, checkpoint_path=ckpt, **STAGE1))
    port = SwatPipeline(cfg.derived())
    summary = port.run()
    port.loss_logger.close()
    assert _summary(capsys.readouterr().out) == summary
    _check_against_jax(jax_run, port.cfg.output_dir, summary)
    bundle, _ = load_bundle(os.path.join(port.cfg.output_dir, next(
        f for f in os.listdir(port.cfg.output_dir)
        if f.endswith(".msgpack"))))
    assert sorted(bundle) == ["best_tau_head", "clip", "head", "logit_scale",
                              "wsft_backbone", "wsft_head"]
    assert bundle["head"].shape == (3, 32)


def test_stage1_cli_matches_swat_tpu(setup, jax_run, tmp_path, capsys):
    from swat_tpu_torch.cli.main import main

    dataset_path, ckpt = setup
    yml = tmp_path / "config.yml"
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    before = (FA.LAUNCHES, FA.LAUNCHES_BWD)
    main(["--dataset", DATASET, "--method", "cutmix", "--data_source",
          "fewshot+retrieved", "--retrieval_split", RETRIEVAL_SPLIT,
          "--model_cfg", "test_tiny", "--shots", "4", "--config_yml",
          str(yml), "--checkpoint_path", ckpt, "--num_workers", "2",
          "--folder", str(tmp_path / "cli"), "--mesh_data", "1",
          "--device", "cpu", "--recal_prompt", "--bsz", "4",
          "--aug_mode", "eval", "--mix_prob", "0", "--epochs", "2",
          "--skip_stage2", "--lr_classifier", "1e-2", "--lr_backbone",
          "1e-4"])
    summary = _summary(capsys.readouterr().out)
    assert (FA.LAUNCHES, FA.LAUNCHES_BWD) == before   # no kernel on the CPU
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "cli", **STAGE1)).derived()
    _check_against_jax(jax_run, cfg.output_dir, summary)


def test_stage1_epochs0_matches_swat_tpu(setup, tmp_path):
    """--epochs 0, the parser's default: no step runs, the initial weights
    are the best snapshot (best_epoch -1), and WiSE-FT, tau-norm and the
    bundle follow as after training."""
    dataset_path, ckpt = setup
    args = dict(STAGE1, epochs=0)
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **args)).derived())
    jax_summary = jax_pipe.run()
    jax_pipe.loss_logger.close()
    port = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", checkpoint_path=ckpt,
        **args)).derived())
    summary = port.run()
    port.loss_logger.close()
    assert summary == jax_summary
    g_meta = _bundle_meta(port.cfg.output_dir, ".msgpack")
    r_meta = _bundle_meta(jax_pipe.cfg.output_dir, ".msgpack")
    assert g_meta["best_epoch"] == r_meta["best_epoch"] == -1
    for key in ("best_val_acc", "best_iter", "test_acc", "best_tau",
                "best_tau_test_acc", "wsft_test_acc"):
        assert g_meta[key] == pytest.approx(r_meta[key], abs=1e-6), key
    assert _rows(port.cfg.output_dir) == _rows(jax_pipe.cfg.output_dir) == []


@pytest.mark.parametrize("kw,match", [
    ({"trace_dir": "trace"}, "--trace_dir .*Queue A item 11"),
])
def test_unported_stage1_options_raise(setup, tmp_path, kw, match):
    dataset_path, ckpt = setup
    args = dict(STAGE1, **kw)
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path, checkpoint_path=ckpt, **args))
    with pytest.raises(NotImplementedError, match=match):
        SwatPipeline(cfg).run()


def test_stage1_test_imagenet_ood_matches_swat_tpu(setup, jax_run, tmp_path,
                                                  capsys, monkeypatch):
    """--test_imagenet_ood with --skip_stage2: the run is swat_tpu's, and
    the sweep runs on the stage-1 bundle with the accuracies swat_tpu's
    sweep gives its own run's bundle."""
    dataset_path, ckpt = setup
    write_v2_tree(dataset_path)
    swept = []
    real = SwatPipeline.run_ood

    def record(self, model_path=None):
        swept.append((model_path, real(self, model_path)))
        return swept[-1][1]

    monkeypatch.setattr(SwatPipeline, "run_ood", record)
    kw = run_kwargs(dataset_path, tmp_path, checkpoint_path=ckpt,
                    test_imagenet_ood=True, **STAGE1)
    port = SwatPipeline(RunConfig(device="cpu", **kw).derived())
    summary = port.run()
    port.loss_logger.close()
    assert _summary(capsys.readouterr().out) == summary
    _check_against_jax(jax_run, port.cfg.output_dir, summary)
    ((path, accs),) = swept
    assert os.path.dirname(path) == port.cfg.output_dir
    assert os.path.basename(path).startswith("stage1_model")
    (jax_bundle,) = [f for f in os.listdir(jax_run[0])
                     if f.startswith("stage1_model") and f.endswith(".msgpack")]
    jax_pipe = JaxPipeline(JaxRunConfig(**kw).derived())
    assert accs == jax_pipe.run_ood(os.path.join(jax_run[0], jax_bundle))
    assert list(accs) == ["imagenet_v2"]


def test_stage1_host_aug_matches_swat_tpu(setup, tmp_path):
    """--aug_mode host: the reference's PIL train transform on the host,
    each image's generator seeded from the loader's own draws, so both
    packages train on bit-equal images (mix_prob 0: no mixing draws)."""
    dataset_path, ckpt = setup
    args = dict(STAGE1, aug_mode="host", epochs=1)
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **args)).derived())
    jax_summary = jax_pipe.run()
    jax_pipe.loss_logger.close()
    port = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", checkpoint_path=ckpt,
        **args)).derived())
    summary = port.run()
    port.loss_logger.close()
    assert summary == jax_summary
    got, ref = _rows(port.cfg.output_dir), _rows(jax_pipe.cfg.output_dir)
    assert len(got) == len(ref) == 1
    assert got[0][:2] == ref[0][:2] and got[0][4:] == ref[0][4:]
    assert got[0][2] == pytest.approx(ref[0][2], rel=1e-4)
    assert got[0][3] == pytest.approx(ref[0][3], rel=1e-4, abs=1e-6)
