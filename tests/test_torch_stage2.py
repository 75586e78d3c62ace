"""The flagship SWAT run end to end on the CPU, lock-step: the same
OpenCLIP-format checkpoint and synthetic dataset (few-shot + retrieved
split) through swat_tpu's SwatPipeline and swat_tpu_torch.cli.main with
--method cutmix --data_source fewshot+retrieved --aug_mode eval --mix_prob
0 --epochs 2 in fp32, stage 2 included: stage-1 finetuning, WiSE-FT,
tau-norm, stage-2 probing on the few-shot snapshot features (10 epochs) and
few-shot finetuning (10 epochs).  The eval preprocess on train batches and
mix_prob 0 make every trajectory deterministic, so the summary line, the
22 loss.csv rows, the score files and the output files must agree.  Then
--skip_stage1 from a stage-1 bundle of either package in the other."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
from torch_port_lib import (DATASET, RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, loss_rows, make_dataset,
                            random_state_dict, register_dataset, run_kwargs,
                            summary_line)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.train.checkpoint import load_bundle as jax_load_bundle
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.data.features import params_fingerprint, tree_leaves
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.checkpoint import load_bundle
from swat_tpu_torch.train.stages import SwatPipeline

torch.set_num_threads(TORCH_THREADS)

FLAGSHIP = dict(method="cutmix", data_source="fewshot+retrieved",
                retrieval_split=RETRIEVAL_SPLIT, aug_mode="eval",
                mix_prob=0.0, epochs=2, compute_dtype="float32",
                lr_classifier=1e-2, lr_backbone=1e-4)
CLI_FLAGSHIP = [
    "--dataset", DATASET, "--method", "cutmix", "--data_source",
    "fewshot+retrieved", "--retrieval_split", RETRIEVAL_SPLIT,
    "--model_cfg", "test_tiny", "--shots", "4", "--num_workers", "2",
    "--mesh_data", "1", "--device", "cpu", "--recal_prompt", "--bsz", "4",
    "--aug_mode", "eval", "--mix_prob", "0", "--epochs", "2",
    "--lr_classifier", "1e-2", "--lr_backbone", "1e-4"]
STAGE_FILES = ("test_scores.json", "test_confusion_matrix.npy",
               "val_scores_best.json", "val_confusion_matrix_best.npy")


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


def _cache_files(dataset_path) -> set:
    path = os.path.join(dataset_path, DATASET, "pre_extracted")
    return set(os.listdir(path)) if os.path.isdir(path) else set()


@pytest.fixture(scope="module")
def jax_run(setup, tmp_path_factory):
    """The flagship run through swat_tpu -> (output dir, summary, the
    feature-cache files it wrote)."""
    dataset_path, ckpt = setup
    before = _cache_files(dataset_path)
    pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path_factory.mktemp("jax"), checkpoint_path=ckpt,
        **FLAGSHIP)).derived())
    summary = pipe.run()
    pipe.loss_logger.close()
    return pipe.cfg.output_dir, summary, _cache_files(dataset_path) - before


@pytest.fixture(scope="module")
def port_run(setup, jax_run, tmp_path_factory):
    """The same run through the port's CLI, after the JAX one -> (output
    dir, summary, the feature-cache files it wrote)."""
    from swat_tpu_torch.cli.main import main

    dataset_path, ckpt = setup
    folder = tmp_path_factory.mktemp("port")
    yml = folder / "config.yml"
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    before = _cache_files(dataset_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(CLI_FLAGSHIP + ["--config_yml", str(yml), "--checkpoint_path",
                             ckpt, "--folder", str(folder)])
    cfg = RunConfig(device="cpu", **run_kwargs(dataset_path, folder,
                                               **FLAGSHIP)).derived()
    return (cfg.output_dir, summary_line(out.getvalue()),
            _cache_files(dataset_path) - before)


def _bundle(output_dir, stage):
    (name,) = [f for f in os.listdir(output_dir)
               if f.startswith(f"stage{stage}_model") and
               f.endswith(".msgpack")]
    return os.path.join(output_dir, name)


def test_flagship_summary_matches_swat_tpu(jax_run, port_run):
    assert port_run[1] == jax_run[1]
    fields = port_run[1].split(",")
    assert len(fields) == 11 and fields[1] == "cutmix"
    assert all(0.0 <= float(x) <= 100.0 for x in fields[7:])


def test_flagship_loss_rows_match_swat_tpu(jax_run, port_run):
    """2 rows of stage 1, then 10 of stage-2 probing (validating every
    epoch on the snapshot features) and 10 of few-shot finetuning
    (validating at its last epoch only)."""
    got, ref = loss_rows(port_run[0]), loss_rows(jax_run[0])
    assert len(got) == 22
    assert_rows_match(got, ref)
    assert [r[0] for r in got] == [1, 2] + list(range(1, 11)) * 2
    assert all(r[4] >= 0 for r in got[2:12])
    assert all(r[4] == -1.0 for r in got[12:21]) and got[21][4] >= 0


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_flagship_score_files_match_swat_tpu(jax_run, port_run, stage):
    for name in STAGE_FILES:
        name = f"stage{stage}_{name}"
        g, r = (os.path.join(d, name) for d in (port_run[0], jax_run[0]))
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(g), np.load(r))
        else:
            with open(g) as fg, open(r) as fr:
                assert fg.read() == fr.read(), name


def test_flagship_output_files_match_swat_tpu(jax_run, port_run):
    """The same file names, the three bundles' .msgpack included, and
    bundles of the same tree: keys, shapes and dtypes, the sidecars' keys
    and records."""
    assert sorted(os.listdir(port_run[0])) == sorted(os.listdir(jax_run[0]))
    for stage in (1, 2, 3):
        got, g_meta = load_bundle(_bundle(port_run[0], stage))
        ref, r_meta = jax_load_bundle(_bundle(jax_run[0], stage))

        def paths(tree, prefix=()):
            if isinstance(tree, dict):
                return [p for k in sorted(tree)
                        for p in paths(tree[k], prefix + (k,))]
            return [(prefix, np.shape(tree), np.asarray(tree).dtype)]

        assert paths(got) == paths(ref)
        assert sorted(g_meta) == sorted(r_meta)
        for key in ("best_epoch", "best_iter", "best_val_acc", "test_acc",
                    "best_tau", "best_tau_test_acc", "wsft_test_acc"):
            assert g_meta[key] == r_meta[key], (stage, key)
    # probing leaves the model alone and logit_scale at ln 100
    bundle, _ = load_bundle(_bundle(port_run[0], 2))
    assert float(bundle["logit_scale"]) == np.float32(4.60517)


def test_flagship_extracts_its_own_features(setup, jax_run, port_run):
    """Stage 2's feature cache: each package extracted with its own stage-1
    weights and wrote its own files, named by those weights'
    fingerprints (the same function in both packages)."""
    for run in (jax_run, port_run):
        clip = load_bundle(_bundle(run[0], 1))[0]["clip"]
        fp = params_fingerprint(clip)
        assert sorted(f.split("_")[-2] for f in run[2]) == [fp, fp], run[2]
        assert sorted(f.split("_")[3] for f in run[2]) == [
            "fsprobe", "test"]
    assert not jax_run[2] & port_run[2]
    assert len(tree_leaves(clip)) == 37


def _skip_stage1_kwargs(setup, folder, bundle):
    dataset_path, ckpt = setup
    return run_kwargs(dataset_path, folder, checkpoint_path=ckpt,
                      skip_stage1=True, stage1_model_path=bundle,
                      recal_fea=True, **FLAGSHIP)


def _check_stage2_only(summary, rows, other_run):
    """A --skip_stage1 run against the other package's full run from the
    same stage-1 bundle: stage 1's fields at -1.0, stage 2's equal, and
    the 20 stage-2 rows."""
    fields, ref = summary.split(","), other_run[1].split(",")
    assert fields[7:9] == ["-1.0", "-1.0"]
    assert fields[9:] == ref[9:]
    assert_rows_match(rows, loss_rows(other_run[0])[2:])


def test_skip_stage1_from_a_swat_tpu_bundle(setup, jax_run, tmp_path):
    port = SwatPipeline(RunConfig(device="cpu", **_skip_stage1_kwargs(
        setup, tmp_path, _bundle(jax_run[0], 1))).derived())
    summary = port.run()
    port.loss_logger.close()
    _check_stage2_only(summary, loss_rows(port.cfg.output_dir), jax_run)


def test_skip_stage1_from_a_port_bundle_in_swat_tpu(setup, port_run,
                                                    tmp_path):
    pipe = JaxPipeline(JaxRunConfig(**_skip_stage1_kwargs(
        setup, tmp_path, _bundle(port_run[0], 1))).derived())
    summary = pipe.run()
    pipe.loss_logger.close()
    _check_stage2_only(summary, loss_rows(pipe.cfg.output_dir), port_run)
