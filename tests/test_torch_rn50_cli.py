"""RN50 through the CLI on the CPU against swat_tpu: the flagship run
(cutmix, fewshot+retrieved, fp32, into stage 2) on the tiny RN50 of
tests/test_torch_rn50_train.py, registered at run time in both packages'
registries: its summary line, loss.csv rows and stage bundles (swat_tpu's
tree, values close to swat_tpu's, the stage-1 BN statistics trained away
from the checkpoint's, the bytes exactly what swat_tpu's save_bundle writes
for the arrays); and ``--accum 2`` refused before any epoch by both
pipelines."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
from test_torch_rn50_train import (ACCUM_ERROR, MODEL, _assert_bn_equal,
                                   _bn_stats)
from torch_port_lib import (DATASET, RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, loss_rows, make_dataset,
                            random_state_dict, register_dataset,
                            rn50_configs, run_kwargs, summary_line)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.models import configs as JAX_CONFIGS
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train import checkpoint as JCK
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.models import configs as CONFIGS
from swat_tpu_torch.train import checkpoint as CK
from swat_tpu_torch.train.stages import SwatPipeline

torch.set_num_threads(TORCH_THREADS)

# the flagship run's statistics after 20 (stage 1) to 50 (stage 3) steps,
# the weights' own differences compounding (measured 1.0e-4)
BN_REL_RUN = 1e-3

FLAGSHIP = dict(method="cutmix", data_source="fewshot+retrieved",
                retrieval_split=RETRIEVAL_SPLIT, aug_mode="eval",
                mix_prob=0.0, epochs=2, compute_dtype="float32",
                lr_classifier=1e-2, lr_backbone=1e-4)
CLI_FLAGSHIP = [
    "--dataset", DATASET, "--method", "cutmix", "--data_source",
    "fewshot+retrieved", "--retrieval_split", RETRIEVAL_SPLIT,
    "--model_cfg", MODEL, "--shots", "4", "--num_workers", "2",
    "--mesh_data", "1", "--device", "cpu", "--recal_prompt", "--bsz", "4",
    "--aug_mode", "eval", "--mix_prob", "0", "--epochs", "2",
    "--lr_classifier", "1e-2", "--lr_backbone", "1e-4"]


@pytest.fixture(scope="module")
def registered(tmp_path_factory):
    """The tiny RN50 in both packages' registries, the synthetic dataset
    and a seeded OpenCLIP-format checkpoint of it."""
    cfg, jax_cfg = rn50_configs(MODEL)
    undo = register_dataset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(CONFIGS.MODEL_REGISTRY, MODEL, cfg)
        mp.setitem(JAX_CONFIGS.MODEL_REGISTRY, MODEL, jax_cfg)
        base = tmp_path_factory.mktemp("data")
        dataset_path = make_dataset(base, n_test_per_class=6,
                                    n_retrieved_per_class=4)
        ckpt = str(base / "rn50_tiny.pt")
        torch.save(random_state_dict(cfg, seed=3), ckpt)
        yield dataset_path, ckpt
    undo()


def _bundle(output_dir, stage):
    (name,) = [f for f in os.listdir(output_dir)
               if f.startswith(f"stage{stage}_model") and
               f.endswith(".msgpack")]
    return os.path.join(output_dir, name)


@pytest.fixture(scope="module")
def flagship_runs(registered, tmp_path_factory):
    """The flagship run through swat_tpu's pipeline, then through the
    port's CLI -> ((output dir, summary) of swat_tpu, of the port)."""
    from swat_tpu_torch.cli.main import main

    dataset_path, ckpt = registered
    pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path_factory.mktemp("jax"), model_cfg=MODEL,
        checkpoint_path=ckpt, **FLAGSHIP)).derived())
    jax_summary = pipe.run()
    pipe.loss_logger.close()
    folder = tmp_path_factory.mktemp("port")
    yml = folder / "config.yml"
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(CLI_FLAGSHIP + ["--config_yml", str(yml), "--checkpoint_path",
                             ckpt, "--folder", str(folder)])
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, folder, model_cfg=MODEL, **FLAGSHIP)).derived()
    return ((pipe.cfg.output_dir, jax_summary),
            (cfg.output_dir, summary_line(out.getvalue())))


def test_flagship_cli_run_matches_swat_tpu(registered, flagship_runs,
                                           tmp_path):
    """The summary line and the 22 loss.csv rows as swat_tpu's; each stage
    bundle holds swat_tpu's tree (its keys, shapes and dtypes) with values
    close to swat_tpu's, the stage-1 BN statistics trained away from the
    checkpoint's, and its bytes are exactly what swat_tpu's save_bundle
    writes for the arrays it holds."""
    (j_dir, j_summary), (p_dir, p_summary) = flagship_runs
    assert p_summary == j_summary
    assert len(p_summary.split(",")) == 11
    got, ref = loss_rows(p_dir), loss_rows(j_dir)
    assert len(got) == 22
    assert_rows_match(got, ref)
    init = _bn_stats(torch.load(registered[1]))
    for stage in (1, 2, 3):
        path = _bundle(p_dir, stage)
        arrays, meta = CK.load_bundle(path)
        ref_arrays, _ = JCK.load_bundle(_bundle(j_dir, stage))
        JCK.save_bundle(str(tmp_path / "jax.msgpack"), arrays, meta)
        with open(path, "rb") as f:
            assert f.read() == (tmp_path / "jax.msgpack").read_bytes()
        g_sd = params_to_torch_state_dict(arrays["clip"], 0.0)
        r_sd = params_to_torch_state_dict(ref_arrays["clip"], 0.0)
        assert sorted(g_sd) == sorted(r_sd)
        for k, v in r_sd.items():
            assert np.shape(g_sd[k]) == np.shape(v), k
        _assert_bn_equal(_bn_stats(g_sd), _bn_stats(r_sd),
                         init if stage == 1 else None, BN_REL_RUN)


def test_accum_2_on_rn50_is_refused_by_the_pipeline(registered, tmp_path):
    """Stage 1 of ``--accum 2`` on RN50 raises swat_tpu's ValueError in
    both packages before any epoch."""
    dataset_path, ckpt = registered
    kw = dict(FLAGSHIP, accum=2)
    with pytest.raises(ValueError, match=ACCUM_ERROR):
        JaxPipeline(JaxRunConfig(**run_kwargs(
            dataset_path, tmp_path / "jax", model_cfg=MODEL,
            checkpoint_path=ckpt, **kw)).derived()).run()
    with pytest.raises(ValueError, match=ACCUM_ERROR):
        SwatPipeline(RunConfig(device="cpu", **run_kwargs(
            dataset_path, tmp_path / "port", model_cfg=MODEL,
            checkpoint_path=ckpt, **kw))).run()
