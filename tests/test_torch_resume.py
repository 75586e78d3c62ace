"""--save_ckpt then --resume on the CPU, lock-step with swat_tpu: each
package runs stage-1 cutmix (--aug_mode eval --mix_prob 0, fp32) for 3
epochs stopped after 2 (--stop_epochs 2), writing a train checkpoint every
epoch, then the same run with --resume (and --save_ckpt), which restores
the newest checkpoint of its own package and trains epoch 3 alone.  The
checkpoint names, both runs' loss.csv rows and summary lines must agree."""

import os

import pytest
import torch
from torch_port_lib import (RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, loss_rows, make_dataset,
                            random_state_dict, register_dataset, run_kwargs)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.stages import SwatPipeline

torch.set_num_threads(TORCH_THREADS)

RUN = dict(method="cutmix", data_source="fewshot+retrieved",
           retrieval_split=RETRIEVAL_SPLIT, aug_mode="eval", mix_prob=0.0,
           epochs=3, skip_stage2=True, compute_dtype="float32",
           lr_classifier=1e-2, lr_backbone=1e-4)
FIRST = dict(stop_epochs=2, save_ckpt=True, save_freq=1)
RESUMED = dict(FIRST, stop_epochs=200, resume=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' two runs -> {package: [(output dir, summary, loss
    rows, checkpoint names)] for the first and the resumed run}."""
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10,
                                n_retrieved_per_class=10)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config("test_tiny"), seed=0), ckpt)
    out = {}
    for name, config, pipeline, kw in (
            ("jax", JaxRunConfig, JaxPipeline, {}),
            ("port", RunConfig, SwatPipeline, {"device": "cpu"})):
        folder = tmp_path_factory.mktemp(name)
        out[name] = []
        for extra in (FIRST, RESUMED):
            pipe = pipeline(config(**kw, **run_kwargs(
                dataset_path, folder, checkpoint_path=ckpt, **RUN,
                **extra)).derived())
            summary = pipe.run()
            pipe.loss_logger.close()
            d = pipe.cfg.output_dir
            out[name].append((d, summary, loss_rows(d), sorted(
                os.listdir(os.path.join(d, "model_ckpts")))))
    yield out
    undo()


def test_checkpoints_are_written_as_in_swat_tpu(runs):
    """Every epoch of the first run (save_freq 1), then the last epoch of
    the resumed one, under the JAX package's names."""
    first, resumed = runs["port"]
    assert first[3] == ["ckpt_ep1_it10.msgpack", "ckpt_ep1_it10.msgpack.json",
                        "ckpt_ep2_it20.msgpack", "ckpt_ep2_it20.msgpack.json"]
    assert resumed[3] == sorted(first[3] + ["ckpt_ep3_it30.msgpack",
                                            "ckpt_ep3_it30.msgpack.json"])
    assert [r[3] for r in runs["port"]] == [r[3] for r in runs["jax"]]


@pytest.mark.parametrize("which", [0, 1])
def test_runs_match_swat_tpu(runs, which):
    """The stopped run (epochs 1-2, no best snapshot: the run stops before
    its last epoch) and the resumed one (epoch 3, from iteration 20)."""
    got, ref = runs["port"][which], runs["jax"][which]
    assert got[1] == ref[1]
    assert_rows_match(got[2], ref[2])
    assert [r[:2] for r in got[2]] == ([[1, 10], [2, 20]] if which == 0
                                       else [[3, 30]])
