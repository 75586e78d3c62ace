"""The port's random classifier head against swat_tpu's on the CPU:
``init_head_random(seed, ...)`` is ``jax.random.uniform(PRNGKey(seed), ...,
-1/sqrt(D), 1/sqrt(D))`` bit for bit (the numpy threefry of
swat_tpu_torch/models/head.py), for the seeds and shapes the runs draw
(--training_seed, dataset-cls's binary head at it, multitask's dataset
head at training_seed + 1; D = 512 and 768, the B/32 and L/14 embeddings);
the heads each pipeline starts from are equal; a stage-1 run with
--cls_init random gives swat_tpu's loss.csv rows and summary line."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import (RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, loss_rows, make_dataset,
                            random_state_dict, register_dataset, run_kwargs)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.models.head import init_head_random as jax_init_head_random
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.models.head import init_head_random, jax_uniform
from swat_tpu_torch.train.stages import SwatPipeline

torch.set_num_threads(TORCH_THREADS)


@pytest.mark.parametrize("shape", [(2, 512), (2, 768), (10, 512),
                                   (200, 768)])
@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_init_head_random_is_swat_tpus(seed, shape):
    ref = np.asarray(jax_init_head_random(jax.random.PRNGKey(seed), *shape))
    got = init_head_random(seed, *shape, torch.device("cpu"))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), ref)
    bound = np.float32(1 / np.sqrt(shape[1]))
    assert -bound <= ref.min() and ref.max() < bound


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.0, 0.5)])
def test_jax_uniform_other_ranges(lo, hi):
    """The one-rounding affine map holds off the head's symmetric range
    too, at a shape that is not a multiple of anything."""
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (64, 129),
                                        jnp.float32, lo, hi))
    np.testing.assert_array_equal(jax_uniform(3, (64, 129), lo, hi), ref)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10,
                                n_retrieved_per_class=10)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config("test_tiny"), seed=0), ckpt)
    yield dataset_path, ckpt
    undo()


STAGE1 = dict(method="finetune", data_source="fewshot+retrieved",
              retrieval_split=RETRIEVAL_SPLIT, cls_init="random", epochs=2,
              skip_stage2=True, compute_dtype="float32", aug_mode="eval",
              lr_classifier=1e-2, lr_backbone=1e-4, training_seed=3,
              no_wsft=True)


def test_random_head_run_matches_swat_tpu(dataset, tmp_path):
    """--cls_init random, --training_seed 3, no zero-shot check: both
    pipelines start from the same head, and stage 1 gives the same
    loss.csv rows and summary line."""
    dataset_path, ckpt = dataset
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **STAGE1)).derived())
    port = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", checkpoint_path=ckpt,
        **STAGE1)).derived())
    np.testing.assert_array_equal(port.zeroshot_head.numpy(),
                                  np.asarray(jax_pipe.head))
    assert port.zeroshot_head.shape == (3, 32)
    jax_summary = jax_pipe.run()
    summary = port.run()
    for pipe in (jax_pipe, port):
        pipe.loss_logger.close()
    assert summary == jax_summary
    got, ref = loss_rows(port.cfg.output_dir), loss_rows(
        jax_pipe.cfg.output_dir)
    assert len(got) == 2
    assert_rows_match(got, ref)
