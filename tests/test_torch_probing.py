"""Linear probing on the CPU against swat_tpu: the probing step
(make_probing_step, 3 steps on pre-extracted features and 3 streaming
eval-preprocessed images through the frozen tower) held by the
gradient-conditioned delta rule, and stage-1 --method probing end to end
in both --pre_extracted modes (a train-transform snapshot, or fresh
images every step), lock-step: summary line, loss.csv rows and the
bundle's records."""

import json
import os

import numpy as np
import pytest
import torch
from torch_port_lib import (RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, delta_check,
                            jax_params_from_state_dict, loss_rows,
                            make_dataset, random_state_dict,
                            register_dataset, run_kwargs)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.train import steps as JS
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.optim import default_warmup_lr, make_lr_schedule
from swat_tpu_torch.train.stages import SwatPipeline
from swat_tpu_torch.train.state import LOG100, create_train_state
from swat_tpu_torch.train.steps import StepDraws, make_probing_step

torch.set_num_threads(TORCH_THREADS)

N_STEPS, BSZ, LR_HEAD, TOTAL_ITER = 3, 6, 1e-2, 10


def _batches(pre_extracted, embed_dim):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(N_STEPS):
        batch = {"labels": rng.integers(0, 3, BSZ).astype(np.int32),
                 "source": rng.integers(0, 2, BSZ).astype(np.int32)}
        if pre_extracted:
            f = rng.standard_normal((BSZ, embed_dim)).astype(np.float32)
            batch["features"] = f / np.linalg.norm(f, axis=-1, keepdims=True)
        else:
            batch["images"] = rng.standard_normal(
                (BSZ, 32, 32, 3)).astype(np.float32)
        out.append(batch)
    return out


@pytest.mark.parametrize("pre_extracted", [True, False])
def test_probing_steps_match_swat_tpu(pre_extracted):
    """The head trains alone: its deltas by the delta rule, logit_scale
    pinned at ln 100 and every model tensor bit-unchanged in both."""
    import jax
    import jax.numpy as jnp

    cfg = get_model_config("test_tiny")
    sd = random_state_dict(cfg, seed=0)
    params, _ = jax_params_from_state_dict(sd, cfg)
    head = np.random.default_rng(1).standard_normal(
        (3, cfg.embed_dim)).astype(np.float32)
    batches = _batches(pre_extracted, cfg.embed_dim)

    jmodel = JaxCLIPModel(jax_model_config("test_tiny"), precision=JAX_FP32)
    jstate, tx = jax_create_state(params, head, "probing",
                                  lr_classifier=LR_HEAD, total_iter=TOTAL_ITER)
    jstep = JS.make_probing_step(jmodel, tx, pre_extracted=pre_extracted,
                                 image_size=32)
    j_losses = []
    for batch, key in zip(batches, jax.random.split(jax.random.PRNGKey(0),
                                                    N_STEPS)):
        jstate, loss = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, key)
        j_losses.append(float(loss))

    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(sd)
    state = create_train_state(model, torch.from_numpy(head), "probing",
                               lr_classifier=LR_HEAD, total_iter=TOTAL_ITER)
    assert [g["label"] for g in state.optimizer.param_groups] == ["head"]
    assert not any(p.requires_grad for p in model.parameters())
    step = make_probing_step(pre_extracted=pre_extracted, image_size=32)
    losses, g0 = [], None
    for batch in batches:
        losses.append(float(step(state, batch, StepDraws())))
        if g0 is None:
            g0 = state.head.grad.numpy().copy()

    np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-6)
    schedule = make_lr_schedule(LR_HEAD, TOTAL_ITER,
                                warmup_lr=default_warmup_lr(1e-6))
    assert delta_check("head", head, np.asarray(jstate.head),
                       state.head.detach().numpy(), g0,
                       sum(schedule(i) for i in range(N_STEPS)), 0.0) == 1
    assert state.logit_scale.item() == float(jstate.logit_scale) == \
        np.float32(LOG100)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


STAGE1 = dict(method="probing", data_source="fewshot+retrieved",
              retrieval_split=RETRIEVAL_SPLIT, aug_mode="eval", epochs=2,
              skip_stage2=True, compute_dtype="float32", lr_classifier=1e-2)


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


def _meta(output_dir):
    (name,) = [f for f in os.listdir(output_dir)
               if f.startswith("stage1_model") and f.endswith(".json")]
    with open(os.path.join(output_dir, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("pre_extracted", [True, False])
def test_stage1_probing_matches_swat_tpu(setup, tmp_path, pre_extracted):
    """Two epochs of stage-1 probing, validating every epoch on the cached
    val features; the port extracts its own (--recal_fea)."""
    dataset_path, ckpt = setup
    args = dict(STAGE1, pre_extracted=pre_extracted, recal_fea=True)
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
    assert summary.split(",")[1] == "probing"
    rows = loss_rows(port.cfg.output_dir)
    assert len(rows) == 2 and all(r[4] >= 0 for r in rows)
    assert_rows_match(rows, loss_rows(jax_pipe.cfg.output_dir))
    g, r = _meta(port.cfg.output_dir), _meta(jax_pipe.cfg.output_dir)
    assert g == r
