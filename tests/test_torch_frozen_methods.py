"""REAL-Linear and CMLP (cross-modal linear probing) on the CPU against
swat_tpu: 3 steps of each through make_probing_step / make_cmlp_step, on
pre-extracted features and on uint8 canvases augmented with the JAX
steps' own crops (torch_port_lib.jax_crop_draws) and encoded by the frozen
tower, held by the gradient-conditioned delta rule (the head) with both
towers bit-unchanged; CMLP's flattened prompt bank and its text batches,
its halved batch, and one stage-1 run of each method through the port's
CLI (CMLP with --use_attribute) against swat_tpu's pipeline: summary line
and loss.csv rows."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_steps import (BSZ, LR_HEAD, N_STEPS,  # noqa: F401
                                    TOTAL_ITER, _lr_sum, setup)
from torch_port_lib import (DATASET, RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, delta_check, jax_crop_draws,
                            loss_rows, make_dataset, random_state_dict,
                            register_dataset, run_kwargs, summary_line)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.data import pipeline as JP
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.train import stages as JST
from swat_tpu.train import steps as JS
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.data import pipeline as P
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.stages import flatten_prompt_bank
from swat_tpu_torch.train.state import LOG100, create_train_state
from swat_tpu_torch.train.steps import (StepDraws, make_cmlp_step,
                                        make_probing_step, make_sampler)

torch.set_num_threads(TORCH_THREADS)

N_TEXT = 4      # text rows a CMLP step


def _with_inputs(batches, pre_extracted, embed_dim):
    """The setup's canvas batches, or feature batches of the same labels;
    each with a batch of CMLP's text rows."""
    rng = np.random.default_rng(5)
    out = []
    for b in batches:
        b = dict(b)
        if pre_extracted:
            f = rng.standard_normal((BSZ, embed_dim)).astype(np.float32)
            b = {"features": f / np.linalg.norm(f, axis=-1, keepdims=True),
                 "labels": b["labels"], "source": b["source"]}
        t = rng.standard_normal((N_TEXT, embed_dim)).astype(np.float32)
        b["text_features"] = t / np.linalg.norm(t, axis=-1, keepdims=True)
        b["text_labels"] = rng.integers(0, 3, N_TEXT).astype(np.int32)
        out.append(b)
    return out


@pytest.mark.parametrize("pre_extracted", [True, False])
@pytest.mark.parametrize("method", ["REAL-Linear", "CMLP"])
def test_frozen_steps_match_swat_tpu(setup, method, pre_extracted):
    """The head trains alone: the per-step losses (fp32 forwards of the
    same weights; the crop resample differs by up to ~1e-2 of 255 between
    the frameworks: rtol 1e-4), the head by the delta rule, logit_scale
    pinned at ln 100 and every tensor of both towers bit-unchanged in both
    packages."""
    cfg, sd, params, head, batches, keys, _ = setup
    batches = _with_inputs(batches, pre_extracted, cfg.embed_dim)
    if not pre_extracted:
        draws = [jax_crop_draws(k, b["valid_hw"])
                 for k, b in zip(keys, batches)]
    else:
        draws = [StepDraws()] * N_STEPS

    jmodel = JaxCLIPModel(jax_model_config("test_tiny"), precision=JAX_FP32)
    jstate, tx = jax_create_state(params, head, method,
                                  lr_classifier=LR_HEAD, total_iter=TOTAL_ITER)
    make = JS.make_cmlp_step if method == "CMLP" else JS.make_probing_step
    jstep = make(jmodel, tx, pre_extracted=pre_extracted, image_size=32)
    j_losses = []
    for batch, key in zip(batches, keys):
        jstate, loss = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, key)
        j_losses.append(float(loss))

    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(sd)
    state = create_train_state(model, torch.from_numpy(head), method,
                               lr_classifier=LR_HEAD, total_iter=TOTAL_ITER)
    assert [g["label"] for g in state.optimizer.param_groups] == ["head"]
    assert not any(p.requires_grad for p in model.parameters())
    make = make_cmlp_step if method == "CMLP" else make_probing_step
    step = make(pre_extracted=pre_extracted, image_size=32)
    losses, g0 = [], None
    for batch, d in zip(batches, draws):
        losses.append(float(step(state, batch, d)))
        if g0 is None:
            g0 = state.head.grad.numpy().copy()

    np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-6)
    assert delta_check("head", head, np.asarray(jstate.head),
                       state.head.detach().numpy(), g0, _lr_sum(LR_HEAD),
                       0.0) == 1
    assert state.logit_scale.item() == float(jstate.logit_scale) == \
        np.float32(LOG100)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_frozen_samplers_draw_crops_only(setup):
    """REAL-Linear, CMLP (and FLYP) draw a canvas batch's crops and flips
    and no mix; a feature batch draws nothing."""
    batches = setup[4]
    for method in ("REAL-Linear", "CMLP", "FLYP"):
        d = make_sampler(method, image_size=32)(np.random.default_rng(0),
                                                batches[0])
        assert d.mix is None and d.twin_crops is None
        assert d.crops.boxes.shape == (BSZ, 4) and d.crops.flips.shape == \
            (BSZ,)
        d = make_sampler(method)(np.random.default_rng(0),
                                 {"labels": np.zeros(3)})
        assert d == StepDraws()


@pytest.mark.parametrize("seed", [0, 1])
def test_cmlp_text_bank_matches_swat_tpu(seed):
    """The flattened bank (classes in integer order, not string order) and
    two epochs of its shuffled drop-last batches through CyclingLoader."""
    rng = np.random.default_rng(seed)
    bank = {str(c): {"all": rng.standard_normal(
        (int(rng.integers(1, 5)), 8)).astype(np.float32)}
        for c in (10, 2, 0, 1)}
    feats, labels = flatten_prompt_bank(bank)
    ref_feats, ref_labels = JST._flatten_prompt_bank(bank)
    np.testing.assert_array_equal(feats, ref_feats)
    np.testing.assert_array_equal(labels, ref_labels)
    assert labels.dtype == ref_labels.dtype == np.int32
    assert list(dict.fromkeys(labels)) == [0, 1, 2, 10]
    got = P.CyclingLoader(P.FeatureBatches(feats, labels, batch_size=3,
                                           shuffle=True, drop_last=True,
                                           seed=seed + 1))
    ref = JP.CyclingLoader(JP.FeatureBatches(ref_feats, ref_labels,
                                             batch_size=3, shuffle=True,
                                             drop_last=True, seed=seed + 1))
    for _ in range(2 * (len(labels) // 3) + 1):
        g, r = got.next(), ref.next()
        for k in ("features", "labels"):
            np.testing.assert_array_equal(g[k], r[k])


@pytest.mark.parametrize("bsz", [8, 9, 32])
def test_cmlp_batch_is_halved_as_in_swat_tpu(bsz):
    """RunConfig.derived() halves CMLP's batch once (deriving again leaves
    it), as swat_tpu's does; REAL-Linear keeps it."""
    for method, want in (("CMLP", bsz // 2), ("REAL-Linear", bsz)):
        kw = dict(dataset=DATASET, method=method, bsz=bsz)
        got = RunConfig(**kw).derived()
        ref = JaxRunConfig(**kw).derived()
        assert got.bsz == ref.bsz == want
        assert got.derived().bsz == ref.derived().bsz == want
        assert got.freeze_visual and ref.freeze_visual


STAGE1 = dict(data_source="fewshot+retrieved", retrieval_split=RETRIEVAL_SPLIT,
              epochs=2, skip_stage2=True, compute_dtype="float32",
              lr_classifier=1e-2)
# the attribute corpus of --use_attribute, class by class
ATTRIBUTES = {"0": {"corpus": ["Has red feathers", "round shape"]},
              "1": {"corpus": ["Has green leaves"]},
              "2": {"corpus": []}}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10,
                                n_retrieved_per_class=10)
    prompts = os.path.join(dataset_path, DATASET, "prompts")
    os.makedirs(prompts, exist_ok=True)
    with open(os.path.join(prompts, f"visual-attrs-{DATASET}.json"),
              "w") as f:
        json.dump(ATTRIBUTES, f)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config("test_tiny"), seed=0), ckpt)
    yield dataset_path, ckpt
    undo()


@pytest.mark.parametrize("method,pre_extracted,use_attribute", [
    ("REAL-Linear", False, False), ("CMLP", True, True)])
def test_frozen_method_cli_matches_swat_tpu(dataset, tmp_path, capsys,
                                            method, pre_extracted,
                                            use_attribute):
    """Stage 1 through the port's CLI and swat_tpu's pipeline, --aug_mode
    eval, 2 epochs at bsz 8 (CMLP: 4, and text batches of 4 from the
    attribute bank): the summary line and both loss.csv rows.  REAL-Linear
    encodes its images at every step, CMLP reads a snapshot's features."""
    from swat_tpu_torch.cli.main import main

    dataset_path, ckpt = dataset
    args = dict(STAGE1, method=method, bsz=8, recal_fea=True,
                aug_mode="eval", pre_extracted=pre_extracted,
                use_attribute=use_attribute)
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **args)).derived())
    jax_summary = jax_pipe.run()
    jax_pipe.loss_logger.close()
    capsys.readouterr()
    yml = tmp_path / "config.yml"
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    main(["--dataset", DATASET, "--method", method, "--data_source",
          "fewshot+retrieved", "--retrieval_split", RETRIEVAL_SPLIT,
          "--model_cfg", "test_tiny", "--shots", "4", "--config_yml",
          str(yml), "--checkpoint_path", ckpt, "--num_workers", "2",
          "--folder", str(tmp_path / "port"), "--mesh_data", "1",
          "--device", "cpu", "--recal_prompt", "--recal_fea", "--bsz", "8",
          "--epochs", "2", "--skip_stage2", "--lr_classifier", "1e-2",
          "--aug_mode", "eval", "--use_attribute", str(use_attribute),
          *(["--pre_extracted"] if pre_extracted else [])])
    out = capsys.readouterr().out
    summary = summary_line(out)
    assert summary == jax_summary
    assert summary.split(",")[1] == method
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", **args)).derived()
    got, ref = loss_rows(cfg.output_dir), loss_rows(jax_pipe.cfg.output_dir)
    assert len(got) == 2
    assert_rows_match(got, ref)


def test_cmlp_weighted_ce_raises_at_start(dataset, tmp_path):
    """CMLP's text rows carry no source flag: swat_tpu's WeightedCE fails
    inside its first step (None has no astype), the port refuses the run
    before any work, with a ValueError that says why."""
    from swat_tpu_torch.train.stages import SwatPipeline

    dataset_path, ckpt = dataset
    args = dict(STAGE1, method="CMLP", bsz=8, pre_extracted=True,
                aug_mode="eval", loss_name="WeightedCE")
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **args)).derived())
    with pytest.raises(AttributeError, match="astype"):
        jax_pipe.run()
    jax_pipe.loss_logger.close()
    port = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", checkpoint_path=ckpt, **args)))
    with pytest.raises(ValueError, match="WeightedCE"):
        port.run()
    port.loss_logger.close()
    assert not os.path.exists(os.path.join(port.cfg.output_dir, "loss.csv")) \
        or loss_rows(port.cfg.output_dir) == []
