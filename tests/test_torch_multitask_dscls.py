"""finetune-multitask and dataset-cls on the CPU against swat_tpu, test_tiny
in fp32: 3 steps of each from the same weights and canvases (the JAX
steps' own crops, torch_port_lib.jax_crop_draws), held by the per-step
losses (rtol 1e-4), logit_scale (1e-5) and the delta rule on every visual
tensor and head, multitask's dataset head included; validate_multitask
against swat_tpu's (both accuracies and confusion matrices exactly, the
loss to rtol 1e-5); one stage-1 run of each through the port's CLI and
swat_tpu's pipeline (multitask: loss.csv rows, summary line, and a
stage-1 bundle whose bytes are swat_tpu's save_bundle of its arrays;
dataset-cls: loss.csv rows and no summary row); the --accum and
WeightedCE refusals; a multitask train checkpoint round trip."""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_steps import (BSZ, LR_BB, LR_HEAD, MODEL,  # noqa: F401
                                    N_STEPS, TOTAL_ITER, setup)
from torch_port_lib import (DATASET, RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, delta_check, jax_crop_draws,
                            loss_rows, make_dataset, random_state_dict,
                            register_dataset, run_kwargs, summary_line,
                            write_dataset_cls_splits)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.eval.validate import Evaluator as JaxEvaluator
from swat_tpu.eval.validate import validate_multitask as jax_validate_mt
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train import steps as JS
from swat_tpu.train.checkpoint import save_bundle as jax_save_bundle
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.eval.validate import Evaluator, validate_multitask
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.checkpoint import (load_bundle, load_train_ckpt,
                                             save_train_ckpt)
from swat_tpu_torch.train.optim import default_warmup_lr, make_lr_schedule
from swat_tpu_torch.train.stages import SwatPipeline
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import (make_dataset_cls_step,
                                        make_multitask_step, make_sampler)

torch.set_num_threads(TORCH_THREADS)

DS_WD = 0.7


def _dataset_head(embed_dim, seed=8):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, embed_dim)).astype(np.float32)
    return h / np.linalg.norm(h, axis=-1, keepdims=True)


def _jax_run(method, params, head, dhead, batches, keys):
    model = JaxCLIPModel(jax_model_config(MODEL), precision=JAX_FP32)
    tree = head if dhead is None else {"cls": head, "dataset": dhead}
    state, tx = jax_create_state(params, tree, method, lr_classifier=LR_HEAD,
                                 lr_backbone=LR_BB, total_iter=TOTAL_ITER)
    if method == "finetune-multitask":
        step = JS.make_multitask_step(model, tx, dataset_wd=DS_WD,
                                      image_size=32)
    else:
        step = JS.make_dataset_cls_step(model, tx, image_size=32)
    losses = []
    for batch, key in zip(batches, keys):
        state, loss = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, key)
        losses.append(float(loss))
    return state, losses


def _port_state(method, sd, head, dhead=None):
    model = CLIPModel(get_model_config(MODEL), precision=FP32_PRECISION)
    model.load_state_dict(sd)
    return create_train_state(
        model, torch.from_numpy(head), method, lr_classifier=LR_HEAD,
        lr_backbone=LR_BB, total_iter=TOTAL_ITER,
        dataset_head=None if dhead is None else torch.from_numpy(dhead))


def _lr_sum(base):
    schedule = make_lr_schedule(base, TOTAL_ITER,
                                warmup_lr=default_warmup_lr(LR_BB))
    return sum(schedule(i) for i in range(N_STEPS))


@pytest.mark.parametrize("method", ["finetune-multitask", "dataset-cls"])
def test_steps_match_swat_tpu(setup, method):
    """3 steps of each (module docstring); dataset-cls on a binary head,
    its labels the batch's source flag; multitask's dataset logits
    unscaled, its dataset head moved by the delta rule too."""
    cfg, sd, params, head, batches, keys, _ = setup
    multitask = method == "finetune-multitask"
    if not multitask:
        head = _dataset_head(cfg.embed_dim, seed=9)
    dhead = _dataset_head(cfg.embed_dim) if multitask else None
    jstate, j_losses = _jax_run(method, params, head, dhead, batches, keys)

    state = _port_state(method, sd, head, dhead)
    step = (make_multitask_step(dataset_wd=DS_WD, image_size=32) if multitask
            else make_dataset_cls_step(image_size=32))
    losses, g0 = [], {}
    for batch, key in zip(batches, keys):
        losses.append(float(step(state, batch,
                                 jax_crop_draws(key, batch["valid_hw"]))))
        if not g0:
            g0 = {k: p.grad.detach().clone().numpy()
                  for k, p in state.model.named_parameters()
                  if p.grad is not None}
            g0["head"] = state.head.grad.numpy().copy()
            if multitask:
                g0["dataset"] = state.dataset_head.grad.numpy().copy()

    np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-5)
    assert state.logit_scale.item() == pytest.approx(
        float(jstate.logit_scale), abs=1e-5)
    j_head = jstate.head["cls"] if multitask else jstate.head
    moved = delta_check("head", head, np.asarray(j_head),
                        state.head.detach().numpy(), g0["head"],
                        _lr_sum(LR_HEAD), 0.0)
    if multitask:
        moved += delta_check("dataset", dhead,
                             np.asarray(jstate.head["dataset"]),
                             state.dataset_head.detach().numpy(),
                             g0["dataset"], _lr_sum(LR_HEAD), 0.0)
    j_model = params_to_torch_state_dict(jstate.model, 0.0)
    got = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    for k, ref in j_model.items():
        if k == "logit_scale":
            continue
        init = sd[k].numpy()
        if not k.startswith("visual."):
            np.testing.assert_array_equal(got[k], init, err_msg=k)
            continue
        moved += delta_check(k, init, ref, got[k], g0[k], _lr_sum(LR_BB),
                             N_STEPS * LR_BB * 1.5)
    assert moved == sum(k.startswith("visual.") for k in j_model) + 1 + (
        1 if multitask else 0)


@pytest.mark.parametrize("method", ["finetune-multitask", "dataset-cls"])
def test_samplers_draw_crops_only(setup, method):
    batch = setup[4][0]
    d = make_sampler(method, image_size=32)(np.random.default_rng(0), batch)
    assert d.mix is None and d.twin_crops is None
    assert d.crops.boxes.shape == (BSZ, 4)


def test_validate_multitask_matches_swat_tpu(setup):
    """Three batches of 5 images, the last padded by 2 masked rows: class
    and dataset accuracy and both confusion matrices equal, the loss (mean
    of per-batch means at exp(logit_scale)) to rtol 1e-5."""
    cfg, sd, params, head = setup[:4]
    dhead = _dataset_head(cfg.embed_dim)
    rng = np.random.default_rng(4)
    batches = []
    for i in range(3):
        batches.append({
            "images": rng.standard_normal((5, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 3, 5).astype(np.int32),
            "source": rng.integers(0, 2, 5).astype(np.int32),
            "mask": np.array([True] * (3 if i == 2 else 5)
                             + [False] * (2 if i == 2 else 0))})
    jmodel = JaxCLIPModel(jax_model_config(MODEL), precision=JAX_FP32)
    ref = jax_validate_mt(JaxEvaluator(jmodel, 3), params, head, dhead,
                          np.float32(4.0), batches)
    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(sd)
    got = validate_multitask(Evaluator(3), model, torch.from_numpy(head),
                             torch.from_numpy(dhead), 4.0, batches)
    assert got[0] == ref[0] and got[3] == ref[3]
    assert got[1] == pytest.approx(ref[1], rel=1e-5)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[4], ref[4])
    assert got[2].sum() == got[4].sum() == 13 and got[4].shape == (2, 2)


def test_multitask_train_checkpoint_round_trip(setup, tmp_path):
    """A multitask train checkpoint: the head slot is the map {cls,
    dataset} (swat_tpu's layout); restoring it gives back both heads,
    logit_scale, the step and the AdamW moments of every group."""
    cfg, sd, params, head, batches, keys, _ = setup
    dhead = _dataset_head(cfg.embed_dim)
    saved, fresh = (_port_state("finetune-multitask", sd, head, dhead)
                    for _ in range(2))
    make_multitask_step(image_size=32)(
        saved, batches[0], jax_crop_draws(keys[0], batches[0]["valid_hw"]))
    path = save_train_ckpt(str(tmp_path), "ep1_it1", saved, {})
    arrays, _ = load_bundle(path)
    assert sorted(arrays["head"]) == ["cls", "dataset"]
    assert sorted(arrays["opt_state"]["head"]) == ["cls", "dataset"]
    load_train_ckpt(path, fresh)
    assert fresh.step == saved.step == 1
    for a, b in ((fresh.head, saved.head),
                 (fresh.dataset_head, saved.dataset_head),
                 (fresh.logit_scale, saved.logit_scale)):
        assert torch.equal(a, b)
    assert not torch.equal(fresh.dataset_head.detach(),
                           torch.from_numpy(dhead))
    for p, q in zip((p for g in saved.optimizer.param_groups
                     for p in g["params"]),
                    (q for g in fresh.optimizer.param_groups
                     for q in g["params"])):
        for slot in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(saved.optimizer.state[p][slot],
                               fresh.optimizer.state[q][slot])


# ---------------------------------------------------------------------------
# through the pipelines

STAGE1 = dict(data_source="fewshot+retrieved", retrieval_split=RETRIEVAL_SPLIT,
              epochs=2, skip_stage2=True, compute_dtype="float32",
              lr_classifier=1e-2, lr_backbone=1e-4, aug_mode="eval", bsz=4)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10,
                                n_retrieved_per_class=10,
                                n_unlabeled_per_class=2)
    write_dataset_cls_splits(dataset_path)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config(MODEL), seed=0), ckpt)
    yield dataset_path, ckpt
    undo()


def _cli(dataset_path, ckpt, folder, method, *extra):
    from swat_tpu_torch.cli.main import main

    yml = folder / "config.yml"
    os.makedirs(folder, exist_ok=True)
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--dataset", DATASET, "--method", method, "--model_cfg", MODEL,
              "--shots", "4", "--config_yml", str(yml), "--checkpoint_path",
              ckpt, "--num_workers", "2", "--folder", str(folder),
              "--mesh_data", "1", "--device", "cpu", "--recal_prompt",
              "--bsz", "4", "--aug_mode", "eval", "--epochs", "2",
              "--skip_stage2", "--lr_classifier", "1e-2", "--lr_backbone",
              "1e-4", *extra])
    return out.getvalue()


def test_multitask_cli_matches_swat_tpu(dataset, tmp_path):
    """Stage-1 finetune-multitask (--dataset_wd 0.5): the summary line,
    both loss.csv rows (every epoch validated, both heads), the dataset
    accuracies logged, and the stage-1 bundle: swat_tpu's tree (the class
    head alone in its head slot), its bytes those of swat_tpu's
    save_bundle of the same arrays and sidecar, its head near swat_tpu's."""
    dataset_path, ckpt = dataset
    args = dict(STAGE1, method="finetune-multitask", dataset_wd=0.5)
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **args)).derived())
    jax_summary = jax_pipe.run()
    jax_pipe.loss_logger.close()
    out = _cli(dataset_path, ckpt, tmp_path / "port", "finetune-multitask",
               "--data_source", "fewshot+retrieved", "--retrieval_split",
               RETRIEVAL_SPLIT, "--dataset_wd", "0.5")
    assert summary_line(out) == jax_summary
    assert jax_summary.split(",")[1] == "finetune-multitask"
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", **args)).derived()
    got, ref = loss_rows(cfg.output_dir), loss_rows(jax_pipe.cfg.output_dir)
    assert len(got) == 2 and got[0][4] >= 0
    assert_rows_match(got, ref)
    with open(os.path.join(cfg.output_dir, "main.log")) as f:
        log = f.read()
    assert log.count("Dataset Val Acc:") == log.count("Dataset Test Acc:") \
        == 2

    def bundle(d):
        (name,) = [f for f in os.listdir(d)
                   if f.startswith("stage1_model") and f.endswith(".msgpack")]
        return os.path.join(d, name)

    path = bundle(cfg.output_dir)
    arrays, meta = load_bundle(path)
    ref_arrays, _ = load_bundle(bundle(jax_pipe.cfg.output_dir))
    assert arrays["head"].shape == ref_arrays["head"].shape == (3, 32)
    np.testing.assert_allclose(arrays["head"], ref_arrays["head"],
                               rtol=0, atol=1e-4)
    jax_save_bundle(str(tmp_path / "again.msgpack"),
                    jax.tree_util.tree_map(np.asarray, arrays), meta)
    assert (tmp_path / "again.msgpack").read_bytes() == open(
        path, "rb").read()


def test_dataset_cls_cli_matches_swat_tpu(dataset, tmp_path):
    """Stage-1 dataset-cls (--data_source dataset-cls: the few-shot and
    retrieved images, flagged): both loss.csv rows against swat_tpu's,
    validation on the flag (its accuracy logged), no summary row, no stage
    bundle, in both packages."""
    dataset_path, ckpt = dataset
    args = dict(STAGE1, method="dataset-cls", data_source="dataset-cls")
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **args)).derived())
    assert jax_pipe.run() == ""
    jax_pipe.loss_logger.close()
    out = _cli(dataset_path, ckpt, tmp_path / "port", "dataset-cls",
               "--data_source", "dataset-cls")
    assert not [ln for ln in out.splitlines() if ln.startswith(DATASET)]
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", **args)).derived()
    got, ref = loss_rows(cfg.output_dir), loss_rows(jax_pipe.cfg.output_dir)
    assert len(got) == 2 and 0 <= got[1][4] <= 100.001
    assert_rows_match(got, ref)
    for d in (cfg.output_dir, jax_pipe.cfg.output_dir):
        assert not [f for f in os.listdir(d) if f.endswith(".msgpack")]
    with open(os.path.join(cfg.output_dir, "main.log")) as f:
        assert "dataset-cls run complete (no summary row" in f.read()


@pytest.mark.parametrize("method", ["fixmatch", "finetune-multitask",
                                    "dataset-cls"])
def test_accum_is_refused(dataset, tmp_path, method):
    """--accum 2: the same ValueError as swat_tpu's, before any step."""
    dataset_path, ckpt = dataset
    kw = dict(STAGE1, method=method, accum=2)
    if method == "dataset-cls":
        kw["data_source"] = "dataset-cls"
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **kw)).derived())
    with pytest.raises(ValueError, match="--accum only supports"):
        jax_pipe.train_method(jax_pipe.cfg, jax_pipe.params, jax_pipe.head)
    jax_pipe.loss_logger.close()
    port = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", checkpoint_path=ckpt,
        **kw)).derived())
    with pytest.raises(ValueError, match="--accum only supports"):
        port.train_method(port.cfg, port.zeroshot_head)
    port.loss_logger.close()


def test_dataset_cls_weighted_ce_raises_at_start(dataset, tmp_path):
    """dataset-cls hands its loss no source flag: swat_tpu's WeightedCE
    fails inside its first step (None has no astype), the port refuses the
    run before any work, with a ValueError that says why."""
    dataset_path, ckpt = dataset
    kw = dict(STAGE1, method="dataset-cls", data_source="dataset-cls",
              loss_name="WeightedCE")
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **kw)).derived())
    with pytest.raises(AttributeError, match="astype"):
        jax_pipe.run()
    jax_pipe.loss_logger.close()
    port = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", checkpoint_path=ckpt,
        **kw)).derived())
    with pytest.raises(ValueError, match="WeightedCE"):
        port.run()
    port.loss_logger.close()
    assert loss_rows(port.cfg.output_dir) == []
