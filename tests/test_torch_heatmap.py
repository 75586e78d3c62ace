"""The heatmap path of attentivemix in the port, on the CPU against
swat_tpu: encode_image_tokens against the Flax model's own
(``model.apply(..., method=CLIPModel.encode_image_tokens)`` with
use_pallas=True, the heads-first Pallas kernel in interpret mode), both
heatmaps, the pipeline's text bank with its fallback, and the stage-1 run
of each new method through both pipelines and the port's CLI, lock-step
(--aug_mode eval --mix_prob 0: no augmentation or mixing draws, so summary
line, loss.csv rows and bundle records must agree)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stage1 import _bundle_meta, _rows, _summary
from torch_port_lib import (DATASET, RETRIEVAL_SPLIT, TORCH_THREADS,
                            jax_params_from_state_dict, make_dataset,
                            random_state_dict, register_dataset, run_kwargs)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.eval import heatmap as jheatmap
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from swat_tpu_torch.eval import heatmap
from swat_tpu_torch.kernels import flash_attention as FA
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train import stages
from swat_tpu_torch.train.stages import SwatPipeline

torch.set_num_threads(TORCH_THREADS)

MODEL = "test_tiny"     # 2 layers, width 64, 4 heads (D = 16), 32 px, 4x4 grid


@pytest.fixture(scope="module")
def towers():
    cfg = get_model_config(MODEL)
    sd = random_state_dict(cfg, seed=0)
    params, _ = jax_params_from_state_dict(sd, cfg)
    jax_model = JaxCLIPModel(jax_model_config(MODEL), precision=JAX_FP32,
                             use_pallas=True)
    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(sd)
    model.eval().requires_grad_(False)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((5, 32, 32, 3)).astype(np.float32)
    return cfg, model, jax_model, params, images


def test_encode_image_tokens_matches_the_flax_model(towers):
    """ln_post and the projection on every token, class token first, fp32:
    the Flax scan tower through the heads-first Pallas kernel against the
    port's tower through the kernel's plain twin (atol 1e-5: summation
    order through 2 layers)."""
    cfg, model, jax_model, params, images = towers
    ref = np.asarray(jax_model.apply(
        {"params": params}, jnp.asarray(images),
        method=JaxCLIPModel.encode_image_tokens))
    got = model.encode_image_tokens(torch.from_numpy(images))
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (5, 17, cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # the class token's row is encode_image's feature
    feats = model.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got[:, 0].numpy(), feats.numpy(), rtol=0,
                               atol=1e-5)


def test_tokens_take_the_heads_first_route(towers, monkeypatch):
    """encode_image_tokens goes through flash_attention (one call per
    layer), encode_image through the packed-head attention; in fp32 the
    two routes agree."""
    cfg, model, _, _, images = towers
    calls = []
    real = FA.FlashAttention.apply
    monkeypatch.setattr(FA.FlashAttention, "apply", staticmethod(
        lambda *a: calls.append(a[0].shape) or real(*a)))
    x = torch.from_numpy(images)
    tokens = model.encode_image_tokens(x)
    assert calls == [(5, 4, 17, 16)] * cfg.vision.layers
    calls.clear()
    packed = model.encode_image_tokens(x, attention=FA.mha_qkv)
    assert calls == []
    torch.testing.assert_close(tokens, packed, rtol=0, atol=1e-5)


def test_heatmaps_match_swat_tpu(towers):
    cfg, model, jax_model, params, images = towers
    ref = np.asarray(jheatmap.clip_attention_heatmap(jax_model, params,
                                                     jnp.asarray(images)))
    got = heatmap.clip_attention_heatmap(model, torch.from_numpy(images))
    assert got.shape == ref.shape == (5, 4, 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert np.abs(got.numpy()).max() <= 1 + 1e-6
    np.testing.assert_array_equal(got.reshape(5, -1).argmax(-1).numpy(),
                                  ref.reshape(5, -1).argmax(-1))

    text = np.random.default_rng(2).standard_normal(
        (5, cfg.embed_dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    ref = np.asarray(jheatmap.clip_text_heatmap(
        jax_model, params, jnp.asarray(images), jnp.asarray(text)))
    got = heatmap.clip_text_heatmap(model, torch.from_numpy(images),
                                    torch.from_numpy(text))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_bf16_heatmaps_stay_close_to_fp32(towers):
    """The throughput policy (bf16 compute, fp32 LayerNorm and softmax):
    cosine maps within 3e-2 of the fp32 ones after 2 layers of bf16
    matmuls, and finite."""
    cfg, model, _, _, images = towers
    ref = heatmap.clip_attention_heatmap(model, torch.from_numpy(images))
    model.precision = DEFAULT_PRECISION
    try:
        got = heatmap.clip_attention_heatmap(model, torch.from_numpy(images))
    finally:
        model.precision = FP32_PRECISION
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, rtol=0, atol=3e-2)


# ---------------------------------------------------------------------------
# the pipeline


STAGE1 = dict(data_source="fewshot+retrieved",
              retrieval_split=RETRIEVAL_SPLIT, aug_mode="eval", mix_prob=0.0,
              epochs=2, skip_stage2=True, compute_dtype="float32",
              lr_classifier=1e-2, lr_backbone=1e-4)
METHODS = ["mixup", "resizemix", "saliencymix", "attentivemix"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10,
                                n_retrieved_per_class=10)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config(MODEL), seed=0), ckpt)
    yield dataset_path, ckpt
    undo()


@pytest.fixture(scope="module")
def jax_runs(setup, tmp_path_factory):
    """method -> (output dir, summary, text bank) of swat_tpu's run, made
    once per method on first use."""
    dataset_path, ckpt = setup
    done = {}

    def run(method):
        if method not in done:
            folder = tmp_path_factory.mktemp(f"jax_{method}")
            cfg = JaxRunConfig(**run_kwargs(
                dataset_path, folder, checkpoint_path=ckpt, method=method,
                use_pallas=True, **STAGE1))
            pipe = JaxPipeline(cfg.derived())
            bank = (np.asarray(pipe._attentive_text_bank())
                    if method == "attentivemix" else None)
            summary = pipe.run()
            pipe.loss_logger.close()
            done[method] = (pipe.cfg.output_dir, summary, bank)
        return done[method]

    return run


def _check_against_jax(jax_run, output_dir, summary, method):
    jax_dir, jax_summary, _ = jax_run
    assert summary == jax_summary
    parts = summary.split(",")
    assert len(parts) == 11 and parts[1] == method
    assert parts[9:] == ["-1.0", "-1.0"]
    got, ref = _rows(output_dir), _rows(jax_dir)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g[:2] == r[:2]
        assert g[2] == pytest.approx(r[2], rel=1e-4)
        assert g[3] == pytest.approx(r[3], rel=1e-4, abs=1e-6)
        assert g[4:] == r[4:]
    # saliencymix validates on the last epoch only; the other three every
    # epoch (trainer.VALIDATE_EVERY_EPOCH)
    if method == "saliencymix":
        assert got[0][3:] == [-1.0, -1.0, -1.0]
    else:
        assert got[0][3] > 0 and got[0][4] >= 0
    g_meta = _bundle_meta(output_dir, ".msgpack")
    r_meta = _bundle_meta(jax_dir, ".msgpack")
    for key in ("best_val_acc", "best_epoch", "best_iter", "test_acc",
                "best_tau", "best_tau_test_acc", "wsft_test_acc"):
        assert g_meta[key] == pytest.approx(r_meta[key], abs=1e-6), key


@pytest.mark.parametrize("method", METHODS)
def test_stage1_pipeline_matches_swat_tpu(setup, jax_runs, tmp_path, capsys,
                                          method):
    """saliencymix and attentivemix sum the per-sample CE (lambda vector of
    ones at mix_prob 0), so their train losses are bsz x the others'."""
    dataset_path, ckpt = setup
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path, checkpoint_path=ckpt, method=method,
        **STAGE1))
    port = SwatPipeline(cfg.derived())
    summary = port.run()
    port.loss_logger.close()
    assert _summary(capsys.readouterr().out) == summary
    _check_against_jax(jax_runs(method), port.cfg.output_dir, summary, method)
    loss0 = _rows(port.cfg.output_dir)[0][2]
    if method in ("saliencymix", "attentivemix"):
        assert loss0 > 2.0          # 4 x ~ln(3)
    else:
        assert loss0 < 2.0


@pytest.mark.parametrize("method", ["mixup", "attentivemix"])
def test_stage1_cli_matches_swat_tpu(setup, jax_runs, tmp_path, capsys,
                                     method):
    from swat_tpu_torch.cli.main import main

    dataset_path, ckpt = setup
    yml = tmp_path / "config.yml"
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    before = (FA.LAUNCHES, FA.LAUNCHES_BWD, FA.LAUNCHES_FLASH,
              FA.LAUNCHES_FLASH_BWD)
    main(["--dataset", DATASET, "--method", method, "--data_source",
          "fewshot+retrieved", "--retrieval_split", RETRIEVAL_SPLIT,
          "--model_cfg", MODEL, "--shots", "4", "--config_yml",
          str(yml), "--checkpoint_path", ckpt, "--num_workers", "2",
          "--folder", str(tmp_path / "cli"), "--mesh_data", "1",
          "--device", "cpu", "--recal_prompt", "--bsz", "4",
          "--aug_mode", "eval", "--mix_prob", "0", "--epochs", "2",
          "--skip_stage2", "--lr_classifier", "1e-2", "--lr_backbone",
          "1e-4"])
    summary = _summary(capsys.readouterr().out)
    assert (FA.LAUNCHES, FA.LAUNCHES_BWD, FA.LAUNCHES_FLASH,
            FA.LAUNCHES_FLASH_BWD) == before         # no kernel on the CPU
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "cli", method=method, **STAGE1)).derived()
    _check_against_jax(jax_runs(method), cfg.output_dir, summary, method)


@pytest.mark.parametrize("method,resident", [
    ("mixup", True), ("resizemix", True), ("saliencymix", True),
    ("attentivemix", False)])
def test_canvas_mode_runs_resident_where_swat_tpu_does(setup, tmp_path,
                                                       method, resident):
    """With real draws (--aug_mode canvas, --mix_prob 1): the run finishes
    with finite losses; mixup, resizemix and saliencymix take the resident
    epoch, attentivemix streams (swat_tpu's SCAN_METHODS)."""
    dataset_path, ckpt = setup
    args = dict(STAGE1, aug_mode="canvas", mix_prob=1.0, epochs=1)
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path, checkpoint_path=ckpt, method=method, **args))
    port = SwatPipeline(cfg.derived())
    summary = port.run()
    port.loss_logger.close()
    assert len(summary.split(",")) == 11
    rows = _rows(port.cfg.output_dir)
    assert len(rows) == 1 and np.isfinite(rows[0][2]) and rows[0][2] > 0
    with open(f"{port.cfg.output_dir}/main.log") as f:
        log = f.read()
    assert ("resident epochs" in log) == resident


def test_attentive_text_bank_matches_swat_tpu(setup, jax_runs, tmp_path):
    """The [C, D] localization-text bank (c-name: most_common_name here),
    encoded once by the frozen text tower, and the heatmap function built
    on it."""
    dataset_path, ckpt = setup
    _, _, ref = jax_runs("attentivemix")
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path, checkpoint_path=ckpt, method="attentivemix",
        **STAGE1))
    port = SwatPipeline(cfg.derived())
    bank = port._attentive_text_bank()
    assert bank.shape == ref.shape == (3, 32)
    np.testing.assert_allclose(bank.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bank.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    fn = port._heatmap_fn()
    images = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    labels = torch.tensor([2, 0, 1, 2])
    torch.testing.assert_close(
        fn(port.model, images, labels),
        heatmap.clip_text_heatmap(port.model, images, bank[labels]))
    general = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "g", checkpoint_path=ckpt,
        method="attentivemix", attentive_name="general", **STAGE1)).derived())
    g_bank = general._attentive_text_bank()
    torch.testing.assert_close(g_bank[0], g_bank[2])    # 'bird' for all
    port.loss_logger.close()
    general.loss_logger.close()


def test_text_bank_falls_back_to_self_relevance(setup, tmp_path,
                                                monkeypatch):
    """Class ids other than 0..C-1, or a class without a usable name: no
    bank, a warning for the ids, and class-token self-relevance heatmaps."""
    dataset_path, ckpt = setup
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path, checkpoint_path=ckpt, method="attentivemix",
        **STAGE1))
    port = SwatPipeline(cfg.derived())
    warnings = []
    monkeypatch.setattr(port.logger, "warning", warnings.append)
    real = stages.P.load_class_metrics
    monkeypatch.setattr(stages.P, "load_class_metrics", lambda path: {
        str(int(k) + 1): v for k, v in real(path).items()})
    assert port._attentive_text_bank() is None
    assert len(warnings) == 1 and "not contiguous" in warnings[0]
    fn = port._heatmap_fn()                  # warns again, as it asks again
    images = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 32, 32, 3)).astype(np.float32))
    torch.testing.assert_close(
        fn(port.model, images, torch.tensor([0, 1, 2])),
        heatmap.clip_attention_heatmap(port.model, images))
    monkeypatch.setattr(stages.P, "load_class_metrics", lambda path: {
        k: {"name": ""} for k in real(path)})
    del warnings[:]
    assert port._attentive_text_bank() is None
    assert warnings == []                    # no warning for missing names
    port.loss_logger.close()
