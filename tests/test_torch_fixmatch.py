"""FixMatch on the CPU against swat_tpu, test_tiny in fp32.

(a) 3 steps fed swat_tpu's own weak and strong views ('images_w' /
'images_s', made by its RRC, flip and RandAugment from its step keys),
the labeled canvases cropped by the JAX step's draws: the per-step losses
(rtol 1e-4), the mask rates (exactly) and loss_u (rtol 1e-4, atol 1e-6),
every visual tensor and the head by the delta rule, logit_scale
bit-constant in both packages; the threshold is set so that the mask is
neither empty nor full on some step.
(b) one step from unlabeled canvases under torch_port_lib's
jax_fixmatch_draws: the weak view to 1e-3 of 255 (the crop's fp32
rounding), the strong view (crop, then RandAugment, whose truncations can
flip on that rounding) by fewer than 0.5 % of values off by more than
1e-3, then the step's loss (rtol 1e-3) and mask rate (exactly).
(c) stage 1 through the port's CLI and swat_tpu's pipeline, 2 epochs over
the unlabeled split, the port's sampler replaced by swat_tpu's draws from
its own key chain: loss.csv rows and the summary line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_steps import (BSZ, CANVAS, LR_BB, LR_HEAD,  # noqa: F401
                                    MODEL, N_STEPS, TOTAL_ITER, setup)
from torch_port_lib import (DATASET, RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, delta_check,
                            jax_fixmatch_draws, loss_rows, make_dataset,
                            random_state_dict, register_dataset, run_kwargs,
                            summary_line)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.kernels import augment as jaug
from swat_tpu.kernels.randaugment import rand_augment as jax_rand_augment
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train import steps as JS
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train import stages
from swat_tpu_torch.train.optim import default_warmup_lr, make_lr_schedule
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import (FixmatchDraws, fixmatch_views,
                                        make_fixmatch_step, make_sampler)

torch.set_num_threads(TORCH_THREADS)

# the tiny model's max softmax over its 3 unscaled logits lies in
# 0.41-0.45 on these views: this threshold splits the unlabeled rows, at
# least 2e-3 from any of the first step's values
THRESHOLD = 0.433
LAMBDA_U = 1.0


@pytest.fixture(scope="module")
def unlabeled():
    """N_STEPS batches of BSZ unlabeled canvases (mu = 1) and their valid
    sizes."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(N_STEPS):
        valid_hw = np.stack([rng.integers(24, CANVAS + 1, BSZ),
                             rng.integers(24, CANVAS + 1, BSZ)], 1)
        canvases = np.zeros((BSZ, CANVAS, CANVAS, 3), np.uint8)
        for i, (h, w) in enumerate(valid_hw):
            canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        out.append((canvases, valid_hw.astype(np.int32)))
    return out


@jax.jit
def _jax_views(canvases, valid_hw, key):
    """swat_tpu's make_fixmatch_step views of the unlabeled canvases for
    the step key ``key`` (its k_w, k_s, k_ra), normalized."""
    _, k_w, k_s, k_ra = jax.random.split(key, 4)
    k_wc, k_wf = jax.random.split(k_w)
    k_sc, k_sf = jax.random.split(k_s)
    w = jaug.random_hflip(jaug.random_resized_crop(
        canvases, valid_hw, k_wc, 32), k_wf)
    s = jaug.random_hflip(jaug.random_resized_crop(
        canvases, valid_hw, k_sc, 32), k_sf)
    s = jax_rand_augment(s, k_ra, n=2, m=10, cutout=16)
    return jaug._normalize_float_pixels(w), jaug._normalize_float_pixels(s)


def _jax_steps(params, head, batches, keys):
    model = JaxCLIPModel(jax_model_config(MODEL), precision=JAX_FP32)
    state, tx = jax_create_state(params, head, "fixmatch",
                                 lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                                 total_iter=TOTAL_ITER)
    step = JS.make_fixmatch_step(model, tx, threshold=THRESHOLD,
                                 lambda_u=LAMBDA_U, image_size=32, aux=True)
    out = []
    for batch, key in zip(batches, keys):
        state, (loss, rate, loss_u) = step(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        out.append((float(loss), float(rate), float(loss_u)))
    return state, out


def _port_state(sd, head):
    model = CLIPModel(get_model_config(MODEL), precision=FP32_PRECISION)
    model.load_state_dict(sd)
    return create_train_state(model, torch.from_numpy(head), "fixmatch",
                              lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                              total_iter=TOTAL_ITER)


def _lr_sum(base):
    schedule = make_lr_schedule(base, TOTAL_ITER,
                                warmup_lr=default_warmup_lr(LR_BB))
    return sum(schedule(i) for i in range(N_STEPS))


def test_fixmatch_steps_match_swat_tpu(setup, unlabeled):
    """(a): 3 steps on swat_tpu's views (module docstring)."""
    cfg, sd, params, head, batches, keys, _ = setup
    views = [tuple(np.array(v) for v in _jax_views(c, hw, k))
             for (c, hw), k in zip(unlabeled, keys)]
    fm_batches = [dict(b, images_w=w, images_s=s)
                  for b, (w, s) in zip(batches, views)]
    jstate, ref = _jax_steps(params, head, fm_batches, keys)

    state = _port_state(sd, head)
    ls0 = state.logit_scale.detach().clone()
    step = make_fixmatch_step(THRESHOLD, LAMBDA_U, image_size=32, aux=True)
    got, g0 = [], {}
    for batch, key in zip(fm_batches, keys):
        draws = jax_fixmatch_draws(key, batch["valid_hw"])
        assert draws.weak is None and draws.rand_augment is None
        loss, rate, loss_u = step(state, batch, draws)
        got.append((float(loss), float(rate), float(loss_u)))
        if not g0:
            g0 = {k: p.grad.detach().clone().numpy()
                  for k, p in state.model.named_parameters()
                  if p.grad is not None}
            g0["head"] = state.head.grad.detach().clone().numpy()
            assert state.logit_scale.grad is None

    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[:, 1], ref[:, 1])
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=1e-4, atol=1e-6)
    assert ((got[:, 1] > 0) & (got[:, 1] < 1)).any(), got[:, 1]
    assert torch.equal(state.logit_scale.detach(), ls0)
    assert float(jstate.logit_scale) == ls0.item()

    moved = delta_check("head", head, np.asarray(jstate.head),
                        state.head.detach().numpy(), g0["head"],
                        _lr_sum(LR_HEAD), 0.0)
    j_model = params_to_torch_state_dict(jstate.model, 0.0)
    got_sd = {k: v.detach().numpy()
              for k, v in state.model.state_dict().items()}
    for k, r in j_model.items():
        if k == "logit_scale":
            continue
        init = sd[k].numpy()
        if not k.startswith("visual."):
            np.testing.assert_array_equal(got_sd[k], init, err_msg=k)
            np.testing.assert_array_equal(r, init, err_msg=k)
            continue
        moved += delta_check(k, init, r, got_sd[k], g0[k], _lr_sum(LR_BB),
                             N_STEPS * LR_BB * 1.5)
    assert moved == sum(k.startswith("visual.") for k in j_model) + 1


def test_fixmatch_step_from_canvases_matches_swat_tpu(setup, unlabeled):
    """(b): the views and one step from the unlabeled canvases under the
    JAX step's draws (module docstring)."""
    cfg, sd, params, head, batches, keys, _ = setup
    canvases, valid_hw_u = unlabeled[0]
    batch = dict(batches[0], canvases_u=canvases, valid_hw_u=valid_hw_u)
    draws = jax_fixmatch_draws(keys[0], batch["valid_hw"], valid_hw_u)
    assert isinstance(draws, FixmatchDraws) and draws.rand_augment.gates.any()

    jw, js = (np.asarray(v) for v in _jax_views(canvases, valid_hw_u,
                                                keys[0]))
    pw, ps = (v.numpy() for v in fixmatch_views(
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        draws, 32))
    std = 255 * np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
    np.testing.assert_allclose(pw * std, jw * std, rtol=0, atol=1e-3)
    assert (np.abs(ps - js) * std > 1e-3).mean() < 0.005

    _, ref = _jax_steps(params, head, [batch], keys[:1])
    state = _port_state(sd, head)
    loss, rate, _ = make_fixmatch_step(THRESHOLD, LAMBDA_U, image_size=32,
                                       aux=True)(state, batch, draws)
    assert float(loss) == pytest.approx(ref[0][0], rel=1e-3)
    assert float(rate) == ref[0][1]


def test_fixmatch_sampler_draw_order():
    """sample_fixmatch draws the labeled crops, the weak and the strong
    view's crops, then RandAugment's, from one generator; a batch of
    pre-augmented views draws none for them."""
    rng = np.random.default_rng(0)
    hw = np.full((4, 2), 40)
    hw_u = np.full((8, 2), 36)
    batch = {"canvases": np.zeros((4, 40, 40, 3), np.uint8), "valid_hw": hw,
             "labels": np.zeros(4), "canvases_u": np.zeros((8, 40, 40, 3)),
             "valid_hw_u": hw_u}
    d = make_sampler("fixmatch")(np.random.default_rng(3), batch)
    assert d.crops.boxes.shape == (4, 4) and d.weak.boxes.shape == (8, 4)
    assert d.rand_augment.ops.shape == (8, 2)
    assert not np.array_equal(d.weak.boxes, d.strong.boxes)
    from swat_tpu_torch.kernels.augment import sample_crops, sample_flips
    from swat_tpu_torch.kernels.randaugment import sample_rand_augment

    rng = np.random.default_rng(3)
    for part, vhw in ((d.crops, hw), (d.weak, hw_u), (d.strong, hw_u)):
        np.testing.assert_array_equal(part.boxes, sample_crops(rng, vhw))
        np.testing.assert_array_equal(part.flips,
                                      sample_flips(rng, len(vhw)))
    np.testing.assert_array_equal(d.rand_augment.ops,
                                  sample_rand_augment(rng, 8).ops)
    images = {"images": np.zeros((4, 32, 32, 3)), "labels": np.zeros(4),
              "images_w": np.zeros((8, 32, 32, 3)),
              "images_s": np.zeros((8, 32, 32, 3))}
    d = make_sampler("fixmatch")(rng, images)
    assert d == FixmatchDraws()


# ---------------------------------------------------------------------------
# through the pipelines

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10,
                                n_retrieved_per_class=10,
                                n_unlabeled_per_class=8)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config(MODEL), seed=0), ckpt)
    yield dataset_path, ckpt
    undo()


def test_fixmatch_cli_matches_swat_tpu(dataset, tmp_path, capsys,
                                       monkeypatch):
    """(c): stage-1 fixmatch through the port's CLI (mu 2, the labeled
    batches of --aug_mode eval cycled beside the unlabeled canvases) and
    swat_tpu's pipeline: the port's draws replaced by those swat_tpu's
    train_loop makes from PRNGKey(training_seed), split once a step; the
    loss.csv rows (4 steps an epoch over 24 unlabeled images at bsz 3 x
    mu 2) and the summary line."""
    from swat_tpu_torch.cli.main import main

    dataset_path, ckpt = dataset
    args = dict(method="fixmatch", data_source="fewshot+retrieved",
                retrieval_split=RETRIEVAL_SPLIT, epochs=2, skip_stage2=True,
                compute_dtype="float32", lr_classifier=1e-2,
                lr_backbone=1e-4, bsz=3, mu=2, threshold=THRESHOLD,
                aug_mode="eval")
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **args)).derived())
    jax_summary = jax_pipe.run()
    jax_pipe.loss_logger.close()
    capsys.readouterr()

    seen = []

    def jax_sampler(method, **kw):
        assert method == "fixmatch"
        chain = [jax.random.PRNGKey(1)]            # --training_seed 1

        def sample(rng, batch):
            chain[0], sub = jax.random.split(chain[0])
            seen.append(np.asarray(batch["valid_hw_u"]).shape[0])
            return jax_fixmatch_draws(sub, batch.get("valid_hw"),
                                      batch["valid_hw_u"])

        return sample

    monkeypatch.setattr(stages, "make_sampler", jax_sampler)
    yml = tmp_path / "config.yml"
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    main(["--dataset", DATASET, "--method", "fixmatch", "--data_source",
          "fewshot+retrieved", "--retrieval_split", RETRIEVAL_SPLIT,
          "--model_cfg", MODEL, "--shots", "4", "--config_yml", str(yml),
          "--checkpoint_path", ckpt, "--num_workers", "2", "--folder",
          str(tmp_path / "port"), "--mesh_data", "1", "--device", "cpu",
          "--recal_prompt", "--bsz", "3", "--mu", "2", "--threshold",
          str(THRESHOLD), "--aug_mode", "eval", "--epochs", "2",
          "--skip_stage2", "--lr_classifier", "1e-2", "--lr_backbone",
          "1e-4"])
    summary = summary_line(capsys.readouterr().out)
    assert summary == jax_summary
    assert summary.split(",")[1] == "fixmatch"
    assert seen == [6] * 8
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", **args)).derived()
    got, ref = loss_rows(cfg.output_dir), loss_rows(jax_pipe.cfg.output_dir)
    assert [r[:2] for r in got] == [[1, 4], [2, 8]]
    assert_rows_match(got, ref)
