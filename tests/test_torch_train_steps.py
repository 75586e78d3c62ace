"""Stage-1 train steps on the CPU against swat_tpu's: 3 cutmix steps at
mix_prob=1 and 3 finetune steps on test_tiny in fp32, from the same weights
and uint8 canvas batches, the port fed the JAX steps' own draws (crop
boxes, flips, cutmix gate / lambda / permutation / box; see
torch_port_lib.jax_step_draws).  ``check_steps_match`` takes any ported
method; tests/test_torch_mixing.py runs it for the other mixes.  Held: the
per-step losses, logit_scale, the head and every visual tensor by the
gradient-conditioned delta rule, for both the port's streaming step and its
resident epoch; the text tower stays bit-unchanged."""

import numpy as np
import pytest
import torch
from torch_port_lib import (TORCH_THREADS, delta_check,
                            jax_params_from_state_dict, jax_step_draws,
                            random_state_dict)

from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.eval.heatmap import clip_attention_heatmap as jax_heatmap
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train import steps as JS
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.eval.heatmap import clip_attention_heatmap
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.optim import default_warmup_lr, make_lr_schedule
from swat_tpu_torch.train.resident import ResidentData, make_resident_epoch
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import make_ce_step, make_mixing_step

torch.set_num_threads(TORCH_THREADS)

MODEL = "test_tiny"
N_STEPS, BSZ, CANVAS = 3, 6, 40
LR_HEAD, LR_BB, TOTAL_ITER = 1e-2, 1e-4, 10
VALID_HW = [(40, 30), (28, 40), (40, 40), (40, 22), (33, 40), (40, 36)]


@pytest.fixture(scope="module")
def setup():
    cfg = get_model_config(MODEL)
    sd = random_state_dict(cfg, seed=0)
    params, _ = jax_params_from_state_dict(sd, cfg)
    rng = np.random.default_rng(0)
    head = rng.standard_normal((3, cfg.embed_dim)).astype(np.float32)
    head /= np.linalg.norm(head, axis=-1, keepdims=True)
    n = N_STEPS * BSZ
    canvases = np.zeros((n, CANVAS, CANVAS, 3), np.uint8)
    valid_hw = np.asarray(VALID_HW * N_STEPS, np.int32)
    for i, (h, w) in enumerate(valid_hw):
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    labels = rng.integers(0, 3, n).astype(np.int32)
    source = rng.integers(0, 2, n).astype(np.int32)
    batches = [{"canvases": canvases[s * BSZ:(s + 1) * BSZ],
                "valid_hw": valid_hw[s * BSZ:(s + 1) * BSZ],
                "labels": labels[s * BSZ:(s + 1) * BSZ],
                "source": source[s * BSZ:(s + 1) * BSZ]}
               for s in range(N_STEPS)]
    import jax

    keys = list(jax.random.split(jax.random.PRNGKey(42), N_STEPS))
    data = (canvases, valid_hw, labels, source)
    return cfg, sd, params, head, batches, keys, data


def _jax_run(method, params, head, batches, keys):
    import jax.numpy as jnp

    model = JaxCLIPModel(jax_model_config(MODEL), precision=JAX_FP32)
    state, tx = jax_create_state(params, head, method,
                                 lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                                 total_iter=TOTAL_ITER)
    if method == "finetune":
        step = JS.make_ce_step(model, tx, image_size=32)
    else:
        kw = {}
        if method == "attentivemix":
            # the heatmap tower as --use_pallas builds it: the Flax tower
            # through the heads-first Pallas kernel (interpret mode here)
            hm_model = JaxCLIPModel(jax_model_config(MODEL),
                                    precision=JAX_FP32, use_pallas=True)
            kw["heatmap_fn"] = lambda p, images, labels: jax_heatmap(
                hm_model, p, images)
        step = JS.make_mixing_step(model, tx, method, mix_prob=1.0,
                                   image_size=32, **kw)
    losses = []
    for batch, key in zip(batches, keys):
        state, loss = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, key)
        losses.append(float(loss))
    model_np = {k: np.asarray(v) for k, v in params_to_torch_state_dict(
        state.model, 0.0).items()}
    return (losses, model_np, np.asarray(state.head),
            float(state.logit_scale))


def _port_state(method, sd, head):
    cfg = get_model_config(MODEL)
    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(sd)
    return create_train_state(model, torch.from_numpy(head), method,
                              lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                              total_iter=TOTAL_ITER)


def _grads(state):
    out = {f"model.{k}": p.grad.detach().clone().numpy()
           for k, p in state.model.named_parameters() if p.grad is not None}
    out["head"] = state.head.grad.detach().clone().numpy()
    return out


def _port_run(method, sd, head, batches, all_draws, runner):
    state = _port_state(method, sd, head)
    if method == "finetune":
        step = make_ce_step(image_size=32)
    else:
        step = make_mixing_step(
            method, image_size=32,
            heatmap_fn=lambda model, images, labels: clip_attention_heatmap(
                model, images))
    g0 = {}

    def first_grads(state, batch, draws):
        val = step(state, batch, draws)
        if not g0:
            g0.update(_grads(state))
        return val

    if runner == "streaming":
        losses = [float(first_grads(state, b, d))
                  for b, d in zip(batches, all_draws)]
    else:
        canvases, valid_hw, labels, source = _data = runner
        data = ResidentData(torch.from_numpy(canvases), valid_hw,
                            torch.from_numpy(labels).long(),
                            torch.from_numpy(source).long())
        draws = iter(all_draws)
        losses = []

        def recording(state, batch, d):
            val = first_grads(state, batch, d)
            losses.append(float(val))
            return val

        epoch = make_resident_epoch(recording, lambda rng, batch: next(draws))
        perm = np.arange(N_STEPS * BSZ).reshape(N_STEPS, BSZ)
        mean = epoch(state, data, perm, np.random.default_rng(0))
        assert float(mean) == pytest.approx(np.mean(losses), rel=1e-6)
    return losses, state, g0


def _lr_sum(base):
    schedule = make_lr_schedule(base, TOTAL_ITER,
                                warmup_lr=default_warmup_lr(LR_BB))
    return sum(schedule(i) for i in range(N_STEPS))


@pytest.mark.parametrize("runner", ["streaming", "resident"])
@pytest.mark.parametrize("method", ["cutmix", "finetune"])
def test_steps_match_swat_tpu(setup, method, runner):
    draws = check_steps_match(setup, method, runner)
    if method == "cutmix":
        assert all(d.mix.gate for d in draws)
        assert any(d.mix.box[1] > d.mix.box[0] for d in draws)


def check_steps_match(setup, method, runner):
    """N_STEPS steps of ``method`` at mix_prob=1 through both packages ->
    the draws they shared."""
    cfg, sd, params, head, batches, keys, data = setup
    draws = [jax_step_draws(k, b["valid_hw"], 32, 1.0, 1.0, method=method)
             for k, b in zip(keys, batches)]
    j_losses, j_model, j_head, j_ls = _jax_run(method, params, head,
                                               batches, keys)
    p_losses, state, g0 = _port_run(
        method, sd, head, batches, draws,
        runner if runner == "streaming" else data)

    # losses: fp32 forward of the same weights and pixels (the crop
    # resample differs by up to ~1e-2 of 255 between the frameworks)
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4, atol=1e-5)
    # logit_scale moves by lr_classifier-sized Adam steps: 1e-5 is 0.1 % of
    # one step
    assert state.logit_scale.item() == pytest.approx(j_ls, abs=1e-5)

    sd_out = {k: v.detach().numpy() for k, v in state.model.state_dict(
        ).items()}
    lr_sum_bb = _lr_sum(LR_BB)
    moved = delta_check("head", head, j_head, state.head.detach().numpy(),
                        g0["head"], _lr_sum(LR_HEAD), 0.0)
    for k, ref in j_model.items():
        if k == "logit_scale":
            continue
        init = sd[k].numpy()
        if not k.startswith("visual."):
            # the text tower is frozen: bit-unchanged in both packages
            np.testing.assert_array_equal(sd_out[k], init, err_msg=k)
            np.testing.assert_array_equal(ref, init, err_msg=k)
            continue
        moved += delta_check(k, init, ref, sd_out[k], g0[f"model.{k}"],
                             lr_sum_bb, N_STEPS * LR_BB * 1.5)
    n_visual = sum(k.startswith("visual.") for k in j_model)
    assert moved == n_visual + 1       # every visual tensor and the head
    return draws
