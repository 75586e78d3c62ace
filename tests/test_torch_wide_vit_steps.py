"""One fp32 cutmix step of the port on the CPU against swat_tpu's
make_mixing_step at the full widths of ViT-B/16 (S = 197, erf GELU) and
ViT-L/14 (S = 257, 16 heads, a 768-wide text tower) cut to 2 layers a tower
(tests/test_torch_towers.py's two_layers), from the same weights and uint8
canvases, the port fed the JAX step's own draws
(torch_port_lib.jax_step_draws).  swat_tpu trains these towers with its
plain XLA attention on the CPU (functional._pick_pallas), the port with the
kernels' plain twins.  Held: the loss, logit_scale, and the head and every
visual tensor by the gradient-conditioned delta rule
(torch_port_lib.delta_check); the text tower stays bit-unchanged."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_towers import two_layers
from torch_port_lib import (TORCH_THREADS, delta_check,
                            jax_params_from_state_dict, jax_step_draws,
                            random_state_dict)

from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.models import configs as JAX_CONFIGS
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train import steps as JS
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.train.optim import default_warmup_lr, make_lr_schedule
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import make_mixing_step

torch.set_num_threads(TORCH_THREADS)

BSZ, CANVAS, N_PX = 4, 48, 224
LR_HEAD, LR_BB, TOTAL_ITER = 1e-2, 1e-4, 10
TOWERS = ("vitb16_openclip_laion400m", "vitl14_openclip_laion400m")


def _jax_config(name):
    cfg = JAX_CONFIGS.get_model_config(name)
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=2),
        text=dataclasses.replace(cfg.text, layers=2))


@pytest.mark.parametrize("name", TOWERS)
def test_cutmix_step_matches_swat_tpu(name):
    cfg, jax_cfg = two_layers(name), _jax_config(name)
    for tower in ("vision", "text"):
        assert (dataclasses.asdict(getattr(jax_cfg, tower))
                == dataclasses.asdict(getattr(cfg, tower)))
    sd = random_state_dict(cfg, seed=0)
    params, _ = jax_params_from_state_dict(sd, cfg)
    rng = np.random.default_rng(0)
    head = rng.standard_normal((3, cfg.embed_dim)).astype(np.float32)
    head /= np.linalg.norm(head, axis=-1, keepdims=True)
    valid_hw = np.asarray([(48, 36), (30, 48), (48, 48), (41, 48)],
                          np.int32)
    canvases = np.zeros((BSZ, CANVAS, CANVAS, 3), np.uint8)
    for i, (h, w) in enumerate(valid_hw):
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    batch = {"canvases": canvases, "valid_hw": valid_hw,
             "labels": rng.integers(0, 3, BSZ).astype(np.int32),
             "source": rng.integers(0, 2, BSZ).astype(np.int32)}
    key = jax.random.PRNGKey(7)

    state, tx = jax_create_state(params, head, "cutmix",
                                 lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                                 total_iter=TOTAL_ITER)
    step = JS.make_mixing_step(JaxCLIPModel(jax_cfg, precision=JAX_FP32),
                               tx, "cutmix", mix_prob=1.0, image_size=N_PX)
    state, j_loss = step(state, {k: jnp.asarray(v)
                                 for k, v in batch.items()}, key)
    j_model = {k: np.asarray(v) for k, v in params_to_torch_state_dict(
        state.model, 0.0).items()}

    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(sd)
    pstate = create_train_state(model, torch.from_numpy(head), "cutmix",
                                lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                                total_iter=TOTAL_ITER)
    draws = jax_step_draws(key, valid_hw, N_PX, 1.0, 1.0)
    assert draws.mix.gate and draws.mix.box[1] > draws.mix.box[0]
    loss = make_mixing_step("cutmix", image_size=N_PX)(pstate, batch, draws)

    assert float(loss) == pytest.approx(float(j_loss), rel=1e-4, abs=1e-5)
    assert pstate.logit_scale.item() == pytest.approx(
        float(state.logit_scale), abs=1e-5)

    def lr_sum(base):
        return make_lr_schedule(base, TOTAL_ITER,
                                warmup_lr=default_warmup_lr(LR_BB))(0)

    moved = delta_check("head", head, np.asarray(state.head),
                        pstate.head.detach().numpy(),
                        pstate.head.grad.numpy(), lr_sum(LR_HEAD), 0.0)
    trained = dict(pstate.model.named_parameters())
    for k, ref in j_model.items():
        if k == "logit_scale":
            continue
        init = sd[k].numpy()
        got = trained[k].detach().numpy()
        if not k.startswith("visual."):
            np.testing.assert_array_equal(got, init, err_msg=k)
            np.testing.assert_array_equal(ref, init, err_msg=k)
            continue
        moved += delta_check(k, init, ref, got, trained[k].grad.numpy(),
                             lr_sum(LR_BB), 1.5 * LR_BB)
    assert moved == sum(k.startswith("visual.") for k in j_model) + 1
