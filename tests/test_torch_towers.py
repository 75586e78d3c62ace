"""The port's CLIP towers (swat_tpu_torch.models.clip, on the CPU) against
the JAX package's functional towers with the Pallas attention kernel in
interpret mode (functional.vit_encode_image / text_encode,
use_pallas=True), under both precision policies, on test_tiny and on
2-layer towers at the widths of ViT-B/32, ViT-B/16 (S = 197, erf GELU) and
ViT-L/14 (S = 257, 16 heads of 64; its 768-wide text tower of 12 heads);
and the registry's RN50 built at full size."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import (TORCH_THREADS, cosine, jax_params_from_state_dict,
                            random_state_dict)

from swat_tpu.core import precision as JP
from swat_tpu.models import functional as F
from swat_tpu_torch.core import precision as TP
from swat_tpu_torch.kernels import flash_attention as FA
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config

torch.set_num_threads(TORCH_THREADS)



def two_layers(name: str):
    """The registry's ``name`` cut to 2 layers in each tower."""
    cfg = get_model_config(name)
    return dataclasses.replace(
        cfg, name=cfg.name + "-2layer",
        vision=dataclasses.replace(cfg.vision, layers=2),
        text=dataclasses.replace(cfg.text, layers=2))


CONFIGS = {
    "test_tiny": get_model_config("test_tiny"),
    "vitb32_2layer": two_layers("vitb32_openclip_laion400m"),
    "vitb16_2layer": two_layers("vitb16_openclip_laion400m"),
    "vitl14_2layer": two_layers("vitl14_openclip_laion400m"),
}
POLICIES = {"fp32": (JP.FP32_PRECISION, TP.FP32_PRECISION),
            "bf16": (JP.DEFAULT_PRECISION, TP.DEFAULT_PRECISION)}
# fp32: the README's parity bar (measured gap ~1e-13).  bf16: both round
# every matmul operand and the residual stream to bf16, but the CPU
# backends accumulate in other orders, so a rounding can land one bf16 ulp
# apart; the measured gap is ~1.5e-5 at 2 layers of B/32 width, and the
# bound leaves room for more layers
MIN_COS = {"fp32": 1 - 1e-5, "bf16": 1 - 1e-3}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def towers(request):
    cfg = CONFIGS[request.param]
    sd = random_state_dict(cfg, seed=0)
    params, _ = jax_params_from_state_dict(sd, cfg)
    rng = np.random.default_rng(0)
    n_px = cfg.vision.image_size
    images = rng.standard_normal((2, n_px, n_px, 3)).astype(np.float32)
    ctx = cfg.text.context_length
    tokens = np.zeros((3, ctx), np.int32)
    for i, n in enumerate((4, 9, ctx - 2)):     # EOT (the max id) at n
        tokens[i, 0] = cfg.text.vocab_size - 2
        tokens[i, 1:n] = rng.integers(1, cfg.text.vocab_size - 3, n - 1)
        tokens[i, n] = cfg.text.vocab_size - 1
    return cfg, sd, params, images, tokens


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_image_tower_matches_jax_pallas(towers, policy):
    cfg, sd, params, images, _ = towers
    jprec, tprec = POLICIES[policy]
    ref = F.vit_encode_image(params["visual"], jnp.asarray(images),
                             cfg.vision, jprec, normalize=True,
                             use_pallas=True)
    model = CLIPModel(cfg, precision=tprec)
    model.load_state_dict(sd)
    with torch.inference_mode():
        got = model.encode_image(torch.from_numpy(images), normalize=True)
    assert got.dtype == torch.float32 and got.shape == (2, cfg.embed_dim)
    assert cosine(got.numpy(), np.asarray(ref)).min() >= MIN_COS[policy]


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_text_tower_matches_jax_pallas(towers, policy):
    cfg, sd, params, _, tokens = towers
    jprec, tprec = POLICIES[policy]
    ref = F.text_encode(params["text"], jnp.asarray(tokens), cfg.text, jprec,
                        normalize=True, use_pallas=True)
    model = CLIPModel(cfg, precision=tprec)
    model.load_state_dict(sd)
    with torch.inference_mode():
        got = model.encode_text(torch.from_numpy(tokens).long(),
                                normalize=True)
    assert got.dtype == torch.float32 and got.shape == (3, cfg.embed_dim)
    assert cosine(got.numpy(), np.asarray(ref)).min() >= MIN_COS[policy]


def test_cpu_towers_launch_no_kernel(towers):
    cfg, sd, _, images, tokens = towers
    model = CLIPModel(cfg, precision=TP.FP32_PRECISION)
    model.load_state_dict(sd)
    before = FA.LAUNCHES
    with torch.inference_mode():
        model.encode_image(torch.from_numpy(images))
        model.encode_text(torch.from_numpy(tokens).long())
    assert FA.LAUNCHES == before


def test_attention_argument_swaps_the_attention(towers):
    """The towers call whatever attention they are given, once per layer
    (the smoke test passes the plain twin on the card this way)."""
    cfg, sd, _, images, _ = towers
    model = CLIPModel(cfg, precision=TP.FP32_PRECISION)
    model.load_state_dict(sd)
    calls = []

    def attention(qkv, heads, causal):
        calls.append((heads, causal, qkv.shape[-1]))
        return FA.mha_qkv_reference(qkv, heads, causal)

    with torch.inference_mode():
        model.encode_image(torch.from_numpy(images), attention=attention)
    # the attention gets the qkv projection's output whole (3*width wide)
    assert calls == [(cfg.vision.heads, False, 3 * cfg.vision.width)] * \
        cfg.vision.layers


def test_resnet_config_is_not_ported():
    """The RN50 tower is ported: the name is kept from when this test
    asserted the raise, so that its runs compare across the change.  The
    registry's RN50 at full size: OpenCLIP's names, the running
    statistics as buffers (in no optimizer group), and an OpenCLIP state
    dict with ``num_batches_tracked`` entries loads strictly, those dropped."""
    model = CLIPModel(get_model_config("rn50_openclip_openai"))
    sd = model.state_dict()
    assert sd["visual.conv1.weight"].shape == (32, 3, 3, 3)
    assert sd["visual.layer4.2.conv3.weight"].shape == (2048, 512, 1, 1)
    assert sd["visual.layer3.0.downsample.0.weight"].shape == (
        1024, 512, 1, 1)
    assert sd["visual.attnpool.positional_embedding"].shape == (50, 2048)
    assert sd["visual.attnpool.c_proj.weight"].shape == (1024, 2048)
    assert sum(k.startswith("visual.layer") and k.endswith("conv1.weight")
               for k in sd) == 16
    params = dict(model.named_parameters())
    assert not any(k.endswith(("running_mean", "running_var"))
                   for k in params)
    openclip = {k: torch.full_like(v, i) for i, (k, v) in enumerate(
        sd.items())}
    for k in list(sd):
        if k.endswith(".running_var"):
            openclip[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    assert len(openclip) == len(sd) + 55          # 55 BatchNorms
    model.load_state_dict(openclip)
    got = model.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in got.items():
        assert torch.equal(v, openclip[k]), k
