"""Weights across the two packages: the JAX param tree into the port's
module (swat_tpu_torch.models.loader.state_dict_from_jax_params), and
OpenCLIP-format checkpoints written from JAX params read back by the port
(load_torch_checkpoint)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import TORCH_THREADS, cosine

from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.models import functional as F
from swat_tpu.models.clip import CLIPModel as FlaxCLIP
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.models.loader import (load_torch_checkpoint,
                                          state_dict_from_jax_params)

torch.set_num_threads(TORCH_THREADS)

LOGIT_SCALE = 4.6052


@pytest.fixture(scope="module")
def jax_params():
    """The Flax initializer's params for test_tiny, as numpy arrays."""
    cfg = jax_model_config("test_tiny")
    params = FlaxCLIP(cfg, precision=JAX_FP32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_state_dict_matches_swat_tpu_converter(jax_params):
    """Same keys and exactly the same values as the JAX package's own
    params_to_torch_state_dict."""
    ours = state_dict_from_jax_params(jax_params, LOGIT_SCALE)
    theirs = params_to_torch_state_dict(jax_params, LOGIT_SCALE)
    assert sorted(ours) == sorted(theirs)
    for key, val in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(),
                                      np.asarray(val, np.float32), key)


def test_jax_params_give_jax_features(jax_params):
    cfg = get_model_config("test_tiny")
    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(state_dict_from_jax_params(jax_params, LOGIT_SCALE))
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 500, (3, 16)).astype(np.int32)
    tokens[:, 12] = 511                                  # EOT
    ref_img = F.vit_encode_image(jax_params["visual"], jnp.asarray(images),
                                 cfg.vision, JAX_FP32, use_pallas=True)
    ref_txt = F.text_encode(jax_params["text"], jnp.asarray(tokens),
                            cfg.text, JAX_FP32, use_pallas=True)
    with torch.inference_mode():
        img = model.encode_image(torch.from_numpy(images))
        txt = model.encode_text(torch.from_numpy(tokens).long())
    assert cosine(img.numpy(), np.asarray(ref_img)).min() >= 1 - 1e-5
    assert cosine(txt.numpy(), np.asarray(ref_txt)).min() >= 1 - 1e-5
    assert model.logit_scale.item() == pytest.approx(LOGIT_SCALE)


class _Holder(torch.nn.Module):
    """A scriptable module that only holds buffers."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _save_torchscript(sd, path):
    """``sd`` as the buffers of a TorchScript archive, with the config
    scalars OpenAI's CLIP archives carry beside the parameters."""
    root = _Holder()
    extra = {"input_resolution": torch.tensor(32),
             "context_length": torch.tensor(16),
             "vocab_size": torch.tensor(512)}
    for key, val in {**sd, **extra}.items():
        *parents, leaf = key.split(".")
        mod = root
        for name in parents:
            if not hasattr(mod, name):
                mod.add_module(name, _Holder())
            mod = getattr(mod, name)
        mod.register_buffer(leaf, val.clone())
    torch.jit.save(torch.jit.script(root), str(path))


@pytest.mark.parametrize("layout", ["plain", "wrapped_dataparallel",
                                    "torchscript_openai"])
def test_checkpoint_round_trips_exactly(jax_params, tmp_path, layout):
    """params_to_torch_state_dict -> torch.save -> the port's
    load_torch_checkpoint: plain, as {'state_dict': {'module.<k>': ...}},
    or as a TorchScript archive in the layout of OpenAI's releases."""
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in params_to_torch_state_dict(jax_params,
                                                 LOGIT_SCALE).items()}
    path = tmp_path / "ckpt.pt"
    if layout == "torchscript_openai":
        _save_torchscript(sd, path)
    else:
        torch.save(sd if layout == "plain" else {
            "state_dict": {f"module.{k}": v for k, v in sd.items()},
            "epoch": 3}, path)
    loaded, logit_scale = load_torch_checkpoint(str(path))
    assert sorted(loaded) == sorted(sd)
    for key, val in sd.items():
        assert torch.equal(loaded[key], val), key
    assert logit_scale == pytest.approx(LOGIT_SCALE)
    model = CLIPModel(get_model_config("test_tiny"))
    model.load_state_dict(loaded)            # strict: OpenCLIP names match


def test_resnet_params_are_not_ported():
    """The RN50 tree converts: the name is kept from when this test
    asserted the raise, so that its runs compare across the change.  The
    Flax initializer's ModifiedResNet params (a tiny RN50) into the
    port's module: exactly the tensors of swat_tpu's own converter, loaded
    strictly, and the eval-mode features of the two towers agree."""
    from torch_port_lib import rn50_configs

    cfg, jax_cfg = rn50_configs("rn50_tiny")
    params = jax.jit(FlaxCLIP(jax_cfg, precision=JAX_FP32).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 16), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = state_dict_from_jax_params(params, LOGIT_SCALE)
    ref = params_to_torch_state_dict(params, LOGIT_SCALE)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), k)
    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(sd)
    images = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: F.encode_image(
        FlaxCLIP(jax_cfg, precision=JAX_FP32), p, x, normalize=True))(
        params, jnp.asarray(images))
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(images), normalize=True)
    assert cosine(got.numpy(), np.asarray(want)).min() >= 1 - 1e-5
