"""W8A8 int8 inference in the PyTorch port (models/quant.py, the W8A8
product in models/clip.py, the int8 layout of CLIPModel) against
swat_tpu's (swat_tpu/models/quant.py, functional._qdot) at test_tiny
widths, from numpy-seeded inputs.

Tolerances: the quantized codes and scales, the activation codes and the
int32 products are integers or exact fp32 operations and must be equal
bit for bit (measured: no activation code differs); the quantized towers'
features differ from swat_tpu's by the fp32 summation order of the
LayerNorms, attention and products between the quantized steps, 6e-8
measured, held to 1e-6; against the float towers, swat_tpu's own bounds
(mean cosine > 0.995 image, > 0.99 text)."""

import numpy as np
import pytest
import torch
from torch_port_lib import (TORCH_THREADS, cosine, jax_params_from_state_dict,
                            random_state_dict)

import jax.numpy as jnp

from swat_tpu.core.precision import DEFAULT_PRECISION as JAX_BF16
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.models import functional as JF
from swat_tpu.models import quant as JQ
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from swat_tpu_torch.models import clip as C
from swat_tpu_torch.models import quant as Q
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.models.head import init_head_random
from swat_tpu_torch.models.loader import (jax_params_from_state_dict as
                                          port_params_from_state_dict,
                                          state_dict_from_jax_params)
from swat_tpu_torch.train.state import create_train_state

torch.set_num_threads(TORCH_THREADS)

CFG = get_model_config("test_tiny")
FEATURE_ATOL = 1e-6


@pytest.fixture(scope="module")
def trees():
    """(fp32 JAX-layout tree, its quantized tree by swat_tpu, logit_scale)."""
    params, logit_scale = jax_params_from_state_dict(
        random_state_dict(CFG, seed=0), jax_model_config("test_tiny"))
    return params, JQ.quantize_tree(params), logit_scale


def _assert_trees_equal(got, ref, path=""):
    assert isinstance(got, dict) == isinstance(ref, dict), path
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{path}/{k}")
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, path
    assert np.array_equal(got, ref), path


@pytest.mark.parametrize("shape", [(16, 8), (3, 48, 24), (2, 192, 64)])
def test_quantize_weight_matches_swat_tpu(shape):
    """Codes and scales bit-equal, stacked [L, in, out] leaves included
    (one layer's range 100x the others')."""
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    if w.ndim == 3:
        w[1] *= 100.0
    got_q, got_s = Q.quantize_weight(w)
    ref_q, ref_s = JQ.quantize_weight(w)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    assert np.array_equal(got_q, np.asarray(ref_q))
    assert np.array_equal(got_s, np.asarray(ref_s))
    assert got_s.shape == shape[:-2] + shape[-1:]


def test_quantize_tree_matches_swat_tpu(trees):
    params, ref, _ = trees
    got = Q.quantize_tree(params)
    _assert_trees_equal(got, ref)
    assert Q.is_quantized(got) and not Q.is_quantized(params)
    # quantizing a quantized tree leaves it as it is, in both packages
    _assert_trees_equal(Q.quantize_tree(got), JQ.quantize_tree(ref))


# (rows, K, N): B/32-like rows, rows at and below _int_mm's 17, and K / N
# off its multiples of 8 (L/14's patch embedding has K = 588)
QDOT_SHAPES = [(2, 7, 64, 48), (1, 5, 20, 12), (1, 16, 36, 8),
               (1, 17, 588 // 7, 40), (3, 50, 96, 13)]


@pytest.mark.parametrize("shape", QDOT_SHAPES)
def test_qdot_matches_swat_tpu(shape, monkeypatch):
    """The activation codes equal swat_tpu's (captured at the int8
    product of each), and the dequantized fp32 products are bit-equal;
    in bf16 the cast of the same fp32 values too."""
    *lead, k, n = shape
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=(*lead, k)) * rng.uniform(0.1, 8.0, (*lead, 1))
         ).astype(np.float32)
    # rows whose absmax is 127 have s = 1 exactly: ties at the half there
    # round to even
    x[..., 0, 0] = 127.0
    x[..., 0, 1:4] = (2.5, -3.5, 0.5)
    w_q, scale = Q.quantize_weight(rng.normal(size=(k, n)).astype(np.float32))

    seen = {}
    real_dot = JF.jax.lax.dot_general
    real_mm = C.int8_matmul

    def jax_dot(xq, *a, **kw):
        seen["jax"] = np.asarray(xq)
        return real_dot(xq, *a, **kw)

    def port_mm(a, codes):
        seen["port"] = a.numpy().copy()
        return real_mm(a, codes)

    monkeypatch.setattr(JF.jax.lax, "dot_general", jax_dot)
    monkeypatch.setattr(C, "int8_matmul", port_mm)
    weight = C.Int8Weight(torch.from_numpy(w_q.T.copy()),
                          torch.from_numpy(scale))
    for prec, jax_prec, out_dtype, jax_dtype in (
            (FP32_PRECISION, JAX_FP32, torch.float32, jnp.float32),
            (DEFAULT_PRECISION, JAX_BF16, None, None)):
        ref = JF._qdot(jnp.asarray(x), {"kernel_q": jnp.asarray(w_q),
                                        "scale": jnp.asarray(scale)},
                       jax_prec, out_dtype=jax_dtype)
        got = C.qdot(torch.from_numpy(x), weight, prec, out_dtype=out_dtype)
        differ = np.mean(seen["jax"].reshape(-1, k) != seen["port"])
        assert differ == 0.0, differ
        assert got.dtype == (out_dtype or prec.compute_dtype)
        assert np.array_equal(got.float().numpy(),
                              np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("m,k,n", [(1, 3, 5), (16, 8, 8), (17, 588, 40),
                                   (40, 12, 13)])
def test_int8_matmul_pads_to_the_exact_product(m, k, n):
    """Zero padding to _int_mm's CUDA rules leaves every int32 sum as the
    int64 product of the same codes gives it, sums near 127^2 K included."""
    rng = np.random.default_rng(m * k * n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (n, k)).astype(np.int8)
    a[0] = 127
    b[0] = 127
    got = C.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.T.astype(
        np.int64))


def test_int8_matmul_refuses_what_cannot_be_padded():
    with pytest.raises(ValueError, match="cannot be padded"):
        C.int8_matmul(torch.zeros(4, 0, dtype=torch.int8),
                      torch.zeros(8, 0, dtype=torch.int8))
    with pytest.raises(ValueError, match="cannot be padded"):
        C.int8_matmul(torch.zeros(4, 8, dtype=torch.int8),
                      torch.zeros(8, 16, dtype=torch.int8))


def _int8_model(qtree, logit_scale):
    model = C.CLIPModel(CFG, precision=FP32_PRECISION)
    return model.load_weights(state_dict_from_jax_params(
        qtree, logit_scale)).eval()


def test_int8_state_dict_round_trip(trees):
    """The quantized tree -> state dict -> tree is bit-equal; the codes
    and scales are buffers of the int8 layout, never parameters."""
    _, qtree, logit_scale = trees
    sd = state_dict_from_jax_params(qtree, logit_scale)
    assert sd["visual.conv1.weight_q"].shape == (64, 8 * 8 * 3)
    assert sd["visual.proj_q"].shape == (32, 64)
    assert sd["transformer.resblocks.1.attn.in_proj_weight_q"].dtype == \
        torch.int8
    back, scale = port_params_from_state_dict(sd)
    _assert_trees_equal(back, qtree)
    model = _int8_model(qtree, logit_scale)
    assert model.is_int8
    names = {n for n, _ in model.named_parameters()}
    buffers = {n for n, _ in model.named_buffers()}
    quantized = {k for k in sd if k.endswith("_q")}
    quantized |= {k[:-len("_q")] + "_scale" for k in quantized}
    assert quantized <= buffers and not quantized & names
    assert "visual.conv1.weight" not in names and "visual.proj" not in names
    codes = [n for n, b in model.named_buffers() if b.dtype == torch.int8]
    assert len(codes) == 4 * (CFG.vision.layers + CFG.text.layers) + 3
    _assert_trees_equal(port_params_from_state_dict(model.state_dict())[0],
                        qtree)


def _tokens(rng, n):
    toks = np.zeros((n, CFG.text.context_length), np.int64)
    toks[:, 0] = 1
    toks[:, 1:5] = rng.integers(2, CFG.text.vocab_size - 1, (n, 4))
    toks[:, 5] = CFG.text.vocab_size - 1          # eot = argmax
    return toks


def test_int8_features_match_swat_tpu(trees):
    """Quantized image and text features against swat_tpu's quantized
    features (FEATURE_ATOL), and against the float features by swat_tpu's
    own bounds."""
    params, qtree, logit_scale = trees
    model = _int8_model(qtree, logit_scale)
    jmodel = JaxCLIPModel(jax_model_config("test_tiny"), precision=JAX_FP32)
    rng = np.random.default_rng(3)
    images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    toks = _tokens(rng, 6)
    with torch.inference_mode():
        img = model.encode_image(torch.from_numpy(images),
                                 normalize=True).numpy()
        txt = model.encode_text(torch.from_numpy(toks),
                                normalize=True).numpy()
    for got, fn, inputs, bound in (
            (img, JF.encode_image, images, 0.995),
            (txt, JF.encode_text, toks.astype(np.int32), 0.99)):
        ref_q = np.asarray(fn(jmodel, qtree, jnp.asarray(inputs),
                              normalize=True, mode="infer"))
        ref_f = np.asarray(fn(jmodel, params, jnp.asarray(inputs),
                              normalize=True, mode="infer"))
        np.testing.assert_allclose(got, ref_q, rtol=0, atol=FEATURE_ATOL)
        assert cosine(got, ref_f).mean() > bound


def test_training_refuses_an_int8_model(trees):
    _, qtree, logit_scale = trees
    model = _int8_model(qtree, logit_scale)
    head = init_head_random(1, 3, CFG.embed_dim, torch.device("cpu"))
    with pytest.raises(ValueError, match="int8"):
        create_train_state(model, head, "finetune", lr_classifier=1e-3,
                           lr_backbone=1e-4, total_iter=10)


def test_rn50_tree_refused():
    from torch_port_lib import rn50_configs

    cfg, _ = rn50_configs("rn50_tiny")
    sd = random_state_dict(cfg, seed=0)
    params, _ = port_params_from_state_dict(sd)
    with pytest.raises(ValueError, match="ViT"):
        Q.quantize_tree(params)
    with pytest.raises(ValueError, match="RN50"):
        C.CLIPModel(cfg).int8_()


def test_use_mega_with_int8_raises(trees):
    _, qtree, logit_scale = trees
    model = _int8_model(qtree, logit_scale)
    images = torch.zeros(2, 32, 32, 3)
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="no int8 path"):
        model.encode_image(images, use_mega=True)
