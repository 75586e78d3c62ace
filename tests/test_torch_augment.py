"""The port's on-device augmentation (swat_tpu_torch.kernels.augment) on the
CPU against swat_tpu.kernels.augment, fed the JAX package's own draws: a
helper (torch_port_lib.jax_step_draws) mirrors make_mix_fn's key splits
and calls aug._sample_crop, jax.random.bernoulli, aug._safe_beta,
jax.random.permutation and aug._rand_bbox, and the port applies what they
drew.  Held: the bicubic
crop-resize against jax.image.scale_and_translate, the flip, the
normalization, the whole train transform, the cutmix image / y_a / y_b /
lambda, and the host samplers (including _sample_crop's fallback)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import TORCH_THREADS, jax_step_draws

from swat_tpu.kernels import augment as jaug
from swat_tpu_torch.kernels import augment as aug

torch.set_num_threads(TORCH_THREADS)

# (canvas, out_size, valid (h, w) per sample): crops of 0.9-1.0 of the
# valid region, resized to out_size, so nearly always a downscale
CASES = [
    (96, 64, [(96, 72), (64, 96), (96, 96), (96, 45)]),
    (256, 224, [(256, 192), (170, 256), (256, 256)]),
]


def _canvases(canvas, valid, seed=0):
    rng = np.random.default_rng(seed)
    out = np.zeros((len(valid), canvas, canvas, 3), np.uint8)
    for n, (h, w) in enumerate(valid):
        out[n, :h, :w] = rng.integers(0, 256, (h, w, 3))
    return out, np.asarray(valid, np.int32)


def jax_draws(key, valid_hw, out_size, beta=1.0, mix_prob=1.0):
    """The keys the JAX functions take, and the port's draws made from the
    same keys (torch_port_lib.jax_step_draws)."""
    k_aug, _, k_mix = jax.random.split(key, 3)
    k_crop, k_flip = jax.random.split(k_aug)
    draws = jax_step_draws(key, valid_hw, out_size, beta, mix_prob)
    return (k_aug, k_crop, k_flip, k_mix), draws.crops, draws.mix


@pytest.mark.parametrize("canvas,out_size,valid", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_crop_resize_matches_scale_and_translate(canvas, out_size, valid,
                                                 seed):
    """fp32, pixels on the 0-255 scale.  The weights agree to ~2e-7; the
    JAX resample on the CPU is itself up to 1.1e-2 off an fp64 application
    of its own weights (measured at 256 -> 224), so that bounds the
    comparison (2e-2, ~8e-5 of the range).  The port's resample is held
    tighter, to 1e-3 of an fp64 application of the same weights."""
    cv, vhw = _canvases(canvas, valid, seed)
    (_, k_crop, _, _), crops, _ = jax_draws(jax.random.PRNGKey(seed), vhw,
                                            out_size)
    ref = np.asarray(jaug.random_resized_crop(
        jnp.asarray(cv), jnp.asarray(vhw), k_crop, out_size,
        aug.CROP_SCALE, aug.CROP_RATIO))
    got = aug.random_resized_crop(torch.from_numpy(cv), crops.boxes,
                                  out_size).numpy()
    assert got.shape == ref.shape == (len(valid), out_size, out_size, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
    i, j, h, w = torch.as_tensor(crops.boxes).float().unbind(1)
    sy, sx = out_size / h, out_size / w
    wy = aug.resample_weights(canvas, out_size, sy, -i * sy).double()
    wx = aug.resample_weights(canvas, out_size, sx, -j * sx).double()
    exact = torch.einsum("bhwc,bhy,bwx->byxc",
                         torch.from_numpy(cv).double(), wy, wx).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-3)


def test_crop_resize_bf16_matches_within_two_roundings():
    """The resident epoch resamples in bf16 (both packages): each of the
    two contractions rounds to bf16, whose ulp is 1 on [128, 256), and the
    two frameworks may contract in either order: 4 pixel levels."""
    canvas, out_size, valid = CASES[1]
    cv, vhw = _canvases(canvas, valid, 3)
    (_, k_crop, _, _), crops, _ = jax_draws(jax.random.PRNGKey(3), vhw,
                                            out_size)
    ref = np.asarray(jaug.random_resized_crop(
        jnp.asarray(cv), jnp.asarray(vhw), k_crop, out_size,
        aug.CROP_SCALE, aug.CROP_RATIO, dtype=jnp.bfloat16
    ).astype(jnp.float32))
    got = aug.random_resized_crop(torch.from_numpy(cv), crops.boxes,
                                  out_size, torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=4.0)


def test_flip_and_normalize_match():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 255, (6, 8, 10, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    flips = np.asarray(jax.random.bernoulli(key, 0.5, (6, 1, 1, 1))
                       ).reshape(6)
    assert 0 < flips.sum() < 6
    ref = np.asarray(jaug.random_hflip(jnp.asarray(x), key))
    got = aug.hflip(torch.from_numpy(x), flips).numpy()
    np.testing.assert_array_equal(got, ref)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6),
                          (jnp.bfloat16, torch.bfloat16, 0.0)):
        ref = np.asarray(jaug._normalize_float_pixels(jnp.asarray(x), jdt
                                                      ).astype(jnp.float32))
        got = aug.normalize_float_pixels(torch.from_numpy(x), tdt
                                         ).float().numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("canvas,out_size,valid", CASES[:1])
def test_train_augment_matches(canvas, out_size, valid):
    """Crop-resize, flip and normalize together: the crop-resize bound
    (2e-2 pixel levels) divided by the smallest CLIP std x 255 (66.6) is
    3e-4."""
    cv, vhw = _canvases(canvas, valid, 7)
    (k_aug, _, _, _), crops, _ = jax_draws(jax.random.PRNGKey(7), vhw,
                                           out_size)
    ref = np.asarray(jaug.train_augment(jnp.asarray(cv), jnp.asarray(vhw),
                                        k_aug, out_size))
    got = aug.train_augment(torch.from_numpy(cv), crops, out_size).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-4)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mix_prob,beta", [(1.0, 1.0), (0.5, 1.0),
                                           (0.0, 1.0), (1.0, 0.0)])
def test_cutmix_matches(seed, mix_prob, beta):
    """Images, y_a, y_b exactly; lambda as the same float32 number."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((5, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 5).astype(np.int32)
    key = jax.random.PRNGKey(100 + seed)
    (_, _, _, k_mix), _, draws = jax_draws(
        key, np.full((5, 2), 16, np.int32), 16, beta, mix_prob)
    r_img, r_ya, r_yb, r_lam = jaug.cutmix(jnp.asarray(images),
                                           jnp.asarray(labels), k_mix, beta,
                                           mix_prob)
    g_img, g_ya, g_yb, g_lam = aug.cutmix(torch.from_numpy(images),
                                          torch.from_numpy(labels), draws)
    np.testing.assert_array_equal(g_img.numpy(), np.asarray(r_img))
    np.testing.assert_array_equal(g_ya.numpy(), np.asarray(r_ya))
    np.testing.assert_array_equal(g_yb.numpy(), np.asarray(r_yb))
    assert np.float32(g_lam) == np.float32(r_lam)
    if beta <= 0:
        assert draws.lam0 == 1.0 and g_lam == 1.0


@pytest.mark.parametrize("lam", [0.0, 0.13, 0.5, 0.77, 0.999, 1.0])
def test_rand_bbox_matches(lam):
    for seed in range(8):
        k_box = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(k_box)
        cy = int(jax.random.randint(k1, (), 0, 224))
        cx = int(jax.random.randint(k2, (), 0, 224))
        ref = tuple(int(x) for x in jaug._rand_bbox(k_box, 224, 224,
                                                     jnp.float32(lam)))
        assert aug.rand_bbox(224, 224, lam, cy, cx) == ref


@pytest.mark.parametrize("valid", [(256, 40), (40, 256), (256, 170),
                                   (170, 256)])
def test_sample_crop_fallback_matches(valid):
    """Regions with an aspect outside [3/4, 4/3] fail all ten tries (a
    crop of >= 0.9 of the area at a ratio in [3/4, 4/3] does not fit):
    both take the ratio-clamped centre crop, which depends on no draw."""
    vh, vw = valid
    ref = [int(x) for x in jaug._sample_crop(
        jax.random.PRNGKey(0), jnp.int32(vh), jnp.int32(vw),
        aug.CROP_SCALE, aug.CROP_RATIO)]
    got = aug.sample_crops(np.random.default_rng(0),
                           np.asarray([valid], np.int32))[0].tolist()
    assert got == ref


def test_host_samplers_stay_in_bounds():
    rng = np.random.default_rng(11)
    vhw = np.stack([rng.integers(20, 257, 500), rng.integers(20, 257, 500)],
                   axis=1)
    boxes = aug.sample_crops(rng, vhw)
    i, j, h, w = boxes.T
    assert (i >= 0).all() and (j >= 0).all() and (h > 0).all()
    assert (i + h <= vhw[:, 0]).all() and (j + w <= vhw[:, 1]).all()
    ratio = vhw[:, 1] / vhw[:, 0]
    square = (ratio > 0.8) & (ratio < 1.25)       # a random crop fits
    assert (h * w / (vhw[:, 0] * vhw[:, 1]))[square].min() > 0.85
    flips = aug.sample_flips(rng, 4000)
    assert abs(flips.mean() - 0.5) < 0.03
    draws = [aug.sample_cutmix(rng, 8, 224, 224, 1.0, 0.5)
             for _ in range(400)]
    assert abs(np.mean([d.gate for d in draws]) - 0.5) < 0.08
    assert abs(np.mean([d.lam0 for d in draws]) - 0.5) < 0.05
    assert all(sorted(d.perm) == list(range(8)) for d in draws)
