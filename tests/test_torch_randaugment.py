"""The port's batched RandAugment (swat_tpu_torch/kernels/randaugment.py)
against swat_tpu/kernels/randaugment.py on the CPU, images 47 x 33.

Tolerances: the ops whose output is integral on integral input
(posterize, solarize, equalize, the translations, identity) and the cutout
are bit-equal; so are the samples of rotate and shear here, held to fewer
than 0.5 % of pixels (XLA may fuse a * x + b into one rounding, torch does
not, so a sample at a pixel boundary can flip); the blend and filter ops
(autocontrast, brightness, color, contrast, sharpness) agree to atol 1e-4
on the 0..255 scale (a few fp32 ulps: the mean and the 3 x 3 sum are summed
in another order).  A whole batch under swat_tpu's own draws
(torch_port_lib.jax_rand_augment_draws), on integral and on non-integral
pixels, differs by more than 1e-3 in fewer than 0.5 % of its values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swat_tpu.kernels import randaugment as JR
from swat_tpu_torch.kernels import randaugment as R
from torch_port_lib import TORCH_THREADS, jax_rand_augment_draws

torch.set_num_threads(TORCH_THREADS)

H, W, B = 33, 47, 6
EXACT = {"op_identity", "op_posterize", "op_solarize", "op_equalize",
         "op_translate_x", "op_translate_y"}
GEOMETRIC = {"op_rotate", "op_shear_x", "op_shear_y"}
BLEND_ATOL = 1e-4
MAX_SHARE = 0.005


def _images(seed, integral=True):
    """Pixels in 10..229, so that autocontrast stretches them too."""
    rng = np.random.default_rng(seed)
    x = rng.integers(10, 230, (B, H, W, 3)).astype(np.float32)
    if not integral:
        x += rng.uniform(-3.0, 3.0, x.shape).astype(np.float32)
    return x


def _jax_value(i, mag, sign):
    """swat_tpu's _apply_one scaling of a raw magnitude for op i."""
    fn, max_v, bias, signed = JR._POOL[i]
    m = jnp.float32(mag)
    if max_v is None:
        v = jnp.float32(0)
    elif i in JR._INT_PARAM_OPS:
        v = jnp.floor(m * max_v / JR.PARAMETER_MAX) + bias
    else:
        v = m * max_v / JR.PARAMETER_MAX + bias
    if signed:
        v = v * sign
    return v


@pytest.mark.parametrize("op", range(R.NUM_OPS),
                         ids=[p[0].__name__ for p in R.POOL])
def test_op_matches_swat_tpu(op):
    """Each pool op on six integral images, each with its own magnitude
    and sign: the per-image values equal swat_tpu's scaling bit for bit,
    the images agree within the op's tolerance (module docstring)."""
    name = R.POOL[op][0].__name__
    assert JR._POOL[op][0].__name__ == name
    x = _images(op)
    mags = np.array([1, 3, 5, 7, 9, 2])
    signs = np.array([1, -1, 1, -1, -1, 1], np.float32)
    values = R.op_values(op, mags, signs)
    ref = []
    for n in range(B):
        v = _jax_value(op, mags[n], signs[n])
        assert np.float32(v) == values[n], (name, n)
        ref.append(np.asarray(JR._POOL[op][0](jnp.asarray(x[n]), v, None)))
    ref = np.stack(ref)
    got = R.apply_op(op, torch.from_numpy(x), values).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    if name in EXACT:
        np.testing.assert_array_equal(got, ref)
    elif name in GEOMETRIC:
        assert (got != ref).any(axis=-1).mean() < MAX_SHARE
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=BLEND_ATOL)
    if name != "op_identity":
        assert not np.array_equal(got, x)          # the op did something


def test_cutout_matches_swat_tpu():
    """CutoutAbs: swat_tpu's box from its two uniforms, the x1 / y1 edge
    included, the box clipped at the far edges, bit-equal."""
    x = _images(20)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, B)
    u = np.zeros((B, 2), np.float32)
    ref = []
    for n in range(B):
        k1, k2 = jax.random.split(keys[n])
        u[n] = float(jax.random.uniform(k1)), float(jax.random.uniform(k2))
        ref.append(np.asarray(JR.cutout_abs(jnp.asarray(x[n]), 16, keys[n])))
    boxes = R.cutout_box(u, H, W, 16)
    got = R.cutout_abs(torch.from_numpy(x), boxes).numpy()
    np.testing.assert_array_equal(got, np.stack(ref))
    assert ((got == 127.0).all(axis=-1).sum(axis=(1, 2)) > 0).all()


@pytest.mark.parametrize("integral", [True, False])
def test_batch_matches_swat_tpu_under_its_draws(integral):
    """RandAugmentMC(2, 10) of a batch of 16 with a 16-pixel cutout,
    swat_tpu's rand_augment against the port's fed the draws that key
    makes; the draws exercise most ops with their gates on, and the
    non-integral case feeds unclipped pixels (the strong view's crop)."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (16, H, W, 3)).astype(np.float32)
    if not integral:
        x += rng.uniform(-3.0, 3.0, x.shape).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(JR.rand_augment(jnp.asarray(x), key, n=2, m=10,
                                     cutout=16))
    draws = jax_rand_augment_draws(key, 16)
    assert len(set(draws.ops[draws.gates].tolist())) >= 10
    got = R.rand_augment(torch.from_numpy(x), draws, cutout=16).numpy()
    assert (np.abs(got - ref) > 1e-3).mean() < MAX_SHARE


def test_sampler_and_gates():
    """sample_rand_augment draws ops in 0..13, magnitudes in 1..9, gates
    and signs both ways, uniforms in [0, 1), the same for the same seed;
    with every gate off only the cutout changes the images."""
    d = R.sample_rand_augment(np.random.default_rng(0), 64)
    e = R.sample_rand_augment(np.random.default_rng(0), 64)
    for f in ("ops", "magnitudes", "gates", "signs", "cutout"):
        np.testing.assert_array_equal(getattr(d, f), getattr(e, f))
    assert d.ops.shape == (64, 2) and d.cutout.shape == (64, 2)
    assert d.ops.min() == 0 and d.ops.max() == R.NUM_OPS - 1
    assert d.magnitudes.min() == 1 and d.magnitudes.max() == 9
    assert d.gates.any() and not d.gates.all()
    assert set(d.signs.ravel().tolist()) == {-1.0, 1.0}
    assert ((d.cutout >= 0) & (d.cutout < 1)).all()
    x = torch.from_numpy(_images(9))
    d = R.sample_rand_augment(np.random.default_rng(1), B)
    d.gates[:] = False
    got = R.rand_augment(x, d, cutout=16)
    want = R.cutout_abs(x, R.cutout_box(d.cutout, H, W, 16))
    assert torch.equal(got, want)
    assert torch.equal(x, torch.from_numpy(_images(9)))   # not in place
