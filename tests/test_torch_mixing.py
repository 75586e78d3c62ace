"""The single-loader mixing family of the port (mixup, resizemix,
saliencymix, attentivemix) on the CPU against swat_tpu.kernels.augment and
swat_tpu.train, fed the JAX package's own draws (torch_port_lib.
jax_mix_draws replays each method's jax.random calls on the same sub-keys).
Held: each mix's images, y_a, y_b and lambda(s); the triangle-kernel weight
matrices against jax.image.scale_and_translate; the saliency map; what each
mix returns for bf16 images; the per-sample lambda criterion; the host
samplers; and 3 lock-step train steps per method by the delta rule of
tests/test_torch_train_steps.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_steps import check_steps_match, setup  # noqa: F401
from torch_port_lib import TORCH_THREADS, jax_mix_draws

from swat_tpu.kernels import augment as jaug
from swat_tpu.train import losses as jlosses
from swat_tpu_torch.kernels import augment as aug
from swat_tpu_torch.train import losses
from swat_tpu_torch.train.steps import make_mix_fn, make_sampler

torch.set_num_threads(TORCH_THREADS)

B, SIZE = 5, 16
GATES = [(1.0, 1.0), (0.5, 1.0), (0.0, 1.0), (1.0, 0.0)]   # mix_prob, beta


def _batch(seed, size=SIZE, b=B):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 3, b).astype(np.int32)
    return images, labels


def _same_labels(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("mix_prob,alpha", GATES)
def test_mixup_matches(seed, mix_prob, alpha):
    """The blend in fp32: the same two products and one sum, which XLA may
    contract into an fma, so one fp32 ulp of the largest term (values up
    to ~4); lambda as the same float32 number."""
    images, labels = _batch(seed)
    k_mix = jax.random.PRNGKey(200 + seed)
    draws = jax_mix_draws("mixup", k_mix, B, SIZE, alpha, mix_prob)
    r_img, r_ya, r_yb, r_lam = jaug.mixup(jnp.asarray(images),
                                          jnp.asarray(labels), k_mix, alpha,
                                          mix_prob)
    g_img, g_ya, g_yb, g_lam = aug.mixup(torch.from_numpy(images),
                                         torch.from_numpy(labels), draws)
    np.testing.assert_allclose(g_img.numpy(), np.asarray(r_img), rtol=0,
                               atol=5e-7)
    _same_labels((g_ya, g_yb), (r_ya, r_yb))
    assert np.float32(g_lam) == np.float32(r_lam)
    if alpha <= 0 or mix_prob == 0:
        assert g_lam == 1.0
        np.testing.assert_array_equal(g_img.numpy(), images)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mix_prob", [1.0, 0.5, 0.0])
def test_resizemix_matches(seed, mix_prob):
    """Outside the pasted box the images are bit-equal; inside, the
    triangle-kernel resample agrees to fp32 summation order (two
    contractions over 32 pixels of values up to ~4: 1e-5)."""
    size = 32
    images, labels = _batch(seed, size)
    k_mix = jax.random.PRNGKey(300 + seed)
    draws = jax_mix_draws("resizemix", k_mix, B, size, mix_prob=mix_prob)
    r_img, r_ya, r_yb, r_lam = jaug.resizemix(
        jnp.asarray(images), jnp.asarray(labels), k_mix, mix_prob)
    g_img, g_ya, g_yb, g_lam = aug.resizemix(
        torch.from_numpy(images), torch.from_numpy(labels), draws)
    r_img = np.asarray(r_img)
    np.testing.assert_allclose(g_img.numpy(), r_img, rtol=0, atol=1e-5)
    _same_labels((g_ya, g_yb), (r_ya, r_yb))
    assert np.float32(g_lam) == np.float32(r_lam)
    if draws.gate:
        box = np.zeros((size, size), bool)
        box[draws.pos_y:draws.pos_y + draws.rh,
            draws.pos_x:draws.pos_x + draws.rw] = True
        np.testing.assert_array_equal(g_img.numpy()[:, ~box], images[:, ~box])
        assert not np.array_equal(r_img[:, box], images[:, box])
    else:
        assert g_lam == 1.0
        np.testing.assert_array_equal(g_img.numpy(), images)


@pytest.mark.parametrize("size,r,pos", [
    (32, 9, 0), (32, 25, 6), (224, 22, 150), (224, 179, 44), (50, 5, 44)])
def test_triangle_weights_match_scale_and_translate(size, r, pos):
    """The weight matrix itself: scale_and_translate of the identity is
    its weight matrix (rows = input pixels), linear, antialias off, with a
    translation."""
    scale = jnp.float32(r) / size
    eye = jnp.eye(size, dtype=jnp.float32)
    ref = np.asarray(jax.image.scale_and_translate(
        eye, (size, size), (1,), jnp.stack([scale]),
        jnp.stack([jnp.float32(pos)]), method="linear", antialias=False))
    got = aug.resample_weights(
        size, size, torch.tensor([np.float32(r) / np.float32(size)]),
        torch.tensor([float(pos)]), kernel=aug._triangle,
        antialias=False)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    # the rendered image is zero outside [pos, pos + r): the box mask of
    # resizemix cuts exactly the non-zero columns (give or take the edge)
    assert np.abs(got[:, :max(pos - 1, 0)]).max(initial=0) == 0
    assert np.abs(got[:, pos + r + 1:]).max(initial=0) == 0


def test_saliency_map_matches():
    """|gray - 7x7 zero-padded box mean / 49|: the average pool sums the
    49 taps and divides, the JAX convolution sums products with 1/49:
    fp32 rounding of values up to ~3 (1e-6)."""
    images, _ = _batch(11, 24, 4)
    ref = np.asarray(jaug.saliency_map(jnp.asarray(images)))
    got = aug.saliency_map(torch.from_numpy(images)).numpy()
    assert got.shape == ref.shape == (4, 24, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # the border divides by 49 too: a constant image is salient only there
    flat = aug.saliency_map(torch.ones(1, 12, 12, 3))[0]
    assert float(flat[3:-3, 3:-3].abs().max()) < 1e-6
    assert float(flat[0, 0]) == pytest.approx(1 - 16 / 49, abs=1e-6)
    # bf16 images are taken to fp32 first, as .astype(float32) does
    bf = torch.from_numpy(images).bfloat16()
    np.testing.assert_allclose(
        aug.saliency_map(bf).numpy(),
        np.asarray(jaug.saliency_map(jnp.asarray(bf.float().numpy()).astype(
            jnp.bfloat16))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mix_prob,beta", GATES)
def test_saliencymix_matches(seed, mix_prob, beta):
    """Images, labels and the per-image lambdas exactly: the boxes hang on
    the argmax of the saliency map, whose 1e-6 agreement does not move the
    peak of a random image."""
    images, labels = _batch(seed, 24)
    k_mix = jax.random.PRNGKey(400 + seed)
    draws = jax_mix_draws("saliencymix", k_mix, B, 24, beta, mix_prob)
    ref = jaug.saliencymix(jnp.asarray(images), jnp.asarray(labels), k_mix,
                           beta, mix_prob)
    got = aug.saliencymix(torch.from_numpy(images), torch.from_numpy(labels),
                          draws)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    _same_labels(got[1:3], ref[1:3])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[3].dtype == torch.float32 and got[3].shape == (B,)
    if not draws.gate or beta <= 0:
        assert bool((got[3] == 1).all())


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mix_prob,beta", GATES)
@pytest.mark.parametrize("grid", [4, 7])
def test_attentivemix_matches(seed, mix_prob, beta, grid):
    """The SAME heatmaps fed to both sides: images, labels and lambdas
    exactly.  The heatmaps belong to the unshuffled batch and are permuted
    with the images; the peak is the centre of the argmax cell."""
    size = grid * 8
    images, labels = _batch(seed, size)
    heatmaps = np.random.default_rng(seed).uniform(
        -1, 1, (B, grid, grid)).astype(np.float32)
    k_mix = jax.random.PRNGKey(500 + seed)
    draws = jax_mix_draws("attentivemix", k_mix, B, size, beta, mix_prob)
    ref = jaug.attentivemix(jnp.asarray(images), jnp.asarray(labels),
                            jnp.asarray(heatmaps), k_mix, beta, mix_prob)
    got = aug.attentivemix(torch.from_numpy(images), torch.from_numpy(labels),
                           torch.from_numpy(heatmaps), draws)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    _same_labels(got[1:3], ref[1:3])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_attentivemix_box_is_centred_on_the_partners_peak_cell():
    """One hot cell per heatmap: image i takes from its partner perm[i] a
    box centred on the CENTRE of the partner's hot cell."""
    size, grid = 32, 4
    images, labels = _batch(3, size, 4)
    cells = [(0, 0), (1, 2), (3, 3), (2, 1)]
    heatmaps = np.full((4, grid, grid), -1.0, np.float32)
    for n, (cy, cx) in enumerate(cells):
        heatmaps[n, cy, cx] = 1.0
    perm = np.array([2, 0, 3, 1])
    lam0 = 0.75                                  # side = int(32 * 0.5) = 16
    mixed, _, y_b, lam = aug.attentivemix(
        torch.from_numpy(images), torch.from_numpy(labels),
        torch.from_numpy(heatmaps), aug.PeakMixDraws(True, lam0, perm))
    for i, j in enumerate(perm):
        cy, cx = (c * 8 + 4 for c in cells[j])
        y1, y2 = max(cy - 8, 0), min(cy + 8, size)
        x1, x2 = max(cx - 8, 0), min(cx + 8, size)
        box = np.zeros((size, size), bool)
        box[y1:y2, x1:x2] = True
        np.testing.assert_array_equal(mixed[i].numpy()[box], images[j][box])
        np.testing.assert_array_equal(mixed[i].numpy()[~box], images[i][~box])
        assert float(lam[i]) == pytest.approx(
            1 - (y2 - y1) * (x2 - x1) / size ** 2, abs=1e-7)
        assert int(y_b[i]) == labels[j]


@pytest.mark.parametrize("method", ["mixup", "resizemix", "saliencymix",
                                    "attentivemix"])
def test_bf16_images_come_out_as_in_swat_tpu(method):
    """Under the resident epoch's bf16 aug_dtype the mixes see bf16 images:
    mixup returns fp32 (its lambda is an fp32 array in swat_tpu, so the
    blend promotes), the others keep bf16; same values within one bf16
    rounding of the resample (resizemix) or exactly."""
    size = 32
    images, labels = _batch(7, size)
    bf = torch.from_numpy(images).bfloat16()
    j_bf = jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16)
    heatmaps = np.random.default_rng(7).uniform(-1, 1, (B, 4, 4)).astype(
        np.float32)
    k_mix = jax.random.PRNGKey(77)
    draws = jax_mix_draws(method, k_mix, B, size, 1.0, 1.0)
    if method == "attentivemix":
        ref = jaug.attentivemix(j_bf, jnp.asarray(labels),
                                jnp.asarray(heatmaps), k_mix, 1.0, 1.0)
        got = aug.attentivemix(bf, torch.from_numpy(labels),
                               torch.from_numpy(heatmaps), draws)
    else:
        ref = getattr(jaug, method)(j_bf, jnp.asarray(labels), k_mix,
                                    mix_prob=1.0)
        got = getattr(aug, method)(bf, torch.from_numpy(labels), draws)
    want = torch.float32 if method == "mixup" else torch.bfloat16
    assert got[0].dtype == want
    assert ref[0].dtype == (jnp.float32 if method == "mixup"
                            else jnp.bfloat16)
    atol = {"mixup": 5e-7, "resizemix": 4e-2}.get(method, 0.0)
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(ref[0].astype(jnp.float32)),
                               rtol=0, atol=atol)


def test_lam_vector_criterion_sums():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((7, 5)).astype(np.float32) * 3
    y_a = rng.integers(0, 5, 7)
    y_b = rng.integers(0, 5, 7)
    lam = rng.uniform(0, 1, 7).astype(np.float32)
    ref = float(jlosses.mixup_criterion_lam_vector(
        jnp.asarray(logits), jnp.asarray(y_a), jnp.asarray(y_b),
        jnp.asarray(lam)))
    got = losses.mixup_criterion_lam_vector(
        torch.from_numpy(logits), torch.from_numpy(y_a),
        torch.from_numpy(y_b), torch.from_numpy(lam))
    assert float(got) == pytest.approx(ref, rel=1e-6)
    # a sum, not a mean: lambda = 1 gives bsz x the mean CE
    ones = torch.ones(7)
    mean_ce = losses.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(y_a))
    assert float(losses.mixup_criterion_lam_vector(
        torch.from_numpy(logits), torch.from_numpy(y_a),
        torch.from_numpy(y_b), ones)) == pytest.approx(7 * float(mean_ce),
                                                       rel=1e-6)


def test_host_samplers_have_the_methods_distributions():
    rng = np.random.default_rng(5)
    mix = [aug.sample_mixup(rng, 8, 1.0, 0.5) for _ in range(600)]
    off = np.mean([d.lam == 1.0 for d in mix])
    assert abs(off - 0.5) < 0.07                       # the gate
    assert abs(np.mean([d.lam for d in mix if d.lam < 1]) - 0.5) < 0.05
    assert aug.sample_mixup(rng, 8, 0.0, 1.0).lam == 1.0   # alpha <= 0
    rz = [aug.sample_resizemix(rng, 8, 224, 224, 0.5) for _ in range(600)]
    assert abs(np.mean([d.gate for d in rz]) - 0.5) < 0.07
    assert all(22 <= d.rh == d.rw <= 179 for d in rz)  # 224 * [0.1, 0.8)
    assert all(0 <= d.pos_y < max(224 - d.rh, 1) and
               0 <= d.pos_x < max(224 - d.rw, 1) for d in rz)
    pk = [aug.sample_peak_mix(rng, 8, 1.0, 0.5) for _ in range(600)]
    assert abs(np.mean([d.gate for d in pk]) - 0.5) < 0.07
    assert abs(np.mean([d.lam0 for d in pk]) - 0.5) < 0.05
    assert aug.sample_peak_mix(rng, 8, 0.0, 1.0).lam0 == 1.0
    for d in mix + rz + pk:
        assert sorted(d.perm) == list(range(8))
    assert aug.resized_patch(224, 224, 0.8) == (179, 179)


@pytest.mark.parametrize("method,draws_type", [
    ("mixup", aug.MixupDraws), ("resizemix", aug.ResizemixDraws),
    ("saliencymix", aug.PeakMixDraws), ("attentivemix", aug.PeakMixDraws)])
def test_sampler_and_mix_fn_dispatch(method, draws_type):
    """make_sampler draws the method's own draws; make_mix_fn applies them
    and returns one lambda or a lambda vector, never both; attentivemix
    without a heatmap_fn is refused, and no gradient reaches its heatmap."""
    images, labels = _batch(2, 32)
    batch = {"images": torch.from_numpy(images).requires_grad_(True),
             "labels": torch.from_numpy(labels).long(),
             "source": torch.zeros(B, dtype=torch.long)}
    draws = make_sampler(method, mix_prob=1.0, image_size=32)(
        np.random.default_rng(0), batch)
    assert isinstance(draws.mix, draws_type) and draws.crops is None
    seen = []

    def heatmap_fn(model, imgs, lab):
        seen.append(torch.is_grad_enabled())
        return imgs.mean(-1)[:, ::8, ::8]

    if method == "attentivemix":
        with pytest.raises(ValueError, match="heatmap_fn"):
            make_mix_fn(method, image_size=32)
    mix = make_mix_fn(method, heatmap_fn=heatmap_fn, image_size=32)

    class State:
        model = None

    out, y_a, y_b, lam, lam_vec, source = mix(State, batch, draws)
    assert out.shape == images.shape and source is batch["source"]
    if method in ("saliencymix", "attentivemix"):
        assert lam is None and lam_vec.shape == (B,)
    else:
        assert lam_vec is None and isinstance(lam, float)
    assert seen == ([False] if method == "attentivemix" else [])


@pytest.mark.parametrize("method,runner", [
    ("mixup", "streaming"), ("mixup", "resident"),
    ("resizemix", "streaming"), ("resizemix", "resident"),
    ("saliencymix", "streaming"), ("saliencymix", "resident"),
    ("attentivemix", "streaming")])
def test_mixing_steps_match_swat_tpu(setup, method, runner):  # noqa: F811
    """3 lock-step train steps at mix_prob=1 against
    swat_tpu.train.steps.make_mixing_step: per-step losses, logit_scale,
    head and every visual tensor by the delta rule, for the streaming step
    and (where swat_tpu has a resident epoch for the method) the resident
    epoch.  attentivemix: swat_tpu's heatmaps through the Flax tower with
    the heads-first Pallas kernel in interpret mode, the port's through the
    kernel's plain twin."""
    draws = check_steps_match(setup, method, runner)
    if method == "mixup":
        assert any(0 < d.mix.lam < 1 for d in draws)
    elif method == "resizemix":
        assert all(d.mix.gate and d.mix.rh > 0 for d in draws)
    else:
        assert all(d.mix.gate for d in draws)
        assert any(d.mix.lam0 < 1 for d in draws)
