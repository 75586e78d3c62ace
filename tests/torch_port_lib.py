"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py): a
synthetic JPEG dataset in the split-file format of tests/test_e2e_cli.py,
run configs for both packages, and weights carried between them."""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

DATASET = "test3port"
NUM_CLASSES = 3
CLASS_NAMES = ["red thing", "green thing", "blue thing"]
# tiny-model torch threads: the suite runs in several worker processes
TORCH_THREADS = 2


RETRIEVAL_SPLIT = "T2T30.txt"


def make_dataset(base, n_test_per_class: int = 50, seed: int = 0,
                 n_retrieved_per_class: int = 0) -> str:
    """``<base>/<DATASET>`` with fewshot4_seed1.txt, test.txt, the metrics
    json and, when ``n_retrieved_per_class``, the retrieved split
    RETRIEVAL_SPLIT (retrieved data lives under retrieved_path/<dataset>,
    here the same root, as in tests/test_e2e_cli.py); class-colored JPEGs
    (learnable by color).  Returns the dataset_path to pass as
    ``dataset_path``."""
    rng = np.random.default_rng(seed)
    root = os.path.join(str(base), DATASET)
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    colors = np.asarray([[220, 40, 40], [40, 220, 40], [40, 40, 220]])

    def write_split(name, n_per_class, fewshot, prefix):
        lines = []
        for c in range(NUM_CLASSES):
            for i in range(n_per_class):
                fname = f"imgs/{prefix}_{c}_{i}.jpg"
                arr = (colors[c] + rng.integers(-90, 90, (40, 48, 3))
                       ).clip(0, 255).astype(np.uint8)
                Image.fromarray(arr).save(os.path.join(root, fname))
                lines.append(f"{fname} {c} {fewshot}")
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")

    write_split("fewshot4_seed1.txt", 4, 1, "fs")
    write_split("test.txt", n_test_per_class, 0, "te")
    if n_retrieved_per_class:
        write_split(RETRIEVAL_SPLIT, n_retrieved_per_class, 0, "rt")
    metrics = {str(c): {"name": f"class{c}",
                        "most_common_name": CLASS_NAMES[c]}
               for c in range(NUM_CLASSES)}
    with open(os.path.join(root, f"{DATASET}_metrics-LAION400M.json"),
              "w") as f:
        json.dump(metrics, f)
    return str(base)


def register_dataset():
    """Register DATASET in both packages' registries (each has its own
    data.registry and data.prompts); returns an undo."""
    from swat_tpu.data import prompts as jax_prompts
    from swat_tpu.data import registry as jax_registry
    from swat_tpu_torch.data import prompts, registry

    tables = [(m.NUM_CLASSES_DICT, n.TEMPLATES)
              for m, n in ((jax_registry, jax_prompts), (registry, prompts))]
    for num_classes, templates in tables:
        num_classes[DATASET] = NUM_CLASSES
        templates[DATASET] = ["a photo of a {}.", "a blurry photo of a {}."]

    def undo():
        for num_classes, templates in tables:
            num_classes.pop(DATASET, None)
            templates.pop(DATASET, None)

    return undo


def run_kwargs(dataset_path, folder, **kw) -> dict:
    """RunConfig fields shared by both packages' zero-shot runs."""
    out = dict(dataset=DATASET, model_cfg="test_tiny", shots=4, seed=1,
               training_seed=1, dataset_path=dataset_path,
               retrieved_path=dataset_path, folder=str(folder), bsz=4,
               num_workers=2, mesh_data=1, mesh_model=1, method="zeroshot",
               recal_prompt=True)
    out.update(kw)
    return out


def random_state_dict(cfg, seed: int = 0) -> dict:
    """Seeded OpenCLIP-format state dict (torch tensors) for ``cfg``, made
    by the port's initializer."""
    import torch

    from swat_tpu_torch.models.clip import CLIPModel

    model = CLIPModel(cfg).init_random(torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def jax_params_from_state_dict(sd, cfg):
    """The JAX package's param tree (numpy leaves) for a torch state dict,
    through swat_tpu's own converter."""
    from swat_tpu.models.loader import torch_state_dict_to_params

    params, logit_scale = torch_state_dict_to_params(
        {k: v.numpy() for k, v in sd.items()}, cfg.vision.layers,
        cfg.text.layers)
    return params, logit_scale


def cosine(a, b) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def jax_step_draws(key, valid_hw, image_size: int, beta: float = 1.0,
                   mix_prob: float = 0.5, crops: bool = True,
                   method: str = "cutmix"):
    """The random inputs the JAX package's step draws from ``key``, as the
    port's StepDraws, mirroring make_mix_fn's key splits: key -> (k_aug,
    _, k_mix); train_augment's (k_crop, k_flip); random_resized_crop's
    per-sample keys into aug._sample_crop; then the method's own splits of
    k_mix (``jax_mix_draws``).  ``beta`` is the method's Beta parameter
    (cutmix_beta, or mixup_alpha for mixup)."""
    import jax
    import jax.numpy as jnp

    from swat_tpu.kernels import augment as jaug
    from swat_tpu_torch.kernels import augment as aug
    from swat_tpu_torch.train.steps import StepDraws

    valid_hw = np.asarray(valid_hw)
    b = valid_hw.shape[0]
    k_aug, _, k_mix = jax.random.split(key, 3)
    crop_draws = None
    if crops:
        k_crop, k_flip = jax.random.split(k_aug)
        keys = jax.random.split(k_crop, b)
        boxes = np.asarray([[int(x) for x in jaug._sample_crop(
            keys[n], jnp.int32(valid_hw[n, 0]), jnp.int32(valid_hw[n, 1]),
            aug.CROP_SCALE, aug.CROP_RATIO)] for n in range(b)])
        flips = np.array(jax.random.bernoulli(k_flip, 0.5, (b, 1, 1, 1))
                         ).reshape(b)
        crop_draws = aug.CropDraws(boxes, flips)
    return StepDraws(crop_draws, jax_mix_draws(method, k_mix, b, image_size,
                                               beta, mix_prob))


def jax_mix_draws(method, k_mix, b, image_size, beta=1.0, mix_prob=0.5,
                  tau_range=(0.1, 0.8)):
    """The draws swat_tpu.kernels.augment.<method> makes from ``k_mix``, as
    the port's draws dataclass, each made with the same jax.random call on
    the same sub-key."""
    import jax
    import jax.numpy as jnp

    from swat_tpu.kernels import augment as jaug
    from swat_tpu_torch.kernels import augment as aug

    if method == "finetune":
        return None
    if method == "cutmix":
        k_gate, k_lam, k_perm, k_box = jax.random.split(k_mix, 4)
        gate = bool(jax.random.uniform(k_gate) < mix_prob)
        lam0 = float(jaug._safe_beta(k_lam, beta))
        perm = np.array(jax.random.permutation(k_perm, b))
        box = tuple(int(x) for x in jaug._rand_bbox(
            k_box, image_size, image_size, jnp.float32(lam0)))
        return aug.CutmixDraws(gate, lam0, perm, box)
    if method == "mixup":
        k_gate, k_lam, k_perm = jax.random.split(k_mix, 3)
        lam = jnp.where(jax.random.uniform(k_gate) <= mix_prob,
                        jaug._safe_beta(k_lam, beta), 1.0)
        return aug.MixupDraws(float(lam),
                              np.array(jax.random.permutation(k_perm, b)))
    if method == "resizemix":
        k_gate, k_tau, k_perm, k_py, k_px = jax.random.split(k_mix, 5)
        gate = bool(jax.random.uniform(k_gate) < mix_prob)
        tau = jax.random.uniform(k_tau, minval=tau_range[0],
                                 maxval=tau_range[1])
        rh = int((image_size * tau).astype(jnp.int32))
        rw = rh
        pos_y = int(jax.random.randint(k_py, (), 0,
                                       max(image_size - rh, 1)))
        pos_x = int(jax.random.randint(k_px, (), 0,
                                       max(image_size - rw, 1)))
        assert (rh, rw) == aug.resized_patch(image_size, image_size,
                                             float(tau))
        return aug.ResizemixDraws(
            gate, rh, rw, pos_y, pos_x,
            np.array(jax.random.permutation(k_perm, b)))
    if method in ("saliencymix", "attentivemix"):
        k_gate, k_lam, k_perm = jax.random.split(k_mix, 3)
        return aug.PeakMixDraws(
            bool(jax.random.uniform(k_gate) < mix_prob),
            float(jaug._safe_beta(k_lam, beta)),
            np.array(jax.random.permutation(k_perm, b)))
    raise NotImplementedError(method)


def delta_check(k, init, ref, got, g0, lr_sum, k_bias_bound):
    """The gradient-conditioned comparison of one trained tensor of
    tests/test_torch_twin_fullscale.py::_delta_check, with the run's own
    bounds: Adam's first step is +-lr * sign(g0) whatever |g0|, so an
    element whose first gradient is rounding noise (|g0| <= 1e-2 x the
    tensor's median nonzero |g0|) may walk by up to 2 x the summed lr;
    every other element's delta (final - init) must agree to 2 % of the
    tensor's largest delta plus 2 ulps of the parameter.  The K third of
    attn.in_proj_bias has exactly zero gradient (softmax is shift
    invariant), so it is only bounded by ``k_bias_bound``.  Returns 1 if
    the tensor moved, 0 if it did not."""
    d_ref = ref - init
    d_got = got - init
    if k.endswith("attn.in_proj_bias"):
        d = init.shape[0] // 3
        assert np.abs(d_ref[d:2 * d]).max() <= k_bias_bound, k
        assert np.abs(d_got[d:2 * d]).max() <= k_bias_bound, k
        sel = np.r_[0:d, 2 * d:3 * d]
        d_ref, d_got, init, g0 = d_ref[sel], d_got[sel], init[sel], g0[sel]
    scale = np.abs(d_ref).max()
    if scale == 0:
        np.testing.assert_array_equal(got, ref, err_msg=k)
        return 0
    ulp = float(np.spacing(np.float32(np.abs(init).max() + np.abs(scale))))
    tol = 2e-2 * scale + 2 * ulp
    diff = np.abs(d_got - d_ref)
    bad = diff > tol
    g0_abs = np.abs(g0)
    g0_nz = g0_abs[g0_abs > 0]
    assert g0_nz.size > 0, f"{k}: no first-step gradient anywhere"
    noise = (g0_abs > 0) & (g0_abs <= 1e-2 * float(np.median(g0_nz)))
    hard = bad & ~noise
    assert hard.sum() == 0, (
        f"{k}: {hard.sum()}/{hard.size} gradient-carrying delta mismatches "
        f"(max diff {diff[hard].max() if hard.any() else 0:.3e} vs tol "
        f"{tol:.3e})")
    if bad.any():
        walk = 2.05 * lr_sum + tol
        assert diff[bad].max() <= walk, (
            f"{k}: noise-g0 element diverged {diff[bad].max():.3e} beyond "
            f"the Adam walk bound {walk:.3e}")
    return 1
