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


def summary_line(out: str) -> str:
    """The one summary line a run printed."""
    lines = [ln for ln in out.splitlines() if ln.startswith(f"{DATASET},")]
    assert len(lines) == 1, out
    return lines[0]


def loss_rows(output_dir) -> list:
    """loss.csv's rows as lists of floats."""
    with open(os.path.join(output_dir, "loss.csv")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "Epoch,Iter,Train_loss,Val_loss,Val_acc,Test_acc"
    return [[float(x) for x in ln.split(",")] for ln in lines[1:]]


def assert_rows_match(got, ref) -> None:
    """loss.csv rows of the two packages: epoch, iter and the accuracies
    exactly; the losses, means of fp32 losses summed in another order by
    another framework's kernels, to rtol 1e-4 or the file's own resolution
    (it rounds to 6 decimals; probing's losses fall to 1e-5)."""
    import pytest

    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g[:2] == r[:2]
        assert g[2] == pytest.approx(r[2], rel=1e-4, abs=1e-6)
        assert g[3] == pytest.approx(r[3], rel=1e-4, abs=1e-6)
        assert g[4:] == r[4:]


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


def mega_layer_numpy(width: int, mlp: int, seed: int = 0) -> dict:
    """One transformer block's parameters as float32 numpy arrays in torch's
    layouts, under the field names of the port's
    ``kernels.megablock.BlockWeights``; LayerNorm scale and bias are random
    (not 1 and 0), so that their rounding to the compute dtype shows."""
    rng = np.random.default_rng(seed)
    d, f = width, mlp

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {
        "in_w": normal((3 * d, d), d ** -0.5), "in_b": normal((3 * d,), 0.1),
        "out_w": normal((d, d), d ** -0.5), "out_b": normal((d,), 0.1),
        "ln1_w": 1 + normal((d,), 0.1), "ln1_b": normal((d,), 0.1),
        "ln2_w": 1 + normal((d,), 0.1), "ln2_b": normal((d,), 0.1),
        "fc_w": normal((f, d), d ** -0.5), "fc_b": normal((f,), 0.1),
        "proj_w": normal((d, f), f ** -0.5), "proj_b": normal((d,), 0.1),
    }


def mega_jax_weights(layer: dict, heads: int, dtype):
    """``mega_layer_numpy``'s block in the layout of
    ``swat_tpu.kernels.megablock._prep_weights`` (per-head [H, D, hd] /
    [H, hd, D] stacks, 2-D vectors), cast to ``dtype`` (a jnp dtype)."""
    import jax.numpy as jnp

    d = layer["out_w"].shape[0]
    hd = d // heads

    def heads_cols(w):          # [D, D] -> [H, D, hd]
        return w.reshape(d, heads, hd).transpose(1, 0, 2)

    wq, wk, wv = np.split(layer["in_w"].T, 3, axis=1)
    bq, bk, bv = np.split(layer["in_b"], 3)
    out = (heads_cols(wq), heads_cols(wk), heads_cols(wv),
           bq.reshape(heads, 1, hd), bk.reshape(heads, 1, hd),
           bv.reshape(heads, 1, hd), layer["out_w"].T.reshape(heads, hd, d),
           layer["out_b"].reshape(1, d), layer["ln1_w"].reshape(1, d),
           layer["ln1_b"].reshape(1, d), layer["ln2_w"].reshape(1, d),
           layer["ln2_b"].reshape(1, d), layer["fc_w"].T,
           layer["fc_b"].reshape(1, -1), layer["proj_w"].T,
           layer["proj_b"].reshape(1, d))
    return tuple(jnp.asarray(t, dtype) for t in out)


def mega_grads_to_torch_layout(grads) -> dict:
    """The 16 weight gradients of the JAX fused block (the order of
    ``mega_jax_weights``) as float32 numpy arrays in torch's layouts under
    ``BlockWeights``' field names."""
    (dwq, dwk, dwv, dbq, dbk, dbv, dwo, dbo, dl1s, dl1b, dl2s, dl2b, dwfc,
     dbfc, dwp, dbp) = (np.asarray(g, np.float32) for g in grads)
    d = dwo.shape[-1]

    def cols(w):                # [H, D, hd] -> [D, H*hd]
        return w.transpose(1, 0, 2).reshape(d, d)

    return {
        "in_w": np.concatenate([cols(dwq), cols(dwk), cols(dwv)], axis=1).T,
        "in_b": np.concatenate([dbq.reshape(d), dbk.reshape(d),
                                dbv.reshape(d)]),
        "out_w": dwo.reshape(d, d).T, "out_b": dbo.reshape(d),
        "ln1_w": dl1s.reshape(d), "ln1_b": dl1b.reshape(d),
        "ln2_w": dl2s.reshape(d), "ln2_b": dl2b.reshape(d),
        "fc_w": dwfc.T, "fc_b": dbfc.reshape(-1), "proj_w": dwp.T,
        "proj_b": dbp.reshape(d),
    }


# name: (batch, seq, width, heads, mlp, causal, quick_gelu); S = 5 pads to 8
# and S = 12 to 16 in the JAX package, the port runs them unpadded
MEGA_CASES = {
    "image_quick": (4, 5, 64, 4, 256, False, True),
    "image_gelu": (3, 5, 64, 4, 256, False, False),
    "text_quick": (3, 12, 64, 4, 256, True, True),
    "text_gelu": (2, 12, 64, 4, 256, True, False),
}


def mega_case_inputs(name: str):
    """x and dy [B, S, D] float32 and the layer of ``mega_layer_numpy`` for
    one of MEGA_CASES, from a seed that depends on the case alone."""
    b, s, d, heads, f, causal, quick = MEGA_CASES[name]
    seed = sorted(MEGA_CASES).index(name)
    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    return x, dy, mega_layer_numpy(d, f, seed=seed)


def mega_pallas_reference(out_path: str) -> None:
    """Every MEGA_CASES case, fp32 and bf16, through the JAX package's three
    Pallas kernels in interpret mode: y and x2 from ``_fwd_kernel`` (a direct
    ``pallas_call``, as ``_make_block_fn`` builds it), dx and the 16 weight
    gradients from ``jax.vjp`` of the custom-VJP block.  Saved as float32
    arrays ``<case>/<dtype>/<name>`` in an npz, the weight gradients in
    torch's layouts.  Run it in a process whose XLA_FLAGS hold
    ``--xla_allow_excess_precision=false`` (``mega_reference_subprocess``):
    by default XLA on the CPU drops a cast to bf16 that a cast back to fp32
    follows, which moves the kernels' rounding points."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from swat_tpu.kernels import megablock as JM

    out = {}
    for name, (b, s, d, heads, f, causal, quick) in MEGA_CASES.items():
        x, dy, layer = mega_case_inputs(name)
        sp = max(-(-s // 8) * 8, 8)
        assert sp != s                      # the JAX run is a padded one
        for dname, dtype in (("float32", jnp.float32),
                             ("bfloat16", jnp.bfloat16)):
            w = mega_jax_weights(layer, heads, dtype)

            def padded(t):
                full = np.zeros((b, sp, d), np.float32)
                full[:, :s] = t
                return jnp.asarray(full, dtype).reshape(b * sp, d)

            def cut(t):
                return np.asarray(t.astype(jnp.float32)).reshape(
                    b, sp, d)[:, :s]

            xj = padded(x)
            kern = functools.partial(
                JM._fwd_kernel, bi=b, sp=sp, seq_len=s, heads=heads,
                head_dim=d // heads, causal=causal, quick_gelu=quick)
            y, x2 = pl.pallas_call(
                kern, grid=(1,),
                in_specs=[JM._x_spec(b, sp, d)] + [JM._w_spec(t.shape)
                                                   for t in w],
                out_specs=(JM._x_spec(b, sp, d),) * 2,
                out_shape=(jax.ShapeDtypeStruct(xj.shape, xj.dtype),) * 2,
                interpret=True)(xj, *w)
            block = JM._make_block_fn(b, sp, s, heads, d // heads, d, f,
                                      causal, quick, True)
            y_vjp, vjp = jax.vjp(block, xj, *w)
            grads = vjp(padded(dy))
            np.testing.assert_array_equal(np.asarray(y_vjp, np.float32),
                                          np.asarray(y, np.float32))
            key = f"{name}/{dname}/"
            out[key + "y"], out[key + "x2"] = cut(y), cut(x2)
            out[key + "dx"] = cut(grads[0])
            for k, g in mega_grads_to_torch_layout(grads[1:]).items():
                out[key + k] = g
    np.savez(out_path, **out)


def mega_reference_subprocess(out_path: str) -> dict:
    """``mega_pallas_reference`` in a fresh interpreter with
    ``--xla_allow_excess_precision=false`` -> the arrays it saved."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = [%r, %r]; import torch_port_lib; "
            "torch_port_lib.mega_pallas_reference(%r)"
            % (here, os.path.dirname(here), str(out_path)))
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(out_path) as data:
        return {k: data[k] for k in data.files}


# ---------------------------------------------------------------------------
# the tensor cores' own sum, as an H100 does it (measured bit for bit
# against the block kernels' fp32 products: tests/test_torch_cuda.py,
# test_mega_products_sum_as_the_mma_model)

MMA_K = 16              # products one mma.sync.m16n8k16 sums
MMA_EXTRA_BITS = 2      # bits kept below an fp32 significand when aligning


def _exponent(x):
    """floor(log2 |x|) of a float64 tensor; very low for zeros."""
    import torch

    e = torch.frexp(x).exponent.to(torch.float64) - 1
    return torch.where(x == 0, torch.full_like(e, -1e4), e)


def _toward_zero_fp32(x):
    """float64 ``x`` cut to fp32's 24 significant bits, toward zero."""
    import torch

    q = torch.exp2(_exponent(x) - 23)
    return torch.where(x == 0, x, torch.trunc(x / q) * q)


def mma_sum(c, a, b):
    """One mma.sync.m16n8k16 with bf16 operands and an fp32 accumulator as
    an H100 computes it: c [M, N] + a [M, k] . b [k, N], k <= 16, all
    float64 tensors that hold bf16 (a, b) and fp32 (c) values.  The
    products are exact; each counts as having the exponent of its factors'
    exponents summed (its significand lies in [1, 4)); the products and c
    are aligned to the largest of those exponents and c's, and every bit
    below 2^(largest - 23 - MMA_EXTRA_BITS) is cut off (toward zero); the
    aligned terms are summed exactly and the sum is cut to fp32 toward
    zero.  A chain of mma therefore errs one way, and more than an fp32 sum
    rounded to nearest."""
    import torch

    prods = a[:, None, :] * b.t()[None, :, :]
    pexp = _exponent(a)[:, None, :] + _exponent(b.t())[None, :, :]
    pexp = torch.where(prods == 0, torch.full_like(pexp, -1e4), pexp)
    terms = torch.cat([prods, c[..., None]], -1)
    top = torch.cat([pexp, _exponent(c)[..., None]], -1).amax(-1, True)
    q = torch.exp2((top - 23 - MMA_EXTRA_BITS).clamp(min=-900))
    return _toward_zero_fp32((torch.trunc(terms / q) * q).sum(-1))


def mma_sum_dot(a, b, depth=32, rows=256):
    """a [..., K] . b [K, N] of bf16 values -> fp32, summed as the block
    kernels' tensor-core product sums bf16 (csrc/megablock_mma.cuh): K in
    steps of ``depth``, each step two chained mma (``mma_sum``) from a zero
    accumulator, the steps added by the CUDA cores in fp32, rounded to
    nearest.  Set in place of ``megablock._dot``, it gives the plain
    versions the card's sums; ``rows`` rows of a at a time."""
    import torch

    assert a.dtype == b.dtype == torch.bfloat16, (a.dtype, b.dtype)
    lead, k = a.shape[:-1], a.shape[-1]
    a2, b2 = a.reshape(-1, k).double(), b.double()
    out = []
    for r0 in range(0, a2.shape[0], rows):
        ar = a2[r0:r0 + rows]
        acc = torch.zeros(ar.shape[0], b2.shape[1], device=a.device)
        for s0 in range(0, k, depth):
            c = torch.zeros(acc.shape, dtype=torch.float64, device=a.device)
            for k0 in range(s0, min(k, s0 + depth), MMA_K):
                ks = slice(k0, min(k, k0 + MMA_K))
                c = mma_sum(c, ar[:, ks], b2[ks])
            acc = acc + c.float()
        out.append(acc)
    return torch.cat(out).reshape(*lead, b.shape[1])
