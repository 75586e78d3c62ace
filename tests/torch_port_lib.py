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
UNLABELED_SPLIT = "u_train_in_oracle.txt"
DATASET_CLS_SPLITS = ("dataset_train.txt", "dataset_val.txt",
                      "dataset_test.txt")


def make_dataset(base, n_test_per_class: int = 50, seed: int = 0,
                 n_retrieved_per_class: int = 0,
                 n_unlabeled_per_class: int = 0) -> str:
    """``<base>/<DATASET>`` with fewshot4_seed1.txt, test.txt, the metrics
    json and, when ``n_retrieved_per_class``, the retrieved split
    RETRIEVAL_SPLIT (retrieved data lives under retrieved_path/<dataset>,
    here the same root, as in tests/test_e2e_cli.py), and when
    ``n_unlabeled_per_class`` FixMatch's unlabeled split UNLABELED_SPLIT
    (written last, so the other splits do not depend on it); class-colored
    JPEGs (learnable by color).  Returns the dataset_path to pass as
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
    if n_unlabeled_per_class:
        write_split(UNLABELED_SPLIT, n_unlabeled_per_class, 0, "ul")
    metrics = {str(c): {"name": f"class{c}",
                        "most_common_name": CLASS_NAMES[c]}
               for c in range(NUM_CLASSES)}
    with open(os.path.join(root, f"{DATASET}_metrics-LAION400M.json"),
              "w") as f:
        json.dump(metrics, f)
    return str(base)


def write_dataset_cls_splits(dataset_path) -> None:
    """dataset-cls's three split files beside the dataset's: the few-shot
    images flagged 1 and the retrieved ones 0 (make_dataset's
    ``n_retrieved_per_class``), each line with its absolute path, since
    these splits' root is empty (``core/config.py``'s val / test /
    train_split)."""
    root = os.path.join(str(dataset_path), DATASET)
    lines = []
    for name, flag in (("fewshot4_seed1.txt", 1), (RETRIEVAL_SPLIT, 0)):
        with open(os.path.join(root, name)) as f:
            for line in f.read().split("\n"):
                if line:
                    rel, label, _ = line.split()
                    lines.append(f"{os.path.join(root, rel)} {label} {flag}")
    for name in DATASET_CLS_SPLITS:
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def same_native_decoders() -> None:
    """Both packages' native JPEG decoders loaded from whole libraries, so
    that both decode the same way (the PIL fallback differs by +-1 uint8
    LSB).  swat_tpu's own build links its library in place, so a process
    that loads it while another is still linking it gives up on it for good
    (``_lib_tried``); the port's locked, atomic build makes swat_tpu's
    library here first, and a given-up load is tried again."""
    from swat_tpu.data import native as jax_native
    from swat_tpu_torch.data import native
    from swat_tpu_torch.utils import native_build

    native_build.build_library(jax_native._DIR, "libswatdecoder.so",
                               ("decoder.cpp",))
    if jax_native._lib is None:
        jax_native._lib_tried = False
    assert jax_native._load() is not None and native._load() is not None


def register_dataset():
    """Register DATASET in both packages' registries (each has its own
    data.registry and data.prompts), with both packages' native decoders
    loaded (``same_native_decoders``); returns an undo."""
    from swat_tpu.data import prompts as jax_prompts
    from swat_tpu.data import registry as jax_registry
    from swat_tpu_torch.data import prompts, registry

    tables = [(m.NUM_CLASSES_DICT, n.TEMPLATES)
              for m, n in ((jax_registry, jax_prompts), (registry, prompts))]
    for num_classes, templates in tables:
        num_classes[DATASET] = NUM_CLASSES
        templates[DATASET] = ["a photo of a {}.", "a blurry photo of a {}."]
    same_native_decoders()

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


# RN50 image towers for the CPU tests: a tiny one (the widths of
# tests/test_torch_oracle_rn50.py) and RN50's own widths at one bottleneck a
# stage; both with a small text tower
RN50_TEST_TOWERS = {
    "rn50_tiny": dict(image_size=64, width=16, layers=(1, 1, 1, 1),
                      embed_dim=32, heads=4),
    "rn50_1111": dict(image_size=224, width=64, layers=(1, 1, 1, 1),
                      embed_dim=1024, heads=32),
}


def rn50_configs(name: str):
    """-> (the port's CLIPConfig, swat_tpu's) of RN50_TEST_TOWERS[name]."""
    from swat_tpu.models import configs as JC
    from swat_tpu.models.resnet import ResNetConfig as JaxResNetConfig
    from swat_tpu_torch.models import configs as C

    vision = RN50_TEST_TOWERS[name]
    text = dict(context_length=16, vocab_size=512, width=32, layers=2,
                heads=4, embed_dim=vision["embed_dim"], quick_gelu=True)
    return (C.CLIPConfig(name=name, vision=C.ResNetConfig(**vision),
                         text=C.TextConfig(**text)),
            JC.CLIPConfig(name=name, vision=JaxResNetConfig(**vision),
                          text=JC.TextConfig(**text)))


def rn50_bn_shapes(vision) -> list:
    """(channels, side, relu) of each train-mode AffineBN of a ModifiedResNet
    forward (``vision``: its ResNetConfig), in call order: the stem's three
    at half the image side, then each bottleneck's bn1 and bn2 at its input
    side, bn3 at its output side and, in a stage's first, the downsample's
    BN; ``relu``: a ReLU follows it (the stem's, bn1, bn2).  55 for layers
    (3, 4, 6, 3)."""
    w, side = vision.width, vision.image_size // 2
    shapes = [(w // 2, side, True), (w // 2, side, True), (w, side, True)]
    side //= 2
    planes = w
    for stage, blocks in enumerate(vision.layers):
        for i in range(blocks):
            out = side // 2 if stage and not i else side
            shapes += [(planes, side, True), (planes, side, True),
                       (4 * planes, out, False)]
            if not i:
                shapes.append((4 * planes, out, False))
            side = out
        planes *= 2
    return shapes


def port_bn_updates(model, updates) -> dict:
    """A train-mode encode's BN batch statistics (AffineBN module -> (mean,
    var)) folded as a train step folds them (``resnet.fold_bn_updates``),
    into a copy of ``model`` -> {state-dict name of the buffer: float32
    numpy array}; ``model`` is left as it was."""
    import copy

    from swat_tpu_torch.models.resnet import fold_bn_updates

    names = {m: n for n, m in model.named_modules()}
    twin = copy.deepcopy(model)
    modules = dict(twin.named_modules())
    fold_bn_updates({modules[names[bn]]: stats
                     for bn, stats in updates.items()})
    sd = twin.state_dict()
    return {f"{names[bn]}.{k}": sd[f"{names[bn]}.{k}"].float().numpy()
            for bn in updates for k in ("running_mean", "running_var")}


def jax_rn50_outputs(jax_cfg, params, images, precision) -> dict:
    """swat_tpu's RN50 tower on ``images``: 'eval' and 'train' features
    (normalized), 'tokens' (encode_image_tokens) and 'bn/<name>' (the
    sown running statistics folded by apply_bn_updates, under the port's
    buffer names)."""
    import jax
    import jax.numpy as jnp

    from swat_tpu.models import functional as JF
    from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
    from swat_tpu.models.loader import params_to_torch_state_dict

    model = JaxCLIPModel(jax_cfg, precision=precision)

    @jax.jit
    def run(params, x):
        feats, sown = JF.encode_image_bn_train(model, params, x)
        return {"eval": JF.encode_image(model, params, x, normalize=True),
                "tokens": model.apply(
                    {"params": params}, x,
                    method=JaxCLIPModel.encode_image_tokens),
                "train": feats,
                "visual": JF.apply_bn_updates(params["visual"], sown)}

    out = run(params, jnp.asarray(images))
    folded = dict(params, visual=out.pop("visual"))
    for k, v in params_to_torch_state_dict(folded, 0.0).items():
        if k.endswith(("running_mean", "running_var")):
            out["bn/" + k] = v
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def rn50_bf16_reference(inputs_path: str, out_path: str) -> None:
    """``jax_rn50_outputs`` in bf16 (swat_tpu's DEFAULT policy) for each
    tower of the npz ``inputs_path`` ('<name>/sd/<key>' state dicts of
    RN50_TEST_TOWERS, '<name>/images'), saved as '<name>/<output>'.  Run
    it in a process whose XLA_FLAGS hold
    ``--xla_allow_excess_precision=false`` (``excess_precision_subprocess``):
    XLA on the CPU otherwise keeps bf16 products in fp32 where a cast
    follows, and the rounding points move."""
    from swat_tpu.core.precision import DEFAULT_PRECISION
    from swat_tpu.models.loader import torch_state_dict_to_params

    with np.load(inputs_path) as data:
        d = {k: data[k] for k in data.files}
    out = {}
    for name in sorted({k.split("/")[0] for k in d}):
        _, jax_cfg = rn50_configs(name)
        sd = {k[len(name) + 4:]: v for k, v in d.items()
              if k.startswith(f"{name}/sd/")}
        params, _ = torch_state_dict_to_params(sd, 0, jax_cfg.text.layers)
        for k, v in jax_rn50_outputs(jax_cfg, params, d[f"{name}/images"],
                                     DEFAULT_PRECISION).items():
            out[f"{name}/{k}"] = v
    np.savez(out_path, **out)


def cosine(a, b) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _jax_crops(k_aug, valid_hw):
    """The crop boxes and flips train_augment draws from ``k_aug``: its
    (k_crop, k_flip) split and random_resized_crop's per-sample keys into
    aug._sample_crop."""
    import jax
    import jax.numpy as jnp

    from swat_tpu.kernels import augment as jaug
    from swat_tpu_torch.kernels import augment as aug

    b = valid_hw.shape[0]
    k_crop, k_flip = jax.random.split(k_aug)
    keys = jax.random.split(k_crop, b)
    boxes = np.asarray([[int(x) for x in jaug._sample_crop(
        keys[n], jnp.int32(valid_hw[n, 0]), jnp.int32(valid_hw[n, 1]),
        aug.CROP_SCALE, aug.CROP_RATIO)] for n in range(b)])
    flips = np.array(jax.random.bernoulli(k_flip, 0.5, (b, 1, 1, 1))
                     ).reshape(b)
    return aug.CropDraws(boxes, flips)


def jax_crop_draws(key, valid_hw):
    """The random inputs of a JAX step that augments with its step key
    itself (swat_tpu's make_probing_step, make_cmlp_step and
    make_flyp_step pass the key straight to train_augment), as the port's
    StepDraws: crops and flips only."""
    from swat_tpu_torch.train.steps import StepDraws

    return StepDraws(_jax_crops(key, np.asarray(valid_hw)))


def jax_rand_augment_draws(key, b: int, n: int = 2, m: int = 10):
    """The draws swat_tpu.kernels.randaugment.rand_augment makes from
    ``key`` for ``b`` images, as the port's RandAugmentDraws: the batch's
    split(key, b), each image's split into 5 n + 1 keys; round j takes
    (op, magnitude, gate, sign, apply) from keys[5 j: 5 j + 5] (the apply
    key feeds no op), the cutout's (x, y) uniforms come from
    split(keys[-1])."""
    import jax

    from swat_tpu.kernels.randaugment import NUM_OPS
    from swat_tpu_torch.kernels.randaugment import RandAugmentDraws

    ops = np.zeros((b, n), np.int64)
    mags = np.zeros((b, n), np.int64)
    gates = np.zeros((b, n), bool)
    signs = np.zeros((b, n), np.float32)
    cutout = np.zeros((b, 2), np.float32)
    for i, key_i in enumerate(jax.random.split(key, b)):
        keys = jax.random.split(key_i, n * 5 + 1)
        for j in range(n):
            k_op, k_mag, k_gate, k_sign, _ = keys[j * 5: j * 5 + 5]
            ops[i, j] = int(jax.random.randint(k_op, (), 0, NUM_OPS))
            mags[i, j] = int(jax.random.randint(k_mag, (), 1, m))
            gates[i, j] = bool(jax.random.uniform(k_gate) < 0.5)
            signs[i, j] = -1.0 if bool(jax.random.uniform(k_sign) < 0.5) \
                else 1.0
        k1, k2 = jax.random.split(keys[-1])
        cutout[i] = (float(jax.random.uniform(k1)),
                     float(jax.random.uniform(k2)))
    return RandAugmentDraws(ops, mags, gates, signs, cutout)


def jax_fixmatch_draws(key, valid_hw, valid_hw_u=None):
    """The random inputs swat_tpu's make_fixmatch_step draws from its step
    key, as the port's FixmatchDraws: key -> (k_l, k_w, k_s, k_ra); the
    labeled crops from k_l (train_augment's), the weak and the strong
    view's from k_w and k_s (their own (crop, flip) splits, the same as
    train_augment's, ``_jax_crops``), RandAugment's from k_ra.  Without
    ``valid_hw_u`` (pre-augmented views) no view draws; without
    ``valid_hw`` (labeled images) no labeled crops."""
    import jax

    from swat_tpu_torch.train.steps import FixmatchDraws

    k_l, k_w, k_s, k_ra = jax.random.split(key, 4)
    draws = FixmatchDraws(None if valid_hw is None
                          else _jax_crops(k_l, np.asarray(valid_hw)))
    if valid_hw_u is not None:
        valid_hw_u = np.asarray(valid_hw_u)
        draws.weak = _jax_crops(k_w, valid_hw_u)
        draws.strong = _jax_crops(k_s, valid_hw_u)
        draws.rand_augment = jax_rand_augment_draws(k_ra, len(valid_hw_u))
    return draws


def jax_step_draws(key, valid_hw, image_size: int, beta: float = 1.0,
                   mix_prob: float = 0.5, crops: bool = True,
                   method: str = "cutmix", twin_valid_hw=None):
    """The random inputs the JAX package's step draws from ``key``, as the
    port's StepDraws, mirroring make_mix_fn's key splits: key -> (k_aug,
    k_aug2, k_mix); the batch's crops from k_aug and, when
    ``twin_valid_hw`` (the twin batch's valid_hw) is given, the twin's
    from k_aug2 (``_jax_crops``); then the method's own splits of k_mix
    (``jax_mix_draws``), cutmix-fs's over the batch and its twin joined.
    ``beta`` is the method's Beta parameter (cutmix_beta, or mixup_alpha
    for mixup)."""
    import jax

    from swat_tpu_torch.train.steps import StepDraws

    valid_hw = np.asarray(valid_hw)
    b = valid_hw.shape[0]
    k_aug, k_aug2, k_mix = jax.random.split(key, 3)
    crop_draws = twin_crops = None
    if crops:
        crop_draws = _jax_crops(k_aug, valid_hw)
        if twin_valid_hw is not None:
            twin_crops = _jax_crops(k_aug2, np.asarray(twin_valid_hw))
    if method == "cutmix-fs":
        b += len(twin_valid_hw)
    return StepDraws(crop_draws, jax_mix_draws(method, k_mix, b, image_size,
                                               beta, mix_prob), twin_crops)


def jax_mix_draws(method, k_mix, b, image_size, beta=1.0, mix_prob=0.5,
                  tau_range=(0.1, 0.8)):
    """The draws swat_tpu.kernels.augment.<method> makes from ``k_mix``, as
    the port's draws dataclass, each made with the same jax.random call on
    the same sub-key (cutmix-fs: cutmix's over the joined batch of ``b``;
    CMO: cutmix_from's; mixup-fs: mixup_fs's)."""
    import jax
    import jax.numpy as jnp

    from swat_tpu.kernels import augment as jaug
    from swat_tpu_torch.kernels import augment as aug

    if method in ("finetune", "finetune-mixed"):
        return None
    if method == "CMO":
        k_gate, k_lam, k_box = jax.random.split(k_mix, 3)
        gate = bool(jax.random.uniform(k_gate) < mix_prob)
        lam0 = float(jaug._safe_beta(k_lam, beta))
        box = tuple(int(x) for x in jaug._rand_bbox(
            k_box, image_size, image_size, jnp.float32(lam0)))
        return aug.CutmixFromDraws(gate, lam0, box)
    if method == "mixup-fs":
        k_gate, _ = jax.random.split(k_mix)
        return aug.MixupFsDraws(
            0.0 if bool(jax.random.uniform(k_gate) <= mix_prob) else 1.0)
    if method in ("cutmix", "cutmix-fs"):
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


def excess_precision_subprocess(call: str, out_path: str) -> dict:
    """``torch_port_lib.<call>`` (a Python call expression) in a fresh
    interpreter with ``--xla_allow_excess_precision=false``, on the CPU ->
    the arrays it saved to ``out_path``."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = [%r, %r]; import torch_port_lib; "
            "torch_port_lib.%s" % (here, os.path.dirname(here), call))
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(out_path) as data:
        return {k: data[k] for k in data.files}


def mega_reference_subprocess(out_path: str) -> dict:
    """``mega_pallas_reference`` in a fresh interpreter with
    ``--xla_allow_excess_precision=false`` -> the arrays it saved."""
    return excess_precision_subprocess(
        f"mega_pallas_reference({str(out_path)!r})", out_path)


def flyp_bf16_reference(inputs_path: str, out_path: str) -> None:
    """One swat_tpu FLYP step (``train.steps.make_flyp_step``) in bf16, the
    DEFAULT policy, its towers through the Pallas attention kernels in
    interpret mode (``use_pallas=True``: the forward and its custom-VJP
    backward kernel, the rounding points of the port's kernels).  The
    inputs are the npz ``inputs_path``: 'sd/<name>' (an OpenCLIP state
    dict), 'head', 'canvases', 'valid_hw', 'labels', 'source',
    'prompt_tokens', 'key_seed' and 'model_cfg'.  The step's optimizer
    keeps the gradients as its state and moves nothing, so the step's own
    loss function is differentiated as it is in training.  Saved: 'loss',
    'logit_scale' (its gradient) and 'model/<name>' (each model tensor's
    gradient, in torch's names and layouts).  Run it in a process whose
    XLA_FLAGS hold ``--xla_allow_excess_precision=false``
    (``excess_precision_subprocess``)."""
    import jax
    import jax.numpy as jnp
    import optax

    from swat_tpu.core.precision import DEFAULT_PRECISION
    from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
    from swat_tpu.models.configs import get_model_config as jax_model_config
    from swat_tpu.models.loader import (params_to_torch_state_dict,
                                        torch_state_dict_to_params)
    from swat_tpu.train import steps as JS
    from swat_tpu.train.state import create_train_state

    with np.load(inputs_path) as data:
        d = {k: data[k] for k in data.files}
    cfg = jax_model_config(str(d["model_cfg"]))
    params, _ = torch_state_dict_to_params(
        {k[3:]: v for k, v in d.items() if k.startswith("sd/")},
        cfg.vision.layers, cfg.text.layers)
    model = JaxCLIPModel(cfg, precision=DEFAULT_PRECISION, use_pallas=True)
    state, _ = create_train_state(params, d["head"], "FLYP", total_iter=10)

    def update(grads, _state, _params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), update)
    state = state.replace(opt_state=keep.init(state.trainable))
    step = JS.make_flyp_step(model, keep, image_size=cfg.vision.image_size)
    batch = {k: jnp.asarray(d[k]) for k in ("canvases", "valid_hw", "labels",
                                            "source", "prompt_tokens")}
    state, loss = step(state, batch, jax.random.PRNGKey(int(d["key_seed"])))
    grads = state.opt_state
    out = {"loss": np.asarray(loss, np.float32),
           "logit_scale": np.asarray(grads["logit_scale"], np.float32)}
    for k, v in params_to_torch_state_dict(grads["model"], 0.0).items():
        if k != "logit_scale":
            out["model/" + k] = np.asarray(v, np.float32)
    np.savez(out_path, **out)


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


# the ImageNet OOD sweep's trees (eval/ood.py) under a dataset_path:
# ImageNet-V2's numeric class folders, ImageNet-A's and -R's wnid folders
OOD_TREES = {"imagenet_v2": "imagenet_v2",
             "imagenet_adv": os.path.join("imagenet_adv", "imagenet-a"),
             "imagenet_ren": os.path.join("imagenet_ren", "imagenet-r")}


def write_ood_trees(base, n_classes: int = 3, per_class: int = 2,
                    seed: int = 0) -> dict:
    """Class-colored JPEGs (mixed .jpg / .JPEG / .png) in each of
    OOD_TREES under ``base``: V2 in numeric folders of spread ImageNet
    indices, A and R in the wnid folders of classes of their 200-class
    subsets -> {tree: [the ImageNet-1k index of each class]}."""
    from swat_tpu_torch.eval.ood import _load_asset

    asset = _load_asset()
    rng = np.random.default_rng(seed)
    picks = {"imagenet_v2": [int(i) for i in np.linspace(0, 999, n_classes)],
             "imagenet_adv": asset["indices_in_1k_adv"][1:1 + n_classes],
             "imagenet_ren": asset["indices_in_1k_ren"][-n_classes:]}
    exts = (".jpg", ".JPEG", ".png")
    for name, rel in OOD_TREES.items():
        for c, idx in enumerate(picks[name]):
            folder = str(idx) if name == "imagenet_v2" else \
                asset["all_wnids"][idx]
            d = os.path.join(str(base), rel, folder)
            os.makedirs(d, exist_ok=True)
            color = rng.integers(30, 225, 3)
            for i in range(per_class):
                arr = (color + rng.integers(-30, 30, (36, 44, 3))
                       ).clip(0, 255).astype(np.uint8)
                Image.fromarray(arr).save(
                    os.path.join(d, f"img{i}{exts[(c + i) % 3]}"))
    return picks


def write_v2_tree(dataset_path) -> None:
    """An ImageNet-V2 tree (numeric class folders) under ``dataset_path``
    whose folders 0-2 hold images of make_dataset's three class colors, so
    that the OOD sweep's accuracy under a 3-class head means something."""
    rng = np.random.default_rng(7)
    colors = np.asarray([[220, 40, 40], [40, 220, 40], [40, 40, 220]])
    for c, color in enumerate(colors):
        d = os.path.join(str(dataset_path), "imagenet_v2", str(c))
        os.makedirs(d, exist_ok=True)
        for i in range(3):
            arr = (color + rng.integers(-90, 90, (40, 48, 3))
                   ).clip(0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"v2_{i}.jpeg"))



def jax_retrieval_runs(argvs, texts, checkpoint_path: str, model_cfg: str,
                       out_path: str) -> None:
    """``swat_tpu.retrieval.cli`` once per argv of ``argvs`` (each writes
    its outputs where its argv says), its towers in their default bf16
    policy; then the normalized text features of ``texts`` from
    ``swat_tpu``'s text encoder over the same checkpoint, saved to
    ``out_path`` as 'text_features'.  Run it in a process whose XLA_FLAGS
    hold ``--xla_allow_excess_precision=false``
    (``excess_precision_subprocess``), so that XLA keeps the bf16 roundings
    the port's towers make."""
    from swat_tpu.data.features import make_text_encoder
    from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
    from swat_tpu.models.configs import get_model_config as jax_model_config
    from swat_tpu.models.loader import load_torch_checkpoint
    from swat_tpu.models.tokenizer import get_tokenizer
    from swat_tpu.retrieval.cli import main

    for argv in argvs:
        main(argv)
    cfg = jax_model_config(model_cfg)
    params, _ = load_torch_checkpoint(checkpoint_path, cfg.vision.layers,
                                      cfg.text.layers)
    tokens = get_tokenizer(None, vocab_size=cfg.text.vocab_size)(
        list(texts), cfg.text.context_length)
    encode = make_text_encoder(JaxCLIPModel(cfg), params)
    np.savez(out_path, text_features=np.asarray(encode(np.asarray(tokens))))


# ---------------------------------------------------------------------------
# retrieval inputs on a dyadic grid: every fp32 product and sum over them is
# exact whatever the order of its terms, so every framework and device gets
# the same scores bit for bit, and duplicate rows tie exactly


def grid(x, step=2.0 ** -8):
    return (np.round(np.asarray(x) / step) * step).astype(np.float32)


def rank_inputs(seed=0, c=4, n=64, d=8):
    """Class 0 holds five copies of one candidate (rows 3, 14, 15, 16, 33:
    across the 16-row chunk edge at 16), tied in its ranking."""
    rng = np.random.default_rng(seed)
    cands = grid(rng.normal(size=(n, d)) / 4)
    dup = [3, 14, 15, 16, 33]
    cands[dup] = cands[3]
    cls = rng.integers(0, c, n).astype(np.int32)
    cls[dup] = 0
    prompts = grid(rng.normal(size=(c, d)) / 4)
    return prompts, cands, cls


def reference_pool():
    """tests/test_retrieval.py's pool (3 classes x 20, candidate quality
    rising with the index within a class) on the grid, with exact copies
    of a class-1 candidate (a unit image) at 30, 33 and 38 tied in its
    ranking."""
    rng = np.random.default_rng(0)
    c, per, d = 3, 20, 16
    prompts = {str(k): {"mean": np.eye(c, d)[k].astype(np.float32)}
               for k in range(c)}
    labels = np.repeat(np.arange(c), per)
    img = rng.normal(size=(c * per, d)) * 0.01
    cap = rng.normal(size=(c * per, d)) * 0.01
    for k in range(c):
        for i in range(per):
            w = i / per
            cap[k * per + i] += w * np.eye(c, d)[k]
            img[k * per + i] += w * np.eye(c, d)[k]
    img, cap = grid(img), grid(cap)
    img[30] = np.eye(c, d)[1]
    for i in (33, 38):
        img[i], cap[i] = img[30], cap[30]
    files = [f"/pool/{k}/{i:05d}.jpg" for k in range(c) for i in range(per)]
    fs = {k: grid(rng.normal(size=(4, d)) * 0.1 + np.eye(c, d)[k], 2.0 ** -6)
          for k in range(c)}
    return (files, labels, img, cap), prompts, fs


def gapped_pool():
    """Gapped class ids (1 and 3 absent), an under-filled class, and a
    few-shot bundle covering a class absent from the pool."""
    rng = np.random.default_rng(1)
    d = 16
    labels = np.array([0] * 10 + [2] * 3 + [4] * 8, np.int32)
    img = grid(rng.normal(size=(len(labels), d)) / 4)
    cap = grid(rng.normal(size=(len(labels), d)) / 4)
    img[17], cap[17] = img[14], cap[14]
    files = [f"/p/{i}.jpg" for i in range(len(labels))]
    prompts = {str(k): {"mean": grid(rng.normal(size=d) / 4)}
               for k in (0, 2, 4)}
    fs = {k: grid(rng.normal(size=(4, d)) / 4, 2.0 ** -6) for k in range(5)}
    return (files, labels, img, cap), prompts, fs


# ---------------------------------------------------------------------------
# the LayerNorm kernels' arithmetic (csrc/layer_norm.cu), launch by launch:
# every fp32 step the kernels round, in their order, so that the model
# repeats them bit for bit (tests/test_torch_cuda.py) and stands for them
# on the CPU (tests/test_torch_layer_norm.py)


def _ln_lanes(t, group: int, iters: int, vec: int):
    """fp32 rows [T, W] -> [T, iters, group, 32, vec]: lane l of warp g of a
    row's group holds the vectors i * 32 * group + g * 32 + l, i < iters;
    zeros past the width."""
    import torch

    rows, width = t.shape
    held = iters * group * 32 * vec
    padded = torch.zeros(rows, held, dtype=torch.float32, device=t.device)
    padded[:, :width] = t
    return padded.reshape(rows, iters, group, 32, vec)


def _ln_row_sum(lanes):
    """A row's sum over its lanes' elements [T, iters, group, 32, vec]: each
    lane in order (i, then the element), the warp's lanes xor 16, 8, 4, 2,
    1, then the group's warps in order -> [T]."""
    import torch

    acc = torch.zeros(lanes.shape[0], lanes.shape[2], 32,
                      dtype=torch.float32, device=lanes.device)
    for i in range(lanes.shape[1]):
        for e in range(lanes.shape[4]):
            acc = acc + lanes[:, i, :, :, e]
    idx = torch.arange(32, device=lanes.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, idx ^ o]
    total = acc[:, 0, 0]
    for g in range(1, acc.shape[1]):
        total = total + acc[:, g, 0]
    return total


def _ln_div(s, n: int):
    """s / n, an IEEE fp32 division (never a product by 1 / n)."""
    import torch

    return s / torch.full_like(s, float(n))


def _ln_layout(width: int, dtype):
    import torch

    from swat_tpu_torch.kernels import layer_norm as LN

    group, iters = LN.plan(width, dtype)
    return group, iters, 16 * 8 // torch.finfo(dtype).bits


def ln_model_fwd(x, weight, bias, fast: bool, eps: float, out_dtype):
    """The forward kernel's arithmetic -> (y in ``out_dtype``, fp32 mu and
    rstd [*x.shape[:-1]], rstd negated where the clamp acted)."""
    import torch

    width = x.shape[-1]
    xr = x.reshape(-1, width).float()
    group, iters, vec = _ln_layout(width, x.dtype)
    lanes = _ln_lanes(xr, group, iters, vec)
    mu = _ln_div(_ln_row_sum(lanes), width)
    if fast:
        var = _ln_div(_ln_row_sum(lanes * lanes), width) - mu * mu
        clamped = var < 0
        var = torch.where(clamped, torch.zeros_like(var), var)
    else:
        held = _ln_lanes(torch.ones_like(xr), group, iters, vec) > 0
        d = torch.where(held, lanes - mu[:, None, None, None, None],
                        torch.zeros_like(lanes))
        var = _ln_div(_ln_row_sum(d * d), width)
        clamped = torch.zeros_like(var, dtype=torch.bool)
    eps32 = torch.full_like(var, eps)
    # 1 / sqrt correctly rounded to fp32 (__frsqrt_rn), through float64
    rstd = torch.rsqrt((var + eps32).double()).float()
    y = ((xr - mu[:, None]) * (rstd[:, None] * weight.float()[None])
         + bias.float()[None])
    lead = x.shape[:-1]
    return (y.to(out_dtype).reshape(x.shape), mu.reshape(lead),
            torch.where(clamped, -rstd, rstd).reshape(lead))


def ln_model_colsum(p, groups: int):
    """The backward's column sums of fp32 p [T, W] with ``groups`` row
    groups a block: block b sums rows [64 b, 64 b + 64), group g the rows
    64 b + k * groups + g in order of k; the groups joined in a tree (g adds
    g + half, half = groups / 2 .. 1); then the blocks' partial rows in
    JOIN_WARPS contiguous chunks, each in order, the chunks in order -> [W]."""
    import torch

    from swat_tpu_torch.kernels import layer_norm as LN

    rows, width = p.shape
    rb = LN.ROWS_PER_BLOCK
    blocks = -(-rows // rb)
    padded = torch.zeros(blocks * rb, width, dtype=torch.float32,
                         device=p.device)
    padded[:rows] = p
    by = padded.reshape(blocks, rb // groups, groups, width)
    acc = torch.zeros(blocks, groups, width, dtype=torch.float32,
                      device=p.device)
    for k in range(rb // groups):
        acc = acc + by[:, k]
    half = groups // 2
    while half >= 1:
        acc = torch.cat([acc[:, :half] + acc[:, half:2 * half],
                         acc[:, half:]], dim=1)
        half //= 2
    part = acc[:, 0]
    chunk = -(-blocks // LN.JOIN_WARPS)
    sums = []
    for j in range(LN.JOIN_WARPS):
        s = torch.zeros(width, dtype=torch.float32, device=p.device)
        for b in range(j * chunk, min(blocks, (j + 1) * chunk)):
            s = s + part[b]
        sums.append(s)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total


def ln_model_bwd(x, dy, mu, rstd, weight):
    """The backward kernel's arithmetic and its join's -> (dx in x's dtype,
    fp32 dw, db)."""
    import torch

    from swat_tpu_torch.kernels import layer_norm as LN

    width = x.shape[-1]
    xr = x.reshape(-1, width).float()
    dyr = dy.reshape(-1, width).float()
    group, iters, vec = _ln_layout(width, x.dtype)
    rs = rstd.reshape(-1)
    r = rs.abs()[:, None]
    xh = (xr - mu.reshape(-1)[:, None]) * r
    g = dyr * weight.float()[None]
    s1 = _ln_row_sum(_ln_lanes(g, group, iters, vec))
    s2 = _ln_row_sum(_ln_lanes(g * xh, group, iters, vec))
    m1 = _ln_div(s1, width)[:, None]
    m2 = torch.where(rs > 0, _ln_div(s2, width),
                     torch.zeros_like(s2))[:, None]
    dx = r * ((g - m1) - xh * m2)
    groups = LN.WARPS // group
    return (dx.to(x.dtype).reshape(x.shape),
            ln_model_colsum(dyr * xh, groups), ln_model_colsum(dyr, groups))
