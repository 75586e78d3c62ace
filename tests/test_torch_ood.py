"""The ImageNet OOD sweep and the top-k prompt scoring of the PyTorch port
(eval/ood.py, eval/topk_prompts.py) against swat_tpu's: the folder scans,
the logit-column masking, a sweep over synthetic ImageNet-V2 / -A / -R
trees through both packages' real test_tiny towers (equal accuracies), the
top-k prompt logits (1e-6: fp32 dot products of 16 terms summed in another
order) and the asset, byte for byte."""

import logging
import os

import numpy as np
import pytest
import torch
from torch_port_lib import (OOD_TREES, TORCH_THREADS,
                            jax_params_from_state_dict, random_state_dict,
                            same_native_decoders, write_ood_trees)

import jax.numpy as jnp

from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.data.pipeline import EvalLoader as JaxEvalLoader
from swat_tpu.eval import ood as JO
from swat_tpu.eval import topk_prompts as JT
from swat_tpu.eval.validate import Evaluator as JaxEvaluator
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.data.pipeline import EvalLoader
from swat_tpu_torch.data.splits import Sample
from swat_tpu_torch.eval import ood as O
from swat_tpu_torch.eval import topk_prompts as T
from swat_tpu_torch.eval.validate import Evaluator
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config

torch.set_num_threads(TORCH_THREADS)

CFG = get_model_config("test_tiny")
TOPK_ATOL = 1e-6


def test_asset_is_a_byte_copy_of_swat_tpus():
    with open(O._ASSET, "rb") as f, open(JO._ASSET, "rb") as g:
        assert f.read() == g.read()
    assert os.path.dirname(O._ASSET).endswith(
        os.path.join("swat_tpu_torch", "eval"))
    for name in ("imagenet_v2", "imagenet_adv", "imagenet_ren"):
        assert O.ood_index_subset(name) == JO.ood_index_subset(name)
    assert O.wnid_to_index() == JO.wnid_to_index()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    same_native_decoders()
    base = tmp_path_factory.mktemp("ood")
    return str(base), write_ood_trees(base)


def _as_tuples(samples):
    return [(s.path, s.label, s.is_fewshot) for s in samples]


@pytest.mark.parametrize("name", list(OOD_TREES))
def test_folder_scans_match_swat_tpu(trees, name):
    """wnid folders through the full map and the 200-class subset map,
    numeric folders (V2); every extension of a mixed tree found once."""
    base, picks = trees
    root = os.path.join(base, OOD_TREES[name])
    wmap = O.wnid_to_index()
    sub = O.ood_index_subset(name)
    if sub is None:
        maps = [(None, True), (wmap, False)]
    else:
        inv = {idx: pos for pos, idx in enumerate(sub)}
        maps = [({w: inv[j] for w, j in wmap.items() if j in inv}, False),
                (wmap, False)]
    for label_map, numeric in maps:
        got = O.folder_dataset_samples(root, label_map, numeric=numeric)
        ref = JO.folder_dataset_samples(root, label_map, numeric=numeric)
        assert _as_tuples(got) == _as_tuples(ref)
        assert all(isinstance(smp, Sample) for smp in got)
    labels = [s.label for s in O.folder_dataset_samples(
        root, maps[0][0], numeric=maps[0][1])]
    assert len(labels) == 2 * len(picks[name])
    want = (picks[name] if sub is None
            else [sub.index(i) for i in picks[name]])
    assert sorted(set(labels)) == sorted(want)
    # a wnid tree read as numeric finds nothing, a numeric one without
    # numeric mode nothing either
    assert O.folder_dataset_samples(root, None, numeric=sub is not None) \
        == []


class _OneHotModel:
    """encode_image -> one-hot features of the 1000-way index each
    'image' carries (images are index arrays here)."""

    def __init__(self, sub):
        self.sub = sub

    def encode_image(self, images, normalize=True):
        idx = images.long()
        if self.sub is not None:
            idx = torch.as_tensor(self.sub)[idx]
        return torch.eye(10)[idx]


def test_validate_ood_masks_the_subset_columns():
    """A/R: logits restricted to subset columns, labels subset positions
    (reference validate_simple, testing.py:388-389); without the mask
    the predictions land on 1000-way indices and all are wrong."""
    sub = [2, 5, 7]
    labels = np.asarray([0, 1, 2, 2])
    batch = [{"images": labels, "labels": labels,
              "mask": np.ones(4, bool)}]
    head = torch.eye(10)
    ev = Evaluator(10)
    assert O.validate_ood(ev, _OneHotModel(sub), head, None, batch,
                          indices_in_1k=sub) == 100.0
    assert O.validate_ood(ev, _OneHotModel(sub), head, None, batch) == 0.0
    # padding rows (mask False) count for nothing
    batch[0]["mask"] = np.asarray([True, True, False, False])
    batch[0]["labels"] = np.asarray([0, 1, 0, 0])
    assert O.validate_ood(ev, _OneHotModel(sub), head, None, batch,
                          indices_in_1k=sub) == 100.0


def test_sweep_matches_swat_tpu(trees):
    """The four-dataset sweep over the synthetic trees (Sketch absent,
    skipped) through both packages' tiny towers, with a 1000-class head
    built from the port's features of the trees' images so that the
    accuracies are not trivially 0: equal accuracies."""
    base, picks = trees
    sd = random_state_dict(CFG, seed=0)
    model = CLIPModel(CFG, precision=FP32_PRECISION)
    model.load_state_dict(sd)
    model.eval()
    params, _ = jax_params_from_state_dict(sd, jax_model_config("test_tiny"))
    rng = np.random.default_rng(0)
    head = rng.normal(size=(1000, CFG.embed_dim)).astype(np.float32) * 0.05
    for name, rel in OOD_TREES.items():
        samples = JO.folder_dataset_samples(
            os.path.join(base, rel), JO.wnid_to_index(),
            numeric=name == "imagenet_v2")
        batch = next(iter(EvalLoader(samples, batch_size=len(samples),
                                     n_px=32, num_workers=2)))
        with torch.inference_mode():
            feats = model.encode_image(torch.from_numpy(batch["images"]),
                                       normalize=True).numpy()
        for s, f in zip(samples, feats):
            head[s.label] += f
    logger = logging.getLogger("test_torch_ood")

    accs = O.test_imagenet_ood(
        Evaluator(1000), model, torch.from_numpy(head), None, base,
        lambda s: EvalLoader(s, batch_size=4, n_px=32, num_workers=2),
        logger)
    jmodel = JaxCLIPModel(jax_model_config("test_tiny"), precision=JAX_FP32)
    ref = JO.test_imagenet_ood(
        JaxEvaluator(jmodel, 1000), params, jnp.asarray(head), None, base,
        lambda s: JaxEvalLoader(s, batch_size=4, n_px=32, num_workers=2),
        logger)
    assert accs == ref
    assert sorted(accs) == sorted(OOD_TREES)
    assert max(accs.values()) > 0.0


def _prompt_tensors(rng, sizes, d=16):
    out = {}
    for c, n in enumerate(sizes):
        f = rng.normal(size=(n, d)).astype(np.float32)
        f /= np.linalg.norm(f, axis=-1, keepdims=True)
        out[str(c)] = {"all": f, "mean": f.mean(0)}
    return out


@pytest.mark.parametrize("k", [1, 3, 9])
def test_topk_prompt_logits_match_swat_tpu(k):
    """Pools of 1-7 prompts padded to the largest: the -inf slots drop out
    of each class's top-k mean (k past a pool's size included)."""
    rng = np.random.default_rng(k)
    prompts = _prompt_tensors(rng, [3, 1, 7, 5, 2, 4])
    feats = rng.normal(size=(9, 16)).astype(np.float32)
    bank, mask = T.build_prompt_bank(prompts)
    jbank, jmask = JT.build_prompt_bank(prompts)
    assert np.array_equal(bank.numpy(), np.asarray(jbank))
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    got = T.topk_prompt_logits(feats, bank, mask, k).numpy()
    ref = np.asarray(JT.topk_prompt_logits(feats, jbank, jmask, k))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOPK_ATOL)
    labels = rng.integers(0, len(prompts), 9)
    assert T.validate_topk(feats, labels, prompts, k) == \
        JT.validate_topk(feats, labels, prompts, k)

