"""Text and image feature extraction and the feature cache (counterpart of
``swat_tpu/data/features.py:23-160`` and ``swat_tpu/data/prompts.py:221-247``).

Everything runs under ``torch.inference_mode()`` on the model's device;
host arrays go in and come out as numpy.  The cache is the JAX package's:
``.npz`` files named by dataset, model config, split tag and a fingerprint
of the weights taken over the JAX package's param tree
(``models.loader.jax_params_from_state_dict``), so the same weights give
the same file name in both packages.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, List, Mapping

import numpy as np
import torch

from swat_tpu_torch.models.clip import CLIPModel


def _device(model: CLIPModel) -> torch.device:
    return model.logit_scale.device


def make_text_encoder(model: CLIPModel) -> Callable[[np.ndarray], np.ndarray]:
    """``tokens [N, context] -> [N, D]`` normalized fp32 text features."""
    device = _device(model)

    def encode_fn(tokens: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            ids = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                  device=device)
            return model.encode_text(ids, normalize=True).cpu().numpy()

    return encode_fn


def batched_encode(encode_fn, tokens: np.ndarray,
                   batch_size: int = 1024) -> np.ndarray:
    """Encode [N, ctx] token rows in fixed-size chunks; the tail chunk is
    padded by repeating its last row (every call sees one shape, as in the
    JAX package) and the padding is stripped from the output."""
    feats = []
    n = tokens.shape[0]
    for i in range(0, n, batch_size):
        chunk = tokens[i: i + batch_size]
        pad = 0
        if chunk.shape[0] < batch_size and n > batch_size:
            pad = batch_size - chunk.shape[0]
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], pad, 0)], axis=0)
        out = np.asarray(encode_fn(chunk))
        feats.append(out[: out.shape[0] - pad] if pad else out)
    return (np.concatenate(feats, axis=0) if feats
            else np.empty((0,), np.float32))


def encode_prompts(encode_fn, tokenized: Mapping[str, np.ndarray],
                   batch_size: int = 1024) -> Dict[str, dict]:
    """Every prompt of every class in one batched pass -> class_id ->
    {'all': [n, D], 'mean': [D]}, 'mean' the re-normalized mean of the
    class's normalized prompt embeddings (reference utils/features.py:57-59)."""
    cids = list(tokenized)
    all_tokens = np.concatenate([tokenized[c] for c in cids], axis=0)
    feats = batched_encode(encode_fn, all_tokens, batch_size)
    out: Dict[str, dict] = {}
    ofs = 0
    for cid in cids:
        k = tokenized[cid].shape[0]
        cls_feats = feats[ofs: ofs + k]
        ofs += k
        mean = cls_feats.mean(axis=0)
        out[cid] = {"all": cls_feats, "mean": mean / np.linalg.norm(mean)}
    return out


def extract_image_features(model: CLIPModel, loader) -> Dict[str, np.ndarray]:
    """loader: EvalLoader-style (padded batches with masks) -> {
    'image_features': [N, D] normalized fp32, 'labels': [N], 'source': [N]}."""
    device = _device(model)
    feats, labels, source = [], [], []
    with torch.inference_mode():
        for batch in loader:
            images = torch.from_numpy(batch["images"]).to(device)
            out = model.encode_image(images, normalize=True).cpu().numpy()
            m = np.asarray(batch["mask"])
            feats.append(out[m])
            labels.append(np.asarray(batch["labels"])[m])
            source.append(np.asarray(batch["source"])[m])
    return {"image_features": np.concatenate(feats, axis=0),
            "labels": np.concatenate(labels, axis=0),
            "source": np.concatenate(source, axis=0)}


def feature_cache_path(cache_dir: str, dataset: str, model_cfg: str,
                       split_tag: str, extra: str = "") -> str:
    name = (f"{dataset}_{model_cfg}_{split_tag}"
            f"{('_' + extra) if extra else ''}.npz")
    return os.path.join(cache_dir, name)


def save_features(path: str, feats: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **feats)


def load_features(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def extract_or_load(path: str, recalc: bool, extract_fn, logger=None):
    """The reference's pre_extract_feature contract
    (utils/dataloader.py:35-104): reuse the features on disk across runs
    unless ``recalc`` (--recal_fea)."""
    if not recalc and os.path.exists(path):
        if logger:
            logger.info(f"Loading pre-extracted features: {path}")
        return load_features(path)
    feats = extract_fn()
    try:
        save_features(path, feats)
        if logger:
            logger.info(f"Saved pre-extracted features: {path}")
    except OSError as e:   # a read-only dataset root must not end the run
        if logger:
            logger.warning(f"Could not save feature cache {path}: {e}")
    return feats


def tree_leaves(tree) -> List[np.ndarray]:
    """The leaves of a dict tree in ``jax.tree_util`` order: keys sorted at
    every level, None and empty dicts holding no leaf."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in
                tree_leaves(tree[key])]
    return [] if tree is None else [tree]


def params_fingerprint(params) -> str:
    """A digest of every leaf of a JAX-layout param tree, as
    ``swat_tpu.data.features.params_fingerprint``: per leaf its shape, a
    strided sample of 64 values and the exact float64 sum."""
    leaves = tree_leaves(params)
    h = hashlib.sha1()
    h.update(str(len(leaves)).encode())
    for leaf in leaves:
        a = np.asarray(leaf)
        h.update(str(a.shape).encode())
        flat = a.reshape(-1)
        stride = max(1, flat.size // 64)
        h.update(np.ascontiguousarray(flat[::stride][:64]).tobytes())
        h.update(np.float64(flat.astype(np.float64).sum()).tobytes())
    return h.hexdigest()[:10]
