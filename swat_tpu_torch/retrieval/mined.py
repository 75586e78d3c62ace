"""Mined-pool feature extraction + caption maps (counterpart of
``swat_tpu/retrieval/mined.py``).

Step [3]-[4] of the retrieval pipeline (SURVEY.md §3.3): the downloaded
per-class image folders and their caption map are encoded, images AND
captions, with the CLIP towers in one batched pass each (the reference
chunks to disk then merges, retrieval/extract_mined_feature.py:103-213).
The saved ``.npz`` holds ``swat_tpu``'s keys and dtypes, so either
package's ``sample`` reads either package's ``extract``.
"""

from __future__ import annotations

import os
import pathlib
from typing import Dict, List, Optional

import numpy as np

from swat_tpu_torch.data.features import (batched_encode,
                                          extract_image_features,
                                          make_text_encoder)
from swat_tpu_torch.data.pipeline import EvalLoader
from swat_tpu_torch.data.splits import Sample


def find_mined_images(dataset_root: str,
                      exts=(".jpg", ".jpeg", ".png")) -> List[Sample]:
    """class-id-named folders of downloaded images -> samples
    (reference MinedDataset, utils/datasets/dataset_utils.py:282-320)."""
    root = pathlib.Path(dataset_root)
    samples: List[Sample] = []
    for ext in exts:
        for p in sorted(root.glob(f"**/*{ext}")):
            try:
                label = int(p.parent.name)
            except ValueError:
                continue
            samples.append(Sample(str(p), label, 0))
    if not samples:
        raise ValueError(f"No images found under {dataset_root}")
    return samples


def build_caption_map(metadata: Dict[str, dict]) -> Dict[str, Dict[str, str]]:
    """{class: {img_idx: caption}} from download metadata (reference
    process_meta_map.py:5-47).  metadata: per-class dict of
    {img_idx: {'caption': ...}} or {img_idx: caption}."""
    cmap: Dict[str, Dict[str, str]] = {}
    for cls, entries in metadata.items():
        cmap[str(cls)] = {}
        for img_idx, info in entries.items():
            cap = info["caption"] if isinstance(info, dict) else info
            cmap[str(cls)][str(img_idx)] = cap
    return cmap


def lookup_caption(caption_map: Dict[str, Dict[str, str]],
                   file_path: str) -> Optional[str]:
    """reference check_caption: caption keyed by (class folder, img id)."""
    p = pathlib.Path(file_path)
    cls = p.parent.name
    img_id = p.name.split(".")[0]
    return caption_map.get(str(cls), {}).get(str(img_id))


def extract_mined_features(model, samples: List[Sample],
                           caption_map: Dict[str, Dict[str, str]],
                           tokenizer, batch_size: int = 256,
                           num_workers: int = 16,
                           image_size: int = 224,
                           context_length: Optional[int] = None,
                           mesh=None) -> Dict[str, np.ndarray]:
    """Encodes on the model's device -> {'image_features',
    'caption_features', 'labels', 'file_paths', 'captions'}, the
    reference's {ds}_{model}_mined.pth bundle
    (extract_mined_feature.py:252-280).  Under a data-parallel ``mesh``
    each rank decodes and encodes its rows of every batch, and every rank
    ends with the whole bundle."""
    loader = EvalLoader(samples, batch_size=batch_size, n_px=image_size,
                        num_workers=num_workers, mesh=mesh)
    img = extract_image_features(model, loader, mesh)

    captions = [lookup_caption(caption_map, s.path) or "" for s in samples]
    if context_length is None:
        context_length = model.cfg.text.context_length
    tokens = tokenizer(captions, context_length)
    cap_feats = batched_encode(make_text_encoder(model, mesh),
                               np.asarray(tokens), batch_size)
    return {
        "image_features": img["image_features"],
        "caption_features": cap_feats,
        "labels": np.asarray([s.label for s in samples], np.int32),
        "file_paths": np.asarray([s.path for s in samples]),
        # carried into the sample stage's sampled/filtered debug lists
        # (reference check_caption appends the caption to each info line)
        "captions": np.asarray(captions),
    }


def save_mined_features(path: str, feats: Dict[str, np.ndarray]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **feats)


def load_mined_features(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
