"""ImageNet OOD suite: ImageNet-V2 / Sketch / A / R (counterpart of
``swat_tpu/eval/ood.py:184-292``).

Mirrors reference testing.py:22-72 (test_imagenet_ood) and the dataset
wrappers in utils/datasets/imagenet_1k.py.  The 1000->200 class-index
subsets for ImageNet-A/R are public constants from the ImageNet-A/R papers,
stored as a JSON asset: ``ood_indices.json`` beside this module, a
byte-for-byte copy of ``swat_tpu/eval/ood_indices.json`` that the port keeps
as its own.

Directory conventions match the reference: each OOD root holds wnid-named
class folders of images (ImageNet-V2: numeric class-index folders); labels
come from folder name -> ImageNet index through the asset's ``all_wnids``
ordering.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from swat_tpu_torch.data.splits import Sample
from swat_tpu_torch.models.head import head_logits

_ASSET = os.path.join(os.path.dirname(__file__), "ood_indices.json")


def _load_asset() -> dict:
    with open(_ASSET) as f:
        return json.load(f)


def ood_index_subset(name: str) -> Optional[List[int]]:
    """Logit column subset for a dataset ('imagenet_adv'/'imagenet_ren'),
    None for full-1000 datasets (reference validate_simple masks logits,
    testing.py:388-389)."""
    asset = _load_asset()
    if name == "imagenet_adv":
        return asset["indices_in_1k_adv"]
    if name == "imagenet_ren":
        return asset["indices_in_1k_ren"]
    return None


def wnid_to_index() -> Dict[str, int]:
    asset = _load_asset()
    return {w: i for i, w in enumerate(asset["all_wnids"])}


def folder_dataset_samples(root: str, label_map: Optional[Dict[str, int]],
                           exts=(".jpeg", ".JPEG", ".jpg", ".png"),
                           numeric: bool = False) -> List[Sample]:
    """Class-folder tree -> samples with ImageNet-1k (or subset) labels.

    ``numeric=True`` handles ImageNet-V2's numeric class-index folders
    ("0".."999" -> label = int(name), reference
    utils/datasets/imagenet_1k.py:82-84); otherwise folder names are wnids
    resolved through ``label_map``."""
    rootp = pathlib.Path(root)
    samples: List[Sample] = []
    for ext in exts:  # union across extensions (mixed-format roots)
        for p in sorted(rootp.glob(f"**/*{ext}")):
            name = p.parent.name
            if numeric and name.isdigit():
                samples.append(Sample(str(p), int(name), 0))
            elif label_map is not None and name in label_map:
                samples.append(Sample(str(p), label_map[name], 0))
    return samples


def validate_ood(evaluator, model, head, logit_scale, loader,
                 indices_in_1k: Optional[Sequence[int]] = None) -> float:
    """Accuracy with optional logit-column masking: for ImageNet-A/R the
    1000-way logits are restricted to the 200 in-subset columns and labels
    are subset indices (reference validate_simple, testing.py:368-399).
    The counts stay on ``evaluator.device``; one host sync at the end.
    ``logit_scale`` is not read (accuracy only), as in ``swat_tpu``."""
    dev = evaluator.device
    head = torch.as_tensor(head).to(dev)
    sub = (None if indices_in_1k is None
           else torch.as_tensor(indices_in_1k, device=dev))
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        for batch in loader:
            images = torch.from_numpy(np.asarray(batch["images"])).to(dev)
            logits = head_logits(head, model.encode_image(images,
                                                          normalize=True))
            if sub is not None:
                logits = logits[:, sub]
            preds = logits.argmax(dim=-1)
            labels = torch.from_numpy(np.asarray(batch["labels"])).to(dev)
            mask = torch.from_numpy(np.asarray(batch["mask"])).to(dev)
            correct += ((preds == labels) & mask).sum()
            count += mask.sum()
    return int(correct) / max(int(count), 1) * 100.0


def test_imagenet_ood(evaluator, model, head, logit_scale, dataset_path,
                      make_loader, logger) -> Dict[str, float]:
    """Run the 4-dataset OOD sweep (reference test_imagenet_ood,
    testing.py:22-72).  ``make_loader(samples)`` builds an EvalLoader."""
    wmap = wnid_to_index()
    roots = {
        "imagenet_v2": os.path.join(dataset_path, "imagenet_v2"),
        "imagenet_sketch": os.path.join(dataset_path, "imagenet_sketch",
                                        "sketch"),
        "imagenet_adv": os.path.join(dataset_path, "imagenet_adv",
                                     "imagenet-a"),
        "imagenet_ren": os.path.join(dataset_path, "imagenet_ren",
                                     "imagenet-r"),
    }
    accs: Dict[str, float] = {}
    for name, root in roots.items():
        if not os.path.isdir(root):
            logger.info(f"{name}: root {root} missing, skipped")
            continue
        sub = ood_index_subset(name)
        if sub is not None:
            # labels are positions within the 200-class subset
            inv = {idx: pos for pos, idx in enumerate(sub)}
            label_map = {wnid: inv[j] for wnid, j in wmap.items()
                         if j in inv}
        else:
            label_map = wmap
        # ImageNet-V2 ships numeric class-index folders (reference
        # imagenet_1k.py:82-84); wnid folders still work as a fallback.
        samples = folder_dataset_samples(root, label_map,
                                         numeric=(name == "imagenet_v2"))
        if not samples:
            logger.info(f"{name}: no labeled images under {root}, skipped")
            continue
        loader = make_loader(samples)
        acc = validate_ood(evaluator, model, head, logit_scale, loader, sub)
        accs[name] = acc
        logger.info(f"{name}, Test Acc: {round(acc, 3)}")
    if accs:
        logger.info(
            f"Average OOD Test Acc: {round(float(np.mean(list(accs.values()))), 3)}")
    return accs
