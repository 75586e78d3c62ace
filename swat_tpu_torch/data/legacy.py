# Copied from swat_tpu/data/legacy.py, over the port's data.splits.Sample; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Legacy dataset readers: semi-iNat / semi-fungi split files and
pseudo-label merging.

Functional equivalent of the reference's iNat loader (reference
utils/datasets/inat_dataset.py:9-35): split files are ``<path> <label>``
lines (semi-fungi paths end in '.JPG' and are split on that marker), with
an optional pseudo-label list appended (the utrain flow).  Output uses the
standard `Sample` type so the normal loaders/pipelines consume it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from swat_tpu_torch.data.splits import Sample


def read_legacy_split(dataset_root: str, split: str, task: str = "All",
                      pl_list: Optional[Sequence[str]] = None
                      ) -> List[Sample]:
    """split: file stem (e.g. 'l_train', 'u_train_in'); task 'semi_fungi'
    uses the '.JPG ' separator quirk."""
    path = os.path.join(dataset_root, split + ".txt")
    with open(path) as f:
        lines = f.readlines()

    def parse(line: str):
        line = line.strip("\n")
        if task == "semi_fungi":
            p, label = line.rsplit(".JPG ")
            return p + ".JPG", int(label)
        parts = line.rsplit()
        return parts[0], int(parts[1])

    rows = [(p, label, 1) for p, label in
            (parse(x) for x in lines if x.strip())]
    if pl_list is not None:
        # pseudo-labeled rows count as retrieved (is_fewshot=0), matching
        # splits.read_pseudo_split's documented semantics
        rows += [(p, label, 0) for p, label in
                 (parse(x) for x in pl_list if x.strip())]
    return [Sample(os.path.join(dataset_root, p), label, fs)
            for p, label, fs in rows]


def read_cub200_split(root: str, train: bool = True) -> List[Sample]:
    """CUB-200-2011 metadata reader (reference utils/datasets/CUB200.py:
    Cub2011._load_metadata/__getitem__): joins images.txt,
    image_class_labels.txt and train_test_split.txt on img_id; labels are
    1-indexed in the metadata and shift to 0 (:74).  Download handling is
    out of scope (no network); point ``root`` at an extracted
    CUB_200_2011 tree."""
    meta = os.path.join(root, "CUB_200_2011")

    def read_pairs(name):
        out = {}
        with open(os.path.join(meta, name)) as f:
            for line in f:
                k, v = line.split()
                out[k] = v
        return out

    files = read_pairs("images.txt")
    labels = read_pairs("image_class_labels.txt")
    is_train = read_pairs("train_test_split.txt")
    want = "1" if train else "0"
    return [
        Sample(os.path.join(meta, "images", files[i]),
               int(labels[i]) - 1, 1)
        for i in sorted(files, key=int)
        if is_train.get(i) == want and i in labels
    ]
