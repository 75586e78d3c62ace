# Copied from swat_tpu/data/splits.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Split-file datasets.

Format parity with the reference: each line of a split file is
``<relative_path> <label> <is_fewshot>`` (reference
utils/datasets/dataset_utils.py:151); a *split spec* is
``([files...], [base_paths...])`` so multiple sources (few-shot + retrieved)
concatenate into one dataset (reference utils/parser.py:185-207,
dataset_utils.py:137-146).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

SplitSpec = Tuple[Sequence[str], Sequence[str]]


@dataclasses.dataclass(frozen=True)
class Sample:
    path: str
    label: int
    is_fewshot: int  # 1 fewshot, 0 retrieved (reference dataset_utils.py:115)


def read_split(dataset_root: str, split: SplitSpec) -> List[Sample]:
    """Read and concatenate split files; each file's lines get its paired
    base path prepended (reference MyDataset, dataset_utils.py:130-156)."""
    files, bases = split
    samples: List[Sample] = []
    for fname, base in zip(files, bases):
        with open(os.path.join(dataset_root, fname)) as f:
            for line in f:
                line = line.strip("\n")
                if not line.strip():
                    continue
                path, label, is_fs = line.split(" ")
                samples.append(Sample(os.path.join(base, path),
                                      int(label), int(is_fs)))
    return samples


def read_pseudo_split(path: str) -> List[Sample]:
    """Pseudo-labeled unlabeled data for the --utrain flow: lines are
    ``<path> <label>`` or ``<path> <label> <is_fewshot>``; paths are taken
    as-is (the dump writes resolved paths).  Merge semantics mirror the
    reference's pl_list append (utils/datasets/inat_dataset.py:26-32 —
    the intended consumer; the modern MyDataset wiring in the reference
    drops pl_list on the floor, utils/dataloader.py:144 vs
    dataset_utils.py:58-64).  Pseudo samples count as retrieved
    (is_fewshot=0) unless the file says otherwise."""
    samples: List[Sample] = []
    with open(path) as f:
        for line in f:
            toks = line.strip().split()
            if len(toks) < 2:
                continue
            if (len(toks) >= 3 and toks[-1] in ("0", "1")
                    and toks[-2].lstrip("-").isdigit()):
                p, label, is_fs = " ".join(toks[:-2]), toks[-2], toks[-1]
            else:
                p, label, is_fs = " ".join(toks[:-1]), toks[-1], "0"
            samples.append(Sample(p, int(label), int(is_fs)))
    return samples


def write_split(path: str, samples: Sequence[Sample]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for s in samples:
            f.write(f"{s.path} {s.label} {s.is_fewshot}\n")


def class_counts(samples: Sequence[Sample], num_classes: int) -> List[int]:
    counts = [0] * num_classes
    for s in samples:
        counts[s.label] += 1
    return counts
