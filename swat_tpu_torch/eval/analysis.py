# Copied from swat_tpu/eval/analysis.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Confusion analysis: worst classes and their top confusions.

Functional equivalent of the reference's ``get_worstk_class``
(utils/extras.py:174-243): rank classes by per-class recall, and for each
of the worst N collect the classes it is most confused with (excluding
self), optionally resolving ids to names.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np


def worst_k_classes(scores: dict, confusion_matrix: np.ndarray,
                    n_worst: int = 30, top_confusions: int = 15,
                    id_to_name: Optional[Mapping[str, str]] = None) -> dict:
    """Returns {class_id: {'recall', 'name', 'confused_with': [(id, name,
    count), ...]}} for the n_worst lowest-recall classes."""
    cm = np.asarray(confusion_matrix)
    recall = scores["per_class_recall"]
    order = sorted(recall, key=lambda c: recall[c])[:n_worst]

    out: dict = {}
    for cls in order:
        row = cm[int(cls)]
        conf_order = np.argsort(-row)
        confused = []
        max_count = 0
        for idx in conf_order[:top_confusions]:
            count = int(row[idx])
            if int(idx) == int(cls) or count == 0:
                continue
            # keep ties with the running max (reference :226-231)
            if count >= max_count:
                max_count = count
                confused.append((int(idx),
                                 (id_to_name or {}).get(str(idx), ""),
                                 count))
        out[str(cls)] = {
            "recall": float(recall[cls]),
            "name": (id_to_name or {}).get(str(cls), ""),
            "confused_with": confused,
        }
    return out
