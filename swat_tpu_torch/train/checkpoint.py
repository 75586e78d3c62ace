"""Stage-final bundles and score files (counterpart of
``swat_tpu/train/checkpoint.py:58-103,209-218``).

The same file names as the JAX package, except that the arrays file ends
in ``.pt`` where ``swat_tpu``'s ends in ``.msgpack``: the arrays go through
``torch.save`` (as CPU tensors), because flax's msgpack needs packages a
GPU machine may not have.  The ``.json`` sidecar, the score files and the
``.npy`` confusion matrices are the same.  Reading and writing the JAX
msgpack bundles, and the periodic train checkpoints, are not ported yet
(ROADMAP Queue A item 4).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def best_model_path(output_dir: str, stage: int, best_epoch: int) -> str:
    # reference naming: utils/models.py:116
    return os.path.join(
        output_dir, f"stage{stage}_model_best-epoch_{best_epoch}_best.pt")


def save_best_model(output_dir: str, stage: int, *, best_records: dict,
                    model_params, head, logit_scale, test_acc: float,
                    best_tau=None, best_tau_test_acc: float = -1,
                    wsft_test_acc: float = -1, best_tau_head=None,
                    wsft_backbone=None, wsft_head=None) -> str:
    """Stage-final bundle (reference utils/models.py:110-146) with its
    sibling stage{N}_val_scores_best.json and confusion matrix."""
    path = best_model_path(output_dir, stage,
                           best_records.get("best_epoch", -1))
    with open(os.path.join(
            output_dir, f"stage{stage}_val_scores_best.json"), "w") as f:
        json.dump(best_records.get("best_scores", {}), f, indent=4,
                  default=float)
    cm = best_records.get("best_confusion_matrix")
    if cm is not None:
        np.save(os.path.join(
            output_dir, f"stage{stage}_val_confusion_matrix_best.npy"), cm)

    arrays = {
        "clip": model_params,
        "head": head,
        "logit_scale": logit_scale,
        "best_tau_head": ({} if best_tau_head is None else
                          {"w": best_tau_head}),
        "wsft_head": {} if wsft_head is None else {"w": wsft_head},
        "wsft_backbone": wsft_backbone if wsft_backbone is not None else {},
    }
    meta = {
        "best_val_acc": best_records.get("best_val_acc", -1),
        "best_epoch": best_records.get("best_epoch", -1),
        "best_iter": best_records.get("best_iter", -1),
        "test_acc": round(float(test_acc), 3),
        "best_tau": best_tau,
        "best_tau_test_acc": round(float(best_tau_test_acc), 3),
        "wsft_test_acc": round(float(wsft_test_acc), 3),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_to_cpu(arrays), path)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=4, default=float)
    return path


def save_test_scores(scores: dict, confusion_matrix, output_dir: str,
                     tag: str, stage: int = 1):
    """reference utils/models.py:149-159 (npy instead of pickle)."""
    with open(os.path.join(output_dir,
                           f"stage{stage}_{tag}_scores.json"), "w") as f:
        json.dump(scores, f, indent=4, default=float)
    if confusion_matrix is not None:
        np.save(os.path.join(
            output_dir, f"stage{stage}_{tag}_confusion_matrix.npy"),
            confusion_matrix)
