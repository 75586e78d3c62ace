# Copied from swat_tpu/eval/metrics.py (calculate_scores); the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Per-class scores from a confusion matrix (counterpart of
``swat_tpu/eval/metrics.py:29-56``; copied, since ``swat_tpu.eval``'s
package init imports JAX).  Rows are true labels, columns predictions;
the key names and the micro-vs-macro accuracy follow the reference
testing.py:134-186.
"""

from __future__ import annotations

import numpy as np


def calculate_scores(confusion_matrix: np.ndarray) -> dict:
    """acc, avg_class_accuracy, per-class recall/precision/f1."""
    cm = np.asarray(confusion_matrix, dtype=np.float64)
    num_class = cm.shape[0]
    scores: dict = {}
    scores["acc"] = float(np.trace(cm) / np.sum(cm))
    # a class with zero true samples divides 0/0 -> NaN, which propagates
    # into avg_class_accuracy exactly like the reference
    with np.errstate(divide="ignore", invalid="ignore"):
        class_accuracy = np.diag(cm) / cm.sum(axis=1)
    scores["avg_class_accuracy"] = float(class_accuracy.mean() * 100)

    recall, precision, f1 = {}, {}, {}
    for i in range(num_class):
        tp = cm[i, i]
        fn = cm[i, :].sum() - tp
        fp = cm[:, i].sum() - tp
        recall[i] = float(tp / (tp + fn)) if tp + fn > 0 else 0.0
        precision[i] = float(tp / (tp + fp)) if tp + fp > 0 else 0.0
        f1[i] = (2 * precision[i] * recall[i] / (precision[i] + recall[i])
                 if tp > 0 else 0)
    scores["per_class_recall"] = recall
    scores["per_class_precision"] = precision
    scores["per_class_f1score"] = f1
    return scores
