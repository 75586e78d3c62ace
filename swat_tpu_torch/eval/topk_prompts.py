"""Top-K prompt-pool zero-shot scoring (counterpart of
``swat_tpu/eval/topk_prompts.py:130-168``).

A working version of the reference's dormant ``validate_topK``
(testing.py:490-545): instead of classifying against each class's *mean*
prompt embedding, score a class by the mean of the top-K cosine
similarities between the image and that class's full prompt pool — one
batched product over the padded [C, P_max, D] prompt bank plus a masked
top-k, no per-class Python loop.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def build_prompt_bank(prompt_tensors: Mapping[str, dict],
                      device: torch.device = torch.device("cpu")):
    """Pad per-class prompt pools to [C, P_max, D] + [C, P_max] mask."""
    cids = sorted(prompt_tensors, key=int)
    pools = [np.asarray(prompt_tensors[c]["all"], np.float32) for c in cids]
    p_max = max(p.shape[0] for p in pools)
    d = pools[0].shape[1]
    bank = np.zeros((len(cids), p_max, d), np.float32)
    mask = np.zeros((len(cids), p_max), bool)
    for i, p in enumerate(pools):
        bank[i, : p.shape[0]] = p
        mask[i, : p.shape[0]] = True
    return (torch.from_numpy(bank).to(device),
            torch.from_numpy(mask).to(device))


def topk_prompt_logits(image_features, bank: torch.Tensor,
                       mask: torch.Tensor, k: int = 3) -> torch.Tensor:
    """[B, D] x [C, P, D] -> [B, C]: per class, mean of the top-k prompt
    similarities (k clamped per the reference's per-class pool-size rule,
    testing.py:517-520); pool slots past a class's prompts are -inf and
    drop out of the mean."""
    k = min(k, int(bank.shape[1]))
    feats = torch.as_tensor(image_features, dtype=torch.float32,
                            device=bank.device)
    sims = torch.einsum("bd,cpd->bcp", feats, bank)
    sims = torch.where(mask[None], sims, -torch.inf)
    top = torch.topk(sims, k, dim=-1).values
    valid = torch.isfinite(top)
    return (torch.where(valid, top, 0.0).sum(-1)
            / valid.sum(-1).clamp_min(1))


def validate_topk(image_features, labels, prompt_tensors, k: int = 3):
    """Returns top-1 accuracy (%) under top-K prompt scoring."""
    bank, mask = build_prompt_bank(prompt_tensors)
    logits = topk_prompt_logits(image_features, bank, mask, k)
    preds = logits.argmax(dim=-1).numpy()
    return float((preds == np.asarray(labels)).mean() * 100.0)
