"""Bias-free linear classifier head (counterpart of
``swat_tpu/models/head.py:18-53``): a [num_classes, embed_dim] fp32 matrix,
from the per-class mean prompt embeddings or random; WiSE-FT interpolation
and tau-normalization are plain tensor arithmetic (reference
main.py:27-129)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def init_head_from_prompts(class_embeddings: np.ndarray,
                           device: torch.device) -> torch.Tensor:
    """class_embeddings: [num_classes, embed_dim], the normalized mean
    prompt embeddings (swat_tpu.data.prompts.class_embedding_matrix)."""
    return torch.as_tensor(np.asarray(class_embeddings, np.float32),
                           device=device)


def init_head_random(generator: torch.Generator, num_classes: int,
                     embed_dim: int, device: torch.device) -> torch.Tensor:
    """torch nn.Linear's default: U(-1/sqrt(in), 1/sqrt(in))."""
    bound = 1.0 / embed_dim ** 0.5
    u = torch.rand((num_classes, embed_dim), generator=generator)
    return (u * (2 * bound) - bound).to(device)


def head_logits(head: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """[B, D] x [C, D] -> [B, C] in fp32 (TF32 is off, see precision)."""
    return torch.matmul(features.float(), head.float().t())


def tau_normalize(head: torch.Tensor, tau: float) -> torch.Tensor:
    """w_c /= ||w_c||^tau (reference main.py:38)."""
    norms = torch.linalg.vector_norm(head, dim=-1, keepdim=True)
    return head / norms ** tau


def wise_ft_head(learned: torch.Tensor, zeroshot: torch.Tensor,
                 alpha: float) -> torch.Tensor:
    """alpha * learned + (1 - alpha) * zeroshot (reference main.py:147)."""
    return alpha * learned + (1.0 - alpha) * zeroshot


def wise_ft_params(finetuned: Dict[str, torch.Tensor],
                   zeroshot: Dict[str, torch.Tensor],
                   alpha: float) -> Dict[str, torch.Tensor]:
    """Backbone interpolation over two state dicts (reference
    main.py:76-98)."""
    return {k: alpha * v + (1.0 - alpha) * zeroshot[k]
            for k, v in finetuned.items()}
