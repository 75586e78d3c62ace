"""Bias-free linear classifier head (counterpart of
``swat_tpu/models/head.py:18-53``): a [num_classes, embed_dim] fp32 matrix,
from the per-class mean prompt embeddings or random (``jax.random``'s
uniform draw reproduced in numpy); WiSE-FT interpolation
and tau-normalization are plain tensor arithmetic (reference
main.py:27-129)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def init_head_from_prompts(class_embeddings: np.ndarray,
                           device: torch.device) -> torch.Tensor:
    """class_embeddings: [num_classes, embed_dim], the normalized mean
    prompt embeddings (swat_tpu.data.prompts.class_embedding_matrix)."""
    return torch.as_tensor(np.asarray(class_embeddings, np.float32),
                           device=device)


def _threefry2x32(k0: int, k1: int, x0: np.ndarray,
                  x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds over uint32 counter pairs (x0, x1)
    under the key (k0, k1): JAX's ``threefry2x32`` hash (Salmon et al.,
    "Parallel random numbers: as easy as 1, 2, 3"), numpy's uint32
    arithmetic wrapping as the hardware's does."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_uniform(seed: int, shape: Tuple[int, ...], minval: float,
                maxval: float) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape, float32,
    minval, maxval)`` bit for bit, in numpy (``jax_threefry_partitionable``
    on, the JAX default): the key is (0, seed); each element's 32 bits are
    the two threefry words of the (hi, lo) halves of its flat index, XORed;
    their top 23 bits are a float in [1, 2), less 1; then f * (max - min) +
    min with one rounding, as XLA on the CPU fuses it into one multiply-add
    (computed in float64, exact there, and rounded once to float32), and
    max(min, .)."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be in [0, 2^32); got {seed}")
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = _threefry2x32(0, seed, hi, lo)
    bits = (a ^ b).reshape(shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo32, hi32 = np.float32(minval), np.float32(maxval)
    span = np.float64(hi32 - lo32)
    out = (f.astype(np.float64) * span + np.float64(lo32)).astype(np.float32)
    return np.maximum(lo32, out)


def init_head_random(seed: int, num_classes: int, embed_dim: int,
                     device: torch.device) -> torch.Tensor:
    """torch nn.Linear's default, U(-1/sqrt(in), 1/sqrt(in)), drawn as
    ``swat_tpu``'s ``init_head_random(jax.random.PRNGKey(seed), ...)``
    draws it (``jax_uniform``), so both packages start from the same
    head."""
    bound = 1.0 / embed_dim ** 0.5
    return torch.from_numpy(jax_uniform(
        seed, (num_classes, embed_dim), -bound, bound)).to(device)


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
