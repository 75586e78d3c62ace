"""CLIP relevance heatmaps (counterpart of ``swat_tpu/eval/heatmap.py``).

The replacement for the external GEM model the reference uses for
AttentiveMix: the heatmap is the cosine similarity between each projected
patch token and a per-image query, the image's own class-token embedding
(self-relevance) or a text embedding.  The forward is
``CLIPModel.encode_image_tokens``, whose attention goes through the
heads-first forward kernel on the card.  No gradient is taken: the callers
run it under ``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from swat_tpu_torch.kernels.attention import heads_first_attention
from swat_tpu_torch.models.clip import Attention, CLIPModel


def _patch_similarity_map(model: CLIPModel, images: torch.Tensor,
                          query_of_tokens,
                          attention: Attention) -> torch.Tensor:
    """Cosine map between every projected patch token and a per-image
    query vector ([B, D], produced by ``query_of_tokens`` from the
    normalized token array) -> [B, gh, gw]."""
    tokens = model.encode_image_tokens(images, attention=attention)
    tokens = tokens / torch.linalg.vector_norm(tokens, dim=-1, keepdim=True)
    patches = tokens[:, 1:]                  # [B, S-1, D]
    query = query_of_tokens(tokens).to(tokens.dtype)
    sim = torch.einsum("bd,bsd->bs", query, patches)
    b, s = sim.shape
    g = int(round(s ** 0.5))
    return sim.reshape(b, g, g)


def clip_attention_heatmap(model: CLIPModel, images: torch.Tensor,
                           attention: Attention = heads_first_attention
                           ) -> torch.Tensor:
    """images [B, H, W, 3] (normalized) -> heatmaps [B, gh, gw] in [-1, 1]:
    self-relevance of each patch token to the image's class token."""
    return _patch_similarity_map(model, images, lambda tokens: tokens[:, 0],
                                 attention)


def clip_text_heatmap(model: CLIPModel, images: torch.Tensor,
                      text_embeds: torch.Tensor,
                      attention: Attention = heads_first_attention
                      ) -> torch.Tensor:
    """Text-conditioned localization map: cosine similarity between each
    projected patch token and the per-image text embedding.

    images [B, H, W, 3] (normalized), text_embeds [B, D] (normalized, from
    a frozen text-tower bank) -> heatmaps [B, gh, gw] in [-1, 1]."""
    return _patch_similarity_map(model, images, lambda _: text_embeds,
                                 attention)
