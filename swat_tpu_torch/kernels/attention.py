"""Multi-head attention compute path (counterpart of
``swat_tpu/kernels/attention.py``).

Two implementations behind one signature, as there:

* ``_attention_xla`` (and its transpose-free form ``attention_heads_last``):
  matmul + fp32 softmax in plain PyTorch, the probabilities rounded to the
  input dtype before p.v; the correctness reference;
* ``flash_attention``: the hand-written heads-first CUDA kernels
  (``kernels/flash_attention.py``), taken with ``use_pallas=True`` (the
  flag keeps the JAX package's name; on the card it selects the CUDA
  kernels, on the CPU their plain twins).

``heads_first_attention`` is the towers' route through the second: the
counterpart of the Flax ``Attention(use_pallas=True)`` body
(``swat_tpu/models/clip.py:74-84``).
"""

from __future__ import annotations

import torch

from swat_tpu_torch.kernels.flash_attention import flash_attention

# jnp.finfo(float32).min, the causal fill of the plain path
_F32_MIN = torch.finfo(torch.float32).min


def _attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool) -> torch.Tensor:
    """q, k, v: [B, H, S, D] in the compute dtype -> [B, H, S, D].  Scores
    accumulate in fp32, the softmax runs in fp32, the probabilities are
    rounded to the input dtype, p.v accumulates in fp32."""
    scale = 1.0 / q.shape[-1] ** 0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = q.shape[-2]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, _F32_MIN)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def attention_heads_last(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool,
                         softmax_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Transpose-free layout: q, k, v [B, S, H, D] -> out [B, S, H, D].
    ``softmax_dtype`` is the storage dtype of the scores through the
    softmax (bf16 under the throughput policy of the JAX package, fp32 for
    parity)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores.to(softmax_dtype) * torch.tensor(scale,
                                                     dtype=softmax_dtype)
    if causal:
        s = q.shape[1]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, -3e38)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    probs = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False,
                         use_pallas: bool = False) -> torch.Tensor:
    """Dispatch to the fused heads-first kernels or the plain path.
    q, k, v: [B, H, S, D]."""
    if use_pallas:
        return flash_attention(q, k, v, causal)
    return _attention_xla(q, k, v, causal=causal)


def heads_first_attention(qkv: torch.Tensor, heads: int,
                          causal: bool) -> torch.Tensor:
    """A towers' ``attention=`` callable: (qkv [B, S, 3*H*D], heads, causal)
    -> out [B, S, H*D] through ``multi_head_attention(use_pallas=True)``.
    q, k, v go in as transposed views of qkv and the kernel writes its
    output in the same memory order, so nothing is copied on the way in or
    out."""
    b, s, w3 = qkv.shape
    d = w3 // 3 // heads
    q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    out = multi_head_attention(q, k, v, causal=causal, use_pallas=True)
    return out.transpose(1, 2).reshape(b, s, heads * d)
