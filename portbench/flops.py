"""Operation and byte counts of a CLIP ViT image tower, and the card's
published peaks.

The counts follow the tower's published structure (OpenCLIP's
``VisionTransformer``): a patch embedding, ``layers`` pre-LN blocks of
multi-head attention and a 4x MLP over ``grid**2 + 1`` tokens, and the
class token's projection.  A multiply-add counts as two operations;
LayerNorm, softmax, GELU and the residual adds are not counted.  Training
counts the forward three times (forward + a backward of twice its
products); recomputation is not counted.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth, and the rates
# of the two compute types the port runs (fp32 outside the tensor cores,
# since the port turns TF32 off; bf16 in them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def vision(cfg: dict) -> dict:
    """The image tower's sizes from a configuration file: image, patch,
    width, layers, heads, embed, tokens."""
    v = cfg["vision_cfg"]
    width = v["width"]
    grid = v["image_size"] // v["patch_size"]
    return {"image": v["image_size"], "patch": v["patch_size"],
            "width": width, "layers": v["layers"],
            "heads": width // cfg["assumed"]["vision_head_width"],
            "embed": cfg["embed_dim"], "grid": grid,
            "tokens": grid * grid + 1}


def image_forward_macs(cfg: dict) -> int:
    """Multiply-adds of one image through the image tower."""
    t = vision(cfg)
    w, s = t["width"], t["tokens"]
    patches = t["grid"] ** 2 * 3 * t["patch"] ** 2 * w
    per_layer = (s * w * 3 * w        # q, k, v projection
                 + 2 * s * s * w      # q k^T and p v, all heads
                 + s * w * w          # output projection
                 + 2 * s * w * 4 * w)  # MLP up and down
    return patches + t["layers"] * per_layer + w * t["embed"]


def image_forward_flops(cfg: dict) -> int:
    return 2 * image_forward_macs(cfg)


def train_flops_per_image(cfg: dict) -> int:
    """Forward and backward of the image tower: three forwards."""
    return 3 * image_forward_flops(cfg)


def attention_bound_s(kind: str, batch: int, seq: int, heads: int,
                      head_dim: int, dtype: str,
                      causal: bool = False) -> Tuple[float, str]:
    """The least time one attention call could take on the card: the
    larger of its bytes (forward: q, k, v read and o written; backward:
    q, k, v, do read and dq, dk, dv written, once each) over the memory
    rate and its operations (2 matrix products forward, 5 backward, of
    2 * head_dim operations for each query-key pair not masked) over the
    type's peak -> (seconds, 'bytes' | 'operations')."""
    tensors, products = (4, 2) if kind == "fwd" else (7, 5)
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    t_bytes = (tensors * batch * heads * seq * head_dim * ITEMSIZE[dtype]
               / HBM_BYTES_PER_S)
    t_ops = products * 2 * batch * heads * pairs * head_dim / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
