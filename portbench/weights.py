"""The model's weights and the classifier head, made by the benchmark from
the seed on the device.

Names and shapes are OpenCLIP's ``CLIP`` state dict for a ViT
configuration file; the values follow OpenCLIP's initialisation scheme
(normal leaves at its standard deviations, LayerNorms at one and zero,
biases at zero).  Every normal leaf is a slice of one ``torch.randn``
call, so the same seed gives the same weights on the same device, to the
program (``load_state_dict``) and to the plain reference alike.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, std, fill): a normal leaf at ``std``, or with std None a
# constant ``fill``
Leaf = Tuple[str, Tuple[int, ...], float, float]


def _blocks(prefix: str, width: int, layers: int) -> List[Leaf]:
    attn_std = width ** -0.5
    proj_std = attn_std * (2 * layers) ** -0.5
    out = []
    for i in range(layers):
        p = f"{prefix}transformer.resblocks.{i}."
        out += [
            (p + "ln_1.weight", (width,), None, 1.0),
            (p + "ln_1.bias", (width,), None, 0.0),
            (p + "attn.in_proj_weight", (3 * width, width), attn_std, 0.0),
            (p + "attn.in_proj_bias", (3 * width,), None, 0.0),
            (p + "attn.out_proj.weight", (width, width), proj_std, 0.0),
            (p + "attn.out_proj.bias", (width,), None, 0.0),
            (p + "ln_2.weight", (width,), None, 1.0),
            (p + "ln_2.bias", (width,), None, 0.0),
            (p + "mlp.c_fc.weight", (4 * width, width), (2 * width) ** -0.5,
             0.0),
            (p + "mlp.c_fc.bias", (4 * width,), None, 0.0),
            (p + "mlp.c_proj.weight", (width, 4 * width), proj_std, 0.0),
            (p + "mlp.c_proj.bias", (width,), None, 0.0),
        ]
    return out


def leaves(cfg: dict) -> List[Leaf]:
    """Every tensor of the model, image tower first."""
    v, t = cfg["vision_cfg"], cfg["text_cfg"]
    w, p, e = v["width"], v["patch_size"], cfg["embed_dim"]
    tokens = (v["image_size"] // p) ** 2 + 1
    tw = t["width"]
    return [
        ("visual.class_embedding", (w,), w ** -0.5, 0.0),
        ("visual.positional_embedding", (tokens, w), w ** -0.5, 0.0),
        ("visual.proj", (w, e), w ** -0.5, 0.0),
        ("visual.conv1.weight", (w, 3, p, p), (3 * p * p) ** -0.5, 0.0),
        ("visual.ln_pre.weight", (w,), None, 1.0),
        ("visual.ln_pre.bias", (w,), None, 0.0),
        *_blocks("visual.", w, v["layers"]),
        ("visual.ln_post.weight", (w,), None, 1.0),
        ("visual.ln_post.bias", (w,), None, 0.0),
        ("positional_embedding", (t["context_length"], tw), 0.01, 0.0),
        ("text_projection", (tw, e), tw ** -0.5, 0.0),
        ("logit_scale", (), None, math.log(1 / 0.07)),
        ("token_embedding.weight", (t["vocab_size"], tw), 0.02, 0.0),
        *_blocks("", tw, t["layers"]),
        ("ln_final.weight", (tw,), None, 1.0),
        ("ln_final.bias", (tw,), None, 0.0),
    ]


def make_weights(cfg: dict, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The whole state dict, fp32 on ``device``: the normal leaves are
    views into one buffer drawn by a single ``randn``."""
    spec = leaves(cfg)
    total = sum(math.prod(shape) for _, shape, std, _ in spec
                if std is not None)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, std, fill in spec:
        if std is None:
            out[name] = torch.full(shape, fill, device=device)
            continue
        n = math.prod(shape)
        out[name] = buf[at:at + n].view(shape).mul_(std)
        at += n
    return out


def make_head(num_classes: int, embed_dim: int, seed: int,
              device: torch.device) -> torch.Tensor:
    """A random classifier head [classes, embed], rows of unit norm."""
    gen = torch.Generator(device=device).manual_seed(seed)
    head = torch.randn(num_classes, embed_dim, generator=gen, device=device)
    return head / torch.linalg.vector_norm(head, dim=-1, keepdim=True)
