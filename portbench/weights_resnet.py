"""The weights of a CLIP model with OpenAI's modified ResNet image tower
(RN50), made by the benchmark from the seed on the device.

Names and shapes are OpenCLIP's ``CLIP`` state dict for a ResNet
configuration file (``ModifiedResNet``: ``visual.conv1..3`` /
``visual.bn1..3``, ``visual.layer{1-4}.{i}.conv{1-3}`` / ``.bn{1-3}`` /
``.downsample.{0,1}``, ``visual.attnpool.*``; the text tower as for a
ViT).  The values follow OpenCLIP's initialisation scheme: convolutions
at torch's default std (3 fan_in)**-0.5; the attention pool's q, k, v and
c_proj weights and its positional embedding at (width * 32)**-0.5, its
biases zero; BatchNorm weights one and biases zero, running statistics
zero and one; the text tower from ``weights.py``'s helpers.  One
departure: every bottleneck's ``bn3.weight``, which OpenCLIP zeroes, is
drawn N(0, 0.1), as the port's ``init_random`` draws it, so that the
first step's gradients reach each bottleneck's convolutions.  Every
normal leaf is a slice of one ``torch.randn`` call, as in ``weights.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.weights import Leaf, _blocks


def _conv(name: str, c_out: int, c_in: int, k: int) -> Leaf:
    return (name + ".weight", (c_out, c_in, k, k), (3 * c_in * k * k) ** -0.5,
            0.0)


def _bn(name: str, n: int, weight_std=None) -> List[Leaf]:
    return [(name + ".weight", (n,), weight_std, 1.0),
            (name + ".bias", (n,), None, 0.0),
            (name + ".running_mean", (n,), None, 0.0),
            (name + ".running_var", (n,), None, 1.0),
            (name + ".num_batches_tracked", (), None, 0)]


def _bottleneck(p: str, inplanes: int, planes: int,
                downsample: bool) -> List[Leaf]:
    out = planes * 4
    leaves = [_conv(p + "conv1", planes, inplanes, 1), *_bn(p + "bn1", planes),
              _conv(p + "conv2", planes, planes, 3), *_bn(p + "bn2", planes),
              _conv(p + "conv3", out, planes, 1),
              *_bn(p + "bn3", out, weight_std=0.1)]
    if downsample:
        leaves += [_conv(p + "downsample.0", out, inplanes, 1),
                   *_bn(p + "downsample.1", out)]
    return leaves


def vision_leaves(cfg: dict) -> List[Leaf]:
    """Every tensor of the image tower, in OpenCLIP's order."""
    v = cfg["vision_cfg"]
    w, e = v["width"], cfg["embed_dim"]
    out = [_conv("visual.conv1", w // 2, 3, 3), *_bn("visual.bn1", w // 2),
           _conv("visual.conv2", w // 2, w // 2, 3),
           *_bn("visual.bn2", w // 2),
           _conv("visual.conv3", w, w // 2, 3), *_bn("visual.bn3", w)]
    inplanes, planes = w, w
    for stage, blocks in enumerate(v["layers"]):
        for i in range(blocks):
            out += _bottleneck(f"visual.layer{stage + 1}.{i}.", inplanes,
                               planes, downsample=i == 0)
            inplanes = planes * 4
        planes *= 2
    c = w * 32
    std = c ** -0.5
    tokens = (v["image_size"] // 32) ** 2 + 1
    out.append(("visual.attnpool.positional_embedding", (tokens, c), std,
                0.0))
    for name, n_out in (("k_proj", c), ("q_proj", c), ("v_proj", c),
                        ("c_proj", e)):
        out += [(f"visual.attnpool.{name}.weight", (n_out, c), std, 0.0),
                (f"visual.attnpool.{name}.bias", (n_out,), None, 0.0)]
    return out


def text_leaves(cfg: dict) -> List[Leaf]:
    """The text tower and ``logit_scale``, as ``weights.leaves`` gives
    them for a ViT configuration."""
    t = cfg["text_cfg"]
    tw = t["width"]
    return [
        ("positional_embedding", (t["context_length"], tw), 0.01, 0.0),
        ("text_projection", (tw, cfg["embed_dim"]), tw ** -0.5, 0.0),
        ("logit_scale", (), None, math.log(1 / 0.07)),
        ("token_embedding.weight", (t["vocab_size"], tw), 0.02, 0.0),
        *_blocks("", tw, t["layers"]),
        ("ln_final.weight", (tw,), None, 1.0),
        ("ln_final.bias", (tw,), None, 0.0),
    ]


def leaves(cfg: dict) -> List[Leaf]:
    """Every tensor of the model, image tower first."""
    return vision_leaves(cfg) + text_leaves(cfg)


def make_weights(cfg: dict, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The whole state dict on ``device``, fp32 but for the int64
    ``num_batches_tracked``: the normal leaves are views into one buffer
    drawn by a single ``randn``."""
    spec = leaves(cfg)
    total = sum(math.prod(shape) for _, shape, std, _ in spec
                if std is not None)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, std, fill in spec:
        if std is None:
            dtype = (torch.int64 if name.endswith("num_batches_tracked")
                     else torch.float32)
            out[name] = torch.full(shape, fill, dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        out[name] = buf[at:at + n].view(shape).mul_(std)
        at += n
    return out
