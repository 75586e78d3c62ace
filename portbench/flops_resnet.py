"""Operation and byte counts of a CLIP ModifiedResNet image tower (RN50).

The counts follow the tower's published structure (OpenCLIP's
``ModifiedResNet``, ``reference/resnet.py``): every convolution's
multiply-adds from its shapes (output pixels x output channels x input
channels x kernel area), and the attention pool's products (q from the
mean token, k and v from all H*W + 1 tokens, one query's scores and
weighted values, ``c_proj``).  A multiply-add counts as two operations;
BatchNorm, ReLU, the average pools, softmax and the residual adds are not
counted.  Training counts each product three times (forward, data
gradient, weight gradient), except the stem's first convolution, whose
input, the images, takes no gradient: twice.
"""

from __future__ import annotations

import dataclasses
from typing import List

from portbench.flops import HBM_BYTES_PER_S, ITEMSIZE, PEAK_FLOPS


@dataclasses.dataclass(frozen=True)
class Conv:
    """One convolution of one image: its name, channels, kernel side, and
    its input's and output's side."""
    name: str
    c_in: int
    c_out: int
    k: int
    side_in: int
    side_out: int

    @property
    def macs(self) -> int:
        return self.side_out ** 2 * self.c_out * self.c_in * self.k ** 2


def convs(cfg: dict) -> List[Conv]:
    """Every convolution of the image tower, in the forward's order."""
    v = cfg["vision_cfg"]
    w, side = v["width"], v["image_size"]
    out = [Conv("visual.conv1", 3, w // 2, 3, side, side // 2)]
    side //= 2
    out += [Conv("visual.conv2", w // 2, w // 2, 3, side, side),
            Conv("visual.conv3", w // 2, w, 3, side, side)]
    side //= 2                                   # avg_pool2d(2)
    inplanes, planes = w, w
    for stage, blocks in enumerate(v["layers"]):
        stride = 1 if stage == 0 else 2
        for i in range(blocks):
            p = f"visual.layer{stage + 1}.{i}."
            s = stride if i == 0 else 1
            out += [Conv(p + "conv1", inplanes, planes, 1, side, side),
                    Conv(p + "conv2", planes, planes, 3, side, side),
                    Conv(p + "conv3", planes, planes * 4, 1, side // s,
                         side // s)]
            if i == 0:
                out.append(Conv(p + "downsample.0", inplanes, planes * 4, 1,
                                side // s, side // s))
            side //= s
            inplanes = planes * 4
        planes *= 2
    return out


def batch_norms(cfg: dict) -> int:
    """BatchNorms a forward: one after every convolution."""
    return len(convs(cfg))


def conv_forward_macs(cfg: dict) -> int:
    return sum(c.macs for c in convs(cfg))


def pool_forward_macs(cfg: dict) -> int:
    """The attention pool's multiply-adds for one image."""
    v = cfg["vision_cfg"]
    c = v["width"] * 32
    s = (v["image_size"] // 32) ** 2 + 1
    return (2 * s * c * c        # k and v of every token
            + c * c              # q of the mean token
            + 2 * s * c          # its scores and weighted values, all heads
            + c * cfg["embed_dim"])  # c_proj


def conv_train_flops_per_image(cfg: dict) -> int:
    """The convolutions' operations of one image's training step."""
    first = convs(cfg)[0].macs
    return 2 * (3 * conv_forward_macs(cfg) - first)


def train_flops_per_image(cfg: dict) -> int:
    """Forward and backward of the image tower."""
    return conv_train_flops_per_image(cfg) + 2 * 3 * pool_forward_macs(cfg)


def conv_train_bound_s(cfg: dict, batch: int, dtype: str) -> float:
    """The least time a training step's convolutions could take on the
    card: for each convolution and each of its passes (forward: input and
    weight read, output written; data gradient: output gradient and weight
    read, input gradient written; weight gradient: input and output
    gradient read, weight gradient written, all once), the larger of its
    bytes over the memory rate and its operations over the type's peak,
    summed."""
    item = ITEMSIZE[dtype]
    total = 0.0
    for i, c in enumerate(convs(cfg)):
        x = batch * c.c_in * c.side_in ** 2
        y = batch * c.c_out * c.side_out ** 2
        wt = c.c_out * c.c_in * c.k ** 2
        ops = 2 * batch * c.macs
        passes = [x + wt + y, x + y + wt]    # forward, weight gradient
        if i > 0:
            passes.append(y + wt + x)        # data gradient
        total += sum(max(n * item / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])
                     for n in passes)
    return total
