"""OpenCLIP's ``ModifiedResNet`` image tower (OpenAI's CLIP RN50, Radford
et al. 2021) in plain float32 PyTorch, in train mode, and SWAT's stage-1
cutmix steps on it.

The tower, from the published description (open_clip's
``modified_resnet.py``): a stem of three 3x3 convolutions (3 -> w/2 at
stride 2, w/2 -> w/2, w/2 -> w), each followed by BatchNorm and ReLU, then
``avg_pool2d(2)``; four stages of ``layers`` bottlenecks at planes w, 2w,
4w, 8w, the first of stages 2-4 at stride 2.  A bottleneck: 1x1
convolution, BatchNorm, ReLU; 3x3 convolution (padding 1), BatchNorm,
ReLU; ``avg_pool2d(stride)`` when the stride is above 1 (the anti-aliased
stride); 1x1 convolution to 4x the planes, BatchNorm; the first of a
stage downsamples its input by ``avg_pool2d(stride)`` (above 1), a 1x1
convolution and BatchNorm; ReLU of the sum.  No convolution has a bias.
The attention pool: the H*W tokens of the last stage, their mean
prepended, the positional embedding added; q from the mean token, k and
v from all of them (each a Linear with bias), scaled dot products at
head_dim**-0.5 per head, softmax, the heads joined, ``c_proj``.

BatchNorm is the train-mode forward: ``F.batch_norm`` with
``training=True``, the batch's mean and biased variance over N, H, W,
eps 1e-5, gradients through the statistics; where ``params`` holds a
module's running statistics, the forward moves them toward the batch's
mean and unbiased variance at momentum 0.1, as ``nn.BatchNorm2d`` does.
Departure from the published module: the tower works in NCHW from images
given as [B, H, W, 3].

Every convolution goes through ``conv`` and every matrix product through
``Rounding.mm``: with a ``Rounding`` other than fp32 their operands and
gradients are rounded (the control).  ``follow`` holds the float32 cutmix
steps with TF32 off for both matrix products and cuDNN's convolutions;
it reuses ``train.py``'s draws, transform, cutmix, schedule, AdamW and
readings, and reads besides each running statistic's change.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.train import (Readings, adamw, cutmix, draw_crops,
                                       draw_cutmix, learning_rate, norms,
                                       transform)
from portbench.reference.vit import (LOG_INV_TEMPERATURE, Rounding,
                                     cross_entropy, normalized)

BN_EPS, BN_MOMENTUM = 1e-5, 0.1
# state-dict entries of BatchNorm that no train-mode step trains
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
# those of them that a train-mode forward moves
RUNNING = ("running_mean", "running_var")


@dataclasses.dataclass
class BNReadings(Readings):
    """``Readings``, and each running statistic's change over the steps,
    by state-dict name, in float32 on the CPU."""
    running_change: Dict[str, torch.Tensor]


class _RoundedConv(torch.autograd.Function):
    """A convolution whose operands, forward and in both gradients, are
    rounded by ``rounding``."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, rounding):
        rx, rw = rounding.fwd(x), rounding.fwd(w)
        ctx.save_for_backward(rx, rw)
        ctx.stride, ctx.padding, ctx.rounding = stride, padding, rounding
        return F.conv2d(rx, rw, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        rx, rw = ctx.saved_tensors
        g = ctx.rounding.bwd(g)
        dx = (torch.nn.grad.conv2d_input(rx.shape, rw, g, ctx.stride,
                                         ctx.padding)
              if ctx.needs_input_grad[0] else None)
        dw = torch.nn.grad.conv2d_weight(rx, rw.shape, g, ctx.stride,
                                         ctx.padding)
        return dx, dw, None, None, None


def conv(x: torch.Tensor, w: torch.Tensor, stride: int,
         r: Rounding) -> torch.Tensor:
    """A bias-free convolution, padding k // 2, through ``r``."""
    padding = w.shape[-1] // 2
    if r.mode == "fp32":
        return F.conv2d(x, w, None, stride, padding)
    return _RoundedConv.apply(x, w, stride, padding, r)


def _bn(x: torch.Tensor, params: Dict[str, torch.Tensor],
        name: str) -> torch.Tensor:
    """Train-mode BatchNorm; the running statistics in ``params``, if
    there, moved in place."""
    return F.batch_norm(x, params.get(name + ".running_mean"),
                        params.get(name + ".running_var"),
                        params[name + ".weight"], params[name + ".bias"],
                        training=True, momentum=BN_MOMENTUM, eps=BN_EPS)


def _conv_bn(x, params, name_conv, name_bn, r, stride=1):
    return _bn(conv(x, params[name_conv + ".weight"], stride, r), params,
               name_bn)


def _bottleneck(x, params, p: str, stride: int, downsample: bool,
                r: Rounding):
    out = F.relu(_conv_bn(x, params, p + "conv1", p + "bn1", r))
    out = F.relu(_conv_bn(out, params, p + "conv2", p + "bn2", r))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = _conv_bn(out, params, p + "conv3", p + "bn3", r)
    identity = x
    if downsample:
        if stride > 1:
            identity = F.avg_pool2d(identity, stride)
        identity = _conv_bn(identity, params, p + "downsample.0",
                            p + "downsample.1", r)
    return F.relu(out + identity)


def _linear(x, params, name, r: Rounding):
    return r.mm(x, params[name + ".weight"].t()) + params[name + ".bias"]


def attention_pool(x: torch.Tensor, params: Dict[str, torch.Tensor],
                   heads: int, r: Rounding) -> torch.Tensor:
    """x [B, C, H, W] -> [B, embed]."""
    b, c, h, w = x.shape
    p = "visual.attnpool."
    tokens = x.flatten(2).transpose(1, 2)                     # [B, HW, C]
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + params[p + "positional_embedding"]
    s, d = h * w + 1, c // heads
    q = _linear(tokens[:, :1], params, p + "q_proj", r)
    k = _linear(tokens, params, p + "k_proj", r)
    v = _linear(tokens, params, p + "v_proj", r)
    q = q.view(b, 1, heads, d).transpose(1, 2)
    k = k.view(b, s, heads, d).transpose(1, 2)
    v = v.view(b, s, heads, d).transpose(1, 2)
    att = torch.softmax(r.mm(q * d ** -0.5, k.transpose(-1, -2)), dim=-1)
    out = r.mm(att, v).transpose(1, 2).reshape(b, c)
    return _linear(out, params, p + "c_proj", r)


def image_features(images: torch.Tensor, params: Dict[str, torch.Tensor],
                   cfg: dict, r: Optional[Rounding] = None) -> torch.Tensor:
    """Normalised images [B, H, W, 3] -> features [B, embed], not
    normalised, with train-mode BatchNorm; ``params`` holds the
    ``visual.*`` tensors (in the images' dtype), and the running
    statistics it holds are moved."""
    r = r or Rounding()
    v = cfg["vision_cfg"]
    heads = v["width"] * 32 // cfg["assumed"]["vision_head_width"]
    x = images.permute(0, 3, 1, 2).contiguous()
    for i, stride in ((1, 2), (2, 1), (3, 1)):
        x = F.relu(_conv_bn(x, params, f"visual.conv{i}", f"visual.bn{i}",
                            r, stride))
    x = F.avg_pool2d(x, 2)
    for stage, blocks in enumerate(v["layers"]):
        for i in range(blocks):
            x = _bottleneck(x, params, f"visual.layer{stage + 1}.{i}.",
                            2 if stage > 0 and i == 0 else 1, i == 0, r)
    return attention_pool(x, params, heads, r)


def trained(name: str) -> bool:
    """Whether a state-dict entry is one of the tower's trained leaves."""
    return name.startswith("visual.") and not name.endswith(BUFFERS)


@contextlib.contextmanager
def no_tf32():
    """Full fp32 products and convolutions, the flags restored on exit."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def follow(cfg: dict, traffic: dict, weights: Dict[str, torch.Tensor],
           head: torch.Tensor, canvases: Sequence[torch.Tensor],
           valid_hw: Sequence[np.ndarray], labels: Sequence[torch.Tensor],
           draws: np.random.Generator, total_iter: int,
           rounding: Rounding = Rounding()) -> BNReadings:
    """``train.follow`` on the ResNet tower: the reference's first
    ``len(canvases)`` steps from ``weights`` (the tower's parameters are
    trained, its running statistics moved by each forward) and ``head``,
    on the given rows, with the crops, flips and boxes drawn from
    ``draws``; ``total_iter`` is the schedule's length."""
    opt = traffic["optimizer"]
    size = cfg["vision_cfg"]["image_size"]
    warmup_lr = 1e-5 if opt["lr_backbone"] > 5e-5 else 1e-6
    params = {k: w.detach().clone().requires_grad_(True)
              for k, w in weights.items() if trained(k)}
    params["head"] = head.detach().clone().requires_grad_(True)
    params["logit_scale"] = torch.tensor(
        LOG_INV_TEMPERATURE, device=head.device).requires_grad_(True)
    running = {k: w.detach().clone() for k, w in weights.items()
               if k.startswith("visual.") and k.endswith(RUNNING)}
    start = {k: p.detach().clone() for k, p in params.items()}
    start_running = {k: s.clone() for k, s in running.items()}
    moments = {k: (torch.zeros_like(p), torch.zeros_like(p))
               for k, p in params.items()}
    losses, grad_norms = [], {}
    with no_tf32():
        for t, (cv, hw, lb) in enumerate(zip(canvases, valid_hw, labels)):
            boxes = draw_crops(draws, hw)
            flips = draws.random(len(hw)) < 0.5
            mix = draw_cutmix(draws, len(hw), size, traffic["cutmix_beta"],
                              traffic["mix_prob"])
            with torch.no_grad():
                images = transform(cv, boxes, flips, size)
                images, y_a, y_b, lam = cutmix(images, lb, mix)
            feats = normalized(image_features(images, {**params, **running},
                                              cfg, rounding))
            logits = feats @ params["head"].t() * params["logit_scale"].exp()
            loss = (lam * cross_entropy(logits, y_a).mean()
                    + (1.0 - lam) * cross_entropy(logits, y_b).mean())
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if t == 0:
                    grad_norms = norms(zip(params, grads))
                for (k, p), g in zip(params.items(), grads):
                    group = ("lr_classifier" if k in ("head", "logit_scale")
                             else "lr_backbone")
                    lr = learning_rate(t, opt[group], total_iter, warmup_lr)
                    adamw(p, g, *moments[k], t + 1, lr, opt["wd"])
    with torch.no_grad():
        change = norms((k, p - start[k]) for k, p in params.items())
    moved = {k: (s - start_running[k]).float().cpu()
             for k, s in running.items()}
    return BNReadings(losses, grad_norms, change, moved)
