"""OpenAI's modified ResNet image tower (CLIP RN50) in PyTorch, the
counterpart of ``swat_tpu/models/resnet.py``.

The module tree carries OpenCLIP's ``ModifiedResNet`` state-dict names
(``visual.conv1..3``, ``visual.bn1..3``, ``visual.layer{s}.{i}.conv{j}`` /
``.bn{j}`` / ``.downsample.0`` / ``.downsample.1``, ``visual.attnpool.*``),
so an OpenCLIP RN50 ``.pt`` loads with ``load_state_dict``; its
``num_batches_tracked`` entries are dropped on load (``swat_tpu`` keeps no
such leaf, and an integer tensor would not mix in WiSE-FT).  The math is
``swat_tpu``'s, rounding point for rounding point:

* ``AffineBN``: BatchNorm with torch semantics (momentum 0.1, eps 1e-5),
  the running statistics as buffers (so no optimizer group holds them: no
  gradient, no weight decay, the port's form of the ``frozen`` label).
  Eval normalizes with the running statistics, train with the batch's
  (mean and biased variance of the fp32 activations over N, H, W, with
  gradients through them) and reports the batch mean and unbiased
  variance, detached; ``fold_bn_updates`` moves the running statistics
  toward them by the momentum, which a train step does after its
  optimizer update.  Either way the affine is computed in fp32 and
  rounded once to the compute dtype, ``x * a + b``; ``F.batch_norm``
  would round at other points in bf16.  ``relu=True`` applies the ReLU
  that follows 35 of the 55 (the stem's three, each bottleneck's bn1 and
  bn2).  Train mode on a CUDA tensor outside a data-parallel mesh runs
  the hand-written kernels of ``kernels/batch_norm.py`` (the same
  function, the ReLU fused, no fp32 copy of the activation saved); the
  CPU, eval mode and the sharded mesh (whose sums are all-reduced between
  the statistics and the affine) keep the plain passes.
* convolutions without bias, padding k // 2 on both sides, the stem's
  first at stride 2; a stride-2 bottleneck average-pools before ``conv3``
  and before its downsampling convolution (anti-aliased stride).  They run
  as ``F.conv2d`` (cuDNN on the card, TF32 off by
  ``Precision.apply_backend_flags``), as ``swat_tpu`` runs them as XLA
  convolutions: no hand-written kernel stands behind them.  Images come in
  ``[B, H, W, 3]`` as for the ViTs; the convolutions see them through a
  channels-last view, no copy.
* ``AttentionPool2d``: the mean token prepended, the positional embedding
  added in the compute dtype, q from the mean token only, k and v from all
  tokens, fp32 scores and softmax, the probabilities rounded to the
  compute dtype, ``c_proj``.  One query row against 50 keys is plain
  ``torch.matmul`` and ``softmax``, as ``swat_tpu`` computes it in XLA
  outside any Pallas kernel.  ``pool=False`` returns ``c_proj(v_proj(t))``
  of every token (the heatmaps' surface).

Tracing (``utils/profiling.py``, nothing while no profiler records): a
train-mode ``AffineBN`` (its ReLU included) runs in a ``resnet.bn`` span
and its backward in a ``resnet.bn_backward`` one, the attention pool in
``resnet.attnpool``; ``BN_BATCH_STATS`` counts the train-mode ``AffineBN``
calls.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from swat_tpu_torch.core.precision import Precision
from swat_tpu_torch.kernels import batch_norm as BN
from swat_tpu_torch.models.configs import ResNetConfig
from swat_tpu_torch.utils.profiling import backward_span, span

# train-mode AffineBN calls (batch statistics) since the process started:
# 55 an RN50 train forward (3 in the stem, 3 a bottleneck, 4 downsamples),
# none in eval
BN_BATCH_STATS = 0


class BNUpdates(dict):
    """AffineBN module -> (batch mean, unbiased batch variance), filled by
    a train-mode forward.  ``mesh``: the data-parallel mesh whose global
    batch the statistics cover (each rank holds its rows of it; the sums
    are all-reduced over the data group), or None for a batch on one
    device."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh

# images of the batch-statistics pass that sets a random tower's running
# statistics (``ModifiedResNet.init_random``)
CALIBRATION_IMAGES = 4


def _dense(x: torch.Tensor, lin: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    return torch.matmul(x.to(cd), lin.weight.to(cd).t()) + lin.bias.to(cd)


class AffineBN(nn.Module):
    """BatchNorm2d's parameters and running statistics under its names;
    the forward is ``swat_tpu``'s ``AffineBN``, whose defaults the two
    constants are."""

    MOMENTUM = 0.1
    EPS = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, precision: Precision,
                updates: Optional[BNUpdates] = None,
                relu: bool = False) -> torch.Tensor:
        """x [B, C, H, W] in the compute dtype -> the normalized x, then
        max(., 0) where ``relu``; ``updates`` None: eval mode, else train
        mode, this module's batch statistics added (a ``resnet.bn`` span,
        its backward a ``resnet.bn_backward`` one, and one more
        ``BN_BATCH_STATS``)."""
        if updates is None:
            y = self._normalize(x, self.running_mean, self.running_var,
                                precision)
            return F.relu(y) if relu else y
        global BN_BATCH_STATS
        BN_BATCH_STATS += 1
        mesh = getattr(updates, "mesh", None)
        with span("resnet.bn"):
            if x.is_cuda and (mesh is None or mesh.data == 1):
                y, mean, var = BN.batch_norm(x, self.weight, self.bias,
                                             self.EPS, relu)
                updates[self] = (mean, var)
            else:
                y = self._normalize(x, *self._batch_stats(x, updates),
                                    precision)
                if relu:
                    y = F.relu(y)
        backward_span("resnet.bn_backward", y, x)
        return y

    def _batch_stats(self, x: torch.Tensor, updates: BNUpdates):
        """-> the batch mean and biased variance of fp32 ``x`` over N, H,
        W, with gradients through them; the mean and the unbiased variance
        go to ``updates``, detached."""
        mesh = getattr(updates, "mesh", None)
        if mesh is not None and mesh.data > 1:
            # the global batch's statistics, as swat_tpu's AffineBN takes
            # them over the sharded batch: mean = sum / n, then the biased
            # variance from the centred squares, each sum all-reduced
            x32 = x.float()
            n = x.numel() // x.shape[1] * mesh.data
            mean = mesh.reduce_sum(x32.sum(dim=(0, 2, 3))) / n
            d = x32 - mean.view(1, -1, 1, 1)
            var = mesh.reduce_sum((d * d).sum(dim=(0, 2, 3))) / n
        else:
            mean, var = BN.batch_stats(x)
            n = x.numel() // x.shape[1]
        updates[self] = (mean.detach(), (var * (n / max(n - 1, 1))).detach())
        return mean, var

    def _normalize(self, x: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor, precision: Precision) -> torch.Tensor:
        """The affine of the statistics in fp32, rounded once to the
        compute dtype, applied as ``x * a + b`` (the kernels' twin's)."""
        return BN.affine(x, mean, var, self.weight, self.bias, self.EPS,
                         precision.compute_dtype)[0]


def _conv(conv: nn.Conv2d, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    k = conv.kernel_size[0]
    return F.conv2d(x, conv.weight.to(cd), stride=conv.stride,
                    padding=k // 2)


def _conv_bn(conv, bn, x, precision, updates, relu=False):
    return bn(_conv(conv, x, precision.compute_dtype), precision, updates,
              relu)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = AffineBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = AffineBN(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = AffineBN(out)
        self.downsample = (nn.ModuleDict({
            "0": nn.Conv2d(inplanes, out, 1, bias=False),
            "1": AffineBN(out)}) if downsample else None)

    def forward(self, x, precision: Precision,
                updates: Optional[BNUpdates] = None):
        h = _conv_bn(self.conv1, self.bn1, x, precision, updates, True)
        h = _conv_bn(self.conv2, self.bn2, h, precision, updates, True)
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = _conv_bn(self.conv3, self.bn3, h, precision, updates)
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = _conv_bn(self.downsample["0"], self.downsample["1"],
                                identity, precision, updates)
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, heads: int,
                 output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor, precision: Precision,
                pool: bool = True) -> torch.Tensor:
        """x [B, C, H, W] -> [B, output_dim] fp32, or with ``pool=False``
        every token's value embedding projected, [B, H*W + 1, output_dim]
        (the mean token first)."""
        cd = precision.compute_dtype
        b, c, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(cd)
        v = _dense(tokens, self.v_proj, cd)
        if not pool:
            return _dense(v, self.c_proj, cd).float()
        s, hd = h * w + 1, c // self.heads
        q = _dense(tokens[:, :1], self.q_proj, cd).view(b, 1, self.heads, hd)
        k = _dense(tokens, self.k_proj, cd).view(b, s, self.heads, hd)
        v = v.view(b, s, self.heads, hd)
        scale = 1.0 / hd ** 0.5
        scores = torch.matmul(q.transpose(1, 2).float(),
                              k.permute(0, 2, 3, 1).float()) * scale
        p = torch.softmax(scores, dim=-1).to(cd)
        out = torch.matmul(p.float(), v.transpose(1, 2).float())
        out = out.reshape(b, c).to(cd)
        return _dense(out, self.c_proj, cd).float()


class ModifiedResNet(nn.Module):
    """OpenCLIP ``ModifiedResNet`` names; the forward is
    ``swat_tpu.models.resnet.ModifiedResNet``'s."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = AffineBN(w // 2)
        self.conv2 = nn.Conv2d(w // 2, w // 2, 3, padding=1, bias=False)
        self.bn2 = AffineBN(w // 2)
        self.conv3 = nn.Conv2d(w // 2, w, 3, padding=1, bias=False)
        self.bn3 = AffineBN(w)
        inplanes, planes = w, w
        for stage, blocks in enumerate(cfg.layers):
            stride = 1 if stage == 0 else 2
            layer = [Bottleneck(inplanes, planes, stride, downsample=True)]
            inplanes = planes * Bottleneck.expansion
            layer += [Bottleneck(inplanes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
            planes *= 2
        self.attnpool = AttentionPool2d(cfg.image_size // 32, w * 32,
                                        cfg.heads, cfg.embed_dim)

    def forward(self, images: torch.Tensor, precision: Precision,
                attention=None, pool: bool = True, use_mega: bool = False,
                remat=False,
                updates: Optional[BNUpdates] = None) -> torch.Tensor:
        """images [B, H, W, 3] -> [B, embed] fp32 (``pool=False``: the
        attnpool's tokens); ``updates`` None: eval-mode BatchNorm, else
        train mode, every AffineBN's batch statistics added.  The call is
        ``VisionTower``'s: ``attention``, ``use_mega`` and ``remat`` name
        transformer-block routes this tower has none of, and are ignored
        (``swat_tpu``'s ModifiedResNet ignores remat too)."""
        cd = precision.compute_dtype
        x = images.to(cd).permute(0, 3, 1, 2)        # channels-last view
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = _conv_bn(conv, bn, x, precision, updates, True)
        x = F.avg_pool2d(x, 2)
        for stage in range(len(self.cfg.layers)):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x, precision, updates)
        with span("resnet.attnpool"):
            return self.attnpool(x, precision, pool)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Random weights that train and evaluate sensibly: He-normal
        convolutions, OpenCLIP's attnpool init (normal q/k/v/c_proj at
        std width**-0.5, the default Linear biases, a normal positional
        embedding), BatchNorm affines 1 / 0 but for every ``bn3``, whose
        weight OpenCLIP zeroes and which is drawn N(0, 0.1) here, so that
        the first step's gradients reach every ``conv1`` / ``conv2``.  Then
        the running statistics are set from one batch-statistics pass of
        fp32 over ``CALIBRATION_IMAGES`` standard-normal images (each BN's
        batch mean and unbiased variance, folded at momentum 1), so that
        eval-mode activations keep their scale through the 16
        bottlenecks."""
        from swat_tpu_torch.core.precision import FP32_PRECISION

        def draw(t, std):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

        for name, mod in self.named_modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                draw(mod.weight, (2.0 / fan_in) ** 0.5)
            elif isinstance(mod, AffineBN):
                if name.endswith("bn3") and name != "bn3":
                    draw(mod.weight, 0.1)
                else:
                    mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        ap = self.attnpool
        c = ap.c_proj.in_features
        draw(ap.positional_embedding, c ** -0.5)
        for lin in (ap.q_proj, ap.k_proj, ap.v_proj, ap.c_proj):
            draw(lin.weight, c ** -0.5)
            bound = lin.in_features ** -0.5
            lin.bias.copy_((torch.rand(lin.bias.shape, generator=generator)
                            * 2 - 1) * bound)
        n_px = self.cfg.image_size
        images = torch.randn((CALIBRATION_IMAGES, n_px, n_px, 3),
                             generator=generator).to(ap.c_proj.weight.device)
        updates: BNUpdates = {}
        self(images, FP32_PRECISION, updates=updates)
        fold_bn_updates(updates, momentum=1.0)


def fold_bn_updates(updates: BNUpdates,
                    momentum: float = AffineBN.MOMENTUM) -> None:
    """Moves each module's running statistics toward a train-mode
    forward's batch statistics, ``(1 - m) * running + m * batch``
    (``swat_tpu``'s sown values, written by ``apply_bn_updates`` /
    ``_fold_bn``)."""
    with torch.no_grad():
        for bn, (mean, var) in updates.items():
            bn.running_mean.copy_((1 - momentum) * bn.running_mean
                                  + momentum * mean)
            bn.running_var.copy_((1 - momentum) * bn.running_var
                                 + momentum * var)
