"""CLIP towers in PyTorch with OpenCLIP's state-dict names.

The math is that of ``swat_tpu/models/functional.py`` (``_layer_norm``,
``_dense``, ``_block``, ``_transformer``, ``vit_encode_image``,
``text_encode``); the module tree is OpenCLIP's ``CLIP`` class, so a real
OpenCLIP ``.pt`` loads with ``load_state_dict`` (key map in
``swat_tpu/models/loader.py``).  Public functions keep the JAX package's
layouts: images ``[B, H, W, 3]`` NHWC, features ``[B, embed]`` fp32.

Attention.  On CUDA every attention goes through the hand-written kernels
(``kernels.flash_attention.mha_qkv``, an autograd Function over the qkv
projection's output: the forward kernel, and the backward kernel as its
gradient) in BOTH precision
policies, for inference and for training.  That departs from
``swat_tpu.models.functional._pick_pallas``, whose rule, measured on a TPU,
uses Pallas only for bf16 on a TPU, and in training only from S = 197 up
(``_PALLAS_TRAIN_MIN_SEQ``; below it, XLA autodiff): the CLI's default
``--compute_dtype float32`` would otherwise run no kernel at all on the
card, and the B/32 train step (S = 50) no backward kernel.  The kernels
compute fp32 in full fp32 (the "highest" precision of the JAX fp32 policy).
On the CPU the same Function runs the kernels' plain PyTorch twins.
``attention=`` swaps in another function of the same signature,
``(qkv, heads, causal) -> out`` (the smoke test passes the plain twin,
``mha_qkv_reference``, on the card).  ``encode_image_tokens``, the
heatmaps' forward, takes the heads-first route
(``kernels.attention.heads_first_attention``), the counterpart of the Flax
towers' ``use_pallas=True`` attention: the heads-first forward kernel on
the card, in both precision policies too.  Training differentiates the image
tower only: the train state turns ``requires_grad`` off for the text tower.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from swat_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from swat_tpu_torch.kernels.attention import heads_first_attention
from swat_tpu_torch.kernels.flash_attention import mha_qkv
from swat_tpu_torch.models.configs import (CLIPConfig, ResNetConfig,
                                           TextConfig, VisionConfig)

# (qkv [B, S, 3*H*D], heads, causal) -> out [B, S, H*D]
Attention = Callable[[torch.Tensor, int, bool], torch.Tensor]


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, precision: Precision,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm, one-pass (clamped) or exact two-pass variance,
    output in the compute dtype (functional._layer_norm)."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    if precision.ln_fast_variance:
        var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    else:
        d = x - mu
        var = (d * d).mean(dim=-1, keepdim=True)
    mul = torch.rsqrt(var + eps) * ln.weight.float()
    y = (x - mu) * mul + ln.bias.float()
    return y.to(precision.compute_dtype)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          precision: Precision) -> torch.Tensor:
    """x @ W^T (+ b) in the compute dtype; torch's [out, in] weight is the
    JAX kernel transposed (functional._dense)."""
    c = precision.compute_dtype
    y = torch.matmul(x.to(c), weight.to(c).t())
    return y + bias.to(c) if bias is not None else y


def project(x: torch.Tensor, proj: torch.Tensor,
            precision: Precision) -> torch.Tensor:
    """[B, width] x [width, embed] with compute-dtype operands and fp32
    accumulation -> fp32 features."""
    c = precision.compute_dtype
    return torch.matmul(x.to(c).float(), proj.to(c).float())


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MultiheadAttentionParams(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` under its names; the
    forward is ``ResidualAttentionBlock``'s."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class ResidualAttentionBlock(nn.Module):
    """One pre-LN transformer block (functional._block)."""

    def __init__(self, width: int, heads: int, quick: bool):
        super().__init__()
        self.heads = heads
        self.quick = quick
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadAttentionParams(width)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, 4 * width),
                                  "c_proj": nn.Linear(4 * width, width)})

    def forward(self, x: torch.Tensor, causal: bool, precision: Precision,
                attention: Attention) -> torch.Tensor:
        h = layer_norm(self.ln_1, x, precision)
        qkv = dense(h, self.attn.in_proj_weight, self.attn.in_proj_bias,
                    precision)
        # the kernels read q, k, v in place from qkv and write its gradient
        # whole
        a = attention(qkv, self.heads, causal)
        x = x + dense(a, self.attn.out_proj.weight, self.attn.out_proj.bias,
                      precision)
        h = layer_norm(self.ln_2, x, precision)
        h = dense(h, self.mlp["c_fc"].weight, self.mlp["c_fc"].bias,
                  precision)
        h = quick_gelu(h) if self.quick else F.gelu(h)
        return x + dense(h, self.mlp["c_proj"].weight,
                         self.mlp["c_proj"].bias, precision)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, quick: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, quick)
            for _ in range(layers))

    def forward(self, x, causal: bool, precision: Precision,
                attention: Attention):
        for block in self.resblocks:
            x = block(x, causal, precision, attention)
        return x


class VisionTower(nn.Module):
    """OpenCLIP ``VisionTransformer`` names; forward is
    functional.vit_encode_image."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        # held for its OpenCLIP name and layout only: the patch embedding
        # runs as reshape + matmul, never as a (cuDNN) convolution
        self.conv1 = nn.Conv2d(3, w, cfg.patch_size, cfg.patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.seq_len, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = Transformer(w, cfg.layers, cfg.heads,
                                       cfg.quick_gelu)
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, images: torch.Tensor, precision: Precision,
                attention: Attention, pool: bool = True) -> torch.Tensor:
        """images [B, H, W, 3] -> [B, embed]; ``pool=False`` applies
        ln_post and the projection to every token -> [B, S, embed], class
        token first (the heatmaps' input)."""
        p = self.cfg.patch_size
        b, h, w, c = images.shape
        gh, gw = h // p, w // p
        cd = precision.compute_dtype
        x = images.to(cd).reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c)
        # conv1 [width, 3, p, p] -> [(kh, kw, in), width], the NHWC unfold
        # order (loader.py's patch_kernel)
        kernel = self.conv1.weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)
        x = torch.matmul(x, kernel.to(cd))
        cls = self.class_embedding.to(cd).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(cd)
        x = layer_norm(self.ln_pre, x, precision)
        x = self.transformer(x, False, precision, attention)
        x = layer_norm(self.ln_post, x[:, 0] if pool else x, precision)
        return project(x, self.proj, precision)


class TextTower(nn.Module):
    """The text half of OpenCLIP's ``CLIP`` (its parameters live at the
    top level of that class); forward is functional.text_encode."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.text_cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.width))
        self.transformer = Transformer(cfg.width, cfg.layers, cfg.heads,
                                       cfg.quick_gelu)
        self.ln_final = nn.LayerNorm(cfg.width)
        self.text_projection = nn.Parameter(
            torch.empty(cfg.width, cfg.embed_dim))

    def encode_text_features(self, token_ids: torch.Tensor,
                             precision: Precision,
                             attention: Attention) -> torch.Tensor:
        cd = precision.compute_dtype
        x = self.token_embedding.weight[token_ids].to(cd)
        x = x + self.positional_embedding.to(cd)
        x = self.transformer(x, True, precision, attention)
        x = layer_norm(self.ln_final, x, precision)
        eot = token_ids.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return project(x, self.text_projection, precision)


def _normalize(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


class CLIPModel(TextTower):
    """OpenCLIP's ``CLIP`` module tree: the text tower at the top level,
    the image tower under ``visual``, and ``logit_scale``.  ``precision``
    is the compute policy of both encoders."""

    def __init__(self, cfg: CLIPConfig,
                 precision: Precision = DEFAULT_PRECISION):
        if isinstance(cfg.vision, ResNetConfig):
            raise NotImplementedError(
                f"{cfg.name}: the port has no ResNet image tower yet "
                "(ROADMAP Queue A item 7)")
        super().__init__(cfg.text)
        self.cfg = cfg
        self.precision = precision
        self.visual = VisionTower(cfg.vision)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     attention: Attention = mha_qkv) -> torch.Tensor:
        """images [B, H, W, 3] (CLIP-normalized) -> [B, embed] fp32."""
        feats = self.visual(images, self.precision, attention)
        return _normalize(feats) if normalize else feats

    def encode_image_tokens(
            self, images: torch.Tensor,
            attention: Attention = heads_first_attention) -> torch.Tensor:
        """All projected token embeddings [B, S, embed] fp32, class token
        first.  Its attention is the heads-first route by default, as the
        Flax tower that computes the heatmaps in ``swat_tpu`` runs under
        ``--use_pallas``: the heads-first forward kernel on the card, its
        plain twin on the CPU."""
        return self.visual(images, self.precision, attention, pool=False)

    def encode_text(self, token_ids: torch.Tensor, normalize: bool = False,
                    attention: Attention = mha_qkv) -> torch.Tensor:
        """token ids [B, context] -> [B, embed] fp32."""
        feats = self.encode_text_features(token_ids, self.precision,
                                          attention)
        return _normalize(feats) if normalize else feats

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "CLIPModel":
        """OpenCLIP's initialisation scheme, drawn from ``generator`` (for
        runs without a checkpoint: smoke tests, synthetic checkpoints)."""

        def normal(t, std):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

        def init_transformer(tr: Transformer, width: int):
            layers = len(tr.resblocks)
            attn_std = width ** -0.5
            proj_std = attn_std * (2 * layers) ** -0.5
            for blk in tr.resblocks:
                normal(blk.attn.in_proj_weight, attn_std)
                blk.attn.in_proj_bias.zero_()
                normal(blk.attn.out_proj.weight, proj_std)
                blk.attn.out_proj.bias.zero_()
                normal(blk.mlp["c_fc"].weight, (2 * width) ** -0.5)
                blk.mlp["c_fc"].bias.zero_()
                normal(blk.mlp["c_proj"].weight, proj_std)
                blk.mlp["c_proj"].bias.zero_()
                for ln in (blk.ln_1, blk.ln_2):
                    ln.weight.fill_(1.0)
                    ln.bias.zero_()

        vis, vw = self.visual, self.cfg.vision.width
        normal(vis.conv1.weight, (3 * self.cfg.vision.patch_size ** 2) ** -0.5)
        normal(vis.class_embedding, vw ** -0.5)
        normal(vis.positional_embedding, vw ** -0.5)
        normal(vis.proj, vw ** -0.5)
        init_transformer(vis.transformer, vw)
        tw = self.text_cfg.width
        normal(self.token_embedding.weight, 0.02)
        normal(self.positional_embedding, 0.01)
        normal(self.text_projection, tw ** -0.5)
        init_transformer(self.transformer, tw)
        for ln in (vis.ln_pre, vis.ln_post, self.ln_final):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        self.logit_scale.fill_(math.log(1 / 0.07))
        return self
