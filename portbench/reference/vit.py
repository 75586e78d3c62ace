"""OpenCLIP's ViT image tower in plain float32 PyTorch.

x = conv1(image) (a stride-p patch embedding, written as its per-patch
linear map), the class token prepended, positions added, ``ln_pre``; then
pre-LN blocks x += out_proj(MHA(ln_1(x))), x += c_proj(act(c_fc(ln_2(x))))
with ``nn.MultiheadAttention``'s packed in_proj (q, k, v in that order,
q scaled by head_dim**-0.5) and act QuickGELU (x * sigmoid(1.702 x)) or
exact GELU; ``ln_post`` of the class token, times ``proj``.  LayerNorm is
exact, eps 1e-5.  Every matrix product goes through ``Rounding.mm``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x through fp8 ``dtype`` under one per-tensor scale (its absolute
    maximum onto the type's largest value), back in fp32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class Rounding:
    """The precision of the tower's products: 'fp32' (none), 'tf32' or
    'fp8'."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown rounding {mode!r}")
        self.mode = mode

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32":
            return _tf32(x)
        if self.mode == "fp8":
            return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)
        return x

    def bwd(self, g: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32":
            return _tf32(g)
        if self.mode == "fp8":
            return _fp8(g, torch.float8_e5m2, E5M2_MAX)
        return g

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b (b 2-D or batched like a), operands of the forward and of
        both backward products rounded."""
        if self.mode == "fp32":
            return torch.matmul(a, b)
        return _RoundedMatmul.apply(a, b, self)


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rounding):
        ra, rb = rounding.fwd(a), rounding.fwd(b)
        ctx.save_for_backward(ra, rb)
        ctx.rounding = rounding
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        g = ctx.rounding.bwd(g)
        da = torch.matmul(g, rb.transpose(-1, -2))
        if rb.dim() == 2 and ra.dim() > 2:
            db = (ra.reshape(-1, ra.shape[-1]).t()
                  @ g.reshape(-1, g.shape[-1]))
        else:
            db = torch.matmul(ra.transpose(-1, -2), g)
        return da, db, None


def _linear(x, w, b, r: Rounding):
    y = r.mm(x, w.t())
    return y if b is None else y + b


def _ln(x, params, name):
    return F.layer_norm(x, x.shape[-1:], params[name + ".weight"],
                        params[name + ".bias"], eps=1e-5)


def block(x: torch.Tensor, params: Dict[str, torch.Tensor], p: str,
          heads: int, quick_gelu: bool, r: Rounding) -> torch.Tensor:
    b, s, w = x.shape
    d = w // heads
    h = _ln(x, params, p + "ln_1")
    qkv = _linear(h, params[p + "attn.in_proj_weight"],
                  params[p + "attn.in_proj_bias"], r)
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    att = torch.softmax(r.mm(q * d ** -0.5, k.transpose(-1, -2)), dim=-1)
    o = r.mm(att, v).transpose(1, 2).reshape(b, s, w)
    x = x + _linear(o, params[p + "attn.out_proj.weight"],
                    params[p + "attn.out_proj.bias"], r)
    h = _ln(x, params, p + "ln_2")
    h = _linear(h, params[p + "mlp.c_fc.weight"], params[p + "mlp.c_fc.bias"],
                r)
    h = h * torch.sigmoid(1.702 * h) if quick_gelu else F.gelu(h)
    return x + _linear(h, params[p + "mlp.c_proj.weight"],
                       params[p + "mlp.c_proj.bias"], r)


def image_features(images: torch.Tensor, params: Dict[str, torch.Tensor],
                   cfg: dict, r: Optional[Rounding] = None) -> torch.Tensor:
    """Normalised images [B, H, W, 3] (fp32) -> features [B, embed], not
    normalised; ``params`` holds the ``visual.*`` tensors."""
    r = r or Rounding()
    v = cfg["vision_cfg"]
    p, w = v["patch_size"], v["width"]
    heads = w // cfg["assumed"]["vision_head_width"]
    b, hh, ww, c = images.shape
    gh, gw = hh // p, ww // p
    # conv1 with kernel = stride = p: each patch's pixels times the kernel
    patches = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
    patches = patches.reshape(b, gh * gw, c * p * p)
    kernel = params["visual.conv1.weight"].reshape(w, c * p * p)
    x = r.mm(patches, kernel.t())
    cls = params["visual.class_embedding"].expand(b, 1, w)
    x = torch.cat([cls, x], dim=1) + params["visual.positional_embedding"]
    x = _ln(x, params, "visual.ln_pre")
    for i in range(v["layers"]):
        x = block(x, params, f"visual.transformer.resblocks.{i}.", heads,
                  cfg["quick_gelu"], r)
    x = _ln(x[:, 0], params, "visual.ln_post")
    return r.mm(x, params["visual.proj"])


def normalized(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample CE of fp32 logits."""
    return torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, labels[:, None])[:, 0]


LOG_INV_TEMPERATURE = math.log(1 / 0.07)
