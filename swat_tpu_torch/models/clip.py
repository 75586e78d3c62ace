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
card, and the B/32 train step (S = 50) no backward kernel.  On an H100
(NVIDIA H100 80GB HBM3, 700 W; ``chip_smoke.py``) the rule pays at S = 50
too: a layer's backward (B = 256, H = 12, D = 64) takes 0.2811 ms fp32 /
0.0817 ms bf16 in the kernel against 1.0126 / 1.2910 ms for the plain
attention that autograd would differentiate, its forward 0.1099 / 0.0337
against 0.4583 / 0.6284, and the cutmix step at bsz 256 200.28 / 61.44 ms
against 212.44 / 77.32 with plain attention in both directions.  The kernels
compute fp32 in full fp32 (the "highest" precision of the JAX fp32 policy).
On the CPU the same Function runs the kernels' plain PyTorch twins.
``attention=`` swaps in another function of the same signature,
``(qkv, heads, causal) -> out`` (the smoke test passes the plain twin,
``mha_qkv_reference``, on the card).  ``encode_image_tokens``, the
heatmaps' forward, takes the heads-first route
(``kernels.attention.heads_first_attention``), the counterpart of the Flax
towers' ``use_pallas=True`` attention: the heads-first forward kernel on
the card, in both precision policies too.  Training differentiates what the
train state leaves ``requires_grad`` on: the image tower, and for FLYP the
text tower too (its causal attention's gradient is the backward kernel's).

LayerNorm.  On CUDA every ``layer_norm`` (``ln_pre``, the blocks',
``ln_post``, ``ln_final``) goes through the hand-written kernel pair
(``kernels.layer_norm``, one autograd Function: the forward kernel, and the
backward kernel as its gradient, the scale and bias read in fp32); where no
input needs a gradient the forward kernel runs alone and saves nothing.  A
CPU tensor runs the plain formula of ``functional._layer_norm``.

Remat (``CLIPModel(remat=...)``, ``--remat``; ``resolve_remat_policy``)
recomputes blocks in the backward through ``torch.utils.checkpoint``
(non-reentrant): every block, the first K, or every block keeping the
products' outputs (``dots``, ``dots_all``; a selective checkpoint).  It acts
only where a graph is built; the blocks draw no random numbers, so the
recompute needs no RNG state.

``use_mega=True`` on ``encode_image`` / ``encode_text`` runs the block stack
through the block-fused layer kernels instead
(``kernels.megablock.fused_transformer``: one forward kernel a layer, two
backward kernels as its gradient, only x and x2 saved), as
``functional._transformer(use_mega=True)`` does; ``attention`` is then not
used.  ``encode_image_tokens`` has no such route, as there.

W8A8 int8 inference (``models/quant.py``).  ``CLIPModel.int8_`` swaps
every dense weight of both ViT towers (the blocks' four products, the
patch embedding and both projections) for int8 codes ``[out, in]`` and
fp32 per-output-channel scales ``[out]``, held as buffers (``<name>_q``,
``<name>_scale``), never as parameters; ``dense``, ``project`` and the
patch embedding then run ``qdot``, the counterpart of
``functional._qdot``: per-row dynamic activation codes, an int8 x int8 ->
int32 product, and the fp32 dequantization.  The int32 product is
``torch._int_mm`` (cuBLASLt's int8 product on the card), as ``swat_tpu``
computes it in XLA outside any Pallas kernel; ``int8_matmul`` zero-pads
its operands to that product's CUDA shape rules.  The attention stays the
kernels'.  ``use_mega`` has no int8 path and raises, as in ``swat_tpu``.

A ``ResNetConfig`` (the RN50 names) builds OpenAI's modified ResNet image
tower instead (``models/resnet.py``): convolutions, BatchNorm and an
attention pool in plain PyTorch, as ``swat_tpu`` runs them in XLA; remat,
``use_mega`` and ``attention`` do not apply to it (the text tower still
runs through the kernels); it takes the ViT tower's call and ignores
those three.  ``encode_image(..., updates={})`` normalizes with batch
statistics and fills ``updates`` with them (``swat_tpu``'s
``encode_image_bn_train``); every other encode uses the running
statistics.  A ViT tower holds no normalization state and leaves
``updates`` empty.

Tensor parallelism (``swat_tpu``'s ``param_partition_spec`` /
``partition_specs``, ``swat_tpu/models/clip.py:413-458``; a library
feature there, as here: the CLI does not shard the towers).
``tp_shard_state_dict`` cuts a state dict into one rank's shard of a model
group of ``size`` ranks and ``tp_join_state_dicts`` is its inverse:

* ``attn.in_proj`` rows split by heads within each of q, k and v, so a
  rank's packed qkv is ``[B, S, 3 * (H / tp) * D]`` and goes straight into
  the attention kernels with ``H / tp`` heads (``swat_tpu`` cuts the
  ``[W, 3W]`` kernel into contiguous column blocks and GSPMD relays them
  out: the math agrees, the layout does not);
* ``mlp.c_fc`` split by output rows;
* ``attn.out_proj`` and ``mlp.c_proj`` split by input columns, their bias
  added once, after the sum;
* ``token_embedding`` split by vocabulary rows: each rank looks up its rows
  with the others masked, then the sum;
* everything else whole on every rank (RN50's image tower among it).

``CLIPModel.tensor_parallel_(tp)`` gives a model the shard's shapes; its
blocks then run ``parallel_block``: ``tp.enter`` (identity forward,
all-reduce backward) before each column-parallel product and ``tp.leave``
(all-reduce forward, identity backward) after each row-parallel one, the
collective being ``TensorParallel``'s ``all_reduce`` argument, so
``lockstep_transformer`` runs every shard of a stack in one process with a
plain sum in its place.  ``use_mega`` under tensor parallelism gathers each
block's whole weights and runs the fused kernels on every rank, as GSPMD
runs ``swat_tpu``'s Pallas block (a custom call it cannot partition) with
the weights gathered.
"""

from __future__ import annotations

import functools
import math
import types
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from swat_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from swat_tpu_torch.kernels.attention import heads_first_attention
from swat_tpu_torch.kernels.flash_attention import mha_qkv
from swat_tpu_torch.kernels.layer_norm import layer_norm as fused_layer_norm
from swat_tpu_torch.kernels.megablock import fused_transformer
from swat_tpu_torch.models.configs import (CLIPConfig, ResNetConfig,
                                           TextConfig, VisionConfig)
from swat_tpu_torch.models.resnet import ModifiedResNet

# (qkv [B, S, 3*H*D], heads, causal) -> out [B, S, H*D]
Attention = Callable[[torch.Tensor, int, bool], torch.Tensor]


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, precision: Precision,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm, one-pass (clamped) or exact two-pass variance,
    output in the compute dtype (functional._layer_norm).  A CUDA tensor
    takes the hand-written kernel pair (``kernels.layer_norm``: the same
    formula in one forward and one backward kernel, the scale and bias read
    in fp32); any other runs the formula below."""
    if x.device.type == "cuda":
        return fused_layer_norm(x, ln.weight.float(), ln.bias.float(),
                                precision.ln_fast_variance, eps,
                                precision.compute_dtype)
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


class Int8Weight(NamedTuple):
    """A dense weight after ``CLIPModel.int8_``: int8 codes [out, in] and
    fp32 scales [out], weight ~= codes * scale[:, None]."""
    codes: torch.Tensor
    scale: torch.Tensor


def weight_of(module: nn.Module, name: str):
    """``module``'s weight ``name``: the float parameter, or its
    ``Int8Weight`` where ``CLIPModel.int8_`` put codes and scales."""
    codes = getattr(module, f"{name}_q", None)
    if codes is None:
        return getattr(module, name)
    return Int8Weight(codes, getattr(module, f"{name}_scale"))


def int8_matmul(a: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 times codes [N, K] int8, transposed -> [M, N] int32,
    through ``torch._int_mm``.  Its CUDA shape rules (M > 16, K and N
    multiples of 8, the second operand column-major) are met by zero
    padding, which adds nothing to any int32 sum; the product is never
    taken in floating point (its sums pass fp32's 2^24 exact integers)."""
    m, k = a.shape
    n = codes.shape[0]
    if not (m and k and n) or codes.shape[1] != k:
        raise ValueError(f"int8 product of {tuple(a.shape)} and "
                         f"{tuple(codes.shape)}^T cannot be padded")
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        codes = F.pad(codes, (0, pad_k, 0, pad_n))
    y = torch._int_mm(a.contiguous(), codes.contiguous().t())
    return y[:m, :n] if pad_m or pad_n else y


def qdot(x: torch.Tensor, w: Int8Weight, precision: Precision,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The W8A8 product (functional._qdot): per-row activation scale
    s = max(absmax(x), 1e-8) / 127 and codes clip(round(x / s), -127, 127)
    (round half to even), the int8 x int8 -> int32 product, then
    y * (s * scale) in fp32, cast to ``out_dtype`` or the compute dtype."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    # divided by a tensor: on CUDA, PyTorch turns a division by a Python
    # number into a product by its fp32 reciprocal, which rounds some rows'
    # scale otherwise than the true division of swat_tpu (and of the CPU)
    s = amax / amax.new_full((), 127.0)
    xq = torch.round(xf / s).clamp(-127, 127).to(torch.int8)
    y = int8_matmul(xq.reshape(-1, xq.shape[-1]), w.codes)
    y = y.reshape(*x.shape[:-1], -1).float() * (s * w.scale.float())
    return y.to(out_dtype or precision.compute_dtype)


def dense(x: torch.Tensor, weight, bias: Optional[torch.Tensor],
          precision: Precision) -> torch.Tensor:
    """x @ W^T (+ b) in the compute dtype; torch's [out, in] weight is the
    JAX kernel transposed (functional._dense).  An ``Int8Weight`` takes
    the W8A8 product."""
    c = precision.compute_dtype
    if isinstance(weight, Int8Weight):
        y = qdot(x, weight, precision)
    else:
        y = torch.matmul(x.to(c), weight.to(c).t())
    return y + bias.to(c) if bias is not None else y


def project(x: torch.Tensor, proj, precision: Precision) -> torch.Tensor:
    """[B, width] x [width, embed] with compute-dtype operands and fp32
    accumulation -> fp32 features; an ``Int8Weight`` (codes [embed,
    width]) takes the W8A8 product with an fp32 result."""
    if isinstance(proj, Int8Weight):
        return qdot(x, proj, precision, out_dtype=torch.float32)
    c = precision.compute_dtype
    return torch.matmul(x.to(c).float(), proj.to(c).float())


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


Remat = Union[bool, str]
# the aten products whose outputs the selective policies keep: ``dense``
# dispatches its 2-D products as mm (addmm with a fused bias), the
# attention's plain versions their batched ones as bmm / baddbmm
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def resolve_remat_policy(remat: Remat):
    """The remat flag -> (enabled, ops whose outputs are kept or None,
    first_k or None), as ``swat_tpu.models.clip.resolve_remat_policy``:

    False          no remat
    True / 'full'  every block recomputed whole in the backward
    'dots'         every block, keeping the outputs of the projections'
                   2-D products (the counterpart of
                   dots_with_no_batch_dims_saveable)
    'dots_all'     the same, keeping the batched products' too
                   (dots_saveable)
    'first<K>'     the first K blocks recomputed whole, the rest not.

    The attention kernels' output is no product here (an empty tensor and
    a launch), so every policy launches the forward kernel again."""
    if not remat:
        return False, None, None
    if remat is True or remat == "full":
        return True, None, None
    if isinstance(remat, str) and remat.startswith("first"):
        suffix = remat[len("first"):]
        if not suffix.isdigit() or int(suffix) <= 0:
            raise ValueError(
                f"remat 'first<K>' needs a positive block count; "
                f"got {remat!r}")
        return True, None, int(suffix)
    policies = {"dots": _DOTS, "dots_all": _DOTS + _BATCHED_DOTS}
    if remat not in policies:
        raise ValueError(
            f"remat must be bool, 'full', 'dots', 'dots_all' or "
            f"'first<K>'; got {remat!r}")
    return True, policies[remat], None


class MultiheadAttentionParams(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` under its names; the
    forward is ``ResidualAttentionBlock``'s."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a
    column-parallel product."""

    @staticmethod
    def forward(ctx, x, all_reduce):
        ctx.all_reduce = all_reduce
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.all_reduce(grad.contiguous().clone()), None


class _Leave(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a row-parallel
    product."""

    @staticmethod
    def forward(ctx, x, all_reduce):
        return all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Unshard(torch.autograd.Function):
    """The whole tensor from every rank's shard (``tp_join``); the gradient
    is this rank's shard of it (every rank computes the same whole
    gradient)."""

    @staticmethod
    def forward(ctx, shard, tp, kind, heads):
        ctx.tp, ctx.kind, ctx.heads = tp, kind, heads
        return tp_join(kind, tp.all_gather(shard), heads)

    @staticmethod
    def backward(ctx, grad):
        return (tp_split(ctx.kind, grad, ctx.tp.size, ctx.tp.rank,
                         ctx.heads), None, None, None)


class TensorParallel:
    """A model group of ``size`` ranks, this rank's place in it, and its
    collectives: ``all_reduce(t) -> the sum of every rank's t`` (out of
    place), and ``all_gather(t) -> [every rank's t]`` (``use_mega`` only).
    Passed as functions, so that a group of shards in one process can stand
    in for the ranks."""

    def __init__(self, size: int, rank: int,
                 all_reduce: Callable[[torch.Tensor], torch.Tensor],
                 all_gather: Optional[Callable] = None):
        self.size, self.rank = size, rank
        self.all_reduce = all_reduce
        self.all_gather = all_gather

    @classmethod
    def of(cls, mesh) -> "TensorParallel":
        """The model group of a ``core.mesh.Mesh``."""
        import torch.distributed as dist

        group = mesh.model_group

        def all_reduce(t):
            dist.all_reduce(t, group=group)
            return t

        def all_gather(t):
            parts = [torch.empty_like(t) for _ in range(mesh.model)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return parts

        return cls(mesh.model, mesh.model_rank, all_reduce, all_gather)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.all_reduce)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return _Leave.apply(x, self.all_reduce)


def parallel_block(blocks: Sequence["ResidualAttentionBlock"],
                   x: torch.Tensor, causal: bool, precision: Precision,
                   attention: Attention,
                   enter: Callable[[torch.Tensor], torch.Tensor],
                   reduce: Callable[[List[torch.Tensor]], torch.Tensor]
                   ) -> torch.Tensor:
    """One block over the shards ``blocks`` of a model group: the layer
    norms of the first (they are whole on every shard), each shard's
    column-parallel then row-parallel product, ``reduce`` of the partial
    outputs, the bias once.  On a rank of a group: ``blocks`` its own
    shard, ``enter`` / ``reduce`` the conjugate collectives; in one
    process: every shard, the identity and ``sum``."""
    b0 = blocks[0]
    cd = precision.compute_dtype
    h = enter(layer_norm(b0.ln_1, x, precision))
    out = reduce([b.attn_partial(h, causal, precision, attention)
                  for b in blocks])
    x = x + (out + b0.attn.out_proj.bias.to(cd))
    h = enter(layer_norm(b0.ln_2, x, precision))
    out = reduce([b.mlp_partial(h, precision) for b in blocks])
    return x + (out + b0.mlp["c_proj"].bias.to(cd))


def lockstep_transformer(stacks: Sequence["Transformer"], x: torch.Tensor,
                         causal: bool, precision: Precision,
                         attention: Attention) -> torch.Tensor:
    """Every shard of a tensor-parallel block stack in one process, layer
    by layer, the partial outputs summed where the all-reduce would stand
    (the card's check of the sharded shapes)."""
    for layer in range(len(stacks[0].resblocks)):
        x = parallel_block([st.resblocks[layer] for st in stacks], x,
                           causal, precision, attention, lambda t: t, sum)
    return x


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

    def attn_partial(self, h: torch.Tensor, causal: bool,
                     precision: Precision,
                     attention: Attention) -> torch.Tensor:
        """The attention half's product over this block's heads, without
        the out-projection's bias."""
        qkv = dense(h, weight_of(self.attn, "in_proj_weight"),
                    self.attn.in_proj_bias, precision)
        a = attention(qkv, self.heads, causal)
        return dense(a, weight_of(self.attn.out_proj, "weight"), None,
                     precision)

    def mlp_partial(self, h: torch.Tensor,
                    precision: Precision) -> torch.Tensor:
        """The MLP half over this block's hidden rows, without the
        projection's bias."""
        h = dense(h, weight_of(self.mlp["c_fc"], "weight"),
                  self.mlp["c_fc"].bias, precision)
        h = quick_gelu(h) if self.quick else F.gelu(h)
        return dense(h, weight_of(self.mlp["c_proj"], "weight"), None,
                     precision)

    def forward(self, x: torch.Tensor, causal: bool, precision: Precision,
                attention: Attention,
                tp: Optional[TensorParallel] = None) -> torch.Tensor:
        if tp is not None:
            return parallel_block([self], x, causal, precision, attention,
                                  tp.enter, lambda ps: tp.leave(ps[0]))
        h = layer_norm(self.ln_1, x, precision)
        qkv = dense(h, weight_of(self.attn, "in_proj_weight"),
                    self.attn.in_proj_bias, precision)
        # the kernels read q, k, v in place from qkv and write its gradient
        # whole
        a = attention(qkv, self.heads, causal)
        x = x + dense(a, weight_of(self.attn.out_proj, "weight"),
                      self.attn.out_proj.bias, precision)
        h = layer_norm(self.ln_2, x, precision)
        h = dense(h, weight_of(self.mlp["c_fc"], "weight"),
                  self.mlp["c_fc"].bias, precision)
        h = quick_gelu(h) if self.quick else F.gelu(h)
        return x + dense(h, weight_of(self.mlp["c_proj"], "weight"),
                         self.mlp["c_proj"].bias, precision)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, quick: bool):
        super().__init__()
        self.heads = heads
        self.quick = quick
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, quick)
            for _ in range(layers))
        # the model group of a tensor-parallel shard (tensor_parallel_)
        self.tp: Optional[TensorParallel] = None

    def _whole_blocks(self):
        """Each block's whole weights gathered from the model group, as
        stand-ins that ``fused_transformer`` reads (``use_mega`` under
        tensor parallelism)."""
        tp, heads = self.tp, self.heads * self.tp.size

        def whole(kind, t):
            return _Unshard.apply(t, tp, kind, heads)

        ns = types.SimpleNamespace
        out = []
        for b in self.resblocks:
            out.append(ns(
                ln_1=b.ln_1, ln_2=b.ln_2,
                attn=ns(in_proj_weight=whole("qkv", b.attn.in_proj_weight),
                        in_proj_bias=whole("qkv", b.attn.in_proj_bias),
                        out_proj=ns(weight=whole("out",
                                                 b.attn.out_proj.weight),
                                    bias=b.attn.out_proj.bias)),
                mlp={"c_fc": ns(weight=whole("fc", b.mlp["c_fc"].weight),
                                bias=whole("fc", b.mlp["c_fc"].bias)),
                     "c_proj": ns(weight=whole("proj",
                                               b.mlp["c_proj"].weight),
                                  bias=b.mlp["c_proj"].bias)}))
        return out

    def forward(self, x, causal: bool, precision: Precision,
                attention: Attention, use_mega: bool = False,
                remat: Remat = False):
        """``remat`` applies where a graph is built; ``use_mega`` ignores
        it, as ``functional._transformer`` does."""
        if use_mega:
            if hasattr(self.resblocks[0].attn, "in_proj_weight_q"):
                raise ValueError(
                    "use_mega has no int8 path: the block kernels read "
                    "float weights (run --quantize int8 without use_mega)")
            blocks, heads = self.resblocks, self.heads
            if self.tp is not None:
                blocks, heads = self._whole_blocks(), self.heads * self.tp.size
            return fused_transformer(
                blocks, x, heads=heads, quick_gelu=self.quick,
                causal=causal, compute_dtype=precision.compute_dtype)
        enabled, saved_ops, first_k = resolve_remat_policy(remat)
        enabled = enabled and torch.is_grad_enabled()
        kw = {}
        if saved_ops is not None:
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, list(saved_ops))
        for i, block in enumerate(self.resblocks):
            if enabled and (first_k is None or i < first_k):
                x = checkpoint(block, x, causal, precision, attention,
                               self.tp, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = block(x, causal, precision, attention, self.tp)
        return x


def _normal(t: torch.Tensor, std: float, generator: torch.Generator):
    t.copy_(torch.randn(t.shape, generator=generator) * std)


def _init_transformer(tr: Transformer, width: int,
                      generator: torch.Generator) -> None:
    """OpenCLIP's initialisation of a tower's blocks."""
    layers = len(tr.resblocks)
    attn_std = width ** -0.5
    proj_std = attn_std * (2 * layers) ** -0.5
    for blk in tr.resblocks:
        _normal(blk.attn.in_proj_weight, attn_std, generator)
        blk.attn.in_proj_bias.zero_()
        _normal(blk.attn.out_proj.weight, proj_std, generator)
        blk.attn.out_proj.bias.zero_()
        _normal(blk.mlp["c_fc"].weight, (2 * width) ** -0.5, generator)
        blk.mlp["c_fc"].bias.zero_()
        _normal(blk.mlp["c_proj"].weight, proj_std, generator)
        blk.mlp["c_proj"].bias.zero_()
        for ln in (blk.ln_1, blk.ln_2):
            ln.weight.fill_(1.0)
            ln.bias.zero_()


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

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """OpenCLIP's initialisation of the tower, drawn from
        ``generator``."""
        w = self.cfg.width
        _normal(self.conv1.weight, (3 * self.cfg.patch_size ** 2) ** -0.5,
                generator)
        _normal(self.class_embedding, w ** -0.5, generator)
        _normal(self.positional_embedding, w ** -0.5, generator)
        _normal(self.proj, w ** -0.5, generator)
        _init_transformer(self.transformer, w, generator)
        for ln in (self.ln_pre, self.ln_post):
            ln.weight.fill_(1.0)
            ln.bias.zero_()

    def forward(self, images: torch.Tensor, precision: Precision,
                attention: Attention, pool: bool = True,
                use_mega: bool = False, remat: Remat = False,
                updates=None) -> torch.Tensor:
        """images [B, H, W, 3] -> [B, embed]; ``pool=False`` applies
        ln_post and the projection to every token -> [B, S, embed], class
        token first (the heatmaps' input).  ``updates`` (the batch
        statistics of a ResNet tower's train mode) is left as it is: the
        tower has no normalization state."""
        p = self.cfg.patch_size
        b, h, w, c = images.shape
        gh, gw = h // p, w // p
        cd = precision.compute_dtype
        x = images.to(cd).reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c)
        conv = weight_of(self.conv1, "weight")
        if isinstance(conv, Int8Weight):
            # codes [width, (kh, kw, in)]
            x = qdot(x, conv, precision)
        else:
            # conv1 [width, 3, p, p] -> [(kh, kw, in), width], the NHWC
            # unfold order (loader.py's patch_kernel)
            kernel = conv.permute(2, 3, 1, 0).reshape(p * p * c, -1)
            x = torch.matmul(x, kernel.to(cd))
        cls = self.class_embedding.to(cd).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(cd)
        x = layer_norm(self.ln_pre, x, precision)
        x = self.transformer(x, False, precision, attention, use_mega,
                             remat)
        x = layer_norm(self.ln_post, x[:, 0] if pool else x, precision)
        return project(x, weight_of(self, "proj"), precision)


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
                             precision: Precision, attention: Attention,
                             use_mega: bool = False,
                             remat: Remat = False) -> torch.Tensor:
        cd = precision.compute_dtype
        tp = self.transformer.tp
        if tp is None:
            x = self.token_embedding.weight[token_ids]
        else:
            # this rank's vocabulary rows, the others masked, then the sum
            rows = self.token_embedding.weight.shape[0]
            local = token_ids - vocab_rows(self.text_cfg.vocab_size,
                                           tp.size, tp.rank).start
            held = (local >= 0) & (local < rows)
            x = tp.leave(self.token_embedding.weight[local.clamp(0, rows - 1)]
                         * held[..., None])
        x = x.to(cd)
        x = x + self.positional_embedding.to(cd)
        x = self.transformer(x, True, precision, attention, use_mega, remat)
        x = layer_norm(self.ln_final, x, precision)
        eot = token_ids.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return project(x, weight_of(self, "text_projection"), precision)


def vocab_rows(vocab: int, size: int, rank: int) -> slice:
    """A rank's contiguous rows of a vocabulary of ``vocab`` split over
    ``size`` ranks (the first ``vocab % size`` ranks one row more)."""
    per, extra = divmod(vocab, size)
    start = rank * per + min(rank, extra)
    return slice(start, start + per + (rank < extra))


def _tp_kind(name: str) -> Optional[str]:
    """How ``tp_shard_state_dict`` cuts the tensor ``name`` of a ViT /
    text block stack, or None (whole on every rank)."""
    if ".resblocks." not in name:
        return None
    if name.endswith("attn.in_proj_weight") or name.endswith(
            "attn.in_proj_bias"):
        return "qkv"
    if name.endswith("attn.out_proj.weight"):
        return "out"
    if name.endswith("mlp.c_fc.weight") or name.endswith("mlp.c_fc.bias"):
        return "fc"
    if name.endswith("mlp.c_proj.weight"):
        return "proj"
    return None


def tp_split(kind: str, t: torch.Tensor, size: int, rank: int,
             heads: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``t`` of a ``kind`` (``_tp_kind``; "vocab"
    for the token embedding), ``heads`` the tower's."""
    if kind == "qkv":            # [3W(, W)]: by heads within q, k, v
        h = heads // size
        v = t.reshape(3, heads, -1, *t.shape[1:])
        return v[:, rank * h: (rank + 1) * h].reshape(-1, *t.shape[1:])
    if kind == "out":            # [W, W]: input columns, by heads
        w = t.shape[1] // size
        return t[:, rank * w: (rank + 1) * w]
    if kind == "fc":             # [F(, W)]: output rows
        f = t.shape[0] // size
        return t[rank * f: (rank + 1) * f]
    if kind == "proj":           # [W, F]: input columns
        f = t.shape[1] // size
        return t[:, rank * f: (rank + 1) * f]
    if kind == "vocab":
        return t[vocab_rows(t.shape[0], size, rank)]
    raise ValueError(kind)


def tp_join(kind: str, parts: Sequence[torch.Tensor],
            heads: int) -> torch.Tensor:
    """The inverse of ``tp_split`` over every rank's shard."""
    if kind == "qkv":
        rest = parts[0].shape[1:]
        return torch.cat([p.reshape(3, -1, *rest) for p in parts],
                         dim=1).reshape(-1, *rest)
    if kind in ("out", "proj"):
        return torch.cat(list(parts), dim=1)
    return torch.cat(list(parts), dim=0)


def _tower_heads(name: str, cfg: CLIPConfig) -> int:
    return cfg.vision.heads if name.startswith("visual.") else cfg.text.heads


def tp_shard_state_dict(state_dict: Dict[str, torch.Tensor],
                        cfg: CLIPConfig, size: int,
                        rank: int) -> Dict[str, torch.Tensor]:
    """One rank's shard of a state dict over a model group of ``size``
    (the rules of the module docstring): the counterpart of ``swat_tpu``'s
    ``partition_specs``, cut on the host."""
    out = {}
    for name, t in state_dict.items():
        kind = ("vocab" if name == "token_embedding.weight"
                else _tp_kind(name))
        out[name] = (t if kind is None else
                     tp_split(kind, t, size, rank, _tower_heads(name, cfg)))
    return out


def tp_join_state_dicts(shards: Sequence[Dict[str, torch.Tensor]],
                        cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's shard, in rank order (the
    inverse of ``tp_shard_state_dict``, for saving)."""
    out = {}
    for name, t in shards[0].items():
        kind = ("vocab" if name == "token_embedding.weight"
                else _tp_kind(name))
        out[name] = (t if kind is None else
                     tp_join(kind, [s[name] for s in shards],
                             _tower_heads(name, cfg)))
    return out


def _normalize(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


class CLIPModel(TextTower):
    """OpenCLIP's ``CLIP`` module tree: the text tower at the top level,
    the image tower under ``visual``, and ``logit_scale``.  ``precision``
    is the compute policy of both encoders, ``remat`` their blocks' remat
    policy in training (``resolve_remat_policy``)."""

    def __init__(self, cfg: CLIPConfig,
                 precision: Precision = DEFAULT_PRECISION,
                 remat: Remat = False):
        resolve_remat_policy(remat)
        super().__init__(cfg.text)
        self.cfg = cfg
        self.precision = precision
        self.remat = remat
        self.visual = (ModifiedResNet(cfg.vision)
                       if isinstance(cfg.vision, ResNetConfig)
                       else VisionTower(cfg.vision))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     attention: Attention = mha_qkv, use_mega: bool = False,
                     updates: Optional[dict] = None) -> torch.Tensor:
        """images [B, H, W, 3] (CLIP-normalized) -> [B, embed] fp32.  With
        ``updates`` (a dict) the ResNet tower normalizes with batch
        statistics and adds each AffineBN's (``resnet.fold_bn_updates``
        folds them); a ViT tower adds none."""
        feats = self.visual(images, self.precision, attention,
                            use_mega=use_mega, remat=self.remat,
                            updates=updates)
        return _normalize(feats) if normalize else feats

    def encode_image_tokens(
            self, images: torch.Tensor,
            attention: Attention = heads_first_attention) -> torch.Tensor:
        """All projected token embeddings [B, S, embed] fp32, class token
        first.  Its attention is the heads-first route by default, as the
        Flax tower that computes the heatmaps in ``swat_tpu`` runs under
        ``--use_pallas``: the heads-first forward kernel on the card, its
        plain twin on the CPU.  The ResNet tower returns its attention
        pool's tokens, the mean token first, with eval-mode BatchNorm
        (``swat_tpu`` applies it with ``train=False`` there too)."""
        return self.visual(images, self.precision, attention, pool=False)

    def encode_text(self, token_ids: torch.Tensor, normalize: bool = False,
                    attention: Attention = mha_qkv,
                    use_mega: bool = False) -> torch.Tensor:
        """token ids [B, context] -> [B, embed] fp32."""
        feats = self.encode_text_features(token_ids, self.precision,
                                          attention, use_mega, self.remat)
        return _normalize(feats) if normalize else feats

    def _dense_weights(self):
        """(module, name, [out, in]) of every dense weight of both ViT
        towers, as ``quant.quantize_tree`` finds them: each block's qkv,
        out-proj, c_fc and c_proj, the patch embedding (its codes in the
        (kh, kw, in) order of its product) and both projections."""
        out = []
        for tower in (self.visual.transformer, self.transformer):
            for blk in tower.resblocks:
                for module, name in ((blk.attn, "in_proj_weight"),
                                     (blk.attn.out_proj, "weight"),
                                     (blk.mlp["c_fc"], "weight"),
                                     (blk.mlp["c_proj"], "weight")):
                    out.append((module, name,
                                tuple(getattr(module, name).shape)))
        conv = self.visual.conv1.weight
        out.append((self.visual.conv1, "weight",
                    (conv.shape[0], conv[0].numel())))
        out.append((self.visual, "proj", tuple(self.visual.proj.shape[::-1])))
        out.append((self, "text_projection",
                    tuple(self.text_projection.shape[::-1])))
        return out

    @property
    def is_int8(self) -> bool:
        return hasattr(self.visual, "proj_q")

    def tensor_parallel_(self, tp: TensorParallel) -> "CLIPModel":
        """Gives every sharded tensor of the model (``tp_shard_state_dict``'s
        rules) this rank's shard's shape, empty, and the blocks ``H / tp``
        heads, for ``load_state_dict`` of a ``tp_shard_state_dict`` shard
        to fill; the towers then run their blocks through ``parallel_block``
        over ``tp``.  The int8 layout has no such path."""
        if self.is_int8:
            raise ValueError("tensor parallelism has no int8 path")
        towers = [self.transformer]
        if isinstance(self.visual, VisionTower):
            towers.append(self.visual.transformer)
        for tower in towers:
            if tower.heads % tp.size:
                raise ValueError(f"{tower.heads} heads do not split over "
                                 f"{tp.size} ranks")
        shapes = {k: tuple(v.shape) for k, v in tp_shard_state_dict(
            {k: v for k, v in self.state_dict().items()},
            self.cfg, tp.size, tp.rank).items()}
        for name, p in list(self.named_parameters()):
            if tuple(p.shape) != shapes[name]:
                mod_name, _, leaf = name.rpartition(".")
                module = self.get_submodule(mod_name) if mod_name else self
                setattr(module, leaf, nn.Parameter(
                    p.new_empty(shapes[name]), requires_grad=p.requires_grad))
        for tower in towers:
            tower.heads //= tp.size
            for blk in tower.resblocks:
                blk.heads //= tp.size
            tower.tp = tp
        return self

    def int8_(self) -> "CLIPModel":
        """Swaps every dense weight (``_dense_weights``) for empty int8
        codes ``<name>_q`` [out, in] and fp32 scales ``<name>_scale``
        [out], buffers on the weight's device, for ``load_state_dict`` of
        a quantized state dict (``loader.state_dict_from_jax_params`` of a
        ``quant.quantize_tree`` tree) to fill.  Inference only; the RN50
        tower has no int8 path (``quantize_tree`` refuses its tree)."""
        if isinstance(self.visual, ModifiedResNet):
            raise ValueError("the RN50 image tower has no int8 path")
        if self.is_int8:
            return self
        for module, name, shape in self._dense_weights():
            device = getattr(module, name).device
            delattr(module, name)
            module.register_buffer(f"{name}_q", torch.zeros(
                shape, dtype=torch.int8, device=device))
            module.register_buffer(f"{name}_scale", torch.zeros(
                shape[0], dtype=torch.float32, device=device))
        return self

    def load_weights(self, state_dict) -> "CLIPModel":
        """``load_state_dict``, into the int8 layout first (``int8_``)
        when ``state_dict`` holds a quantized tree's codes."""
        if "visual.proj_q" in state_dict:
            self.int8_()
        self.load_state_dict(state_dict)
        return self

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "CLIPModel":
        """OpenCLIP's initialisation scheme, drawn from ``generator`` (for
        runs without a checkpoint: smoke tests, synthetic checkpoints): the
        image tower's own ``init_random`` first, then the text tower."""
        self.visual.init_random(generator)
        tw = self.text_cfg.width
        _normal(self.token_embedding.weight, 0.02, generator)
        _normal(self.positional_embedding, 0.01, generator)
        _normal(self.text_projection, tw ** -0.5, generator)
        _init_transformer(self.transformer, tw, generator)
        self.ln_final.weight.fill_(1.0)
        self.ln_final.bias.zero_()
        self.logit_scale.fill_(math.log(1 / 0.07))
        return self
