"""Block-fused transformer layer, forward and backward.

Counterpart of ``swat_tpu/kernels/megablock.py``.  Its three Pallas TPU
kernels each have a hand-written CUDA entry point here:

* ``_fwd_kernel`` (a whole pre-LN block: LN1, q/k/v, softmax attention, the
  out-projection and residual, LN2, the MLP and residual; writes y and x2)
  -> ``swat_tpu_torch/csrc/megablock_fwd.cu``, wrapper ``megablock_fwd``;
* ``_mlp_bwd_kernel`` (from x2 and dy: dx2 and the fp32 gradients of the MLP
  and LN2 parameters) -> ``csrc/megablock_mlp_bwd.cu``, wrapper
  ``megablock_mlp_bwd``;
* ``_attn_bwd_kernel`` (from x and dx2: dx and the fp32 gradients of the
  attention and LN1 parameters) -> ``csrc/megablock_attn_bwd.cu``, wrapper
  ``megablock_attn_bwd``.

``FusedBlock`` pairs the first with the other two as one
``torch.autograd.Function`` (the port of the ``jax.custom_vjp`` there): of
the layer's activations only x and x2 live between forward and backward,
everything else is recomputed.  ``fused_transformer`` runs a stack of the
towers' blocks through it: the ``use_mega`` route of ``models/clip.py``.

The plain PyTorch versions (``block_fwd_reference``, ``mlp_bwd_reference``,
``attn_bwd_reference``) follow the Pallas bodies step by step with their
rounding points (``cd`` is the compute dtype; every product sums in fp32):
LayerNorm in fp32, always in the fast-variance form, with its scale and
bias rounded to ``cd`` first; q, k, v, the out-projection (summed over all
heads before it is rounded), m1 and the MLP projection rounded to ``cd``
once, then biased in ``cd``; p rounded before p.v; in the backward dm, do,
ds and dq/dk/dv rounded to ``cd`` before the products that follow, delta and
every bias gradient taken from the fp32 values.  They are the CPU path and
what the kernels are held against on the card.

What is the TPU's and is not carried over: the block-diagonal attention
over several images of a batch block (a masked score adds exactly 0, so
attention per image gives the same p; ``block_imgs`` is accepted and
changes nothing), S padded to 8, the ``[H, D, hd]`` weight stacks (a head is
a stride of torch's ``in_proj_weight`` here), and the grid that carries
weight-gradient sums from batch block to batch block (here each weight
gradient is one product over all B*S rows, its depth cut into
``split_count`` splits whose fp32 partials are added in order).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from swat_tpu_torch.kernels import flash_attention as FA

# kernel launches since the last reset, one counter per entry point
LAUNCHES_MEGA = 0            # block forward
LAUNCHES_MEGA_MLP_BWD = 0    # backward of the MLP half
LAUNCHES_MEGA_ATTN_BWD = 0   # backward of the attention half

LN_EPS = 1e-5
# rows of one column-sum partial (kBM of csrc/megablock.cuh; the entry
# points refuse a partials buffer that is too small for theirs)
_ROW_BLOCK = 128
# the tensor-core product of csrc/megablock_mma.cuh: its block tile (rows,
# columns), warps (along rows, along columns) and shared-memory stages by
# compute dtype, the depth of a step, and the constants of its rule for
# cutting the depth of a weight gradient into splits (kSplitBlocks,
# kMinSplitSteps, kMaxSplits there)
_TILE = {torch.bfloat16: (128, 128), torch.float32: (128, 64)}
_WARPS = {torch.bfloat16: (2, 4), torch.float32: (4, 2)}
_STAGES = {torch.bfloat16: 3, torch.float32: 1}
_DEPTH = 32
_SPLIT_BLOCKS, _MIN_SPLIT_STEPS, _MAX_SPLITS = 528, 8, 16


class BlockWeights(NamedTuple):
    """One block's parameters in torch's layouts ([out, in] matrices), all
    in the compute dtype.  The field order is the C entry points'."""
    in_w: torch.Tensor     # [3D, D]  attn.in_proj_weight
    in_b: torch.Tensor     # [3D]
    out_w: torch.Tensor    # [D, D]   attn.out_proj.weight
    out_b: torch.Tensor    # [D]
    ln1_w: torch.Tensor    # [D]
    ln1_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc_w: torch.Tensor     # [F, D]   mlp.c_fc.weight
    fc_b: torch.Tensor     # [F]
    proj_w: torch.Tensor   # [D, F]   mlp.c_proj.weight
    proj_b: torch.Tensor   # [D]


def block_weights(block, compute_dtype: torch.dtype) -> BlockWeights:
    """A ``ResidualAttentionBlock``'s parameters cast to the compute dtype
    (once per call; a no-op in fp32), differentiably."""
    ps = (block.attn.in_proj_weight, block.attn.in_proj_bias,
          block.attn.out_proj.weight, block.attn.out_proj.bias,
          block.ln_1.weight, block.ln_1.bias, block.ln_2.weight,
          block.ln_2.bias, block.mlp["c_fc"].weight, block.mlp["c_fc"].bias,
          block.mlp["c_proj"].weight, block.mlp["c_proj"].bias)
    return BlockWeights(*(p.to(compute_dtype) for p in ps))


def pick_block_imgs(batch: int, sp: int, target_rows: int = 512) -> int:
    """Largest divisor of ``batch`` whose token-row count stays near
    ``target_rows``: the TPU kernels' batch block.  The kernels here attend
    per image, so nothing depends on it; kept for the name."""
    bi = min(max(1, target_rows // sp), batch)
    while batch % bi:
        bi -= 1
    return bi


# ---------------------------------------------------------------------------
# the math


def _ln_fwd(x32, scale, bias):
    """fp32 LayerNorm, fast-variance form -> (y32, xhat, rstd)."""
    mu = x32.mean(dim=-1, keepdim=True)
    mu2 = (x32 * x32).mean(dim=-1, keepdim=True)
    var = (mu2 - mu * mu).clamp_min(0.0)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (x32 - mu) * rstd
    return xhat * scale + bias, xhat, rstd


def _ln_bwd(dy32, xhat, rstd, scale):
    """LayerNorm input gradient -> (dx32, dscale, dbias), the parameter
    gradients summed over all rows."""
    n = xhat.shape[-1]
    dyh = dy32 * scale
    s1 = dyh.sum(dim=-1, keepdim=True)
    s2 = (dyh * xhat).sum(dim=-1, keepdim=True)
    dx = (rstd / n) * (n * dyh - s1 - xhat * s2)
    return dx, _rows_sum(dy32 * xhat), _rows_sum(dy32)


def _erf(x):
    """Abramowitz-Stegun 7.1.26 rational erf, the TPU kernels' (their
    compiler has no erf); kept so that both packages compute one gelu."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _act(m32, quick_gelu: bool):
    if quick_gelu:
        return m32 * torch.sigmoid(1.702 * m32)
    return 0.5 * m32 * (1.0 + _erf(m32 * 0.7071067811865476))


def _act_grad(m32, quick_gelu: bool):
    if quick_gelu:
        s = torch.sigmoid(1.702 * m32)
        return s * (1.0 + 1.702 * m32 * (1.0 - s))
    phi = torch.exp(-0.5 * m32 * m32) * 0.3989422804014327
    cdf = 0.5 * (1.0 + _erf(m32 * 0.7071067811865476))
    return cdf + m32 * phi


def _dot(a, b):
    """a . b with the operands widened: an fp32 sum of exact products."""
    return torch.matmul(a.float(), b.float())


def _rows_sum(t):
    """[..., C] -> [C], summed over every leading dimension."""
    return t.reshape(-1, t.shape[-1]).sum(dim=0)


def _rows(t):
    return t.reshape(-1, t.shape[-1])


# ---------------------------------------------------------------------------
# plain PyTorch versions


def block_fwd_reference(x: torch.Tensor, w: BlockWeights, heads: int,
                        causal: bool, quick_gelu: bool):
    """Plain PyTorch twin of the block-forward kernel.  x [B, S, D] in the
    compute dtype -> (y, x2) in it."""
    cd = x.dtype
    h1 = _ln_fwd(x.float(), w.ln1_w.float(), w.ln1_b.float())[0].to(cd)
    qkv = _dot(h1, w.in_w.t()).to(cd) + w.in_b
    # per head: fp32 scores, masked to -1e30, fp32 softmax with a division,
    # p rounded to cd, p.v rounded to cd
    o = FA.mha_packed_reference(*qkv.chunk(3, dim=-1), heads, causal)
    x2 = x + (_dot(o, w.out_w.t()).to(cd) + w.out_b)
    h2 = _ln_fwd(x2.float(), w.ln2_w.float(), w.ln2_b.float())[0].to(cd)
    m1 = _dot(h2, w.fc_w.t()).to(cd) + w.fc_b
    g = _act(m1.float(), quick_gelu).to(cd)
    y = x2 + (_dot(g, w.proj_w.t()).to(cd) + w.proj_b)
    return y, x2


def mlp_bwd_reference(x2: torch.Tensor, dy: torch.Tensor, w: BlockWeights,
                      quick_gelu: bool):
    """Plain PyTorch twin of the MLP-backward kernel -> (dx2 in the compute
    dtype, then fp32 d fc_w [F, D], d fc_b, d proj_w [D, F], d proj_b,
    d ln2_w, d ln2_b, summed over all rows)."""
    cd = x2.dtype
    ln_w = w.ln2_w.float()
    h2_32, xhat, rstd = _ln_fwd(x2.float(), ln_w, w.ln2_b.float())
    h2 = h2_32.to(cd)
    m1 = (_dot(h2, w.fc_w.t()).to(cd) + w.fc_b).float()
    g = _act(m1, quick_gelu).to(cd)
    dy32 = dy.float()
    d_proj_b = _rows_sum(dy32)
    d_proj_w = _dot(_rows(dy).t(), _rows(g))
    dm = _dot(dy, w.proj_w) * _act_grad(m1, quick_gelu)
    d_fc_b = _rows_sum(dm)
    dm_c = dm.to(cd)
    d_fc_w = _dot(_rows(dm_c).t(), _rows(h2))
    dh2 = _dot(dm_c, w.fc_w)
    dx_ln, d_ln_w, d_ln_b = _ln_bwd(dh2, xhat, rstd, ln_w)
    dx2 = (dy32 + dx_ln).to(cd)
    return dx2, d_fc_w, d_fc_b, d_proj_w, d_proj_b, d_ln_w, d_ln_b


def attn_bwd_reference(x: torch.Tensor, dx2: torch.Tensor, w: BlockWeights,
                       heads: int, causal: bool):
    """Plain PyTorch twin of the attention-backward kernel -> (dx in the
    compute dtype, then fp32 d in_w [3D, D], d in_b, d out_w [D, D],
    d out_b, d ln1_w, d ln1_b, summed over all rows)."""
    cd = x.dtype
    ln_w = w.ln1_w.float()
    h1_32, xhat, rstd = _ln_fwd(x.float(), ln_w, w.ln1_b.float())
    h1 = h1_32.to(cd)
    dx2_32 = dx2.float()
    d_out_b = _rows_sum(dx2_32)
    qkv = _dot(h1, w.in_w.t()).to(cd) + w.in_b
    q, k, v = qkv.chunk(3, dim=-1)
    o = FA.mha_packed_reference(q, k, v, heads, causal)
    d_out_w = _dot(_rows(dx2).t(), _rows(o))
    do = _dot(dx2, w.out_w).to(cd)
    # p recomputed; dv from p rounded to cd, delta from the fp32 p, ds
    # masked then rounded; dq, dk, dv stay in fp32 here
    grads = FA._bwd_math(*(FA._split_heads(t, heads) for t in (q, k, v, do)),
                         causal, cd)
    dqkv32 = torch.cat([FA._merge_heads(t, torch.float32) for t in grads],
                       dim=-1)
    d_in_b = _rows_sum(dqkv32)
    dqkv = dqkv32.to(cd)
    d_in_w = _dot(_rows(dqkv).t(), _rows(h1))
    dh1 = _dot(dqkv, w.in_w)
    dx_ln, d_ln_w, d_ln_b = _ln_bwd(dh1, xhat, rstd, ln_w)
    dx = (dx2_32 + dx_ln).to(cd)
    return dx, d_in_w, d_in_b, d_out_w, d_out_b, d_ln_w, d_ln_b


# ---------------------------------------------------------------------------
# wrappers: a CUDA tensor launches the kernel or raises, a CPU tensor takes
# the plain version


def _check(x: torch.Tensor, w: BlockWeights, heads: Optional[int],
           other: Optional[torch.Tensor] = None) -> None:
    """``heads`` None: an entry point that splits no heads."""
    if x.dtype not in FA._DTYPE_CODE:
        raise TypeError(f"the block kernels take float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty [B, S, D]; got "
                         f"{tuple(x.shape)}")
    d = x.shape[2]
    if heads is not None:
        if heads <= 0 or d % heads:
            raise ValueError(f"D={d} is not divisible by heads={heads}")
        FA._check_head_dim(d // heads)
    if other is not None and (other.shape != x.shape
                              or other.dtype != x.dtype
                              or other.device != x.device):
        raise ValueError(f"the gradient must match x: got "
                         f"{tuple(other.shape)} {other.dtype} on "
                         f"{other.device}")
    f = w.fc_w.shape[0]
    shapes = BlockWeights((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,),
                          (d,), (d,), (f, d), (f,), (d, f), (d,))
    for name, t, shape in zip(BlockWeights._fields, w, shapes):
        if (tuple(t.shape) != shape or t.dtype != x.dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {shape} {x.dtype} tensor on "
                f"{x.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")


def split_count(m: int, n: int, k: int, dtype: torch.dtype):
    """(splits, steps of ``_DEPTH`` a split) of a weight-gradient product
    [m, n] summed over k token rows: ``split_count`` of
    csrc/megablock_mma.cuh, a function of (m, n, k) and the tile alone.
    Enough splits for ``_SPLIT_BLOCKS`` blocks, each at least
    ``_MIN_SPLIT_STEPS`` steps deep, at most ``_MAX_SPLITS``; the last split
    takes what is left."""
    bm, bn = _TILE[dtype]
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k // _DEPTH)
    want = max(1, min(-(-_SPLIT_BLOCKS // tiles), _MAX_SPLITS,
                      steps // _MIN_SPLIT_STEPS))
    per = -(-steps // want)
    if per <= 0:
        return 1, 1
    return -(-steps // per), per


def product_smem_bytes(dtype: torch.dtype, a_kcontig: bool,
                       b_kcontig: bool) -> int:
    """Dynamic shared memory of one block of the tensor-core product
    (``smem_bytes`` of csrc/megablock_mma.cuh): its stages of bf16 tiles, an
    fp32 operand in three planes, a k-contiguous tile of R rows as
    [R][depth + 8], an i-contiguous one as [depth][R + 8]."""
    planes = 3 if dtype == torch.float32 else 1

    def tile(rows, kcontig):
        return rows * (_DEPTH + 8) if kcontig else _DEPTH * (rows + 8)

    bm, bn = _TILE[dtype]
    return (_STAGES[dtype] * planes
            * (tile(bm, a_kcontig) + tile(bn, b_kcontig)) * 2)


def _split_floats(m, n, k, dtype):
    splits, _ = split_count(m, n, k, dtype)
    return splits * m * n if splits > 1 else 0


def scratch_shapes(kind: str, batch: int, seq: int, width: int, mlp: int,
                   heads: int, dtype: torch.dtype):
    """What one call of an entry point keeps in device memory between its
    launches, [(shape, dtype), ...] in the entry point's order: what the TPU
    kernel held on chip.  ``kind``: 'fwd', 'mlp_bwd' or 'attn_bwd'."""
    n, d, f, f32 = batch * seq, width, mlp, torch.float32
    blocks = -(-n // _ROW_BLOCK)
    if kind == "fwd":       # h, qkv, o, g
        return [((n, d), dtype), ((n, 3 * d), dtype), ((n, d), dtype),
                ((n, f), dtype)]
    if kind == "mlp_bwd":   # h2, m1 (then dm), g, dh2, row stats, column-
        #                     sum partials, split partials of dWp and dWfc
        split = max(_split_floats(d, f, n, dtype),
                    _split_floats(f, d, n, dtype))
        return [((n, d), dtype), ((n, f), dtype), ((n, f), dtype),
                ((n, d), f32), ((n, 2), f32),
                ((blocks, max(f, 2 * d)), f32), ((split,), f32)]
    if kind == "attn_bwd":  # h1, qkv, o (then do), dqkv, dqkv32, dh1, row
        #                     stats, softmax stats (none where one block of
        #                     the attention backward takes a head), column-
        #                     sum partials, split partials of dWo and dWqkv
        rounded = 0 if dtype == f32 else n
        split = max(_split_floats(d, d, n, dtype),
                    _split_floats(3 * d, d, n, dtype))
        return [((n, d), dtype), ((n, 3 * d), dtype), ((n, d), dtype),
                ((rounded, 3 * d), dtype), ((n, 3 * d), f32), ((n, d), f32),
                ((n, 2), f32),
                (FA._bwd_stats_shape(batch, heads, seq, dtype), f32),
                ((blocks, 3 * d), f32), ((split,), f32)]
    raise ValueError(f"unknown kind {kind!r}")


def scratch_bytes(kind: str, batch: int, seq: int, width: int, mlp: int,
                  heads: int, dtype: torch.dtype) -> int:
    """The bytes of ``scratch_shapes``."""
    return sum(torch.Size(shape).numel() * dt.itemsize
               for shape, dt in scratch_shapes(kind, batch, seq, width, mlp,
                                               heads, dtype))


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _scratch(kind, x, w, heads):
    b, s, d = x.shape
    return [torch.empty(shape, dtype=dt, device=x.device)
            for shape, dt in scratch_shapes(kind, b, s, d, w.fc_w.shape[0],
                                            heads, x.dtype)]


def megablock_fwd(x: torch.Tensor, w: BlockWeights, heads: int, causal: bool,
                  quick_gelu: bool):
    """The block forward alone, no autograd.  x [B, S, D] -> (y, x2).  A
    CUDA tensor launches the kernel (a build or launch failure raises), a
    CPU tensor runs ``block_fwd_reference``."""
    global LAUNCHES_MEGA
    if not FA._on_cuda(x, "megablock_fwd"):
        return block_fwd_reference(x, w, heads, causal, quick_gelu)
    _check(x, w, heads)
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    x = x.contiguous()
    b, s, d = x.shape
    y, x2 = torch.empty_like(x), torch.empty_like(x)
    scratch = _scratch("fwd", x, w, heads)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.swat_mega_fwd(
            x.data_ptr(), _pointers(w), y.data_ptr(), x2.data_ptr(),
            _pointers(scratch), b, s, d, heads, w.fc_w.shape[0],
            FA._DTYPE_CODE[x.dtype], int(causal), int(quick_gelu), stream)
    _build.check(lib, err, "megablock_fwd kernel")
    LAUNCHES_MEGA += 1
    return y, x2


def megablock_mlp_bwd(x2: torch.Tensor, dy: torch.Tensor, w: BlockWeights,
                      quick_gelu: bool):
    """The backward of the MLP half alone -> ``mlp_bwd_reference``'s
    tuple.  A CUDA tensor launches the kernel or raises; a CPU tensor runs
    the plain version."""
    global LAUNCHES_MEGA_MLP_BWD
    if not FA._on_cuda(x2, "megablock_mlp_bwd"):
        return mlp_bwd_reference(x2, dy, w, quick_gelu)
    _check(x2, w, None, dy)
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    x2, dy = x2.contiguous(), dy.contiguous()
    b, s, d = x2.shape
    f = w.fc_w.shape[0]
    dx2 = torch.empty_like(x2)
    grads = [torch.empty(shape, dtype=torch.float32, device=x2.device)
             for shape in ((f, d), (f,), (d, f), (d,), (d,), (d,))]
    scratch = _scratch("mlp_bwd", x2, w, 1)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.swat_mega_mlp_bwd(
            x2.data_ptr(), dy.data_ptr(),
            _pointers((w.fc_w, w.fc_b, w.proj_w, w.ln2_w, w.ln2_b)),
            dx2.data_ptr(), _pointers(grads), _pointers(scratch),
            scratch[-2].numel(), scratch[-1].numel(), b * s, d, f,
            FA._DTYPE_CODE[x2.dtype], int(quick_gelu), stream)
    _build.check(lib, err, "megablock_mlp_bwd kernel")
    LAUNCHES_MEGA_MLP_BWD += 1
    return (dx2, *grads)


def megablock_attn_bwd(x: torch.Tensor, dx2: torch.Tensor, w: BlockWeights,
                       heads: int, causal: bool):
    """The backward of the attention half alone -> ``attn_bwd_reference``'s
    tuple.  A CUDA tensor launches the kernel or raises; a CPU tensor runs
    the plain version."""
    global LAUNCHES_MEGA_ATTN_BWD
    if not FA._on_cuda(x, "megablock_attn_bwd"):
        return attn_bwd_reference(x, dx2, w, heads, causal)
    _check(x, w, heads, dx2)
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    x, dx2 = x.contiguous(), dx2.contiguous()
    b, s, d = x.shape
    dx = torch.empty_like(x)
    grads = [torch.empty(shape, dtype=torch.float32, device=x.device)
             for shape in ((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,))]
    scratch = _scratch("attn_bwd", x, w, heads)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.swat_mega_attn_bwd(
            x.data_ptr(), dx2.data_ptr(),
            _pointers((w.in_w, w.in_b, w.out_w, w.ln1_w, w.ln1_b)),
            dx.data_ptr(), _pointers(grads), _pointers(scratch),
            scratch[-2].numel(), scratch[-1].numel(), b, s, d, heads,
            FA._DTYPE_CODE[x.dtype], int(causal), stream)
    _build.check(lib, err, "megablock_attn_bwd kernel")
    LAUNCHES_MEGA_ATTN_BWD += 1
    return (dx, *grads)


# ---------------------------------------------------------------------------
# the autograd Function and the stack


class FusedBlock(torch.autograd.Function):
    """The block-forward kernel with the MLP-backward and the
    attention-backward kernels as its gradient: the port of
    ``block.defvjp(block_fwd, block_bwd)``.  Of the layer's activations
    only x and x2 are saved; the weights are saved as the inputs they are.
    The fp32 parameter gradients are cast to the compute dtype before they
    leave, as there: in bf16 a parameter's ``.grad`` holds bf16-rounded
    values."""

    @staticmethod
    def forward(ctx, x, heads: int, causal: bool, quick_gelu: bool,
                *weights):
        w = BlockWeights(*weights)
        y, x2 = megablock_fwd(x, w, heads, causal, quick_gelu)
        ctx.save_for_backward(x, x2, *w)
        ctx.heads, ctx.causal, ctx.quick_gelu = heads, causal, quick_gelu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, x2, *weights = ctx.saved_tensors
        w = BlockWeights(*weights)
        dx2, d_fc_w, d_fc_b, d_proj_w, d_proj_b, d_ln2_w, d_ln2_b = \
            megablock_mlp_bwd(x2, dy, w, ctx.quick_gelu)
        dx, d_in_w, d_in_b, d_out_w, d_out_b, d_ln1_w, d_ln1_b = \
            megablock_attn_bwd(x, dx2, w, ctx.heads, ctx.causal)
        grads = BlockWeights(d_in_w, d_in_b, d_out_w, d_out_b, d_ln1_w,
                             d_ln1_b, d_ln2_w, d_ln2_b, d_fc_w, d_fc_b,
                             d_proj_w, d_proj_b)
        return (dx, None, None, None, *(g.to(x.dtype) for g in grads))


def fused_block(x: torch.Tensor, w: BlockWeights, heads: int, causal: bool,
                quick_gelu: bool) -> torch.Tensor:
    """One fused pre-LN block, differentiable.  x [B, S, D] in the compute
    dtype -> y.  A CUDA tensor launches the three kernels; a CPU tensor runs
    their plain twins inside the same autograd Function."""
    return FusedBlock.apply(x, heads, causal, quick_gelu, *w)


def fused_transformer(blocks, x: torch.Tensor, *, heads: int,
                      quick_gelu: bool, causal: bool,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      block_imgs: Optional[int] = None) -> torch.Tensor:
    """Run the ``ResidualAttentionBlock``s of ``blocks`` as fused blocks
    over x [B, S, D]: the drop-in for ``Transformer.forward`` that
    ``use_mega`` selects.  S is taken as it is (no padding).  ``block_imgs``
    is the TPU kernels' batch block: it must divide the batch, as there,
    and changes nothing here."""
    if block_imgs is not None and x.shape[0] % block_imgs:
        raise ValueError(f"block_imgs={block_imgs} must divide batch "
                         f"{x.shape[0]}")
    x = x.to(compute_dtype)
    for block in blocks:
        x = fused_block(x, block_weights(block, compute_dtype), heads,
                        causal, quick_gelu)
    return x
