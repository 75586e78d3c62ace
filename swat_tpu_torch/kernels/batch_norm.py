"""BatchNorm with batch statistics, forward and backward, with an optional
ReLU fused, in one hand-written CUDA kernel set
(``swat_tpu_torch/csrc/batch_norm.cu``).

No TPU kernel stands behind it: ``swat_tpu`` leaves its ``AffineBN`` to
XLA, which fuses its passes.  The RN50 tower's ``models/resnet.py::AffineBN``
runs the same function in train mode as separate PyTorch passes over an
fp32 upcast, which autograd differentiates one by one and whose upcast it
saves; on a CUDA tensor (outside a data-parallel mesh) it calls
``batch_norm`` below instead, one autograd Function over the kernels.  The
forward takes three launches (each channel's fp32 Welford statistics over
fixed slabs of rows, their join in a fixed order, the affine and the ReLU);
the backward three (the channel sums of dz and dz * (x - mean) over the same
slabs, their join, dx).  No atomics: the same inputs give the same bits.
x, y, dy and dx share one dtype, fp32 or bf16 (the tower's compute dtype),
and lie channels-last: a [B, C, H, W] activation is read as its row-major
[B * H * W, C] rows, 16 bytes of channels a thread; C must be a multiple
of those 16 bytes (4 fp32 or 8 bf16, as every BatchNorm width of the
registered ResNets is), and another layout, or a start not on 16 bytes,
is copied to channels-last first (``COPIES_BN`` counts those copies; the
tower makes none).  The host's part is a few allocations and one ctypes
call each way.  The backward saves x, the fp32 mean and rstd and the
rounded a and b of each channel: no fp32 copy of x.

The plain versions are the kernels' twins: ``batch_stats`` and ``affine``
are ``AffineBN``'s train-mode formula, which its own plain path (the CPU,
eval mode, the sharded mesh's affine) calls: fp32 mean and biased
variance, ``a = w * rstd`` and ``b = bias - mean * w * rstd`` rounded once
to the compute dtype, ``x * a + b`` as two rounded passes.
``batch_norm_reference`` is the forward kernels' twin built from them,
then the ReLU, and ``batch_norm_bwd_reference`` its exact fp32 gradient at
the kernels' rounding points (dx rounded once to x's dtype, fp32 dw and
db).  A CPU tensor takes the twins inside the same Function.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from swat_tpu_torch.kernels.flash_attention import _launch_stream, _on_cuda

# calls since the last reset, three kernel launches each: forward calls,
# backward calls; and x or dy that the wrappers copied to channels-last
# first
LAUNCHES_BN = 0
LAUNCHES_BN_BWD = 0
COPIES_BN = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' block (csrc/batch_norm.cu: kThreads); the grid plan() aims at
# (blocks for every SM of an H100 several times over), and the fewest rows a
# thread takes where the batch has them
THREADS = 256
SMS = 132
TARGET_BLOCKS = 8 * SMS
MIN_ROWS = 16


class Plan(NamedTuple):
    """The launch shape of a call: ``vec`` channels a thread reads at once
    (16 bytes of them), ``tpr`` threads across a channel tile (a power
    of two up to a warp), ``slab_rows`` rows a block, ``slabs`` blocks down
    the rows, ``tiles`` channel tiles across."""
    vec: int
    tpr: int
    slab_rows: int
    slabs: int
    tiles: int

    @property
    def blocks(self) -> int:
        return self.slabs * self.tiles


def _per16(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in 16 bytes: what a thread reads at once."""
    return 128 // torch.finfo(dtype).bits


@functools.lru_cache(maxsize=None)
def plan(rows: int, channels: int, dtype: torch.dtype) -> Plan:
    """The kernels' launch shape for ``rows`` rows of ``channels`` elements
    of ``dtype`` (a multiple of 16 bytes): 16-byte vectors; the fewest
    threads, a power of two up to 32, that span a row's vectors, so that a
    warp reads whole row segments; then as many slabs as bring the grid to
    ``TARGET_BLOCKS`` while every thread keeps ``MIN_ROWS`` rows (one slab
    where the batch has fewer)."""
    vec = _per16(dtype)
    nvec = channels // vec
    tpr = 1
    while tpr < min(nvec, 32):
        tpr *= 2
    tiles = -(-nvec // tpr)
    lanes = THREADS // tpr
    slabs = max(1, min(-(-TARGET_BLOCKS // tiles),
                       rows // (lanes * MIN_ROWS)))
    slab_rows = -(-rows // slabs)
    return Plan(vec, tpr, slab_rows, -(-rows // slab_rows), tiles)


# ---------------------------------------------------------------------------
# plain PyTorch twins

_C = (1, -1, 1, 1)   # a [C] vector against [B, C, H, W]


def batch_stats(x: torch.Tensor):
    """The fp32 batch mean and biased variance of each channel of x [B, C,
    H, W] over N, H and W (differentiable)."""
    x32 = x.float()
    return x32.mean(dim=(0, 2, 3)), x32.var(dim=(0, 2, 3), correction=0)


def affine(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
           weight: torch.Tensor, bias: torch.Tensor, eps: float,
           cd: torch.dtype):
    """x normalized by the statistics: the affine in fp32, rounded once to
    ``cd``, applied as ``x * a + b`` -> (y, rstd, a, b)."""
    rstd = torch.rsqrt(var + eps)
    a = (weight * rstd).to(cd)
    b = (bias - mean * weight * rstd).to(cd)
    return x * a.view(_C) + b.view(_C), rstd, a, b


def batch_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float, relu: bool):
    """The forward kernels' twin, ``AffineBN``'s train-mode formula ->
    (y in x's dtype, the fp32 batch mean, unbiased variance and rstd of each
    channel, a and b in x's dtype)."""
    mean, var = batch_stats(x)
    n = x.numel() // x.shape[1]
    y, rstd, a, b = affine(x, mean, var, weight, bias, eps, x.dtype)
    if relu:
        y = torch.relu(y)
    return y, mean, var * (n / max(n - 1, 1)), rstd, a, b


def batch_norm_bwd_reference(x: torch.Tensor, dy: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             weight: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, relu: bool):
    """The backward kernels' twin: with dz = dy where the forward's output
    (recomputed from x, a and b at its rounding points) is positive, or dy
    without the ReLU, and M rows a channel, dw = sum(dz * (x - mean)) * rstd,
    db = sum(dz), dx = (w * rstd) * ((dz - db / M) - (x - mean) * (rstd *
    dw / M)) in x's dtype -> (dx, dw, db)."""
    m = x.numel() // x.shape[1]
    dz = dy.float()
    if relu:
        dz = torch.where(x * a.view(_C) + b.view(_C) <= 0, 0.0, dz)
    xc = x.float() - mean.view(_C)
    db = dz.sum(dim=(0, 2, 3))
    dw = (dz * xc).sum(dim=(0, 2, 3)) * rstd
    dx = (weight * rstd).view(_C) * ((dz - (db / m).view(_C))
                                     - xc * (rstd * (dw / m)).view(_C))
    return dx.to(x.dtype), dw, db


# ---------------------------------------------------------------------------
# wrappers: a CUDA tensor launches the kernels or raises, a CPU tensor takes
# the plain version


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """t [B, C, H, W] when it is channels-last (its [B * H * W, C] rows
    row-major at ``t.data_ptr()``) from a 16-byte boundary, else a
    channels-last copy (counted in ``COPIES_BN``)."""
    global COPIES_BN
    if (t.is_contiguous(memory_format=torch.channels_last)
            and t.data_ptr() % 16 == 0):
        return t
    COPIES_BN += 1
    return t.clone(memory_format=torch.channels_last)


def _check(x: torch.Tensor, weight: torch.Tensor, bias) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"BatchNorm kernels take float32 or bfloat16; got "
                        f"{x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"BatchNorm kernels take a non-empty [B, C, H, W]; "
                         f"got {tuple(x.shape)}")
    c = x.shape[1]
    if c % _per16(x.dtype):
        raise ValueError(f"BatchNorm kernels take channels in 16-byte "
                         f"vectors ({_per16(x.dtype)} of {x.dtype}); got "
                         f"{c}")
    if not 0 < x.numel() // c < 2 ** 31:
        raise ValueError(f"BatchNorm rows of {tuple(x.shape)} are beyond "
                         f"the kernels (1 to 2**31 - 1)")
    for name, p in (("weight", weight), ("bias", bias)):
        if p is None:
            continue
        if p.device != x.device:
            raise ValueError(f"{name} on {p.device}, x on {x.device}")
        if p.dtype != torch.float32 or p.shape != (c,) or p.stride(0) != 1:
            raise ValueError(f"{name} must be a contiguous fp32 [{c}]; got "
                             f"{p.dtype} {tuple(p.shape)}")


def batch_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, relu: bool):
    """The forward alone, no autograd -> (y [x.shape] channels-last in x's
    dtype, the fp32 mean, unbiased variance and rstd [C], a and b [C] in x's
    dtype).  A CUDA tensor launches the forward kernels (a build or launch
    failure raises, and so does a dtype, device or shape they do not take);
    a CPU tensor runs ``batch_norm_reference``."""
    global LAUNCHES_BN
    if not _on_cuda(x, "batch_norm"):
        return batch_norm_reference(x, weight, bias, eps, relu)
    _check(x, weight, bias)
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    x = _channels_last(x)
    c = x.shape[1]
    m = x.numel() // c
    dev = x.device
    y = torch.empty_like(x)
    mean, var, rstd = torch.empty((3, c), dtype=torch.float32,
                                  device=dev).unbind(0)
    a, b = torch.empty((2, c), dtype=x.dtype, device=dev).unbind(0)
    p = plan(m, c, x.dtype)
    part = torch.empty((2, p.slabs, c), dtype=torch.float32, device=dev)
    ctx, stream = _launch_stream(dev)
    with ctx:
        err = lib.swat_bn_fwd(
            x.data_ptr(), _DTYPE_CODE[x.dtype], m, c, p.tpr, p.slab_rows,
            p.slabs, weight.data_ptr(), bias.data_ptr(), eps,
            m / max(m - 1, 1), int(relu), part.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), var.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), stream)
    _build.check(lib, err, "bn_fwd kernels")
    LAUNCHES_BN += 1
    return y, mean, var, rstd, a, b


def batch_norm_bwd(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, weight: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, relu: bool, need_params: bool = True):
    """The gradient of ``batch_norm_fwd`` for the output gradient ``dy`` ->
    (dx channels-last in x's dtype, dw, db in fp32; dw and db None unless
    ``need_params``).  A CUDA tensor launches the backward kernels; a CPU
    tensor runs ``batch_norm_bwd_reference``."""
    global LAUNCHES_BN_BWD
    if not _on_cuda(x, "batch_norm_bwd"):
        dx, dw, db = batch_norm_bwd_reference(x, dy, mean, rstd, weight, a,
                                              b, relu)
        return (dx, dw if need_params else None,
                db if need_params else None)
    _check(x, weight, None)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}, x {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    x, dy = _channels_last(x), _channels_last(dy)
    c = x.shape[1]
    m = x.numel() // c
    dev = x.device
    dx = torch.empty_like(x)
    dw = db = None
    if need_params:
        dw, db = torch.empty((2, c), dtype=torch.float32,
                             device=dev).unbind(0)
    p = plan(m, c, x.dtype)
    # the partial sums, then dx's coefficients
    scratch = torch.empty(2 * p.slabs * c + 3 * c, dtype=torch.float32,
                          device=dev)
    ctx, stream = _launch_stream(dev)
    with ctx:
        err = lib.swat_bn_bwd(
            x.data_ptr(), dy.data_ptr(), _DTYPE_CODE[x.dtype], m, c, p.tpr,
            p.slab_rows, p.slabs, mean.data_ptr(), rstd.data_ptr(),
            weight.data_ptr(), a.data_ptr(), b.data_ptr(), int(relu),
            scratch.data_ptr(), scratch.data_ptr() + 8 * p.slabs * c,
            dw.data_ptr() if need_params else None,
            db.data_ptr() if need_params else None, dx.data_ptr(), stream)
    _build.check(lib, err, "bn_bwd kernels")
    LAUNCHES_BN_BWD += 1
    return dx, dw, db


# ---------------------------------------------------------------------------
# the autograd Function


class BatchNormFunction(torch.autograd.Function):
    """The forward kernels with the backward kernels as their gradient ->
    (y, the batch mean, the unbiased batch variance), the statistics
    without gradient.  Saves x, the fp32 weight, the fp32 mean and rstd and
    a and b of each channel."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, relu: bool):
        y, mean, var, rstd, a, b = batch_norm_fwd(x, weight, bias, eps, relu)
        ctx.save_for_backward(x, weight, mean, rstd, a, b)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        need_dx, need_w, need_b = ctx.needs_input_grad[:3]
        if dy is None:
            return None, None, None, None, None
        x, weight, mean, rstd, a, b = ctx.saved_tensors
        # dx always: in a tower whose BatchNorm trains, its input takes a
        # gradient too
        dx, dw, db = batch_norm_bwd(x, dy, mean, rstd, weight, a, b,
                                    ctx.relu, need_w or need_b)
        return (dx if need_dx else None, dw if need_w else None,
                db if need_b else None, None, None)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, relu: bool):
    """Train-mode BatchNorm of x [B, C, H, W] over N, H and W with fp32
    ``weight`` and ``bias``, then max(., 0) where ``relu`` -> (y in x's
    dtype, the fp32 batch mean and unbiased batch variance [C], without
    gradient).  Differentiable through ``BatchNormFunction`` where a
    gradient will be taken; else the forward alone, which saves nothing."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return BatchNormFunction.apply(x, weight, bias, eps, relu)
    y, mean, var, _, _, _ = batch_norm_fwd(x, weight, bias, eps, relu)
    return y, mean, var
