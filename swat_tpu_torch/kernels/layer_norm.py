"""LayerNorm over the last dimension, forward and backward, in one
hand-written CUDA kernel pair (``swat_tpu_torch/csrc/layer_norm.cu``).

No TPU kernel stands behind it: ``swat_tpu`` leaves LayerNorm
(``functional._layer_norm``) to XLA, which fuses its passes.  The towers'
``models/clip.py::layer_norm`` runs the same formula in fp32 as separate
PyTorch passes, which autograd differentiates one by one; on a CUDA tensor
it calls ``layer_norm`` below instead, one autograd Function over the two
kernels.  The forward kernel reads x and writes y (and each row's fp32 mu
and rstd when a gradient will be taken); the backward kernel reads x, dy
and those statistics and writes dx, and sums the parameter gradients in
fixed row blocks that a second kernel joins in order (no atomics: the same
inputs give the same bits).  x, y, dy and dx share one dtype, fp32 or bf16
(the towers' compute dtype).  Where no input needs a gradient (eval,
prompts, ``torch.no_grad``), nothing is saved.

The plain versions are the kernels' twins: ``layer_norm_reference`` is the
formula of ``models/clip.py::layer_norm`` (fp32 statistics, the one-pass
clamped variance or the exact two-pass one, ``(x - mu) * (rstd * w) + b``
rounded once to the output dtype), and ``layer_norm_bwd_reference`` its
analytic gradient at the kernels' rounding points (dx rounded once to x's
dtype, fp32 dw and db).  A CPU tensor takes them inside the same Function.
"""

from __future__ import annotations

from typing import Optional

import torch

from swat_tpu_torch.kernels.flash_attention import _launch_stream, _on_cuda

# launches since the last reset: forward calls, backward calls (a backward
# call is one kernel, and the join of the parameter gradients when they
# are asked for)
LAUNCHES_LN = 0
LAUNCHES_LN_BWD = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' constants (csrc/layer_norm.cu): warps a block, elements of a
# row a lane holds, rows whose parameter gradients one backward block sums,
# the join's chunks
WARPS = 8
PER_LANE = 32
ROWS_PER_BLOCK = 64
JOIN_WARPS = 8
# the widest row: all warps of a block with full lanes
MAX_WIDTH = WARPS * 32 * PER_LANE


def plan(width: int, dtype: torch.dtype):
    """(warps a row, 16-byte vectors a lane) of the kernel for rows of
    ``width`` elements of ``dtype``: one warp, else 2, 4 or 8; one or two
    with as few vectors a lane as hold the row, more with full lanes
    (``plan`` of the source)."""
    vec = 16 * 8 // torch.finfo(dtype).bits
    max_iters = PER_LANE // vec
    nvec = -(-width // vec)
    group = 1
    while group * 32 * max_iters < nvec:
        group *= 2
    if group > WARPS:
        raise ValueError(f"LayerNorm width {width} is beyond the kernels' "
                         f"{MAX_WIDTH}")
    return group, (-(-nvec // (32 * group)) if group <= 2 else max_iters)


# ---------------------------------------------------------------------------
# plain PyTorch twins


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, fast: bool, eps: float,
                         out_dtype: torch.dtype):
    """The forward kernel's twin, the formula of ``clip.layer_norm`` ->
    (y in ``out_dtype``, fp32 mu and rstd of each row, [*x.shape[:-1]]; rstd
    negated where the fast variance was clamped at 0)."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    if fast:
        var = (x * x).mean(dim=-1, keepdim=True) - mu * mu
        clamped = var < 0
        var = var.clamp_min(0.0)
    else:
        d = x - mu
        var = (d * d).mean(dim=-1, keepdim=True)
        clamped = torch.zeros_like(var, dtype=torch.bool)
    rstd = torch.rsqrt(var + eps)
    y = (x - mu) * (rstd * weight.float()) + bias.float()
    return (y.to(out_dtype), mu.squeeze(-1),
            torch.where(clamped, -rstd, rstd).squeeze(-1))


def layer_norm_bwd_reference(x: torch.Tensor, dy: torch.Tensor,
                             mu: torch.Tensor, rstd: torch.Tensor,
                             weight: torch.Tensor):
    """The backward kernel's twin: with g = dy * w and xhat = (x - mu) *
    |rstd|, dx = |rstd| * ((g - mean(g)) - xhat * mean(g * xhat)) in x's
    dtype (the variance term dropped in rows whose rstd is negative, where
    the clamp passes no gradient), dw = sum(dy * xhat) and db = sum(dy) over
    the rows in fp32."""
    w = x.shape[-1]
    xf, dyf = x.float().reshape(-1, w), dy.float().reshape(-1, w)
    mu, rs = mu.reshape(-1, 1), rstd.reshape(-1, 1)
    r = rs.abs()
    xhat = (xf - mu) * r
    g = dyf * weight.float()
    m1 = g.sum(-1, keepdim=True) / w
    m2 = torch.where(rs > 0, (g * xhat).sum(-1, keepdim=True) / w, 0.0)
    dx = r * ((g - m1) - xhat * m2)
    return (dx.to(x.dtype).reshape(x.shape), (dyf * xhat).sum(0),
            dyf.sum(0))


# ---------------------------------------------------------------------------
# wrappers: a CUDA tensor launches the kernel or raises, a CPU tensor takes
# the plain version


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as [T, W] rows with unit column stride, a view where t allows it
    (the class token ``x[:, 0]`` of [B, S, W] is one), else a copy."""
    if t.dim() == 2 and t.stride(1) == 1:
        return t
    rows = t.reshape(-1, t.shape[-1])
    return rows if rows.stride(1) == 1 else rows.contiguous()


def _check(x: torch.Tensor, weight: torch.Tensor, bias, out_dtype) -> None:
    if x.dtype not in _DTYPE_CODE or out_dtype != x.dtype:
        raise TypeError(f"LayerNorm kernels take float32 or bfloat16, the "
                        f"output in x's dtype; got x {x.dtype}, output "
                        f"{out_dtype}")
    if x.dim() == 0 or not 0 < x.shape[-1] <= MAX_WIDTH:
        raise ValueError(f"LayerNorm rows of {tuple(x.shape)[-1:]} elements "
                         f"are beyond the kernels (1 to {MAX_WIDTH})")
    w = x.shape[-1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p is None:
            continue
        if p.device != x.device:
            raise ValueError(f"{name} on {p.device}, x on {x.device}")
        if p.dtype != torch.float32 or p.shape != (w,) or p.stride(0) != 1:
            raise ValueError(f"{name} must be a contiguous fp32 [{w}]; got "
                             f"{p.dtype} {tuple(p.shape)}")


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   fast: bool, eps: float, out_dtype: torch.dtype,
                   stats: bool = True):
    """The forward alone, no autograd -> (y [x.shape] in ``out_dtype``,
    mu, rstd), the statistics None unless ``stats``.  A CUDA tensor
    launches the forward kernel (a build or launch failure raises, and so
    does a dtype, device or width it does not take, or an ``out_dtype``
    other than x's); a CPU tensor runs ``layer_norm_reference``."""
    global LAUNCHES_LN
    if not _on_cuda(x, "layer_norm"):
        y, mu, rstd = layer_norm_reference(x, weight, bias, fast, eps,
                                           out_dtype)
        return (y, mu, rstd) if stats else (y, None, None)
    _check(x, weight, bias, out_dtype)
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    rows = _rows(x)
    t, w = rows.shape
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    mu = rstd = None
    if stats:
        mu = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
    if t:
        ctx, stream = _launch_stream(x.device)
        with ctx:
            err = lib.swat_ln_fwd(
                rows.data_ptr(), rows.stride(0), _DTYPE_CODE[x.dtype],
                weight.data_ptr(), bias.data_ptr(), y.data_ptr(), w,
                mu.data_ptr() if stats else None,
                rstd.data_ptr() if stats else None, t, w, int(fast), eps,
                stream)
        _build.check(lib, err, "ln_fwd kernel")
        LAUNCHES_LN += 1
    return y, mu, rstd


def layer_norm_bwd(x: torch.Tensor, dy: torch.Tensor, mu: torch.Tensor,
                   rstd: torch.Tensor, weight: torch.Tensor,
                   need_dx: bool = True, need_params: bool = True):
    """The gradient of ``layer_norm_fwd`` for the output gradient ``dy`` ->
    (dx in x's dtype, dw, db in fp32), each None where not asked for.  A
    CUDA tensor launches the backward kernel and, for dw and db, their join
    (ceil(T / 64) x 2 x W floats of scratch); a CPU tensor runs
    ``layer_norm_bwd_reference``."""
    global LAUNCHES_LN_BWD
    if not _on_cuda(x, "layer_norm_bwd"):
        dx, dw, db = layer_norm_bwd_reference(x, dy, mu, rstd, weight)
        return (dx if need_dx else None, dw if need_params else None,
                db if need_params else None)
    _check(x, weight, None, dy.dtype)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy must match x: got {tuple(dy.shape)} on "
                         f"{dy.device}, x {tuple(x.shape)} on {x.device}")
    if mu.shape != x.shape[:-1] or not (mu.is_contiguous()
                                        and rstd.is_contiguous()):
        raise ValueError("mu and rstd must be the forward's, contiguous "
                         f"{tuple(x.shape[:-1])}")
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    xr, dyr = _rows(x), _rows(dy)
    t, w = xr.shape
    dev = x.device
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev) if need_dx else None
    dw = db = part = None
    if need_params:
        # the join writes every column; no rows leave them 0
        new = torch.empty if t else torch.zeros
        dw = new(w, dtype=torch.float32, device=dev)
        db = new(w, dtype=torch.float32, device=dev)
        part = torch.empty((-(-t // ROWS_PER_BLOCK), 2, w),
                           dtype=torch.float32, device=dev)
    if t and (need_dx or need_params):
        ctx, stream = _launch_stream(dev)
        with ctx:
            err = lib.swat_ln_bwd(
                xr.data_ptr(), xr.stride(0), _DTYPE_CODE[x.dtype],
                dyr.data_ptr(), dyr.stride(0),
                mu.data_ptr(), rstd.data_ptr(), weight.data_ptr(),
                dx.data_ptr() if need_dx else None, w,
                part.data_ptr() if need_params else None,
                dw.data_ptr() if need_params else None,
                db.data_ptr() if need_params else None, t, w, stream)
        _build.check(lib, err, "ln_bwd kernel")
        LAUNCHES_LN_BWD += 1
    return dx, dw, db


# ---------------------------------------------------------------------------
# the autograd Function


class LayerNormFunction(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  Saves
    x (alive anyway as the residual stream), the fp32 weight and each
    row's mu and rstd: T x 8 bytes beside x."""

    @staticmethod
    def forward(ctx, x, weight, bias, fast: bool, eps: float,
                out_dtype: torch.dtype):
        y, mu, rstd = layer_norm_fwd(x, weight, bias, fast, eps, out_dtype)
        ctx.save_for_backward(x, weight, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mu, rstd = ctx.saved_tensors
        need_dx, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = layer_norm_bwd(x, dy, mu, rstd, weight, need_dx,
                                    need_w or need_b)
        return (dx, dw if need_w else None, db if need_b else None, None,
                None, None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               fast: bool, eps: float = 1e-5,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm of x's last dimension with fp32 ``weight`` and ``bias``
    -> [x.shape] in ``out_dtype`` (x's dtype by default; on a CUDA tensor
    it must be x's).  ``fast``: the one-pass clamped variance, else the
    exact two-pass one.  Differentiable through ``LayerNormFunction`` where
    a gradient will be taken; else the forward alone, which saves
    nothing."""
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFunction.apply(x, weight, bias, fast, eps, out_dtype)
    return layer_norm_fwd(x, weight, bias, fast, eps, out_dtype,
                          stats=False)[0]
