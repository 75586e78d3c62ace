"""Packed-head multi-head attention, forward and backward.

Counterpart of ``swat_tpu/kernels/flash_attention.py``: ``mha_qkv`` (and
``mha_packed``, its form for q, k, v given apart) replaces the Pallas TPU
kernel ``_mha_fwd_kernel`` (launched by
``_mha_fwd``) with the hand-written CUDA kernel in
``swat_tpu_torch/csrc/mha_fwd.cu``, and its custom-VJP partner
``_mha_bwd_kernel`` (launched by ``_mha_bwd``) with
``swat_tpu_torch/csrc/mha_bwd.cu``.  The two are paired in one
``torch.autograd.Function`` over the packed qkv (``mha_qkv``) that saves
the inputs only, as ``_mha.defvjp`` does: the backward recomputes the
softmax statistics.
``mha_packed_reference`` and ``mha_bwd_reference`` are the same math in
plain PyTorch: the CPU path, and the oracles the kernels are held against on
the card.

The heads-first kernels (``_fwd_kernel``, ``_bwd_kernel``) are not ported
yet (ROADMAP, Queue B).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

# kernel launches since the last reset, one counter per kernel; a run sets
# them to 0 and reads them back to show that its attention went through the
# kernels
LAUNCHES = 0
LAUNCHES_BWD = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D] in fp32."""
    b, s, hd = t.shape
    return t.reshape(b, s, heads, hd // heads).transpose(1, 2).float()


def _merge_heads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, S, D] fp32 -> [B, S, H*D] in ``dtype``, contiguous."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d).to(dtype)


def _softmax(q, k, heads, causal):
    """fp32 p = softmax(q.k^T * scale) with keys past the row masked to
    -1e30 when causal -> (p [B, H, S, S], keep mask or None)."""
    s = q.shape[1]
    scale = 1.0 / (q.shape[2] // heads) ** 0.5
    scores = torch.matmul(_split_heads(q, heads),
                          _split_heads(k, heads).transpose(-1, -2)) * scale
    keep = None
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return p / p.sum(dim=-1, keepdim=True), keep


def mha_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel: fp32 scores, keys past S
    (none here, S is unpadded) and, when causal, keys past the row masked
    to -1e30, fp32 softmax, p rounded to the input dtype, p.v accumulated
    in fp32, output in the input dtype."""
    p, _ = _softmax(q, k, heads, causal)
    p = p.to(q.dtype).float()
    return _merge_heads(torch.matmul(p, _split_heads(v, heads)), q.dtype)


def mha_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, heads: int, causal: bool = False):
    """Plain PyTorch twin of the backward kernel, with the TPU kernel's
    rounding points: p recomputed in fp32; pb = p rounded to the input
    dtype, used only in dv = pb^T.do; dp = do.v^T; delta = rowsum(p * dp)
    with the fp32 p; ds = p * (dp - delta) * scale, zeroed where masked and
    rounded to the input dtype; dq = ds.k, dk = ds^T.q.  Products
    accumulate in fp32; dq, dk, dv come out in the input dtype."""
    scale = 1.0 / (q.shape[2] // heads) ** 0.5
    p, keep = _softmax(q, k, heads, causal)
    dof = _split_heads(do, heads)
    pb = p.to(q.dtype).float()
    dv = torch.matmul(pb.transpose(-1, -2), dof)
    dp = torch.matmul(dof, _split_heads(v, heads).transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    if keep is not None:
        ds = ds.masked_fill(~keep, 0.0)
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, _split_heads(k, heads))
    dk = torch.matmul(ds.transpose(-1, -2), _split_heads(q, heads))
    return tuple(_merge_heads(t, q.dtype) for t in (dq, dk, dv))


def _check_inputs(q, k, v, heads):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must share a dtype in float32/bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v must be [B, S, H*D] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hd = q.shape
    if heads <= 0 or hd % heads:
        raise ValueError(f"H*D={hd} is not divisible by heads={heads}")
    if hd // heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd // heads} not supported by the "
                         f"kernel (supported: {_HEAD_DIMS})")
    if b == 0 or s == 0:
        raise ValueError("empty batch or sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def _on_cuda(q: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (which takes the plain
    twin); any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    return True


def mha_packed_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int, causal: bool = False) -> torch.Tensor:
    """The forward alone, no autograd: a CUDA tensor launches the kernel
    (a build or launch failure raises), a CPU tensor runs
    ``mha_packed_reference``.  -> out [B, S, H*D], contiguous."""
    global LAUNCHES
    if not _on_cuda(q, "mha_packed"):
        return mha_packed_reference(q, k, v, heads, causal)
    _check_inputs(q, k, v, heads)
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    b, s, hd = q.shape
    d = hd // heads
    out = torch.empty((b, s, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.swat_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, heads, d, _DTYPE_CODE[q.dtype],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            1.0 / d ** 0.5, int(causal), stream)
    _build.check(lib, err, "mha_fwd kernel")
    LAUNCHES += 1
    return out


def mha_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, heads: int,
                   causal: bool = False) -> torch.Tensor:
    """The gradient of ``mha_packed`` for the output gradient ``do`` ->
    dqkv [B, S, 3*H*D]: dq, dk and dv side by side, the layout of the qkv
    projection's output, so that it is that output's gradient as it
    stands.

    A CUDA tensor launches the backward kernel (a build or launch failure
    raises), which writes each third in place.  A CPU tensor runs
    ``mha_bwd_reference`` and joins its three results."""
    global LAUNCHES_BWD
    if not _on_cuda(q, "mha_packed_bwd"):
        return torch.cat(mha_bwd_reference(q, k, v, do, heads, causal), -1)
    _check_inputs(q, k, v, heads)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q: got {tuple(do.shape)} "
                         f"{do.dtype} on {do.device}")
    if do.stride(2) != 1:
        do = do.contiguous()
    b, s, hd = q.shape
    dqkv = torch.empty((b, s, 3 * hd), dtype=q.dtype, device=q.device)
    dq, dk, dv = dqkv.split(hd, dim=-1)
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    d = hd // heads
    stats = torch.empty(3 * b * heads * s, dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.swat_mha_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            b, s, heads, d, _DTYPE_CODE[q.dtype],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1),
            dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
            dv.stride(0), dv.stride(1), 1.0 / d ** 0.5, int(causal), stream)
    _build.check(lib, err, "mha_bwd kernel")
    LAUNCHES_BWD += 1
    return dqkv


def _thirds(qkv: torch.Tensor):
    """q, k, v: the three [B, S, H*D] thirds of qkv, strided views."""
    return qkv.chunk(3, dim=-1)


class PackedAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (the
    port of ``_mha.defvjp(_mha_fwd, _mha_bwd)``), over the packed qkv
    [B, S, 3*H*D] of the towers' qkv projection: q, k and v are cut from it
    inside, and the backward kernel's one dqkv output is qkv's gradient,
    with no join of three.  Only qkv is saved: the backward recomputes the
    softmax statistics."""

    @staticmethod
    def forward(ctx, qkv, heads: int, causal: bool):
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.causal = heads, causal
        return mha_packed_fwd(*_thirds(qkv), heads, causal)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return (mha_packed_bwd(*_thirds(qkv), do, ctx.heads, ctx.causal),
                None, None)


def mha_qkv(qkv: torch.Tensor, heads: int,
            causal: bool = False) -> torch.Tensor:
    """Fused multi-head attention over the packed qkv [B, S, 3*H*D] (q, k,
    v side by side, each H*D wide), differentiable -> out [B, S, H*D],
    contiguous, in the input dtype.  The towers' attention.  A CUDA tensor
    launches the forward kernel, and its gradient the backward kernel; a
    build or launch failure raises.  A CPU tensor runs the two plain twins
    inside the same autograd Function."""
    return PackedAttention.apply(qkv, heads, causal)


def mha_qkv_reference(qkv: torch.Tensor, heads: int,
                      causal: bool = False) -> torch.Tensor:
    """``mha_packed_reference`` over the packed qkv, differentiated by
    torch's autograd: the plain attention the kernels are held against."""
    return mha_packed_reference(*_thirds(qkv), heads, causal)


def mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               heads: int, causal: bool = False) -> torch.Tensor:
    """``mha_qkv`` for q, k, v given apart, each [B, S, H*D]: they are
    joined into one qkv first (a copy; the towers call ``mha_qkv`` on the
    projection's output and copy nothing)."""
    return mha_qkv(torch.cat([q, k, v], dim=-1), heads, causal)
