"""Fused multi-head attention, forward and backward, in both layouts.

Counterpart of ``swat_tpu/kernels/flash_attention.py``.  Its four Pallas
TPU kernels each have a hand-written CUDA kernel here:

* ``_mha_fwd_kernel`` (packed-head forward, launched by ``_mha_fwd``) ->
  ``swat_tpu_torch/csrc/mha_fwd.cu``, wrapper ``mha_packed_fwd``;
* ``_mha_bwd_kernel`` (its custom-VJP partner, ``_mha_bwd``) ->
  ``csrc/mha_bwd.cu``, wrapper ``mha_packed_bwd``;
* ``_fwd_kernel`` (heads-first forward, ``_attention_fwd``) ->
  ``csrc/flash_fwd.cu``, wrapper ``flash_attention_fwd``;
* ``_bwd_kernel`` (heads-first backward, in its two forms: the gradient of
  ``flash_attention`` and, with ``keep_dtype``, the backward of
  ``mha_packed(bwd="fused")``) -> ``csrc/flash_bwd.cu``, wrapper
  ``flash_attention_bwd``.

The packed-head pair works on q, k, v in the [B, S, H*D] layout of the qkv
projection and is one ``torch.autograd.Function`` over the packed qkv
(``mha_qkv``), the towers' attention; the heads-first pair works on
[B, H, S, D] of any strides and is another (``flash_attention``).  Both
save the inputs only, as ``_mha.defvjp`` / ``_attention.defvjp`` do: the
backward recomputes the softmax statistics.

The two families differ in where they round below fp32.  The packed-head
forward rounds the normalised p to the input dtype before p.v, and its
backward rounds pb and ds; the heads-first forward takes its operands to
fp32 and rounds nothing but the output, and its backward rounds pb and ds
only in the ``keep_dtype`` form.  The plain PyTorch versions
(``mha_packed_reference``, ``mha_bwd_reference``,
``flash_attention_reference``, ``flash_attention_bwd_reference``) encode
exactly that: they are the CPU path, and the oracles the kernels are held
against on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

NEG_INF = -1e30

# kernel launches since the last reset, one counter per kernel; a run sets
# them to 0 and reads them back to show that its attention went through the
# kernels
LAUNCHES = 0            # packed-head forward
LAUNCHES_BWD = 0        # packed-head backward
LAUNCHES_FLASH = 0      # heads-first forward
LAUNCHES_FLASH_BWD = 0  # heads-first backward

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64)
# the forward kernels keep a row block's scores and the head's k or v in
# shared memory: the longest sequence whose fp32 form still fits a block
MAX_FWD_SEQ = 480
# the backward kernels take the same lengths.  Up to these one block owns a
# whole (batch, head) and needs no scratch; longer rows go through a pair of
# kernels that hand the softmax statistics over in fp32 scratch
# (kHeadSeqFp32 / kHeadSeqBf16 of csrc/attention_bwd.cuh)
_BWD_ONE_BLOCK_SEQ = {torch.float32: 80, torch.bfloat16: 128}
BWD_MODES = ("pallas", "fused", "xla")


# ---------------------------------------------------------------------------
# the math, over fp32 [B, H, S, D] operands


def _heads_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> its [B, H, S, D] view (no copy)."""
    b, s, hd = t.shape
    return t.reshape(b, s, heads, hd // heads).transpose(1, 2)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D] in fp32."""
    return _heads_view(t, heads).float()


def _merge_heads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, S, D] fp32 -> [B, S, H*D] in ``dtype``, contiguous."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d).to(dtype)


def _round(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """fp32 ``t`` rounded to ``dtype`` and back; None rounds nothing."""
    return t if dtype is None else t.to(dtype).float()


def _softmax(q, k, causal):
    """fp32 p = softmax(q.k^T * scale) over fp32 [B, H, S, D] operands,
    with keys past the row masked to -1e30 when causal -> (p [B, H, S, S],
    keep mask or None)."""
    s = q.shape[2]
    scale = 1.0 / q.shape[3] ** 0.5
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    keep = None
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return p / p.sum(dim=-1, keepdim=True), keep


def _fwd_math(q, k, v, causal, round_dtype):
    """out = p.v in fp32; p is rounded to ``round_dtype`` first (None:
    kept in fp32)."""
    p, _ = _softmax(q, k, causal)
    return torch.matmul(_round(p, round_dtype), v)


def _bwd_math(q, k, v, do, causal, round_dtype):
    """dq, dk, dv in fp32 from fp32 [B, H, S, D] operands: p recomputed;
    pb = p rounded to ``round_dtype``, used only in dv = pb^T.do;
    dp = do.v^T; delta = rowsum(p * dp) with the fp32 p;
    ds = p * (dp - delta) * scale, zeroed where masked and rounded to
    ``round_dtype``; dq = ds.k, dk = ds^T.q.  ``round_dtype`` None rounds
    neither."""
    scale = 1.0 / q.shape[3] ** 0.5
    p, keep = _softmax(q, k, causal)
    dv = torch.matmul(_round(p, round_dtype).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    if keep is not None:
        ds = ds.masked_fill(~keep, 0.0)
    ds = _round(ds, round_dtype)
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# plain PyTorch versions


def mha_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the packed-head forward kernel: fp32 scores,
    keys past S (none here, S is unpadded) and, when causal, keys past the
    row masked to -1e30, fp32 softmax, p rounded to the input dtype, p.v
    accumulated in fp32, output in the input dtype."""
    out = _fwd_math(_split_heads(q, heads), _split_heads(k, heads),
                    _split_heads(v, heads), causal, q.dtype)
    return _merge_heads(out, q.dtype)


def mha_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, heads: int, causal: bool = False):
    """Plain PyTorch twin of the packed-head backward kernel, with the TPU
    kernel's rounding points (``_bwd_math`` with the input dtype).
    Products accumulate in fp32; dq, dk, dv come out in the input dtype."""
    grads = _bwd_math(*(_split_heads(t, heads) for t in (q, k, v, do)),
                      causal, q.dtype)
    return tuple(_merge_heads(t, q.dtype) for t in grads)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              causal: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the heads-first forward kernel over
    [B, H, S, D]: the operands taken to fp32, the fp32 p NOT rounded before
    p.v (where the packed-head forward rounds it), output in the input
    dtype.  Equal to ``mha_packed_reference`` in fp32, different in
    bf16."""
    return _fwd_math(q.float(), k.float(), v.float(), causal,
                     None).to(q.dtype)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, do: torch.Tensor,
                                  causal: bool = False,
                                  keep_dtype: bool = False):
    """Plain PyTorch twin of the heads-first backward kernel over
    [B, H, S, D], in its two forms: ``keep_dtype=False``, the gradient of
    ``flash_attention`` (everything in fp32, pb and ds not rounded), and
    ``keep_dtype=True``, the backward of ``mha_packed(bwd="fused")`` (pb
    and ds rounded to the input dtype: the packed-head backward's rounding
    points).  In fp32 the two are one.  -> dq, dk, dv [B, H, S, D] in the
    input dtype."""
    grads = _bwd_math(q.float(), k.float(), v.float(), do.float(), causal,
                      q.dtype if keep_dtype else None)
    return tuple(t.to(q.dtype) for t in grads)


# ---------------------------------------------------------------------------
# wrappers: a CUDA tensor launches the kernel or raises, a CPU tensor takes
# the plain version


def _check_dtype_device(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must share a dtype in float32/bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")


def _check_head_dim(d: int) -> None:
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel "
                         f"(supported: {_HEAD_DIMS})")


def _check_fwd_seq(s: int, what: str = "forward") -> None:
    if s > MAX_FWD_SEQ:
        raise ValueError(f"sequence length {s} is beyond what the {what} "
                         f"kernel holds in shared memory ({MAX_FWD_SEQ})")


def _bwd_stats_shape(batch: int, heads: int, seq: int, dtype: torch.dtype):
    """Shape of the fp32 scratch one backward call needs for the softmax
    statistics (m, 1 / l, delta of every row): empty where one block takes a
    whole head."""
    rows = 0 if seq <= _BWD_ONE_BLOCK_SEQ[dtype] else batch * heads * seq
    return (3, rows)


def _check_inputs(q, k, v, heads):
    _check_dtype_device(q, k, v)
    if q.dim() != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v must be [B, S, H*D] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hd = q.shape
    if heads <= 0 or hd % heads:
        raise ValueError(f"H*D={hd} is not divisible by heads={heads}")
    _check_head_dim(hd // heads)
    if b == 0 or s == 0:
        raise ValueError("empty batch or sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def _check_heads_first(q, k, v):
    _check_dtype_device(q, k, v)
    if q.dim() != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v must be [B, H, S, D] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_head_dim(q.shape[3])
    if 0 in q.shape[:3]:
        raise ValueError("empty batch, heads or sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def _check_do(do, q, last: int) -> torch.Tensor:
    """``do`` checked against q; made contiguous when its last dimension is
    strided."""
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q: got {tuple(do.shape)} "
                         f"{do.dtype} on {do.device}")
    return do if do.stride(last) == 1 else do.contiguous()


def _on_cuda(q: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (which takes the plain
    twin); any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    return True


def _empty_in_order_of(t: torch.Tensor) -> torch.Tensor:
    """A dense uninitialised tensor of t's shape and dtype whose dimensions
    lie in memory in t's order (so a transposed view of [B, S, H, D] gets an
    output that transposes back without a copy): what ``empty_like`` gives
    for a view that is not dense."""
    return torch.empty_like(t)


def _launch_stream(device: torch.device):
    """-> (a context in which ``device`` is the current one, its current
    stream's handle).  A launch costs the host more than these kernels cost
    the card at the towers' shapes, so the usual case (the device is
    current already) does no more than look the stream up."""
    ctx = (contextlib.nullcontext()
           if device.index == torch.cuda.current_device()
           else torch.cuda.device(device))
    return ctx, torch._C._cuda_getCurrentRawStream(device.index)


def mha_packed_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int, causal: bool = False) -> torch.Tensor:
    """The packed-head forward alone, no autograd: a CUDA tensor launches
    the kernel (a build or launch failure raises), a CPU tensor runs
    ``mha_packed_reference``.  -> out [B, S, H*D], contiguous."""
    global LAUNCHES
    if not _on_cuda(q, "mha_packed"):
        return mha_packed_reference(q, k, v, heads, causal)
    _check_inputs(q, k, v, heads)
    _check_fwd_seq(q.shape[1])
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    b, s, hd = q.shape
    d = hd // heads
    out = torch.empty((b, s, hd), dtype=q.dtype, device=q.device)
    ctx, stream = _launch_stream(q.device)
    with ctx:
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

    A CUDA tensor launches the packed-head backward kernel (a build or
    launch failure raises, and so does S > ``MAX_FWD_SEQ``), which writes
    each third in place: one launch and no scratch for rows up to
    ``_BWD_ONE_BLOCK_SEQ``, two launches and 3*B*H*S floats of statistics
    beyond.  A CPU tensor runs ``mha_bwd_reference`` and joins its three
    results."""
    global LAUNCHES_BWD
    if not _on_cuda(q, "mha_packed_bwd"):
        return torch.cat(mha_bwd_reference(q, k, v, do, heads, causal), -1)
    _check_inputs(q, k, v, heads)
    _check_fwd_seq(q.shape[1], "backward")
    do = _check_do(do, q, 2)
    b, s, hd = q.shape
    dqkv = torch.empty((b, s, 3 * hd), dtype=q.dtype, device=q.device)
    dq, dk, dv = dqkv.split(hd, dim=-1)
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    d = hd // heads
    stats = torch.empty(_bwd_stats_shape(b, heads, s, q.dtype),
                        dtype=torch.float32, device=q.device)
    ctx, stream = _launch_stream(q.device)
    with ctx:
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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """The heads-first forward alone, no autograd, over [B, H, S, D] of any
    strides with a unit last stride: a CUDA tensor launches the kernel (a
    build or launch failure raises), a CPU tensor runs
    ``flash_attention_reference``.  -> out [B, H, S, D], dense, its
    dimensions in memory in q's order."""
    global LAUNCHES_FLASH
    if not _on_cuda(q, "flash_attention"):
        return flash_attention_reference(q, k, v, causal)
    _check_heads_first(q, k, v)
    _check_fwd_seq(q.shape[2])
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    b, h, s, d = q.shape
    out = _empty_in_order_of(q)
    ctx, stream = _launch_stream(q.device)
    with ctx:
        err = lib.swat_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, d, _DTYPE_CODE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], 1.0 / d ** 0.5, int(causal), stream)
    _build.check(lib, err, "flash_fwd kernel")
    LAUNCHES_FLASH += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, causal: bool = False,
                        keep_dtype: bool = False, out=None):
    """dq, dk, dv [B, H, S, D] of the heads-first attention for the output
    gradient ``do``, in the form ``keep_dtype`` names (see
    ``flash_attention_bwd_reference``).  A CUDA tensor launches the
    heads-first backward kernel (a build or launch failure raises, and so
    does S > ``MAX_FWD_SEQ``; scratch as ``mha_packed_bwd``), a CPU tensor
    runs the plain version.  ``out``: three [B, H, S, D] views to
    write into (the thirds of a packed gradient); else each gradient is a
    dense tensor with its dimensions in its operand's order."""
    global LAUNCHES_FLASH_BWD
    if not _on_cuda(q, "flash_attention_bwd"):
        grads = flash_attention_bwd_reference(q, k, v, do, causal,
                                              keep_dtype)
        if out is not None:
            for dst, g in zip(out, grads):
                dst.copy_(g)
            return tuple(out)
        return grads
    _check_heads_first(q, k, v)
    _check_fwd_seq(q.shape[2], "backward")
    do = _check_do(do, q, 3)
    if out is None:
        out = tuple(_empty_in_order_of(t) for t in (q, k, v))
    from swat_tpu_torch.kernels import _build

    lib = _build.load()
    b, h, s, d = q.shape
    stats = torch.empty(_bwd_stats_shape(b, h, s, q.dtype),
                        dtype=torch.float32, device=q.device)
    strides = [x for t in (q, k, v, do, *out) for x in t.stride()[:3]]
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    ctx, stream = _launch_stream(q.device)
    with ctx:
        err = lib.swat_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            stats.data_ptr(), b, s, h, d, _DTYPE_CODE[q.dtype], c_strides,
            1.0 / d ** 0.5, int(causal), int(keep_dtype), stream)
    _build.check(lib, err, "flash_bwd kernel")
    LAUNCHES_FLASH_BWD += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# autograd Functions


class FlashAttention(torch.autograd.Function):
    """The heads-first forward kernel with the heads-first backward kernel
    (``keep_dtype=False``) as its gradient: the port of
    ``_attention.defvjp(_attention_fwd, _attention_bwd)``.  Only q, k, v
    are saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, do, ctx.causal, False), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention, differentiable.  q, k, v: [B, H, S, D] of any
    strides with a unit last stride (transposed views of a qkv projection
    are read in place) -> [B, H, S, D] in the input dtype.  A CUDA tensor
    launches the heads-first kernels; a CPU tensor runs their plain twins
    inside the same autograd Function."""
    return FlashAttention.apply(q, k, v, causal)


def _thirds(qkv: torch.Tensor):
    """q, k, v: the three [B, S, H*D] thirds of qkv, strided views."""
    return qkv.chunk(3, dim=-1)


def _fused_bwd(q, k, v, do, heads: int, causal: bool) -> torch.Tensor:
    """The backward of ``bwd="fused"`` -> dqkv [B, S, 3*H*D]: the
    heads-first backward kernel on the [B, H, S, D] views of the packed
    operands, feeding on the input dtype below fp32 (``_mha_fast_bwd``'s
    ``keep_dtype``), writing the thirds of one packed gradient."""
    b, s, hd = q.shape
    dqkv = torch.empty((b, s, 3 * hd), dtype=q.dtype, device=q.device)
    if do.stride(2) != 1:
        do = do.contiguous()
    flash_attention_bwd(
        *(_heads_view(t, heads) for t in (q, k, v, do)), causal,
        keep_dtype=q.dtype != torch.float32,
        out=tuple(_heads_view(t, heads) for t in _thirds(dqkv)))
    return dqkv


def _xla_bwd(q, k, v, do, heads: int, causal: bool) -> torch.Tensor:
    """The backward of ``bwd="xla"`` -> dqkv: autograd through the plain
    attention (``_mha_hybrid_bwd``), no kernel of its own."""
    with torch.enable_grad():
        qkv = torch.cat([q, k, v], dim=-1).detach().requires_grad_(True)
        out = mha_packed_reference(*_thirds(qkv), heads, causal)
        (dqkv,) = torch.autograd.grad(out, qkv, do)
    return dqkv


class PackedAttention(torch.autograd.Function):
    """The packed-head forward kernel with, as its gradient, the backward
    that ``bwd`` names (the port of ``_mha.defvjp``, ``_mha_fast.defvjp``
    and ``_mha_hybrid.defvjp``), over the packed qkv [B, S, 3*H*D] of the
    towers' qkv projection: q, k and v are cut from it inside, and the
    backward's one dqkv output is qkv's gradient, with no join of three.
    Only qkv is saved: the backward recomputes the softmax statistics."""

    @staticmethod
    def forward(ctx, qkv, heads: int, causal: bool, bwd: str):
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.causal, ctx.bwd = heads, causal, bwd
        return mha_packed_fwd(*_thirds(qkv), heads, causal)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        backward = {"pallas": mha_packed_bwd, "fused": _fused_bwd,
                    "xla": _xla_bwd}[ctx.bwd]
        dqkv = backward(*_thirds(qkv), do, ctx.heads, ctx.causal)
        return dqkv, None, None, None


def mha_qkv(qkv: torch.Tensor, heads: int, causal: bool = False,
            bwd: str = "pallas") -> torch.Tensor:
    """Fused multi-head attention over the packed qkv [B, S, 3*H*D] (q, k,
    v side by side, each H*D wide), differentiable -> out [B, S, H*D],
    contiguous, in the input dtype.  The towers' attention.  A CUDA tensor
    launches the packed-head forward kernel, and its gradient the backward
    ``bwd`` names; a build or launch failure raises.  A CPU tensor runs the
    plain twins inside the same autograd Function.

    ``bwd``, with ``swat_tpu``'s three values:
      'pallas' - the packed-head backward kernel (the default, and what the
                 towers use);
      'fused'  - the heads-first backward kernel in its keep-dtype form,
                 on views of the packed operands;
      'xla'    - autograd through the plain attention."""
    if bwd not in BWD_MODES:
        raise ValueError(f"bwd must be one of {BWD_MODES}; got {bwd!r}")
    return PackedAttention.apply(qkv, heads, causal, bwd)


def mha_qkv_reference(qkv: torch.Tensor, heads: int,
                      causal: bool = False) -> torch.Tensor:
    """``mha_packed_reference`` over the packed qkv, differentiated by
    torch's autograd: the plain attention the kernels are held against."""
    return mha_packed_reference(*_thirds(qkv), heads, causal)


def mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               heads: int, causal: bool = False,
               bwd: str = "pallas") -> torch.Tensor:
    """``mha_qkv`` for q, k, v given apart, each [B, S, H*D]: they are
    joined into one qkv first (a copy; the towers call ``mha_qkv`` on the
    projection's output and copy nothing)."""
    return mha_qkv(torch.cat([q, k, v], dim=-1), heads, causal, bwd)
