"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
GPU and nvcc): the packed-head and the heads-first attention forward and
backward against their plain twins at ragged and main-path shapes, fp32 and
bf16, strided and contiguous; the launch counts; determinism; the autograd
Functions and the three backward modes; the wrappers' refusals; and the same
for the three block-fused layer kernels (kernels/megablock.py); the
tensor-core forward and backward templates at the edges of their tiling; the
retrieval ranking and both samplers on the card against the CPU; the
LayerNorm kernel pair (kernels/layer_norm.py) bit for bit against the model
of its arithmetic (torch_port_lib.ln_model_*) and within rounding of its
plain twins; the BatchNorm kernel set (kernels/batch_norm.py) against its
plain twins at every RN50 BatchNorm shape, its determinism, its launches in
an RN50 train forward and backward, and an RN50 step against the plain
path's.  Run them on a GPU machine with ``python -m pytest
tests/test_torch_cuda.py``."""

import contextlib

import pytest
import torch
from torch_port_lib import (gapped_pool, ln_model_bwd, ln_model_fwd,
                            mma_sum_dot, rank_inputs, reference_pool,
                            rn50_bn_shapes)

from swat_tpu_torch.kernels import batch_norm as BN
from swat_tpu_torch.kernels import flash_attention as FA
from swat_tpu_torch.kernels import layer_norm as LN
from swat_tpu_torch.kernels import megablock as MB
from swat_tpu_torch.models.configs import get_model_config

pytestmark = pytest.mark.cuda

# kernel vs plain twin: fp32 differs in summation order only; bf16 by at
# most a rounding flip of p or of the output (one bf16 ulp is 2^-7 relative)
TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (1.6e-2, 1e-2)}
# backward vs plain twin: fp32 differs in summation order only (delta and
# the three products), a few ulps of values of order 1, hence the absolute
# 5e-5; bf16 by a rounding flip of ds or pb (one bf16 ulp of an element)
# or of the output (two ulps allowed, as for the forward)
TOL_BWD = {torch.float32: (2e-4, 5e-5), torch.bfloat16: (1.6e-2, 1e-2)}
# that bf16 bound cannot tell the rounding points apart; with the same
# points, summation order alone flips about 2 in 10^4 elements of an
# output, and one point done wrong leaves 58-78 % of an output bit-equal
# (test_torch_attention_bwd.py)
BWD_MIN_EQUAL_SHARE = 0.99
# the forwards' one rounding point below fp32 is p (rounded to bf16 before
# p.v by the packed-head forward, left in fp32 by the heads-first one): a
# forward is bit-equal to its own plain twin in FWD_MIN_EQUAL_SHARE of a bf16
# output, and to the other's in far less (0.58-0.61 measured on an H100 at
# the towers' shapes)
FWD_MIN_EQUAL_SHARE = 0.99
FWD_MAX_OTHER_SHARE = 0.9


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from swat_tpu_torch.kernels import _build

    try:
        _build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _qkv(b, s, hd, dtype, strided, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    if strided:
        qkv = torch.randn(b, s, 3 * hd, generator=g, device=device)
        return qkv.to(dtype).split(hd, dim=-1)
    return tuple(torch.randn(b, s, hd, generator=g, device=device).to(dtype)
                 for _ in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("s,heads,hd,causal", [
    (1, 1, 64, False), (5, 4, 64, True), (33, 2, 64, True),
    (50, 12, 768, False), (77, 8, 512, True), (257, 4, 256, False),
    (16, 4, 64, False), (16, 4, 32, True), (9, 2, 16, False)])
def test_kernel_matches_plain_twin(device, dtype, strided, s, heads, hd,
                                   causal):
    q, k, v = _qkv(3, s, hd, dtype, strided, device)
    before = FA.LAUNCHES
    got = FA.mha_packed_fwd(q, k, v, heads, causal)
    assert FA.LAUNCHES == before + 1
    ref = FA.mha_packed_reference(q, k, v, heads, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        assert _share(got, ref) >= FWD_MIN_EQUAL_SHARE
        if s >= 50:   # p is 1 at S = 1: short rows round little
            other = _packed(FA.flash_attention_reference(
                *(FA._heads_view(t, heads) for t in (q, k, v)), causal))
            assert _share(got, other) <= FWD_MAX_OTHER_SHARE


def _share(a, b):
    return float((a == b).float().mean())


def _packed(t):
    """[B, H, S, D] -> [B, S, H*D]."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def test_kernel_is_deterministic(device):
    q, k, v = _qkv(8, 50, 768, torch.bfloat16, True, device)
    assert torch.equal(FA.mha_packed_fwd(q, k, v, 12),
                       FA.mha_packed_fwd(q, k, v, 12))


def test_refusals_raise_and_do_not_count(device):
    q, k, v = _qkv(2, 10, 256, torch.float32, False, device)
    before = FA.LAUNCHES
    with pytest.raises(ValueError, match="head dim"):
        FA.mha_packed_fwd(q, k, v, 2)                   # head dim 128
    with pytest.raises(TypeError):
        FA.mha_packed_fwd(q.half(), k.half(), v.half(), 4)
    with pytest.raises(ValueError, match="one device"):
        FA.mha_packed_fwd(q, k.cpu(), v, 4)
    assert FA.LAUNCHES == before


def _do(b, s, hd, dtype, device, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, s, hd, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("b,s,heads,hd,causal", [
    (3, 1, 1, 64, False), (3, 5, 4, 64, True), (3, 33, 2, 64, True),
    (3, 9, 2, 16, False), (2, 16, 4, 32, True), (2, 40, 1, 8, False),
    (16, 50, 12, 768, False), (16, 77, 8, 512, True),
    (4, 197, 12, 768, False), (2, 257, 16, 1024, False)])
def test_bwd_kernel_matches_plain_twin(device, dtype, strided, b, s, heads,
                                       hd, causal):
    q, k, v = _qkv(b, s, hd, dtype, strided, device)
    do = _do(b, s, hd, dtype, device)
    before = FA.LAUNCHES_BWD
    dqkv = FA.mha_packed_bwd(q, k, v, do, heads, causal)
    assert FA.LAUNCHES_BWD == before + 1
    assert dqkv.dtype == dtype and dqkv.shape == (b, s, 3 * hd)
    ref = FA.mha_bwd_reference(q, k, v, do, heads, causal)
    torch.cuda.synchronize()
    rtol, atol = TOL_BWD[dtype]
    for name, g, r in zip(("dq", "dk", "dv"), dqkv.split(hd, -1), ref):
        assert g.dtype == dtype and g.shape == q.shape, name
        torch.testing.assert_close(g.float(), r.float(), rtol=rtol,
                                   atol=atol, msg=name)
        if dtype == torch.bfloat16:
            share = float((g == r).float().mean())
            assert share >= BWD_MIN_EQUAL_SHARE, (name, share)


def test_bwd_writes_the_thirds_of_one_qkv_gradient(device, monkeypatch):
    """The kernel writes dq, dk, dv into the thirds of one [B, S, 3*H*D]
    buffer, and through mha_qkv that buffer is qkv's gradient as it stands
    (no join of three gradients)."""
    g = torch.Generator(device=device).manual_seed(3)
    qkv = torch.randn(4, 50, 3 * 768, generator=g, device=device)
    do = _do(4, 50, 768, torch.float32, device)
    returned = []
    bwd = FA.mha_packed_bwd
    monkeypatch.setattr(FA, "mha_packed_bwd",
                        lambda *a: returned.append(bwd(*a)) or returned[-1])
    (grad,) = torch.autograd.grad(
        FA.mha_qkv(qkv.requires_grad_(True), 12), qkv, do)
    assert grad.data_ptr() == returned[0].data_ptr()
    ref = FA.mha_bwd_reference(*qkv.detach().chunk(3, -1), do, 12)
    rtol, atol = TOL_BWD[torch.float32]
    torch.testing.assert_close(grad, torch.cat(ref, -1), rtol=rtol, atol=atol)


def test_bwd_kernel_is_deterministic(device):
    q, k, v = _qkv(8, 77, 512, torch.bfloat16, True, device)
    do = _do(8, 77, 512, torch.bfloat16, device)
    assert torch.equal(FA.mha_packed_bwd(q, k, v, do, 8, True),
                       FA.mha_packed_bwd(q, k, v, do, 8, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_runs_both_kernels(device, dtype):
    g = torch.Generator(device=device).manual_seed(2)
    qkv = torch.randn(4, 50, 3 * 768, generator=g, device=device).to(dtype)
    do = _do(4, 50, 768, dtype, device)
    qkv.requires_grad_(True)
    fwd0, bwd0 = FA.LAUNCHES, FA.LAUNCHES_BWD
    out = FA.mha_qkv(qkv, 12, False)
    (grad,) = torch.autograd.grad(out, qkv, do)
    assert (FA.LAUNCHES, FA.LAUNCHES_BWD) == (fwd0 + 1, bwd0 + 1)
    ref = FA.mha_bwd_reference(*qkv.detach().split(768, dim=-1), do, 12)
    rtol, atol = TOL_BWD[dtype]
    torch.testing.assert_close(grad.float(), torch.cat(ref, -1).float(),
                               rtol=rtol, atol=atol)


def test_bwd_refusals_raise_and_do_not_count(device):
    q, k, v = _qkv(2, 10, 256, torch.float32, False, device)
    do = _do(2, 10, 256, torch.float32, device)
    before = FA.LAUNCHES_BWD
    with pytest.raises(ValueError, match="head dim"):
        FA.mha_packed_bwd(q, k, v, do, 2)                # head dim 128
    with pytest.raises(TypeError):
        FA.mha_packed_bwd(q.half(), k.half(), v.half(), do.half(), 4)
    with pytest.raises(ValueError, match="do must match"):
        FA.mha_packed_bwd(q, k, v, do.bfloat16(), 4)
    assert FA.LAUNCHES_BWD == before


# ---------------------------------------------------------------------------
# the heads-first kernels


def _heads_first(b, h, s, d, dtype, layout, device, seed=0, n=3):
    """n tensors [B, H, S, D]: 'contiguous', or 'views', the transposed
    views of one [B, S, n*H*D] projection output that the towers pass."""
    g = torch.Generator(device=device).manual_seed(seed)
    if layout == "views":
        x = torch.randn(b, s, n * h * d, generator=g, device=device).to(dtype)
        return tuple(t.reshape(b, s, h, d).transpose(1, 2)
                     for t in x.chunk(n, dim=-1))
    return tuple(torch.randn(b, h, s, d, generator=g, device=device).to(dtype)
                 for _ in range(n))


FLASH_SHAPES = [
    (3, 1, 1, 64, False), (3, 4, 5, 16, True), (3, 2, 33, 32, True),
    (2, 1, 40, 8, False), (16, 12, 50, 64, False), (16, 8, 77, 64, True),
    (4, 12, 197, 64, False), (2, 16, 257, 64, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "views"])
@pytest.mark.parametrize("b,h,s,d,causal", FLASH_SHAPES)
def test_flash_fwd_kernel_matches_plain_twin(device, dtype, layout, b, h, s,
                                             d, causal):
    q, k, v = _heads_first(b, h, s, d, dtype, layout, device)
    before = FA.LAUNCHES_FLASH
    got = FA.flash_attention_fwd(q, k, v, causal)
    assert FA.LAUNCHES_FLASH == before + 1
    ref = FA.flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    # the output lies in memory as q does: a view transposes back for free
    assert got.transpose(1, 2).is_contiguous() == (layout == "views" or h == 1
                                                   or s == 1)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        assert _share(got, ref) >= FWD_MIN_EQUAL_SHARE
        if s >= 50:
            other = FA._heads_view(FA.mha_packed_reference(
                *(_packed(t) for t in (q, k, v)), h, causal), h)
            assert _share(got, other) <= FWD_MAX_OTHER_SHARE


# ---------------------------------------------------------------------------
# the forward template's tiling: 16 query rows a warp, 16 keys a step, the
# scores of a row in one warp's registers up to S = 128 and in those of 2-4
# warps above, head dims 8 padded to 16

EDGE_S = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 197, 257]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGE_S)
def test_forward_kernels_at_tile_edges(device, dtype, d, causal, s):
    """Both forwards on the strided thirds of one qkv tensor (packed-head)
    and on their transposed views (heads-first)."""
    heads = 3
    batch = max(2, -(-4096 // (heads * s * d)))
    q, k, v = _qkv(batch, s, heads * d, dtype, True, device, seed=s + d)
    views = [FA._heads_view(t, heads) for t in (q, k, v)]
    rtol, atol = TOL[dtype]
    for got, ref in (
            (FA.mha_packed_fwd(q, k, v, heads, causal),
             FA.mha_packed_reference(q, k, v, heads, causal)),
            (FA.flash_attention_fwd(*views, causal),
             FA.flash_attention_reference(*views, causal))):
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                                   atol=atol)
        if dtype == torch.bfloat16:
            assert _share(got, ref) >= FWD_MIN_EQUAL_SHARE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,causal", [(50, False), (77, True), (197, False)])
def test_forward_kernels_take_views_that_are_not_16_byte_aligned(
        device, dtype, s, causal):
    """A view whose base lies one element off a 16-byte boundary (rows
    3*H*D + 1 apart): the kernels read and write it element by element,
    same arithmetic, same result as on an aligned copy."""
    heads, d = 4, 64
    g = torch.Generator(device=device).manual_seed(9)
    x = torch.randn(3, s, 3 * heads * d + 1, generator=g,
                    device=device).to(dtype)
    q, k, v = x[..., 1:].split(heads * d, dim=-1)
    assert q.data_ptr() % 16 != 0
    got = FA.mha_packed_fwd(q, k, v, heads, causal)
    assert torch.equal(got, FA.mha_packed_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), heads, causal))
    views = [FA._heads_view(t, heads) for t in (q, k, v)]
    got = FA.flash_attention_fwd(*views, causal)
    assert torch.equal(got, FA.flash_attention_fwd(
        *(t.contiguous() for t in views), causal))
    ref = FA.flash_attention_reference(*views, causal)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,causal", [(50, False), (77, True), (257, False)])
def test_forward_kernels_are_deterministic(device, dtype, s, causal):
    q, k, v = _qkv(8, s, 512, dtype, True, device, seed=3)
    assert torch.equal(FA.mha_packed_fwd(q, k, v, 8, causal),
                       FA.mha_packed_fwd(q, k, v, 8, causal))
    views = [FA._heads_view(t, 8) for t in (q, k, v)]
    assert torch.equal(FA.flash_attention_fwd(*views, causal),
                       FA.flash_attention_fwd(*views, causal))


def test_forward_kernels_refuse_a_sequence_beyond_shared_memory(device):
    q, k, v = _qkv(1, FA.MAX_FWD_SEQ + 1, 64, torch.float32, False, device)
    before = (FA.LAUNCHES, FA.LAUNCHES_FLASH)
    with pytest.raises(ValueError, match="sequence"):
        FA.mha_packed_fwd(q, k, v, 1)
    with pytest.raises(ValueError, match="sequence"):
        FA.flash_attention_fwd(*(FA._heads_view(t, 1) for t in (q, k, v)))
    assert (FA.LAUNCHES, FA.LAUNCHES_FLASH) == before
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(1, FA.MAX_FWD_SEQ, 64, dtype, False, device)
        got = FA.mha_packed_fwd(q, k, v, 1, True)
        ref = FA.mha_packed_reference(q, k, v, 1, True)
        rtol, atol = TOL[dtype]
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("keep_dtype", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "views"])
@pytest.mark.parametrize("b,h,s,d,causal", FLASH_SHAPES)
def test_flash_bwd_kernel_matches_plain_twin(device, keep_dtype, dtype, layout,
                                             b, h, s, d, causal):
    q, k, v, do = _heads_first(b, h, s, d, dtype, layout, device, n=4)
    before = FA.LAUNCHES_FLASH_BWD
    got = FA.flash_attention_bwd(q, k, v, do, causal, keep_dtype)
    assert FA.LAUNCHES_FLASH_BWD == before + 1
    ref = FA.flash_attention_bwd_reference(q, k, v, do, causal, keep_dtype)
    torch.cuda.synchronize()
    rtol, atol = TOL_BWD[dtype]
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == q.shape, name
        torch.testing.assert_close(g.float(), r.float(), rtol=rtol,
                                   atol=atol, msg=name)
        if dtype == torch.bfloat16:
            share = float((g == r).float().mean())
            assert share >= BWD_MIN_EQUAL_SHARE, (name, share)


def test_flash_rounding_differs_from_the_packed_kernels_in_bf16(device):
    """The heads-first forward multiplies the fp32 p by v, the packed-head
    one rounds p to bf16 first: on the same bf16 inputs the two kernels
    differ, and each is closer to its own plain twin than to the other's;
    in fp32 they agree."""
    b, h, s, d = 8, 12, 50, 64
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _heads_first(b, h, s, d, dtype, "views", device, seed=5)
        packed = [t.transpose(1, 2).reshape(b, s, h * d) for t in (q, k, v)]
        hf = FA.flash_attention_fwd(q, k, v).transpose(1, 2).reshape(
            b, s, h * d)
        pk = FA.mha_packed_fwd(*packed, h)
        if dtype == torch.float32:
            torch.testing.assert_close(hf, pk, rtol=2e-4, atol=2e-5)
            continue
        hf_ref = FA.flash_attention_reference(q, k, v).transpose(
            1, 2).reshape(b, s, h * d)
        pk_ref = FA.mha_packed_reference(*packed, h)
        own = float((hf == hf_ref).float().mean())
        other = float((hf == pk_ref).float().mean())
        assert not torch.equal(hf, pk)
        assert own >= BWD_MIN_EQUAL_SHARE > other, (own, other)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bwd_agrees_with_the_packed_bwd_kernel(device, dtype):
    """bwd='fused' is the packed-head backward's math at other strides: the
    two kernels share their templates, so the gradients are bit-equal."""
    g = torch.Generator(device=device).manual_seed(4)
    qkv = torch.randn(8, 50, 3 * 768, generator=g, device=device).to(dtype)
    do = _do(8, 50, 768, dtype, device)
    grads = {}
    for bwd in ("pallas", "fused", "xla"):
        x = qkv.clone().requires_grad_(True)
        c0 = (FA.LAUNCHES, FA.LAUNCHES_BWD, FA.LAUNCHES_FLASH_BWD)
        (grads[bwd],) = torch.autograd.grad(FA.mha_qkv(x, 12, False, bwd),
                                            x, do)
        c1 = (FA.LAUNCHES, FA.LAUNCHES_BWD, FA.LAUNCHES_FLASH_BWD)
        want = {"pallas": (1, 1, 0), "fused": (1, 0, 1), "xla": (1, 0, 0)}
        assert tuple(a - b for a, b in zip(c1, c0)) == want[bwd], bwd
    assert torch.equal(grads["fused"], grads["pallas"])
    rtol, atol = TOL_BWD[dtype]
    torch.testing.assert_close(grads["xla"].float(), grads["pallas"].float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_function_runs_both_kernels(device, dtype):
    q, k, v, do = _heads_first(4, 12, 50, 64, dtype, "views", device, seed=6,
                               n=4)
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    c0 = (FA.LAUNCHES_FLASH, FA.LAUNCHES_FLASH_BWD)
    out = FA.flash_attention(q, k, v, True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (FA.LAUNCHES_FLASH, FA.LAUNCHES_FLASH_BWD) == (c0[0] + 1, c0[1] + 1)
    ref = FA.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                           do, True, False)
    rtol, atol = TOL_BWD[dtype]
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g.float(), r.float(), rtol=rtol, atol=atol)


def test_flash_kernels_are_deterministic(device):
    q, k, v, do = _heads_first(8, 8, 77, 64, torch.bfloat16, "views", device,
                               n=4)
    assert torch.equal(FA.flash_attention_fwd(q, k, v, True),
                       FA.flash_attention_fwd(q, k, v, True))
    for a, b in zip(FA.flash_attention_bwd(q, k, v, do, True),
                    FA.flash_attention_bwd(q, k, v, do, True)):
        assert torch.equal(a, b)


def test_flash_refusals_raise_and_do_not_count(device):
    q, k, v, do = _heads_first(2, 2, 10, 128, torch.float32, "contiguous",
                               device, n=4)
    before = (FA.LAUNCHES_FLASH, FA.LAUNCHES_FLASH_BWD)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_fwd(q, k, v)                  # head dim 128
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_bwd(q, k, v, do)
    q, k, v, do = (t[..., :64] for t in (q, k, v, do))
    with pytest.raises(TypeError):
        FA.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one device"):
        FA.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous in its last dim"):
        FA.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                               k, v)
    with pytest.raises(ValueError, match="do must match"):
        FA.flash_attention_bwd(q, k, v, do.bfloat16())
    assert (FA.LAUNCHES_FLASH, FA.LAUNCHES_FLASH_BWD) == before


# ---------------------------------------------------------------------------
# the tensor-core backward template at the edges of its tiling: 16-row
# tiles, one block a head up to 128 rows in bf16 and 80 in fp32 (4, 5 or 8
# row tiles), the pair of kernels with 64-row chunks above, head dims 8
# padded to 16

BWD_EDGE_S = [1, 15, 16, 17, 50, 63, 64, 65, 77, 80, 81, 127, 128, 129, 197,
              257]


def _assert_grads(got, ref, dtype, what=""):
    rtol, atol = TOL_BWD[dtype]
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert bool(torch.isfinite(g).all()), (what, name)
        torch.testing.assert_close(g.float(), r.float(), rtol=rtol,
                                   atol=atol, msg=f"{what} {name}")
        if dtype == torch.bfloat16:
            assert _share(g, r) >= BWD_MIN_EQUAL_SHARE, (what, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", BWD_EDGE_S)
def test_backward_kernels_at_tile_edges(device, dtype, d, causal, s):
    """The packed-head backward on the strided thirds of one qkv tensor and
    both forms of the heads-first backward on their transposed views."""
    heads = 3
    batch = max(2, -(-4096 // (heads * s * d)))
    q, k, v = _qkv(batch, s, heads * d, dtype, True, device, seed=s + d)
    do = _do(batch, s, heads * d, dtype, device, seed=s)
    got = FA.mha_packed_bwd(q, k, v, do, heads, causal).split(heads * d, -1)
    torch.cuda.synchronize()
    _assert_grads(got, FA.mha_bwd_reference(q, k, v, do, heads, causal),
                  dtype, "mha_bwd")
    views = [FA._heads_view(t, heads) for t in (q, k, v, do)]
    for keep in (False, True):
        got = FA.flash_attention_bwd(*views, causal, keep)
        torch.cuda.synchronize()
        _assert_grads(got, FA.flash_attention_bwd_reference(*views, causal,
                                                            keep),
                      dtype, f"flash_bwd keep_dtype={keep}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,causal", [(50, False), (77, True), (197, False)])
def test_backward_kernels_take_views_that_are_not_16_byte_aligned(
        device, dtype, s, causal):
    """Inputs whose base lies one element off a 16-byte boundary and outputs
    one element off a pair: the kernels read and write them element by
    element, same arithmetic, same result as on aligned copies."""
    heads, d = 4, 64
    g = torch.Generator(device=device).manual_seed(9)
    x = torch.randn(3, s, 4 * heads * d + 1, generator=g,
                    device=device).to(dtype)
    q, k, v, do = x[..., 1:].split(heads * d, dim=-1)
    assert q.data_ptr() % 16 != 0
    aligned = FA.mha_packed_bwd(q.contiguous(), k.contiguous(),
                                v.contiguous(), do.contiguous(), heads,
                                causal)
    assert torch.equal(FA.mha_packed_bwd(q, k, v, do, heads, causal), aligned)
    views = [FA._heads_view(t, heads) for t in (q, k, v, do)]
    y = torch.empty(3, s, 3 * heads * d + 1, dtype=dtype, device=device)
    out = tuple(FA._heads_view(t, heads)
                for t in y[..., 1:].split(heads * d, dim=-1))
    assert out[0].data_ptr() % (2 * y.element_size()) != 0
    FA.flash_attention_bwd(*views, causal, keep_dtype=True, out=out)
    assert torch.equal(y[..., 1:], aligned)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,causal", [(50, False), (77, True), (257, False)])
def test_backward_kernels_are_deterministic(device, dtype, s, causal):
    """No atomics, every sum in one order: two calls are bit-equal, and so
    are bwd='fused' and bwd='pallas' (one template, other strides)."""
    q, k, v = _qkv(8, s, 512, dtype, True, device, seed=3)
    do = _do(8, s, 512, dtype, device)
    first = FA.mha_packed_bwd(q, k, v, do, 8, causal)
    assert torch.equal(first, FA.mha_packed_bwd(q, k, v, do, 8, causal))
    assert torch.equal(first, FA._fused_bwd(q, k, v, do, 8, causal))
    views = [FA._heads_view(t, 8) for t in (q, k, v, do)]
    for a, b in zip(FA.flash_attention_bwd(*views, causal),
                    FA.flash_attention_bwd(*views, causal)):
        assert torch.equal(a, b)


def test_backward_kernels_refuse_a_sequence_beyond_their_reach(device):
    q, k, v = _qkv(1, FA.MAX_FWD_SEQ + 1, 64, torch.float32, False, device)
    do = _do(1, FA.MAX_FWD_SEQ + 1, 64, torch.float32, device)
    before = (FA.LAUNCHES_BWD, FA.LAUNCHES_FLASH_BWD)
    with pytest.raises(ValueError, match="sequence"):
        FA.mha_packed_bwd(q, k, v, do, 1)
    with pytest.raises(ValueError, match="sequence"):
        FA.flash_attention_bwd(*(FA._heads_view(t, 1)
                                 for t in (q, k, v, do)))
    assert (FA.LAUNCHES_BWD, FA.LAUNCHES_FLASH_BWD) == before
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(1, FA.MAX_FWD_SEQ, 64, dtype, False, device)
        do = _do(1, FA.MAX_FWD_SEQ, 64, dtype, device)
        got = FA.mha_packed_bwd(q, k, v, do, 1, True).split(64, -1)
        _assert_grads(got, FA.mha_bwd_reference(q, k, v, do, 1, True), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,causal", [(50, False), (77, True), (197, False)])
def test_mega_attn_bwd_takes_fp32_gradients_from_the_template(device, dtype,
                                                              s, causal,
                                                              monkeypatch):
    """The block-fused attention backward instantiates the template with
    fp32 outputs (it sums dq, dk, dv for the bias gradients before it rounds
    them) at short and at long rows: d in_proj_bias, the column sum of the
    fp32 dq|dk|dv, and dx agree with the plain version.

    bf16 dx ends a chain of six roundings (q|k|v, do, ds, dq|dk|dv, the
    products between them, dx itself), and the tensor cores sum each mma
    their own way (tests/torch_port_lib.py, ``mma_sum``), which flips some
    of them where the plain version's fp32 sums do not.  So dx is held at
    BWD_MIN_EQUAL_SHARE against the plain version with the card's sums
    (``mma_sum_dot`` as its products), and against the plain version itself
    at that share less what the card's sums cost the plain version."""
    d, heads = 96, 3
    (x, _, _, dx2), w = _mega_inputs(4, s, d, 192, dtype, device, seed=s)
    got = MB.megablock_attn_bwd(x, dx2, w, heads, causal)
    ref = MB.attn_bwd_reference(x, dx2, w, heads, causal)
    torch.cuda.synchronize()
    for name, g, r in zip(MEGA_OUT["attn_bwd"], got, ref):
        if name != "dx" or dtype == torch.float32:
            mega_close(f"attn_bwd.{name}", g, r, dtype)
    if dtype == torch.bfloat16:
        monkeypatch.setattr(MB, "_dot", mma_sum_dot)
        card_sums = MB.attn_bwd_reference(x, dx2, w, heads, causal)[0]
        mega_close("attn_bwd.dx", got[0], card_sums, dtype)
        dx, dx_ref = got[0].float(), ref[0].float()
        bound = 1.6e-2 * dx_ref.abs() + 4e-3 * float(dx_ref.abs().max())
        assert bool(((dx - dx_ref).abs() <= bound).all())
        cost = 1 - float((card_sums == ref[0]).float().mean())
        share = float((got[0] == ref[0]).float().mean())
        print(f"[mma-sum] attn_bwd dx S={s}: bit-equal to the plain version "
              f"{share:.5f}, to it with the card's sums "
              f"{float((got[0] == card_sums).float().mean()):.5f}; the "
              f"card's sums cost the plain version {cost:.5f}")
        assert share >= BWD_MIN_EQUAL_SHARE - cost, (share, cost)


# (what, b, s, width, heads): d in_proj_weight over 16 token rows (one mma a sum,
# from a zero accumulator) and over 32 (two chained); dh1 over the 288 and
# 2304 columns of dq|dk|dv (9 and 72 steps added by the CUDA cores)
MMA_SUMS = [("d_in_w", 1, 16, 768, 12), ("d_in_w", 1, 32, 768, 12),
            ("dh1", 4, 50, 96, 3), ("dh1", 2, 50, 768, 12)]


@pytest.mark.parametrize("what,b,s,d,heads", MMA_SUMS)
def test_mega_products_sum_as_the_mma_model(device, what, b, s, d, heads,
                                            monkeypatch):
    """The tensor-core product of the block kernels in bf16 gives, bit for
    bit, what tests/torch_port_lib.py's ``mma_sum_dot`` models: fp32 sums of
    32-deep steps, each two chained mma that cut their terms two bits below
    the largest product's fp32 ulp and their sum toward zero.  Read from the
    attention backward's fp32 products: d in_proj_weight (an output; no
    split at these depths) and dh1 (scratch), from the rounded dq|dk|dv and
    the LayerNorm output that the kernel left in its scratch."""
    (x, _, _, dx2), w = _mega_inputs(b, s, d, 192, torch.bfloat16, device,
                                     seed=s)
    kept = []
    scratch = MB._scratch
    monkeypatch.setattr(MB, "_scratch",
                        lambda *a: kept.append(scratch(*a)) or kept[-1])
    got = MB.megablock_attn_bwd(x, dx2, w, heads, False)
    torch.cuda.synchronize()
    h1, dqkv, dh1 = kept[0][0], kept[0][3], kept[0][5]
    if what == "d_in_w":
        assert MB.split_count(3 * d, d, b * s, torch.bfloat16)[0] == 1
        card, model = got[1], mma_sum_dot(dqkv.t(), h1)
    else:
        card, model = dh1, mma_sum_dot(dqkv, w.in_w)
    assert torch.equal(card, model), float((card == model).float().mean())


# b, s, width, heads, mlp, causal, quick_gelu: ragged tiles (rows, widths
# and depths that are no multiple of a tile), every head dim, both
# activations, and the towers' shapes (B/32 image, text, B/16 image); the
# edges of the tensor-core product's 128-row tiles and 32-deep steps: B*S
# = 1, 127, 129 and 1576 token rows, widths and depths below one tile
# (D = 24, 64, 96; F = 40, 192), the weight gradients' depth cut into
# splits at 1576 rows
MEGA_SHAPES = [
    (3, 5, 64, 4, 256, False, True), (2, 12, 64, 4, 256, True, False),
    (2, 33, 96, 3, 200, True, True), (5, 7, 24, 3, 40, False, False),
    (1, 1, 64, 4, 192, False, True), (1, 127, 64, 4, 256, True, False),
    (3, 43, 96, 3, 192, False, True), (8, 197, 64, 4, 192, False, False),
    (4, 50, 768, 12, 3072, False, True), (4, 77, 512, 8, 2048, True, True),
    (2, 197, 768, 12, 3072, False, False)]
MEGA_OUT = {"fwd": ("y", "x2"),
            "mlp_bwd": ("dx2", "d_fc_w", "d_fc_b", "d_proj_w", "d_proj_b",
                        "d_ln2_w", "d_ln2_b"),
            "attn_bwd": ("dx", "d_in_w", "d_in_b", "d_out_w", "d_out_b",
                         "d_ln1_w", "d_ln1_b")}


def _mega_inputs(b, s, d, f, dtype, device, seed=0):
    """x, x2, two gradients and one block's weights (random LayerNorm scale
    and bias) on the card in ``dtype``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g, device=device) * std
                + mean).to(dtype)

    acts = [normal((b, s, d)) for _ in range(4)]
    w = MB.BlockWeights(
        normal((3 * d, d), d ** -0.5), normal((3 * d,), 0.1),
        normal((d, d), d ** -0.5), normal((d,), 0.1),
        normal((d,), 0.1, 1.0), normal((d,), 0.1), normal((d,), 0.1, 1.0),
        normal((d,), 0.1), normal((f, d), d ** -0.5), normal((f,), 0.1),
        normal((d, f), f ** -0.5), normal((d,), 0.1))
    return acts, w


# the share of a bf16 output that must be bit-equal to the plain twin's.  At
# widths up to 96 every output keeps BWD_MIN_EQUAL_SHARE (dx of the
# attention backward against the plain version with the card's sums, in
# test_mega_attn_bwd_takes_fp32_gradients_from_the_template).  At the
# towers' widths one flipped hidden value moves the 512- to 3072-term sum it
# feeds, so the flips multiply down the chain of roundings: measured on an
# H100 with CUDA-core products 0.986-0.999 (x2, dx2), 0.957-0.995 (dx),
# 0.872-0.992 (y; lowest at S=197).  The tensor-core product of all three
# kernels sums in another order and keeps these bounds only because it
# never chains its running sum through the tensor cores
# (csrc/megablock_mma.cuh); with it dx read 0.956-0.976 at these shapes.
# The rounding points themselves are held by the plain twins against the
# Pallas kernels (tests/test_torch_megablock.py).
MEGA_MIN_SHARE_WIDE = {"x2": 0.97, "dx2": 0.98, "dx": 0.92, "y": 0.80}


def mega_close(name, got, ref, dtype, wide=False):
    """A block kernel's output against its plain twin's.  fp32: the two
    differ in summation order only (a weight gradient sums over all B*S
    rows), so 5e-5 of the output's largest value.  bf16, an output in bf16:
    a rounding flip of it or of what feeds it, two bf16 ulps of the element
    plus one of the largest, and a share of the elements bit-equal (a wrong
    rounding point leaves far fewer): BWD_MIN_EQUAL_SHARE, or
    MEGA_MIN_SHARE_WIDE at the towers' widths (``wide``); an fp32 gradient
    in bf16: a few flipped bf16 roundings among the B*S terms of a sum, 2e-3
    of its largest value."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    assert bool(torch.isfinite(got).all()), name
    got32, ref32 = got.float(), ref.float()
    scale = float(ref32.abs().max())
    err = (got32 - ref32).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 5e-5 * scale, (name, float(err.max()),
                                                  scale)
    elif got.dtype == torch.bfloat16:
        bound = 1.6e-2 * ref32.abs() + 4e-3 * scale
        assert bool((err <= bound).all()), (name, float(err.max()), scale)
        share = float((got == ref).float().mean())
        need = (MEGA_MIN_SHARE_WIDE[name.split(".")[-1]] if wide
                else BWD_MIN_EQUAL_SHARE)
        assert share >= need, (name, share)
    else:
        assert float(err.max()) <= 2e-3 * scale, (name, float(err.max()),
                                                  scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,heads,f,causal,quick", MEGA_SHAPES)
def test_mega_kernels_match_plain_twins(device, dtype, b, s, d, heads, f,
                                        causal, quick):
    (x, x2, dy, dx2), w = _mega_inputs(b, s, d, f, dtype, device)
    before = (MB.LAUNCHES_MEGA, MB.LAUNCHES_MEGA_MLP_BWD,
              MB.LAUNCHES_MEGA_ATTN_BWD)
    got = {"fwd": MB.megablock_fwd(x, w, heads, causal, quick),
           "mlp_bwd": MB.megablock_mlp_bwd(x2, dy, w, quick),
           "attn_bwd": MB.megablock_attn_bwd(x, dx2, w, heads, causal)}
    torch.cuda.synchronize()
    assert (MB.LAUNCHES_MEGA, MB.LAUNCHES_MEGA_MLP_BWD,
            MB.LAUNCHES_MEGA_ATTN_BWD) == tuple(n + 1 for n in before)
    ref = {"fwd": MB.block_fwd_reference(x, w, heads, causal, quick),
           "mlp_bwd": MB.mlp_bwd_reference(x2, dy, w, quick),
           "attn_bwd": MB.attn_bwd_reference(x, dx2, w, heads, causal)}
    for kind, names in MEGA_OUT.items():
        for name, g, r in zip(names, got[kind], ref[kind]):
            mega_close(f"{kind}.{name}", g, r, dtype, wide=d >= 512)


def test_mega_kernels_are_deterministic(device):
    """Two calls give bit-equal outputs at the B/32 block's widths, with
    rows enough (64 images) that the weight gradients' depth is cut into
    splits: the column sums and the split joins add in a fixed order."""
    (x, x2, dy, dx2), w = _mega_inputs(64, 50, 768, 3072, torch.bfloat16,
                                       device)
    assert MB.split_count(768, 3072, 64 * 50, torch.bfloat16)[0] > 1
    for call in (lambda: MB.megablock_fwd(x, w, 12, False, True),
                 lambda: MB.megablock_mlp_bwd(x2, dy, w, True),
                 lambda: MB.megablock_attn_bwd(x, dx2, w, 12, False)):
        for a, b in zip(call(), call()):
            assert torch.equal(a, b)


# the weight gradients of each backward entry point whose depth is split:
# (output names, [m, n] of each product)
MEGA_SPLIT = {"mlp_bwd": (("d_fc_w", "d_proj_w"), ((3072, 768), (768, 3072))),
              "attn_bwd": (("d_in_w", "d_out_w"), ((2304, 768), (768, 768)))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(MEGA_SPLIT))
def test_mega_split_k_matches_one_split(device, dtype, kind, monkeypatch):
    """The weight gradients of a backward entry point (dWp and dWfc; dWo
    and d in_proj_weight) with their depth cut into splits (joined in
    order) against one split each (no split scratch: the entry point then
    sums the whole depth in one launch): the same products summed in
    another order, within the fp32 tolerance of the kernel tests (5e-5 of
    the largest value); every other output is bit-equal."""
    (x, x2, dy, dx2), w = _mega_inputs(64, 50, 768, 3072, dtype, device,
                                       seed=2)
    names, shapes = MEGA_SPLIT[kind]
    for m, n in shapes:
        assert MB.split_count(m, n, 64 * 50, dtype)[0] > 1
    call = {"mlp_bwd": lambda: MB.megablock_mlp_bwd(x2, dy, w, True),
            "attn_bwd": lambda: MB.megablock_attn_bwd(x, dx2, w, 12,
                                                      False)}[kind]
    split = call()
    monkeypatch.setattr(MB, "_split_floats", lambda *shape: 0)
    one = call()
    torch.cuda.synchronize()
    for name, a, b in zip(MEGA_OUT[kind], split, one):
        if name in names:
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 5e-5 * scale, name
            assert not torch.equal(a, b), name       # the splits did run
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_function_runs_the_three_kernels(device, dtype):
    """fused_block on the card: one launch of each kernel, the gradients of
    x and of all 12 weights those of the plain twins chained the same way,
    cast to the compute dtype."""
    (x, _, dy, _), w = _mega_inputs(4, 50, 768, 3072, dtype, device, seed=1)
    x.requires_grad_(True)
    w = MB.BlockWeights(*(t.requires_grad_(True) for t in w))
    before = (MB.LAUNCHES_MEGA, MB.LAUNCHES_MEGA_MLP_BWD,
              MB.LAUNCHES_MEGA_ATTN_BWD)
    y = MB.fused_block(x, w, 12, False, True)
    grads = torch.autograd.grad(y, (x, *w), dy)
    assert (MB.LAUNCHES_MEGA, MB.LAUNCHES_MEGA_MLP_BWD,
            MB.LAUNCHES_MEGA_ATTN_BWD) == tuple(n + 1 for n in before)
    xd, wd = x.detach(), MB.BlockWeights(*(t.detach() for t in w))
    y_ref, x2 = MB.block_fwd_reference(xd, wd, 12, False, True)
    dx2, d_fc_w, d_fc_b, d_proj_w, d_proj_b, d_ln2_w, d_ln2_b = \
        MB.mlp_bwd_reference(x2, dy, wd, True)
    dx, d_in_w, d_in_b, d_out_w, d_out_b, d_ln1_w, d_ln1_b = \
        MB.attn_bwd_reference(xd, dx2, wd, 12, False)
    ref = (dx, d_in_w, d_in_b, d_out_w, d_out_b, d_ln1_w, d_ln1_b, d_ln2_w,
           d_ln2_b, d_fc_w, d_fc_b, d_proj_w, d_proj_b)
    mega_close("y", y.detach(), y_ref, dtype, wide=True)
    for name, g, r in zip(("x",) + MB.BlockWeights._fields, grads, ref):
        assert g.dtype == dtype, name
        if dtype == torch.float32:
            mega_close(name, g, r, dtype)
            continue
        # bf16: the backward kernels start from the forward kernel's x2 and
        # the MLP backward's dx2, the twins from their own, so flipped
        # roundings compound down three kernels and a bit-equal share says
        # little (each kernel alone is held above); every gradient stays
        # within two bf16 ulps of the element plus two of the largest
        torch.testing.assert_close(
            g.float(), r.to(dtype).float(), rtol=1.6e-2,
            atol=8e-3 * float(r.abs().max()), msg=name)


def test_mega_refusals_raise_and_do_not_count(device):
    (x, x2, dy, dx2), w = _mega_inputs(2, 5, 64, 256, torch.float32, device)
    before = (MB.LAUNCHES_MEGA, MB.LAUNCHES_MEGA_MLP_BWD,
              MB.LAUNCHES_MEGA_ATTN_BWD)
    with pytest.raises(ValueError, match="head dim"):
        MB.megablock_fwd(x, w, 16, False, True)            # head dim 4
    with pytest.raises(ValueError, match="divisible"):
        MB.megablock_attn_bwd(x, dx2, w, 3, False)
    with pytest.raises(TypeError):
        MB.megablock_fwd(x.half(), w, 4, False, True)
    with pytest.raises(ValueError, match="in_w must be"):
        MB.megablock_fwd(x, w._replace(in_w=w.in_w.t()), 4, False, True)
    with pytest.raises(ValueError, match="fc_b must be"):
        MB.megablock_mlp_bwd(x2, dy, w._replace(fc_b=w.fc_b.bfloat16()),
                             True)
    with pytest.raises(ValueError, match="gradient must match"):
        MB.megablock_mlp_bwd(x2, dy[:, :3], w, True)
    assert (MB.LAUNCHES_MEGA, MB.LAUNCHES_MEGA_MLP_BWD,
            MB.LAUNCHES_MEGA_ATTN_BWD) == before


# ---------------------------------------------------------------------------
# W8A8 int8 inference: the int8 product (torch._int_mm, cuBLASLt's, zero
# padded to its CUDA shape rules) and the W8A8 product around it, on the
# card against the CPU


@pytest.mark.parametrize("m,k,n", [(5, 3072, 768), (16, 512, 512),
                                   (300, 588, 1024), (50, 768, 2304),
                                   (40, 12, 13)])
def test_int8_matmul_cuda_equals_cpu(device, m, k, n):
    """Integers: the card's padded product equals the CPU's, rows at and
    below 16, K = 588 (ViT-L/14's patch embedding) and N off 8 included."""
    from swat_tpu_torch.models.clip import int8_matmul

    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = int8_matmul(a.to(device), b.to(device)).cpu()
    assert torch.equal(got, int8_matmul(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdot_cuda_equals_cpu(device, dtype):
    """The W8A8 product at a B/32 block's c_fc shape: the same activation
    codes and int32 sums, and the dequantization's elementwise products
    are correctly rounded on both, so the outputs are equal."""
    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.models.clip import Int8Weight, qdot
    from swat_tpu_torch.models.quant import quantize_weight

    prec = FP32_PRECISION if dtype == "float32" else DEFAULT_PRECISION
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 50, 768, generator=g)
    codes, scale = quantize_weight(torch.randn(768, 3072, generator=g).numpy())
    w = Int8Weight(torch.from_numpy(codes.T.copy()), torch.from_numpy(scale))
    got = qdot(x.to(device), Int8Weight(w.codes.to(device),
                                        w.scale.to(device)), prec).cpu()
    assert torch.equal(got, qdot(x, w, prec))


# ---------------------------------------------------------------------------
# retrieval (swat_tpu_torch.retrieval): on inputs of the dyadic grid every
# product is exact, so the card's selections and scores equal the CPU's
# bit for bit, ties broken lower index first on both


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("top_k", [3, 5, 7, 20])
def test_rank_candidates_cuda_equals_cpu(device, top_k, chunk):
    import numpy as np

    from swat_tpu_torch.retrieval import rank as R

    prompts, cands, cls = rank_inputs()
    got = R.rank_candidates(prompts, cands, cls, top_k, chunk=chunk,
                            device=device)
    ref = R.rank_candidates(prompts, cands, cls, top_k, chunk=chunk,
                            device="cpu")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    tied = [i for i in got[0][0] if i in (3, 14, 15, 16, 33)]
    assert tied == sorted(tied)


def test_select_keys_cuda_equals_cpu(device):
    """Equal values, -0.0 and +0.0, -inf: one order on both devices."""
    from swat_tpu_torch.retrieval import rank as R

    sims = torch.tensor([[0.0, -0.0, 0.5, 0.0, -0.0, -torch.inf, 0.5]])
    index = torch.arange(7)
    ref = R._from_keys(R._select_top(sims, index, 7))
    got = R._from_keys(R._select_top(sims.to(device), index.to(device), 7))
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert ref[1][0].tolist() == [2, 6, 0, 3, 1, 4, -1]


def test_near_duplicates_cuda_equal_cpu(device):
    import numpy as np

    from swat_tpu_torch.retrieval import rank as R

    _, labels, img, _ = reference_pool()[0]
    for max_elems in (1 << 27, 20 * 20):
        np.testing.assert_array_equal(
            R.near_duplicate_indices_by_class(img, labels, threshold=0.9,
                                              max_elems=max_elems,
                                              device=device),
            R.near_duplicate_indices_by_class(img, labels, threshold=0.9,
                                              max_elems=max_elems,
                                              device="cpu"))


def _retrieval_strategies():
    from swat_tpu_torch.retrieval.sampler import STRATEGIES

    return STRATEGIES


@pytest.mark.parametrize("engine", ["fused", "per-class"])
@pytest.mark.parametrize("strategy", _retrieval_strategies())
@pytest.mark.parametrize("pool_name", ["reference", "gapped"])
def test_samplers_cuda_equal_cpu(device, pool_name, strategy, engine):
    import numpy as np

    from swat_tpu_torch.retrieval import sampler as S

    arrays, prompts, fs = (reference_pool if pool_name == "reference"
                           else gapped_pool)()
    pool = S.MinedPool(*arrays, captions=[f"c{i}" for i in
                                          range(len(arrays[0]))])
    head = np.stack([np.asarray(prompts[k]["mean"]) for k in
                     sorted(prompts, key=int)])
    sample = (S.sample_retrieved_fused if engine == "fused"
              else S.sample_retrieved)
    kw = dict(num_samples=5, threshold=-0.1, t2i_threshold=0.1, seed=3,
              fewshot_feats_by_class=fs, remove_duplicates=True)
    if pool_name == "reference":
        kw["zeroshot_filter_head"] = head
    got = sample(pool, prompts, strategy, device=device, **kw)
    ref = sample(pool, prompts, strategy, device="cpu", **kw)
    assert got == ref


# ---------------------------------------------------------------------------
# the parallel layer on one card (core/mesh.py, models/clip.py): the two
# tensor-parallel shards of a tower in one process through the kernels at
# H / 2 heads, and the gradient sync through a world-size-1 NCCL group


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tower", ["image", "text"])
def test_tp_shards_through_the_kernels(device, tower, dtype):
    """test_tiny's towers cut in two by tp_shard_state_dict, both shards'
    blocks run on the card (2 heads a shard) and summed in place of the
    all-reduce: the output and the gradients (the input's, the first
    block's qkv weight joined) against the whole tower; fp32 to 1e-4 of
    each tensor's largest value (summation order), bf16 to 5e-2 (each
    shard's partial output rounded before the sum)."""
    from swat_tpu_torch.core.precision import (DEFAULT_PRECISION,
                                               FP32_PRECISION)
    from swat_tpu_torch.models.clip import (CLIPModel, TensorParallel,
                                            lockstep_transformer, tp_join,
                                            tp_shard_state_dict)
    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config("test_tiny")
    prec = FP32_PRECISION if dtype == torch.float32 else DEFAULT_PRECISION
    sd = CLIPModel(cfg).init_random(
        torch.Generator().manual_seed(0)).state_dict()
    full = CLIPModel(cfg, precision=prec)
    full.load_state_dict(sd)
    full.to(device)
    shards = []
    for r in range(2):
        m = CLIPModel(cfg, precision=prec).tensor_parallel_(
            TensorParallel(2, r, lambda t: t))
        m.load_state_dict(tp_shard_state_dict(sd, cfg, 2, r))
        shards.append(m.to(device))
    causal, seq, heads = ((False, 17, cfg.vision.heads) if tower == "image"
                          else (True, 16, cfg.text.heads))

    def stack(m):
        return m.visual.transformer if tower == "image" else m.transformer

    width = stack(full).resblocks[0].ln_1.weight.shape[0]
    g = torch.Generator(device=device).manual_seed(3)
    x0 = torch.randn(8, seq, width, generator=g, device=device)
    wt = torch.randn(8, seq, width, generator=g, device=device)
    outs = []
    for models in ([full], shards):
        x = x0.to(dtype).clone().requires_grad_(True)
        before = (FA.LAUNCHES, FA.LAUNCHES_BWD)
        y = (stack(full)(x, causal, prec, FA.mha_qkv) if len(models) == 1
             else lockstep_transformer([stack(m) for m in models], x,
                                       causal, prec, FA.mha_qkv))
        (y.float() * wt).sum().backward()
        launched = (FA.LAUNCHES - before[0], FA.LAUNCHES_BWD - before[1])
        w_grad = (stack(full).resblocks[0].attn.in_proj_weight.grad
                  if len(models) == 1 else
                  tp_join("qkv", [stack(m).resblocks[0].attn.in_proj_weight
                                  .grad for m in models], heads))
        outs.append((y.detach(), x.grad, w_grad))
    layers = len(stack(full).resblocks)
    assert launched == (2 * layers, 2 * layers)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for got, ref in zip(outs[1], outs[0]):
        scale = ref.float().abs().max()
        assert float((got.float() - ref.float()).abs().max()) <= tol * scale


@contextlib.contextmanager
def _one_rank_nccl():
    """A world-size-1 NCCL group on this card, ended on leaving -> the
    one-rank mesh given that group, whose collectives run
    (``Mesh.live``)."""
    import socket

    import torch.distributed as dist

    from swat_tpu_torch.core.mesh import Mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield Mesh(1, 1, 0, data_group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def test_grad_sync_through_a_one_rank_nccl_group(device, tmp_path):
    """A cutmix step of test_tiny on a one-rank NCCL mesh (its encode
    through ``on_rows``' all_gather, its gradients through the flat
    bucket's all-reduce) equals the step without a mesh, bit for bit."""
    import numpy as np

    from swat_tpu_torch.core.precision import FP32_PRECISION
    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import make_mixing_step, make_sampler

    with _one_rank_nccl() as one_rank:
        cfg = get_model_config("test_tiny")
        sd = CLIPModel(cfg).init_random(
            torch.Generator().manual_seed(0)).state_dict()
        rng = np.random.default_rng(0)
        batch = {"canvases": rng.integers(0, 256, (8, 40, 40, 3)
                                          ).astype(np.uint8),
                 "valid_hw": np.full((8, 2), 40, np.int32),
                 "labels": rng.integers(0, 3, 8).astype(np.int32),
                 "source": rng.integers(0, 2, 8).astype(np.int32)}
        draws = make_sampler("cutmix", mix_prob=1.0, image_size=32)(
            np.random.default_rng(1), batch)
        head = torch.from_numpy(rng.standard_normal((3, cfg.embed_dim)
                                                    ).astype(np.float32))
        got = []
        for mesh in (None, one_rank):
            model = CLIPModel(cfg, precision=FP32_PRECISION)
            model.load_state_dict(sd)
            model.to(device).eval().requires_grad_(False)
            state = create_train_state(model, head, "cutmix",
                                       lr_classifier=1e-2, lr_backbone=1e-4,
                                       total_iter=10, mesh=mesh)
            loss = make_mixing_step("cutmix", image_size=32)(state, batch,
                                                             draws)
            got.append((float(loss), {
                k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()},
                state.head.detach().cpu().clone()))
        assert got[1][0] == got[0][0]
        assert torch.equal(got[1][2], got[0][2])
        for k, v in got[0][1].items():
            assert torch.equal(got[1][1][k], v), k


def test_collectives_through_a_one_rank_nccl_group(device):
    """Each collective of the data-parallel layer on a one-rank NCCL mesh
    gives what no mesh gives, bit for bit: the trainer's ``gather_batch``
    of a loader's batch, a resident split's batch (its uint8 all-reduce),
    ``on_rows`` forward and backward, ``reduce_sum`` and ``sync_grads``."""
    import numpy as np

    from swat_tpu_torch.core.mesh import on_rows, resident_sharding
    from swat_tpu_torch.data.pipeline import local_keys
    from swat_tpu_torch.train.resident import ResidentData

    rng = np.random.default_rng(0)
    batch = {"canvases": rng.integers(0, 256, (8, 40, 40, 3)
                                      ).astype(np.uint8),
             "valid_hw": np.full((8, 2), 40, np.int32),
             "labels": rng.integers(0, 3, 8).astype(np.int32),
             "canvases_fs": torch.from_numpy(rng.integers(
                 0, 256, (4, 40, 40, 3)).astype(np.uint8)).to(device)}
    idx = rng.permutation(16)[:8]
    canvases = torch.from_numpy(rng.integers(
        0, 256, (16, 40, 40, 3)).astype(np.uint8)).to(device)
    valid_hw = np.full((16, 2), 40, np.int32)
    labels = torch.arange(16, device=device)
    x = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32)
                         ).to(device)
    w = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)
                         ).to(device)

    def run(mesh):
        out = {}
        got = (batch if mesh is None
               else mesh.gather_batch(batch, device, local_keys(batch)))
        out.update({f"batch_{k}": torch.as_tensor(v).cpu()
                    for k, v in got.items()})
        split = ResidentData(canvases, valid_hw, labels, labels, mesh,
                             resident_sharding(mesh, 16))
        out["resident"] = split.batch(idx)["canvases"].cpu()
        xg = x.clone().requires_grad_(True)
        y = on_rows(mesh, lambda t: t @ w, xg)
        y.square().sum().backward()
        out["on_rows"], out["on_rows_grad"] = y.detach().cpu(), xg.grad.cpu()
        out["reduce_sum"] = (x.sum(0) if mesh is None
                             else mesh.reduce_sum(x.sum(0))).cpu()
        p = torch.nn.Parameter(w.clone())
        p.grad = x[:5, :3].clone()
        if mesh is not None:
            mesh.sync_grads([p])
        out["sync_grads"] = p.grad.cpu()
        return out

    ref = run(None)
    with _one_rank_nccl() as mesh:
        assert resident_sharding(mesh, 16) == slice(0, 16)
        assert sorted(local_keys(batch)) == ["canvases", "canvases_fs",
                                             "valid_hw"]
        got = run(mesh)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ---------------------------------------------------------------------------
# the LayerNorm kernel pair

LN_EPS = 1e-5


def _ln_inputs(rows, width, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, mean=0.0, std=1.0):
        return mean + std * torch.randn(*shape, generator=g, device=device)

    x = normal(rows, width, mean=0.3, std=2.0).to(dtype)
    dy = normal(rows, width).to(dtype)
    return x, normal(width, mean=1.0, std=0.5), normal(width, std=0.5), dy


def _ln_run(x, w, b, dy, fast):
    """Both kernels on the card -> (y, mu, rstd, dx, dw, db) on the CPU."""
    y, mu, rstd = LN.layer_norm_fwd(x, w, b, fast, LN_EPS, x.dtype)
    dx, dw, db = LN.layer_norm_bwd(x, dy, mu, rstd, w)
    torch.cuda.synchronize()
    return tuple(t.cpu() for t in (y, mu, rstd, dx, dw, db))


def _ln_model(x, w, b, dy, fast):
    y, mu, rstd = ln_model_fwd(x.cpu(), w.cpu(), b.cpu(), fast, LN_EPS,
                               x.dtype)
    return (y, mu, rstd, *ln_model_bwd(x.cpu(), dy.cpu(), mu, rstd, w.cpu()))


LN_NAMES = ("y", "mu", "rstd", "dx", "dw", "db")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("rows,width", [
    (131, 512), (131, 768), (131, 1024), (3, 64), (70, 1001), (33, 1280),
    (65, 3000), (17, 6000), (256 * 50, 768), (64 * 257, 1024)])
def test_ln_kernels_are_the_model_bit_for_bit(device, dtype, fast, rows,
                                              width):
    """Every output of both kernels equals the model of their arithmetic:
    the towers' widths and shapes (B/32's and L/14's blocks), a width of
    no whole vectors, rows of 2, 4 and 8 warps, both dtypes."""
    x, w, b, dy = _ln_inputs(rows, width, dtype, device)
    got = _ln_run(x, w, b, dy, fast)
    ref = _ln_model(x, w, b, dy, fast)
    for name, a, r in zip(LN_NAMES, got, ref):
        assert a.dtype == r.dtype and torch.equal(a, r), (
            name, (a.float() - r.float()).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,width", [(256 * 50, 768), (64 * 257, 1024),
                                        (1024 * 77, 512)])
def test_ln_kernels_match_plain_twins(device, dtype, rows, width):
    """Both kernels against their plain twins on the card at the towers'
    shapes, under the policy's variance: fp32 within summation order, bf16
    within a rounding flip of an element."""
    fast = dtype == torch.bfloat16
    x, w, b, dy = _ln_inputs(rows, width, dtype, device, seed=1)
    y, mu, rstd, dx, dw, db = _ln_run(x, w, b, dy, fast)
    y_ref, mu_ref, rstd_ref = LN.layer_norm_reference(x, w, b, fast, LN_EPS,
                                                      dtype)
    grads = LN.layer_norm_bwd_reference(x, dy, mu_ref, rstd_ref, w)
    for name, a, r in zip(LN_NAMES, (y, mu, rstd, *(dx, dw, db)),
                          (y_ref, mu_ref, rstd_ref, *grads)):
        r = r.cpu().float()
        err = (a.float() - r).abs()
        scale = r.abs().max()
        rel = 2 ** -7 if a.dtype == torch.bfloat16 else 0.0
        assert bool((err <= rel * r.abs() + 1e-5 * scale).all()), (
            name, err.max().item(), scale.item())


def test_ln_parameter_gradients_are_deterministic(device):
    x, w, b, dy = _ln_inputs(64 * 257, 1024, torch.bfloat16, device)
    first = _ln_run(x, w, b, dy, True)
    second = _ln_run(x, w, b, dy, True)
    for name, a, r in zip(LN_NAMES, first, second):
        assert torch.equal(a, r), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_function_runs_both_kernels_once_a_call(device, dtype):
    """Through clip.layer_norm: one forward launch, one backward launch a
    call, the gradients of the saved x, weight and bias; under no_grad the
    forward alone, nothing saved, no backward."""
    from torch import nn

    from swat_tpu_torch.core.precision import (DEFAULT_PRECISION,
                                               FP32_PRECISION)
    from swat_tpu_torch.models import clip

    p = DEFAULT_PRECISION if dtype == torch.bfloat16 else FP32_PRECISION
    ln = nn.LayerNorm(768).to(device)
    x, w, b, dy = _ln_inputs(9 * 50, 768, dtype, device)
    with torch.no_grad():
        ln.weight.copy_(w)
        ln.bias.copy_(b)
    x = x.reshape(9, 50, 768).requires_grad_(True)
    fwd, bwd = LN.LAUNCHES_LN, LN.LAUNCHES_LN_BWD
    y = clip.layer_norm(ln, x, p)
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    assert (LN.LAUNCHES_LN, LN.LAUNCHES_LN_BWD) == (fwd + 1, bwd)
    y.backward(dy.reshape(9, 50, 768))
    assert (LN.LAUNCHES_LN, LN.LAUNCHES_LN_BWD) == (fwd + 1, bwd + 1)
    ref = _ln_model(x.detach().reshape(-1, 768), w, b, dy,
                    p.ln_fast_variance)
    assert torch.equal(y.detach().reshape(-1, 768).cpu(), ref[0])
    assert torch.equal(x.grad.reshape(-1, 768).cpu(), ref[3])
    assert torch.equal(ln.weight.grad.cpu(), ref[4])
    assert torch.equal(ln.bias.grad.cpu(), ref[5])
    with torch.no_grad():
        assert clip.layer_norm(ln, x, p).grad_fn is None
    assert (LN.LAUNCHES_LN, LN.LAUNCHES_LN_BWD) == (fwd + 2, bwd + 1)


def test_ln_takes_the_class_token_view_and_unaligned_rows(device):
    """ln_post's x[:, 0] (rows strided by S * W) and rows that start off a
    16-byte boundary (element by element) give the model's bits."""
    seq, w, b, _ = _ln_inputs(9 * 50, 768, torch.bfloat16, device)
    seq = seq.reshape(9, 50, 768)
    for x in (seq[:, 0], seq[:, 0, 3:]):
        width = x.shape[-1]
        dy = torch.randn(9, width, device=device).bfloat16()
        got = _ln_run(x, w[:width], b[:width], dy, True)
        ref = _ln_model(x, w[:width], b[:width], dy, True)
        for name, a, r in zip(LN_NAMES, got, ref):
            assert torch.equal(a, r), name


def test_ln_refusals_raise_and_do_not_count(device):
    x, w, b, dy = _ln_inputs(8, 512, torch.float32, device)
    wide = torch.zeros(2, LN.MAX_WIDTH + 8, device=device)
    before = (LN.LAUNCHES_LN, LN.LAUNCHES_LN_BWD)
    with pytest.raises(TypeError):
        LN.layer_norm_fwd(x.half(), w, b, True, LN_EPS, torch.float16)
    # the output in another dtype than x's
    with pytest.raises(TypeError):
        LN.layer_norm_fwd(x, w, b, True, LN_EPS, torch.bfloat16)
    with pytest.raises(ValueError, match="weight"):
        LN.layer_norm_fwd(x, w.cpu(), b, True, LN_EPS, torch.float32)
    with pytest.raises(ValueError, match="weight"):
        LN.layer_norm_fwd(x, w.bfloat16(), b, True, LN_EPS, torch.float32)
    with pytest.raises(ValueError, match="beyond"):
        LN.layer_norm_fwd(wide, wide[0] + 1, wide[0], True, LN_EPS,
                          torch.float32)
    assert (LN.LAUNCHES_LN, LN.LAUNCHES_LN_BWD) == before
    _, mu, rstd = LN.layer_norm_fwd(x, w, b, True, LN_EPS, torch.float32)
    before = (LN.LAUNCHES_LN, LN.LAUNCHES_LN_BWD)
    with pytest.raises(ValueError, match="dy must match"):
        LN.layer_norm_bwd(x, dy[:4], mu, rstd, w)
    with pytest.raises(TypeError):
        LN.layer_norm_bwd(x, dy.half(), mu, rstd, w)
    assert (LN.LAUNCHES_LN, LN.LAUNCHES_LN_BWD) == before


# ---------------------------------------------------------------------------
# the BatchNorm kernel set (kernels/batch_norm.py)

BN_EPS = 1e-5
RN50 = get_model_config("rn50_openclip_openai")
# every distinct (C, side) of RN50's 55 BatchNorms at 8 images, and the
# stem's first at the cell's 256 (3.2 M rows, the most slabs)
BN_SHAPES = sorted({(8, c, side) for c, side, _ in
                    rn50_bn_shapes(RN50.vision)}) + [(256, 32, 112)]
# kernel vs twin: the statistics differ in summation order only (fp32
# Welford partials over slabs against torch's reductions), so a, b and the
# backward's sums by an fp32 ulp or two; an output elementwise within
# 1e-5 of its largest value, and in bf16 within a rounding flip of its
# element (2^-7 relative), bit-equal in BN_MIN_EQUAL_SHARE of it
BN_MIN_EQUAL_SHARE = 0.99


def _bn_inputs(bsz, c, side, dtype, device, seed=0):
    """x and dy channels-last [B, C, side, side], fp32 weight and bias."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, mean=0.0, std=1.0):
        return mean + std * torch.randn(*shape, generator=g, device=device)

    x = normal(bsz, side, side, c, mean=0.4, std=1.5).to(dtype)
    dy = normal(bsz, side, side, c).to(dtype)
    return (x.permute(0, 3, 1, 2), normal(c, mean=1.0, std=0.3),
            normal(c, std=0.2), dy.permute(0, 3, 1, 2))


def _bn_close(name, got, ref):
    rel = 2 ** -7 if got.dtype == torch.bfloat16 else 0.0
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = ref.abs().max()
    assert bool((err <= rel * ref.abs() + 1e-5 * scale).all()), (
        name, err.max().item(), scale.item())


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,c,side", BN_SHAPES)
def test_bn_kernels_match_plain_twins(device, bsz, c, side, dtype, relu):
    """Forward and backward against the twins: the statistics, a, b and y
    against batch_norm_reference; dx, dw and db against
    batch_norm_bwd_reference on the kernels' own statistics."""
    x, w, b, dy = _bn_inputs(bsz, c, side, dtype, device)
    got = BN.batch_norm_fwd(x, w, b, BN_EPS, relu)
    ref = BN.batch_norm_reference(x, w, b, BN_EPS, relu)
    y, mean, var, rstd, a, bb = got
    assert y.dtype == a.dtype == dtype and mean.dtype == torch.float32
    assert y.is_contiguous(memory_format=torch.channels_last)
    for name, g_, r in zip(("y", "mean", "var", "rstd", "a", "b"), got, ref):
        _bn_close(name, g_, r)
    grads = BN.batch_norm_bwd(x, dy, mean, rstd, w, a, bb, relu)
    grads_ref = BN.batch_norm_bwd_reference(x, dy, mean, rstd, w, a, bb, relu)
    for name, g_, r in zip(("dx", "dw", "db"), grads, grads_ref):
        _bn_close(name, g_, r)
    assert grads[0].is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.bfloat16:
        for g_, r in ((y, ref[0]), (grads[0], grads_ref[0])):
            assert float((g_ == r).float().mean()) >= BN_MIN_EQUAL_SHARE


def test_bn_kernels_are_deterministic(device):
    x, w, b, dy = _bn_inputs(32, 32, 112, torch.bfloat16, device)
    outs = []
    for _ in range(2):
        y, mean, var, rstd, a, bb = BN.batch_norm_fwd(x, w, b, BN_EPS, True)
        outs.append((y, mean, var, rstd, a, bb,
                     *BN.batch_norm_bwd(x, dy, mean, rstd, w, a, bb, True)))
    for first, second in zip(*outs):
        assert torch.equal(first, second)


@pytest.mark.parametrize("layout", ["contiguous", "unaligned_start",
                                    "channels_last"])
def test_bn_takes_other_layouts_and_unaligned_starts(device, layout):
    """A contiguous x and dy, or channels-last ones that start off a 16-byte
    boundary, are copied to aligned channels-last ones (3 copies counted:
    x and dy for the backward, x for the forward) and give the twins'
    outputs; channels-last ones on a boundary are taken as they are."""
    x, w, b, dy = _bn_inputs(3, 64, 9, torch.float32, device, seed=2)
    if layout == "contiguous":
        x, dy = x.contiguous(), dy.contiguous()
    elif layout == "unaligned_start":
        def shifted(t):
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
            out = flat[1:].view(3, 9, 9, 64).permute(0, 3, 1, 2)
            out.copy_(t)
            assert out.is_contiguous(memory_format=torch.channels_last)
            return out

        x, dy = shifted(x), shifted(dy)
        assert x.data_ptr() % 16 and dy.data_ptr() % 16
    copies = BN.COPIES_BN
    y, mean, var, rstd, a, bb = BN.batch_norm_fwd(x, w, b, BN_EPS, True)
    grads = BN.batch_norm_bwd(x, dy, mean, rstd, w, a, bb, True)
    assert BN.COPIES_BN - copies == (0 if layout == "channels_last" else 3)
    _bn_close("y", y, BN.batch_norm_reference(x, w, b, BN_EPS, True)[0])
    for name, g_, r in zip(("dx", "dw", "db"), grads,
                           BN.batch_norm_bwd_reference(
                               x, dy, mean, rstd, w, a, bb, True)):
        _bn_close(name, g_, r)


def test_bn_refusals_raise_and_do_not_count(device):
    x, w, b, dy = _bn_inputs(2, 16, 4, torch.float32, device)
    before = (BN.LAUNCHES_BN, BN.LAUNCHES_BN_BWD)
    with pytest.raises(TypeError):
        BN.batch_norm_fwd(x.half(), w, b, BN_EPS, False)
    with pytest.raises(ValueError, match="weight"):
        BN.batch_norm_fwd(x, w.cpu(), b, BN_EPS, False)
    with pytest.raises(ValueError, match="bias"):
        BN.batch_norm_fwd(x, w, b.bfloat16(), BN_EPS, False)
    with pytest.raises(ValueError, match="B, C, H, W"):
        BN.batch_norm_fwd(x[0], w, b, BN_EPS, False)
    # channels that 16-byte vectors do not divide: 4 fp32 or 8 bf16
    for dtype, c in ((torch.float32, 22), (torch.bfloat16, 12)):
        xc, wc, bc, _ = _bn_inputs(2, c, 4, dtype, device)
        with pytest.raises(ValueError, match="16-byte"):
            BN.batch_norm_fwd(xc, wc, bc, BN_EPS, False)
    assert (BN.LAUNCHES_BN, BN.LAUNCHES_BN_BWD) == before
    y, mean, var, rstd, a, bb = BN.batch_norm_fwd(x, w, b, BN_EPS, False)
    before = (BN.LAUNCHES_BN, BN.LAUNCHES_BN_BWD)
    with pytest.raises(ValueError, match="dy must match"):
        BN.batch_norm_bwd(x, dy[:1], mean, rstd, w, a, bb, False)
    with pytest.raises(ValueError, match="dy must match"):
        BN.batch_norm_bwd(x, dy.bfloat16(), mean, rstd, w, a, bb, False)
    assert (BN.LAUNCHES_BN, BN.LAUNCHES_BN_BWD) == before


def _rn50_tower(device):
    from swat_tpu_torch.models.resnet import ModifiedResNet

    torch.manual_seed(0)
    model = ModifiedResNet(RN50.vision).to(device)
    # its fp32 calibration pass runs on the card: 55 forward calls
    model.init_random(torch.Generator().manual_seed(0))
    return model


def test_bn_rn50_train_forward_runs_55_calls_each_way(device):
    """One RN50 train forward and backward at 2 images, bf16: 55 forward
    calls, 55 backward calls, no layout copy, 55 update pairs."""
    from swat_tpu_torch.core.precision import DEFAULT_PRECISION
    from swat_tpu_torch.models import resnet

    model = _rn50_tower(device)
    images = torch.randn(2, 224, 224, 3, device=device)
    before = (BN.LAUNCHES_BN, BN.LAUNCHES_BN_BWD, BN.COPIES_BN,
              resnet.BN_BATCH_STATS)
    updates = resnet.BNUpdates()
    feats = model(images, DEFAULT_PRECISION, updates=updates)
    assert BN.LAUNCHES_BN - before[0] == 55 == len(updates)
    assert BN.LAUNCHES_BN_BWD == before[1]
    feats.float().square().mean().backward()
    torch.cuda.synchronize()
    assert BN.LAUNCHES_BN_BWD - before[1] == 55
    assert BN.COPIES_BN == before[2]
    assert resnet.BN_BATCH_STATS - before[3] == 55


# the RN50 step against the plain path on the card.  fp32: chip_smoke.py's
# bounds for the card against the CPU (the loss and the folded statistics
# relative to their largest value, RN50_REL; each gradient's cosine,
# GRAD_MIN_COS).  bf16: a statistic summed in another order flips a
# rounding of a or b now and then, which 16 bottlenecks carry on, so the
# loss and the statistics are held to tests/test_torch_resnet.py's bf16
# BN_REL, and the gradients to the fp32 step's: each leaf's gap over the
# larger of its fp32 norm and the median leaf's (the cell's grad_norm_gap
# measure, by vector), on average over the leaves no larger than the
# plain path's own
BN_STEP_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BN_STEP_MIN_COS = 1 - 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_rn50_step_matches_the_plain_path(device, dtype, monkeypatch):
    """An RN50 train forward, a loss, every gradient and the running
    statistics folded after it, at 4 images: the kernels against
    AffineBN's plain passes (the twin under autograd) on the same card."""
    import statistics

    from swat_tpu_torch.core.precision import (DEFAULT_PRECISION,
                                               FP32_PRECISION)
    from swat_tpu_torch.models import resnet

    images = torch.randn(4, 224, 224, 3, device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(1))

    def step(precision):
        precision.apply_backend_flags()
        model = _rn50_tower(device)
        updates = resnet.BNUpdates()
        feats = model(images, precision, updates=updates)
        loss = feats.square().mean()
        loss.backward()
        resnet.fold_bn_updates(updates)
        # the key bias's gradient is rounding noise (the softmax cancels a
        # shift of every score of a query)
        return (float(loss.detach()), {
            n: p.grad.double().flatten() for n, p in model.named_parameters()
            if not n.endswith("k_proj.bias")},
            {k: v.double() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))})

    precision = FP32_PRECISION if dtype == torch.float32 \
        else DEFAULT_PRECISION
    calls = BN.LAUNCHES_BN
    loss, grads, stats = step(precision)
    assert BN.LAUNCHES_BN - calls == 2 * 55   # init_random's pass, the step

    def plain(x, w, b, eps, relu):
        y, mean, var, *_ = BN.batch_norm_reference(x, w, b, eps, relu)
        return y, mean.detach(), var.detach()

    monkeypatch.setattr(resnet.BN, "batch_norm", plain)
    loss_p, grads_p, stats_p = step(precision)
    rel = BN_STEP_REL[dtype]
    assert abs(loss - loss_p) <= rel * abs(loss_p), (loss, loss_p)
    for k, v in stats.items():
        err = float((v - stats_p[k]).abs().max() / stats_p[k].abs().max())
        assert err <= rel, (k, err)
    if dtype == torch.float32:
        for name, g in grads.items():
            cos = float(torch.nn.functional.cosine_similarity(
                g, grads_p[name], dim=0))
            assert cos >= BN_STEP_MIN_COS, (name, cos)
        return
    _, grads_32, _ = step(FP32_PRECISION)
    med = statistics.median(float(g.norm()) for g in grads_32.values())

    def gaps(got):
        return [float((got[k] - g.view_as(got[k])).norm())
                / max(float(g.norm()), med) for k, g in grads_32.items()]

    kernel, plain_gaps = gaps(grads), gaps(grads_p)
    assert statistics.mean(kernel) <= statistics.mean(plain_gaps), (
        statistics.mean(kernel), max(kernel), statistics.mean(plain_gaps),
        max(plain_gaps))
