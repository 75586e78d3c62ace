"""The port's CUDA attention kernels on the card (marked ``cuda``; skipped
without a GPU and nvcc): the packed-head and the heads-first forward and
backward against their plain twins at ragged and main-path shapes, fp32 and
bf16, strided and contiguous; the launch counts; determinism; the autograd
Functions and the three backward modes; and the wrappers' refusals.  Run
them on a GPU machine with ``python -m pytest tests/test_torch_cuda.py``."""

import pytest
import torch

from swat_tpu_torch.kernels import flash_attention as FA

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
