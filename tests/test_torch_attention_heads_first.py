"""The heads-first attention of the port on the CPU (its kernels' plain
twins) against swat_tpu.kernels.flash_attention in interpret mode, as the
JAX package's own tests run it: flash_attention forward and gradient,
causal and not, fp32 and bf16; mha_packed under the three ``bwd`` values;
the rounding points that tell the heads-first kernels from the packed-head
ones; strided views; multi_head_attention and the plain attention paths;
and the wrappers' refusals.  The kernels themselves are held against the
same plain twins on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import TORCH_THREADS

from swat_tpu.kernels import attention as jattn
from swat_tpu.kernels import flash_attention as jfa
from swat_tpu_torch.kernels import attention as attn
from swat_tpu_torch.kernels import flash_attention as FA

torch.set_num_threads(TORCH_THREADS)

# fp32: both sides compute in full fp32 and differ in summation order only.
# bf16: both take the operands to fp32 and round the result once, so they
# differ by at most a rounding flip, one bf16 ulp (2^-7 relative) of the
# reference, plus the ulp of values near zero
TOL = {"float32": dict(rtol=0, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -9)}
# mha_packed's bf16 gradients round pb and ds on the way (bwd='pallas' and
# 'fused') or p (bwd='xla'): a flip there moves an output by an ulp of an
# element, and the output's own rounding may flip too: two ulps, the bound
# of tests/test_torch_attention_bwd.py
TOL_PACKED_BF16 = dict(rtol=1.6e-2, atol=1e-2)
SHAPES = [(2, 4, 5, 8), (1, 2, 17, 16), (3, 3, 8, 16), (2, 1, 11, 8)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _j(x, dtype):
    """The same values as ``_t``: rounded to bf16 by torch, then handed to
    JAX (both round to nearest even)."""
    if dtype == jnp.bfloat16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return jnp.asarray(x).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_flash_attention_matches_swat_tpu(shape, causal, dname):
    """Forward and the gradient of sum(out * do) against
    flash_attention(interpret=True) and jax.grad of it."""
    tdt, jdt = DTYPES[dname]
    q, k, v, do = _inputs(shape, seed=sum(shape) + causal)
    jq, jk, jv, jdo = (_j(x, jdt) for x in (q, k, v, do))

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal, interpret=True)

    ref = f(jq, jk, jv)
    ref_grads = jax.grad(
        lambda *a: jnp.sum(f(*a).astype(jnp.float32)
                           * jdo.astype(jnp.float32)), argnums=(0, 1, 2))(
        jq, jk, jv)
    tq, tk, tv = (_t(x, tdt).requires_grad_(True) for x in (q, k, v))
    got = FA.flash_attention(tq, tk, tv, causal)
    assert got.dtype == tdt and got.shape == shape
    grads = torch.autograd.grad(got, (tq, tk, tv), _t(do, tdt))
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dname])
    for name, g, r in zip("qkv", grads, ref_grads):
        assert g.dtype == tdt and g.shape == shape
        np.testing.assert_allclose(_np(g), _np(r), err_msg=f"d{name}",
                                   **TOL[dname])


def test_autograd_function_is_the_kernel_pair():
    """flash_attention is one autograd Function whose backward is the
    heads-first backward (keep_dtype=False), not autograd through the
    forward's plain twin; it saves q, k, v only."""
    q, k, v, do = (_t(x, torch.float32) for x in _inputs((2, 2, 6, 8), 1))
    q.requires_grad_(True)
    out = FA.flash_attention(q, k, v, True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (dq,) = torch.autograd.grad(out, q, do)
    ref = FA.flash_attention_bwd_reference(q.detach(), k, v, do, True)[0]
    assert torch.equal(dq, ref)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forwards_differ_in_bf16_and_agree_in_fp32(causal):
    """The heads-first forward multiplies the unrounded fp32 p by v; the
    packed-head forward rounds p to the input dtype first.  In fp32 the two
    plain twins are one function; in bf16 they differ, and swat_tpu's two
    kernels (interpret mode) show the same split: each port twin is
    bit-equal to its own JAX kernel in nearly every element and to the
    other's in far fewer."""
    b, h, s, d = 2, 4, 17, 16
    q, k, v = _inputs((b, h, s, d), seed=3, n=3)

    def packed(t):
        return t.transpose(1, 2).reshape(b, s, h * d)

    def unpacked(t):
        return t.reshape(b, s, h, d).transpose(1, 2)

    tq, tk, tv = (_t(x, torch.float32) for x in (q, k, v))
    hf = FA.flash_attention_reference(tq, tk, tv, causal)
    pk = unpacked(FA.mha_packed_reference(packed(tq), packed(tk), packed(tv),
                                          h, causal))
    torch.testing.assert_close(hf, pk, rtol=0, atol=1e-6)

    bq, bk, bv = (_t(x, torch.bfloat16) for x in (q, k, v))
    hf = FA.flash_attention_reference(bq, bk, bv, causal)
    pk = unpacked(FA.mha_packed_reference(packed(bq), packed(bk), packed(bv),
                                          h, causal))
    assert not torch.equal(hf, pk)
    jq, jk, jv = (_j(x, jnp.bfloat16) for x in (q, k, v))
    j_hf = _np(jfa.flash_attention(jq, jk, jv, causal=causal, interpret=True))
    j_pk = _np(jfa.mha_packed(*(x.transpose(0, 2, 1, 3).reshape(b, s, h * d)
                                for x in (jq, jk, jv)), heads=h,
                              causal=causal, interpret=True))
    j_pk = j_pk.reshape(b, s, h, d).transpose(0, 2, 1, 3)

    def share(a, ref):
        return float(np.mean(_np(a) == ref))

    assert share(hf, j_hf) > 0.99 > share(hf, j_pk)
    assert share(pk, j_pk) > 0.99 > share(pk, j_hf)
    assert share(hf, j_pk) < 0.95 and share(pk, j_hf) < 0.95


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_forms_differ_in_bf16_and_agree_in_fp32(causal):
    """keep_dtype=False rounds neither pb nor ds, keep_dtype=True rounds
    both (the packed-head backward's points): one function in fp32, two in
    bf16, and the keep-dtype form is the packed-head twin bit for bit."""
    b, h, s, d = 2, 4, 17, 16
    ops = _inputs((b, h, s, d), seed=4)
    f32 = [_t(x, torch.float32) for x in ops]
    for a, c in zip(FA.flash_attention_bwd_reference(*f32, causal, False),
                    FA.flash_attention_bwd_reference(*f32, causal, True)):
        assert torch.equal(a, c)
    bf = [_t(x, torch.bfloat16) for x in ops]
    plain = FA.flash_attention_bwd_reference(*bf, causal, False)
    keep = FA.flash_attention_bwd_reference(*bf, causal, True)
    assert all(not torch.equal(a, c) for a, c in zip(plain, keep))
    packed = FA.mha_bwd_reference(
        *(t.transpose(1, 2).reshape(b, s, h * d) for t in bf), h, causal)
    for a, c in zip(keep, packed):
        assert torch.equal(a, c.reshape(b, s, h, d).transpose(1, 2))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_strided_views_match_contiguous(dname):
    """q, k, v as the transposed views of one qkv projection output (what
    the towers pass), and a strided do: the same numbers as contiguous
    copies, forward and gradient, bit for bit."""
    tdt, _ = DTYPES[dname]
    b, h, s, d = 2, 4, 9, 8
    qkv = _t(_inputs((b, s, 3 * h * d), seed=5, n=1)[0], tdt)
    views = [t.reshape(b, s, h, d).transpose(1, 2)
             for t in qkv.chunk(3, dim=-1)]
    assert not any(t.is_contiguous() for t in views)
    do = _t(_inputs((b, s, h, d), seed=6, n=1)[0], tdt).transpose(1, 2)
    for causal in (False, True):
        outs = []
        for ops in (views, [t.contiguous() for t in views]):
            ops = [t.detach().requires_grad_(True) for t in ops]
            out = FA.flash_attention(*ops, causal)
            outs.append((out, *torch.autograd.grad(out, ops, do)))
        for a, c in zip(*outs):
            assert torch.equal(a, c)


def _packed_grads_jax(qkv, do, heads, causal, bwd, jdt):
    w = do.shape[-1]
    q, k, v = (_j(qkv[..., i * w:(i + 1) * w], jdt) for i in range(3))
    jdo = _j(do, jdt)

    def f(q_, k_, v_):
        return jfa.mha_packed(q_, k_, v_, heads=heads, causal=causal,
                              interpret=True, bwd=bwd)

    out = f(q, k, v)
    grads = jax.grad(lambda *a: jnp.sum(f(*a).astype(jnp.float32)
                                        * jdo.astype(jnp.float32)),
                     argnums=(0, 1, 2))(q, k, v)
    return _np(out), np.concatenate([_np(g) for g in grads], axis=-1)


@pytest.mark.parametrize("bwd", FA.BWD_MODES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,heads,width", [(5, 4, 32), (17, 2, 32),
                                           (12, 4, 64)])
def test_mha_packed_bwd_modes_match_swat_tpu(bwd, causal, dname, s, heads,
                                             width):
    """mha_packed(bwd=...) forward and gradient against swat_tpu's under
    the same value: 'pallas' (_mha), 'fused' (_mha_fast: the heads-first
    backward in its keep-dtype form) and 'xla' (_mha_hybrid: autodiff of
    the plain attention)."""
    tdt, jdt = DTYPES[dname]
    qkv, = _inputs((2, s, 3 * width), seed=s + heads, n=1)
    do, = _inputs((2, s, width), seed=s + heads + 1, n=1)
    ref_out, ref_grad = _packed_grads_jax(qkv, do, heads, causal, bwd, jdt)
    x = _t(qkv, tdt).requires_grad_(True)
    out = FA.mha_qkv(x, heads, causal, bwd)
    (grad,) = torch.autograd.grad(out, x, _t(do, tdt))
    assert grad.dtype == tdt and grad.shape == x.shape
    tol = TOL[dname] if dname == "float32" else TOL_PACKED_BF16
    np.testing.assert_allclose(_np(out), ref_out, **tol)
    np.testing.assert_allclose(_np(grad), ref_grad, **tol)
    # q, k, v given apart take the same route
    q, k, v = (t.detach().requires_grad_(True)
               for t in _t(qkv, tdt).chunk(3, dim=-1))
    out2 = FA.mha_packed(q, k, v, heads, causal, bwd)
    grads2 = torch.autograd.grad(out2, (q, k, v), _t(do, tdt))
    assert torch.equal(out2, out)
    assert torch.equal(torch.cat(grads2, dim=-1), grad)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_fused_gradients_are_bit_equal_to_pallas_on_the_cpu(causal, dname):
    """bwd='fused' below fp32 is the packed-head backward's math at other
    strides, and in fp32 both are plain fp32: the plain gradients are
    bit-equal.  bwd='xla' (no rounding of ds) is not, in bf16."""
    tdt, _ = DTYPES[dname]
    qkv = _t(_inputs((3, 17, 3 * 64), seed=8, n=1)[0], tdt)
    do = _t(_inputs((3, 17, 64), seed=9, n=1)[0], tdt)
    grads = {}
    for bwd in FA.BWD_MODES:
        x = qkv.clone().requires_grad_(True)
        (grads[bwd],) = torch.autograd.grad(FA.mha_qkv(x, 4, causal, bwd), x,
                                            do)
    assert torch.equal(grads["fused"], grads["pallas"])
    if dname == "bfloat16":
        assert not torch.equal(grads["xla"], grads["pallas"])
    torch.testing.assert_close(grads["xla"].float(), grads["pallas"].float(),
                               **(TOL_PACKED_BF16 if dname == "bfloat16"
                                  else dict(rtol=0, atol=1e-5)))


def test_unknown_bwd_mode_is_refused():
    x = torch.zeros(1, 4, 3 * 16)
    with pytest.raises(ValueError, match="bwd must be one of"):
        FA.mha_qkv(x, 2, False, "flash")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_multi_head_attention_matches_swat_tpu(causal, dname):
    """Both routes of multi_head_attention, and attention_heads_last,
    against swat_tpu.kernels.attention (the Pallas route in interpret
    mode, as multi_head_attention picks it off the TPU).  The plain routes
    round the probabilities to the input dtype: in bf16 a flip there moves
    the output by an ulp of an element, so two ulps."""
    tdt, jdt = DTYPES[dname]
    shape = (2, 4, 13, 16)
    q, k, v = _inputs(shape, seed=10, n=3)
    tq, tk, tv = (_t(x, tdt) for x in (q, k, v))
    jq, jk, jv = (_j(x, jdt) for x in (q, k, v))
    tol = TOL[dname] if dname == "float32" else TOL_PACKED_BF16
    for use_pallas in (True, False):
        ref = jattn.multi_head_attention(
            jq, jk, jv, causal=causal, use_pallas=use_pallas,
            matmul_precision="highest")
        got = attn.multi_head_attention(tq, tk, tv, causal=causal,
                                        use_pallas=use_pallas)
        assert got.dtype == tdt and got.shape == shape
        np.testing.assert_allclose(_np(got), _np(ref), **(
            TOL[dname] if use_pallas else tol))
    ref = jattn.attention_heads_last(
        *(x.transpose(0, 2, 1, 3) for x in (jq, jk, jv)), causal=causal,
        matmul_precision="highest")
    got = attn.attention_heads_last(
        *(t.transpose(1, 2) for t in (tq, tk, tv)), causal=causal)
    np.testing.assert_allclose(_np(got), _np(ref), **tol)
    # the towers' callable: the packed qkv in, the packed output out
    qkv = torch.cat([t.transpose(1, 2).reshape(2, 13, 64)
                     for t in (tq, tk, tv)], dim=-1)
    packed = attn.heads_first_attention(qkv, 4, causal)
    want = FA.flash_attention_reference(tq, tk, tv, causal)
    assert torch.equal(packed, want.transpose(1, 2).reshape(2, 13, 64))


@pytest.mark.parametrize("bad,err", [
    ("dtype", TypeError), ("shape", ValueError), ("head_dim", ValueError),
    ("stride", ValueError), ("rank", ValueError), ("empty", ValueError)])
def test_heads_first_refusals(bad, err):
    q = k = v = torch.zeros(2, 4, 9, 16)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "shape":
        k = torch.zeros(2, 4, 8, 16)
    elif bad == "head_dim":
        q = k = v = torch.zeros(2, 4, 9, 128)
    elif bad == "stride":
        q = torch.zeros(2, 4, 16, 9).transpose(2, 3)
    elif bad == "rank":
        q = k = v = torch.zeros(2, 9, 64)
    else:
        q = k = v = torch.zeros(2, 4, 0, 16)
    with pytest.raises(err):
        FA._check_heads_first(q, k, v)


def test_non_cuda_accelerator_tensor_raises_heads_first():
    q = torch.zeros(1, 2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        FA.flash_attention_bwd(q, q, q, q)


def test_output_lies_in_memory_as_its_operand():
    """The kernels' outputs are allocated dense in the operand's dimension
    order, so the towers' transposed views transpose back without a copy."""
    qkv = torch.zeros(2, 5, 3 * 32)
    q = qkv[..., :32].reshape(2, 5, 4, 8).transpose(1, 2)
    out = FA._empty_in_order_of(q)
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    c = FA._empty_in_order_of(torch.zeros(2, 4, 5, 8))
    assert c.is_contiguous()
