"""The port's attention backward on the CPU (the backward kernel's plain
twin, swat_tpu_torch.kernels.flash_attention.mha_bwd_reference) against
the JAX package's Pallas backward ``_mha_bwd_kernel``, run in interpret
mode as ``jax.vjp`` of ``mha_packed(..., bwd="pallas")``: fp32 and bf16,
causal and not, S not a multiple of 8, on strided q/k/v cut from one qkv
tensor as the towers cut them.  Then the port's autograd Function on CPU
tensors, which must give the plain twin's dq/dk/dv exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import TORCH_THREADS

from swat_tpu.kernels.flash_attention import mha_packed as jax_mha_packed
from swat_tpu_torch.kernels import flash_attention as FA

torch.set_num_threads(TORCH_THREADS)

SHAPES = [(5, 4, 64), (9, 2, 64), (50, 12, 768), (77, 8, 512)]  # S, H, H*D
# bf16: with the same rounding points, the two differ only in fp32
# summation order, which flips a bf16 rounding (of ds or of an output) in
# about 2 of 10^4 elements (measured); one rounding point done wrong leaves
# 58-78 % of an output bit-equal
MIN_EQUAL_SHARE = 0.99


def _inputs(s, hd, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((batch, s, 3 * hd)).astype(np.float32)
    do = rng.standard_normal((batch, s, hd)).astype(np.float32)
    return qkv, do


def _jax(qkv, do, heads, causal, dtype):
    q, k, v = (jnp.asarray(t, dtype) for t in np.split(qkv, 3, axis=-1))

    def f(q, k, v):
        return jax_mha_packed(q, k, v, heads=heads, causal=causal,
                              interpret=True, bwd="pallas")

    _, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do, dtype))]


def _port(qkv, do, heads, causal, dtype):
    hd = qkv.shape[-1] // 3
    q, k, v = torch.from_numpy(qkv).to(dtype).split(hd, dim=-1)
    grads = FA.mha_bwd_reference(q, k, v, torch.from_numpy(do).to(dtype),
                                 heads, causal)
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,heads,hd", SHAPES)
def test_fp32_matches_pallas_bwd_interpret(s, heads, hd, causal):
    """fp32: the same math, summed in another order (delta and the three
    products over S keys); gradients are of order 1, so a few fp32 ulps."""
    qkv, do = _inputs(s, hd)
    for name, got, ref in zip(("dq", "dk", "dv"),
                              _port(qkv, do, heads, causal, torch.float32),
                              _jax(qkv, do, heads, causal, jnp.float32)):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,heads,hd", SHAPES)
def test_bf16_matches_pallas_bwd_interpret(s, heads, hd, causal):
    """bf16: both round pb and ds to bf16 and the outputs once; a last-bit
    difference in the fp32 softmax or delta can flip one rounding of ds or
    of an output (one bf16 ulp is 2^-7 relative), so two ulps of the
    output plus one ds flip (1e-2 absolute).  That bound cannot tell the
    rounding points apart, so each output must also be bit-equal in at
    least MIN_EQUAL_SHARE of its elements."""
    qkv, do = _inputs(s, hd, seed=1)
    for name, got, ref in zip(("dq", "dk", "dv"),
                              _port(qkv, do, heads, causal, torch.bfloat16),
                              _jax(qkv, do, heads, causal, jnp.bfloat16)):
        np.testing.assert_allclose(got, ref, rtol=1.6e-2, atol=1e-2,
                                   err_msg=name)
        assert np.mean(got == ref) >= MIN_EQUAL_SHARE, name


def _bwd_with(q, k, v, do, heads, wrong):
    """mha_bwd_reference with one rounding point done ``wrong``."""
    scale = 1.0 / (q.shape[2] // heads) ** 0.5
    p, _ = FA._softmax(q, k, heads, False)
    dof = FA._split_heads(do, heads)
    pb = p.to(q.dtype).float()
    dv = torch.matmul((p if wrong == "p_in_dv" else pb).transpose(-1, -2),
                      dof)
    dp = torch.matmul(dof, FA._split_heads(v, heads).transpose(-1, -2))
    if wrong == "delta_from_do_o":
        o = FA._split_heads(FA.mha_packed_reference(q, k, v, heads), heads)
        delta = (dof * o).sum(dim=-1, keepdim=True)
    else:
        delta = ((pb if wrong == "pb_in_delta" else p) * dp).sum(
            dim=-1, keepdim=True)
    ds = (pb if wrong == "pb_in_ds" else p) * (dp - delta) * scale
    if wrong != "ds_unrounded":
        ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, FA._split_heads(k, heads))
    dk = torch.matmul(ds.transpose(-1, -2), FA._split_heads(q, heads))
    return [FA._merge_heads(t, q.dtype).float().numpy() for t in (dq, dk, dv)]


@pytest.mark.parametrize("wrong", ["delta_from_do_o", "pb_in_delta",
                                   "pb_in_ds", "ds_unrounded", "p_in_dv"])
def test_bf16_equal_share_catches_a_wrong_rounding_point(wrong):
    """The bit-equal share separates the rounding points that the bf16
    bound lets through: with one of them done wrong, some output still
    meets the bound but is bit-equal to the Pallas backward in well under
    MIN_EQUAL_SHARE of its elements (measured 0.58-0.78)."""
    qkv, do = _inputs(50, 768, seed=1)
    q, k, v = torch.from_numpy(qkv).bfloat16().split(768, dim=-1)
    got = _bwd_with(q, k, v, torch.from_numpy(do).bfloat16(), 12, wrong)
    ref = _jax(qkv, do, 12, False, jnp.bfloat16)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1.6e-2, atol=1e-2)
    assert min(np.mean(g == r) for g, r in zip(got, ref)) < MIN_EQUAL_SHARE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_on_cpu_runs_the_plain_twins(dtype, causal):
    """mha_qkv on CPU tensors is the same autograd Function as on the
    card, with the two plain twins inside: its output and its qkv gradient
    are exactly the twins', and no kernel launch is counted."""
    qkv_np, do_np = _inputs(9, 64, seed=2)
    qkv = torch.from_numpy(qkv_np).to(dtype).requires_grad_(True)
    do = torch.from_numpy(do_np).to(dtype)
    q, k, v = qkv.split(64, dim=-1)
    before = (FA.LAUNCHES, FA.LAUNCHES_BWD)
    out = FA.mha_qkv(qkv, 4, causal)
    (grad,) = torch.autograd.grad(out, qkv, do)
    assert (FA.LAUNCHES, FA.LAUNCHES_BWD) == before
    ref_out = FA.mha_packed_reference(q.detach(), k.detach(), v.detach(), 4,
                                      causal)
    ref = FA.mha_bwd_reference(q.detach(), k.detach(), v.detach(), do, 4,
                               causal)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(grad, torch.cat(ref, dim=-1), rtol=0, atol=0)
    assert grad.dtype == dtype


def test_bwd_reference_masked_keys_get_no_gradient():
    """Causal: key j is seen only by rows i >= j, so the last key's dk and
    dv come from the last row alone; the first row's dq is zero (one key,
    p = 1, ds = 0)."""
    qkv_np, do_np = _inputs(6, 64, seed=4)
    q, k, v = torch.from_numpy(qkv_np).split(64, dim=-1)
    do = torch.from_numpy(do_np)
    dq, dk, dv = FA.mha_bwd_reference(q, k, v, do, 4, causal=True)
    torch.testing.assert_close(dq[:, 0], torch.zeros_like(dq[:, 0]))
    do_last = torch.zeros_like(do)
    do_last[:, -1] = do[:, -1]
    _, dk1, dv1 = FA.mha_bwd_reference(q, k, v, do_last, 4, causal=True)
    torch.testing.assert_close(dv[:, -1], dv1[:, -1])
    torch.testing.assert_close(dk[:, -1], dk1[:, -1])


def test_qkv_gradient_is_the_backward_output_as_it_stands(monkeypatch):
    """Through the towers' attention, the gradient that reaches the qkv
    projection is the very tensor mha_packed_bwd returned (on the card, the
    buffer the backward kernel wrote its three thirds into): autograd
    neither splits nor joins it."""
    returned = []

    def bwd(*args):
        returned.append(FA_bwd(*args))
        return returned[-1]

    FA_bwd = FA.mha_packed_bwd
    monkeypatch.setattr(FA, "mha_packed_bwd", bwd)
    qkv_np, do_np = _inputs(9, 64, seed=3)
    qkv = torch.from_numpy(qkv_np).requires_grad_(True)
    out = FA.mha_qkv(qkv, 4, False)
    (grad,) = torch.autograd.grad(out, qkv, torch.from_numpy(do_np))
    assert len(returned) == 1 and grad.data_ptr() == returned[0].data_ptr()
    node = out.grad_fn
    assert type(node).__name__ == "PackedAttentionBackward"
    assert [f.variable is qkv for f, _ in node.next_functions[:1]] == [True]
