"""The arithmetic of the tensor-core attention forward
(swat_tpu_torch/csrc/attention_fwd.cuh), modelled in plain PyTorch and held
on the CPU against the kernels' plain twins and, through the same inputs,
against the Pallas kernels in interpret mode.

The CUDA kernel runs only on a card (tests/test_torch_cuda.py holds it
there).  What can be proved without one is its tiling and its number
format: row blocks of 16, keys padded to 16 and masked, head dims padded to
16, the scores of a whole row kept until the final maximum and sum are
known (a row of more than 128 keys by several warps that join their sums
and their partial outputs), p normalised and only then rounded, every product taken on bf16
terms with fp32 sums: bf16 operands as they are, an fp32 operand as three
terms hi + mid + lo and a product as the six cross terms of weight >= 2^-16,
the leading one summed apart from the five corrections; the unrounded p of
the heads-first kernel as two terms.  ``tiled_forward`` below is that
model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import TORCH_THREADS

from swat_tpu.kernels import flash_attention as jfa
from swat_tpu_torch.kernels import flash_attention as FA

torch.set_num_threads(TORCH_THREADS)

TILE = 16   # query rows a warp, keys a step, the depth of one mma
MAX_STEPS = 8   # key steps whose scores one warp keeps in registers
EDGE_S = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 197, 257]
# the model against a plain twin: fp32 differs by the 2^-24 terms a split
# product leaves out and by summation order, the tolerance of the kernel
# tests on the card; bf16 outputs must be bit-equal in this share (a p
# rounded at the wrong place leaves far fewer, see the last tests)
FP32_TOL = dict(rtol=2e-4, atol=2e-5)
MIN_EQUAL_SHARE = 0.99


def split_terms(x: torch.Tensor, terms: int):
    """fp32 ``x`` as ``terms`` bf16-valued fp32 tensors: each is what is
    left of x, rounded to bf16."""
    out = []
    for _ in range(terms):
        out.append(x.bfloat16().float())
        x = x - out[-1]
    return out


def split_product(a_terms, b_terms, n_terms: int):
    """sum over the cross terms a_i . b_j^T with i + j < n_terms -> (the
    leading term, the sum of the others), each product summed in fp32."""
    lead = a_terms[0] @ b_terms[0].transpose(-1, -2)
    corr = torch.zeros_like(lead)
    for i, a in enumerate(a_terms):
        for j, b in enumerate(b_terms):
            if 0 < i + j < n_terms:
                corr = corr + a @ b.transpose(-1, -2)
    return lead, corr


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = x.new_zeros(*x.shape[:-2], rows, cols)
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


def tiled_forward(q, k, v, causal: bool, round_p: bool) -> torch.Tensor:
    """q, k, v [B, H, S, D] (fp32 or bf16) -> out [B, H, S, D], the way the
    kernel computes it."""
    dtype = q.dtype
    b, h, s, d = q.shape
    planes = 1 if dtype == torch.bfloat16 else 3
    p_terms = 3 if planes == 3 else (1 if round_p else 2)
    dp = max(d, TILE)
    s_pad = -(-s // TILE) * TILE
    parts = -(-(s_pad // TILE) // MAX_STEPS)
    c = torch.tensor(1.0 / d ** 0.5 * 1.4426950408889634)   # fp32
    qt, kt, vt = (split_terms(_pad(t.float(), s_pad, dp), planes)
                  for t in (q, k, v))
    out = torch.zeros(b, h, s_pad, dp)
    cols = torch.arange(s_pad)
    for row0 in range(0, s_pad, TILE):
        # a causal row block stops at the key tile of its last row
        n_keys = min(s, row0 + TILE) if causal else s
        n_keys = -(-n_keys // TILE) * TILE
        rows = torch.arange(row0, row0 + TILE)[:, None]
        lead, corr = split_product(
            [t[..., row0:row0 + TILE, :] for t in qt],
            [t[..., :n_keys, :] for t in kt], planes)
        keep = cols[None, :n_keys] < s
        if causal:
            keep = keep & (cols[None, :n_keys] <= rows)
        # exp((s - m) * scale) as 2^(s * c - m * c), the maximum taken first
        scores = (lead + corr).masked_fill(~keep, float("-inf"))
        m = scores.amax(dim=-1, keepdim=True)
        e = torch.exp2(scores * c - m * c)
        # a row of more than 128 keys is shared by several warps, each with
        # an equal run of its key steps: the row sum is the sum of their
        # sums, the output the sum of their partial outputs, in order
        per_part = -(-(n_keys // TILE) // parts) * TILE
        runs = [slice(k0, min(k0 + per_part, n_keys))
                for k0 in range(0, n_keys, per_part)]
        total = sum(e[..., run].sum(dim=-1, keepdim=True) for run in runs)
        p = e * (1.0 / total)
        for run in runs:
            lead, corr = split_product(
                split_terms(p[..., run], p_terms),
                [t[..., run, :].transpose(-1, -2) for t in vt],
                max(planes, p_terms))
            out[..., row0:row0 + TILE, :] += lead + corr
    return out[..., :s, :d].to(dtype)


def _inputs(s, d, dtype, seed, heads=2, min_elements=4096):
    """q, k, v [B, H, S, D] from a numpy seed, B large enough for a share
    of equal elements to mean something."""
    batch = max(2, -(-min_elements // (heads * s * d)))
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.standard_normal((batch, heads, s, d)).astype(np.float32)).to(dtype)
        for _ in range(3))


def _packed(t):
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _plain(q, k, v, causal, round_p):
    """The plain twin of the kernel with that rounding point, heads
    first."""
    if round_p:
        out = FA.mha_packed_reference(_packed(q), _packed(k), _packed(v),
                                      q.shape[1], causal)
        return FA._heads_view(out, q.shape[1])
    return FA.flash_attention_reference(q, k, v, causal)


def _share(a, b):
    return float((a == b).float().mean())


@pytest.mark.parametrize("round_p", [True, False],
                         ids=["mha_fwd", "flash_fwd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGE_S)
def test_tiled_fp32_matches_plain_twin(s, causal, round_p):
    q, k, v = _inputs(s, 16, torch.float32, seed=s, min_elements=512)
    torch.testing.assert_close(tiled_forward(q, k, v, causal, round_p),
                               _plain(q, k, v, causal, round_p), **FP32_TOL)


@pytest.mark.parametrize("round_p", [True, False],
                         ids=["mha_fwd", "flash_fwd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGE_S)
def test_tiled_bf16_is_bit_equal_to_plain_twin(s, causal, round_p):
    q, k, v = _inputs(s, 16, torch.bfloat16, seed=100 + s)
    got = tiled_forward(q, k, v, causal, round_p)
    ref = _plain(q, k, v, causal, round_p)
    torch.testing.assert_close(got.float(), ref.float(), rtol=1.6e-2,
                               atol=1e-2)
    assert _share(got, ref) >= MIN_EQUAL_SHARE


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_tiled_head_dims(d, causal, dname):
    """Head dim 8 is padded to the mma depth with zeros; 32 and 64 take two
    and four steps."""
    dtype = getattr(torch, dname)
    q, k, v = _inputs(50, d, dtype, seed=d)
    for round_p in (True, False):
        got = tiled_forward(q, k, v, causal, round_p)
        ref = _plain(q, k, v, causal, round_p)
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, **FP32_TOL)
        else:
            assert _share(got, ref) >= MIN_EQUAL_SHARE, round_p


def _pallas(q, k, v, causal, round_p, jdtype):
    """The TPU kernel of that rounding point in interpret mode."""
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jdtype) for t in (q, k, v))
    if round_p:
        heads = q.shape[1]
        out = jfa.mha_packed(*(jnp.asarray(_packed(t).float().numpy(), jdtype)
                               for t in (q, k, v)),
                             heads=heads, causal=causal, interpret=True)
        out = torch.from_numpy(np.array(out.astype(jnp.float32)))
        return FA._heads_view(out, heads)
    out = jfa.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("round_p", [True, False],
                         ids=["mha_fwd", "flash_fwd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [17, 50, 77, 129])
def test_tiled_fp32_matches_pallas_interpret(s, causal, round_p):
    q, k, v = _inputs(s, 16, torch.float32, seed=200 + s, min_elements=512)
    torch.testing.assert_close(
        tiled_forward(q, k, v, causal, round_p),
        _pallas(q, k, v, causal, round_p, jnp.float32), **FP32_TOL)


@pytest.mark.parametrize("round_p", [True, False],
                         ids=["mha_fwd", "flash_fwd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [17, 50, 77, 129])
def test_tiled_bf16_is_bit_equal_to_pallas_interpret(s, causal, round_p):
    q, k, v = _inputs(s, 16, torch.bfloat16, seed=300 + s)
    got = tiled_forward(q, k, v, causal, round_p).float()
    ref = _pallas(q, k, v, causal, round_p, jnp.bfloat16)
    torch.testing.assert_close(got, ref, rtol=1.6e-2, atol=1e-2)
    assert _share(got, ref) >= MIN_EQUAL_SHARE


@pytest.mark.parametrize("causal", [False, True])
def test_rounding_point_shows_in_the_bit_equal_share(causal):
    """Each form of the model is bit-equal to its own plain twin and clearly
    not to the other's: the share tells a p rounded at the wrong place
    apart, which two ulps cannot."""
    q, k, v = _inputs(50, 64, torch.bfloat16, seed=7, min_elements=1 << 16)
    for round_p in (True, False):
        got = tiled_forward(q, k, v, causal, round_p)
        own = _share(got, _plain(q, k, v, causal, round_p))
        other = _share(got, _plain(q, k, v, causal, not round_p))
        assert own >= MIN_EQUAL_SHARE, (round_p, own)
        assert other < 0.9, (round_p, other)
        torch.testing.assert_close(
            got.float(), _plain(q, k, v, causal, not round_p).float(),
            rtol=1.6e-2, atol=1e-2)


def test_online_rescale_of_a_rounded_p_is_another_function():
    """Rounding p with the running statistics of the first key tile and
    rescaling it at the end of the row (what an online softmax would do) is
    not the kernels' function in bf16: the share drops."""
    q, k, v = _inputs(64, 64, torch.bfloat16, seed=11, min_elements=1 << 16)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = qf @ kf.transpose(-1, -2) / 8.0
    m1 = s[..., :32].amax(-1, keepdim=True)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    # first half: rounded against the first tile's statistics, then rescaled
    e1 = torch.exp(s[..., :32] - m1)
    p1 = (e1 / e1.sum(-1, keepdim=True)).bfloat16().float()
    p1 = p1 * (e1.sum(-1, keepdim=True) * torch.exp(m1 - m)
               / e.sum(-1, keepdim=True))
    p2 = (e[..., 32:] / e.sum(-1, keepdim=True)).bfloat16().float()
    online = (torch.cat([p1, p2], -1) @ vf).bfloat16()
    assert _share(online, _plain(q, k, v, False, True)) < 0.9
    assert _share(tiled_forward(q, k, v, False, True),
                  _plain(q, k, v, False, True)) >= MIN_EQUAL_SHARE


def test_three_term_split_is_exact_and_two_term_split_to_2e16():
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(1 << 16)
                          * np.exp(rng.uniform(-20, 20, 1 << 16))
                          ).astype(np.float32))
    hi, mid, lo = split_terms(x, 3)
    assert torch.equal((hi.double() + mid.double() + lo.double()).float(), x)
    for t in (hi, mid, lo):
        assert torch.equal(t.bfloat16().float(), t)
    hi, lo = split_terms(x, 2)
    assert float(((x - (hi + lo)).abs() / x.abs()).max()) <= 2.0 ** -16


def test_six_term_product_is_an_fp32_product():
    """The six cross terms of two split fp32 operands against the product
    in float64: the error is that of one fp32 rounding of each of the 64
    summands, not of a bf16 one (which is 2^-9 of the product)."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    lead, corr = split_product(split_terms(a, 3), split_terms(b, 3), 3)
    exact = a.double() @ b.double().T
    scale = a.double().abs() @ b.double().abs().T
    assert float(((lead + corr).double() - exact).abs().div(scale).max()) \
        <= 2.0 ** -22
    assert float((lead.double() - exact).abs().div(scale).max()) > 2.0 ** -12


def test_forward_wrappers_refuse_a_sequence_the_kernel_cannot_hold():
    """Shared memory bounds the rows whose scores a warp can keep: the
    wrappers refuse longer ones before a launch."""
    FA._check_fwd_seq(FA.MAX_FWD_SEQ)
    with pytest.raises(ValueError, match="sequence"):
        FA._check_fwd_seq(FA.MAX_FWD_SEQ + 1)
