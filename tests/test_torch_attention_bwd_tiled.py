"""The arithmetic of the tensor-core attention backward
(swat_tpu_torch/csrc/attention_bwd.cuh), modelled in plain PyTorch and held
on the CPU against the kernels' plain twins and, through the same inputs,
against the Pallas backward kernels in interpret mode.

The CUDA kernels run only on a card (tests/test_torch_cuda.py holds them
there).  What can be proved without one is their tiling and their number
format.  ``tiled_backward`` below is that model, in the kernels' two forms:

* one block a head (rows up to 128 in bf16, 80 in fp32): row tiles of 16,
  keys padded to 16 and masked, head dims padded to 16; the scores of a whole
  row kept until the final maximum and sum are known, p normalised, dp,
  delta from the fp32 p, ds; p and ds rounded (or split) into an S x S
  exchange buffer, then dv and dk summed tile by tile over the query tiles by
  the owner of 16 key rows, causal from the diagonal on;
* longer rows: a sweep over the key tiles that takes the maximum, the sum
  and sum(e * dp) online, a second one for ds and dq, and for dk and dv the
  transposed tiles k.q^T and v.do^T with the stored statistics.

Every product is taken on bf16 terms with fp32 sums: bf16 operands as they
are, an fp32 operand as three terms hi + mid + lo and a product as the six
cross terms of weight >= 2^-16, the leading one summed apart from the five
corrections; the unrounded p and ds of the heads-first kernel as two terms.

The bf16 Pallas reference needs no ``xla_allow_excess_precision=false``
here (the block-fused kernels' tests do): its casts of pb and ds to bf16
feed a matrix product, not a cast back, and the shares below hold as they
do in tests/test_torch_attention_bwd.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import TORCH_THREADS

from swat_tpu.kernels import flash_attention as jfa
from swat_tpu_torch.kernels import flash_attention as FA
from test_torch_attention_fwd_tiled import (_packed, _pad, _share,
                                            split_product, split_terms)

torch.set_num_threads(TORCH_THREADS)

TILE = 16   # rows a warp, the side of a score tile, the depth of one mma
EDGE_S = [1, 15, 16, 17, 50, 63, 64, 65, 77, 127, 128, 129, 197, 257]
# the model against a plain twin or the Pallas kernel: fp32 differs by the
# 2^-24 terms a split product leaves out and by summation order; bf16
# outputs must be bit-equal in this share (a rounding point moved leaves far
# fewer, see the last tests)
FP32_TOL = dict(rtol=2e-4, atol=5e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
MIN_EQUAL_SHARE = 0.99
LOG2E = 1.4426950408889634


def _tile_product(a_terms, b_terms, n_terms, lead, corr):
    """lead, corr += the cross terms of a . b^T, as one mma step adds
    them."""
    new_lead, new_corr = split_product(a_terms, b_terms, n_terms)
    return lead + new_lead, corr + new_corr


def _terms_count(dtype, rounded: bool) -> int:
    """Terms p and ds enter their products as."""
    if dtype == torch.float32:
        return 3
    return 1 if rounded else 2


def _one_block(qt, kt, vt, dot, s, d, causal, planes, n_terms, wrong):
    """dq, dk, dv [B, H, s_pad, dp] of the one-block kernel from the split
    operands."""
    s_pad = qt[0].shape[-2]
    scale = torch.tensor(1.0 / d ** 0.5)
    c = torch.tensor(1.0 / d ** 0.5 * LOG2E)
    cols = torch.arange(s_pad)
    lead_shape = qt[0].shape
    dq = torch.zeros(lead_shape)
    # the exchange buffer [term][query][key]; tiles above a causal diagonal
    # are never written and never read
    xp = [torch.zeros(*lead_shape[:-2], s_pad, s_pad) for _ in range(n_terms)]
    xds = [torch.zeros_like(t) for t in xp]
    mix = max(planes, n_terms)
    for row0 in range(0, s_pad, TILE):
        n_keys = row0 + TILE if causal else s_pad
        rows = torch.arange(row0, row0 + TILE)[:, None]
        tile = slice(row0, row0 + TILE)
        lead, corr = split_product([t[..., tile, :] for t in qt],
                                   [t[..., :n_keys, :] for t in kt], planes)
        keep = cols[None, :n_keys] < s
        if causal:
            keep = keep & (cols[None, :n_keys] <= rows)
        scores = (lead + corr).masked_fill(~keep, float("-inf"))
        m = scores.amax(dim=-1, keepdim=True)
        e = torch.exp2(scores * c - m * c)
        p = e * (1.0 / e.sum(dim=-1, keepdim=True))
        lead, corr = split_product([t[..., tile, :] for t in dot],
                                   [t[..., :n_keys, :] for t in vt], planes)
        dp = lead + corr
        p_delta = p.bfloat16().float() if wrong == "pb_in_delta" else p
        delta = (p_delta * dp).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta) * scale
        ds_terms = split_terms(ds, 2 if wrong == "ds_unrounded" else n_terms)
        lead, corr = split_product(
            ds_terms, [t[..., :n_keys, :].transpose(-1, -2) for t in kt],
            max(planes, len(ds_terms)))
        dq[..., tile, :] = lead + corr
        for buf, terms in ((xp, split_terms(p, n_terms)),
                           (xds, ds_terms[:n_terms])):
            for dst, term in zip(buf, terms):
                dst[..., tile, :n_keys] = term
    dk, dv = torch.zeros(lead_shape), torch.zeros(lead_shape)
    for key0 in range(0, s_pad, TILE):
        keys = slice(key0, key0 + TILE)
        for out, buf, rows_t in ((dv, xp, dot), (dk, xds, qt)):
            lead = torch.zeros(*lead_shape[:-2], TILE, lead_shape[-1])
            corr = torch.zeros_like(lead)
            for row0 in range(key0 if causal else 0, s_pad, TILE):
                tile = slice(row0, row0 + TILE)
                lead, corr = _tile_product(
                    [t[..., tile, keys].transpose(-1, -2) for t in buf],
                    [t[..., tile, :].transpose(-1, -2) for t in rows_t],
                    mix, lead, corr)
            out[..., keys, :] = lead + corr
    return dq, dk, dv


def _two_kernels(qt, kt, vt, dot, s, d, causal, planes, n_terms):
    """The same from the pair of kernels that take the longer rows."""
    s_pad = qt[0].shape[-2]
    scale = torch.tensor(1.0 / d ** 0.5)
    c = torch.tensor(1.0 / d ** 0.5 * LOG2E)
    shape = qt[0].shape
    mix = max(planes, n_terms)
    cols = torch.arange(TILE)
    dq = torch.zeros(shape)
    stats_m = torch.zeros(*shape[:-1], 1)
    stats_inv, stats_delta = torch.ones_like(stats_m), torch.zeros_like(stats_m)

    def tiles_of(row0):
        """(s, dp) of the query tile at row0 for each key tile it attends
        to, masked."""
        n_keys = min(s, row0 + TILE) if causal else s
        rows = torch.arange(row0, row0 + TILE)[:, None]
        tile = slice(row0, row0 + TILE)
        for key0 in range(0, n_keys, TILE):
            keys = slice(key0, key0 + TILE)
            lead, corr = split_product([t[..., tile, :] for t in qt],
                                       [t[..., keys, :] for t in kt], planes)
            keep = (key0 + cols)[None, :] < s
            if causal:
                keep = keep & ((key0 + cols)[None, :] <= rows)
            scores = (lead + corr).masked_fill(~keep, float("-inf"))
            lead, corr = split_product([t[..., tile, :] for t in dot],
                                       [t[..., keys, :] for t in vt], planes)
            yield keys, scores, lead + corr

    for row0 in range(0, s, TILE):
        tile = slice(row0, row0 + TILE)
        m = torch.full((*shape[:-2], TILE, 1), float("-inf"))
        total = torch.zeros_like(m)
        num = torch.zeros_like(m)
        for _, scores, dp in tiles_of(row0):
            m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True) * c)
            shrink = torch.exp2(m - m_new)
            e = torch.exp2(scores * c - m_new)
            total = total * shrink + e.sum(dim=-1, keepdim=True)
            num = num * shrink + (e * dp).sum(dim=-1, keepdim=True)
            m = m_new
        inv = 1.0 / total
        delta = num * inv
        lead = torch.zeros(*shape[:-2], TILE, shape[-1])
        corr = torch.zeros_like(lead)
        for keys, scores, dp in tiles_of(row0):
            p = torch.exp2(scores * c - m) * inv
            ds = p * (dp - delta) * scale
            lead, corr = _tile_product(
                split_terms(ds, n_terms),
                [t[..., keys, :].transpose(-1, -2) for t in kt], mix,
                lead, corr)
        dq[..., tile, :] = lead + corr
        live = slice(row0, min(row0 + TILE, s))   # rows the kernel stores
        n = live.stop - live.start
        stats_m[..., live, :] = m[..., :n, :]
        stats_inv[..., live, :] = inv[..., :n, :]
        stats_delta[..., live, :] = delta[..., :n, :]

    dk, dv = torch.zeros(shape), torch.zeros(shape)
    for key0 in range(0, s, TILE):
        keys = slice(key0, key0 + TILE)
        key_rows = torch.arange(key0, key0 + TILE)[:, None]
        dv_lead = torch.zeros(*shape[:-2], TILE, shape[-1])
        dv_corr, dk_lead, dk_corr = (torch.zeros_like(dv_lead)
                                     for _ in range(3))
        for row0 in range(0, s, TILE):
            if causal and row0 + TILE - 1 < key0:
                continue
            tile = slice(row0, row0 + TILE)
            lead, corr = split_product([t[..., keys, :] for t in kt],
                                       [t[..., tile, :] for t in qt], planes)
            m, inv, delta = (t[..., tile, :].transpose(-1, -2)
                             for t in (stats_m, stats_inv, stats_delta))
            p = torch.exp2((lead + corr) * c - m) * inv
            if causal:
                p = p.masked_fill((row0 + cols)[None, :] < key_rows, 0.0)
            lead, corr = split_product([t[..., keys, :] for t in vt],
                                       [t[..., tile, :] for t in dot], planes)
            ds = p * (lead + corr - delta) * scale
            dv_lead, dv_corr = _tile_product(
                split_terms(p, n_terms),
                [t[..., tile, :].transpose(-1, -2) for t in dot], mix,
                dv_lead, dv_corr)
            dk_lead, dk_corr = _tile_product(
                split_terms(ds, n_terms),
                [t[..., tile, :].transpose(-1, -2) for t in qt], mix,
                dk_lead, dk_corr)
        dv[..., keys, :] = dv_lead + dv_corr
        dk[..., keys, :] = dk_lead + dk_corr
    return dq, dk, dv


def tiled_backward(q, k, v, do, causal: bool, rounded: bool, form=None,
                   wrong=None):
    """q, k, v, do [B, H, S, D] (fp32 or bf16) -> dq, dk, dv [B, H, S, D],
    the way the kernels compute them.  ``rounded``: pb and ds are rounded to
    the input dtype (the packed-head kernel, and the heads-first one with
    keep_dtype).  ``form``: 'block' or 'pair'; None picks as the launch
    does.  ``wrong`` moves one rounding point (one-block form only)."""
    dtype = q.dtype
    s, d = q.shape[-2:]
    planes = 1 if dtype == torch.bfloat16 else 3
    n_terms = _terms_count(dtype, rounded)
    if form is None:
        form = "block" if s <= FA._BWD_ONE_BLOCK_SEQ[dtype] else "pair"
    s_pad = -(-s // TILE) * TILE
    qt, kt, vt, dot = (split_terms(_pad(t.float(), s_pad, max(d, TILE)),
                                   planes) for t in (q, k, v, do))
    if form == "block":
        grads = _one_block(qt, kt, vt, dot, s, d, causal, planes, n_terms,
                           wrong)
    else:
        grads = _two_kernels(qt, kt, vt, dot, s, d, causal, planes, n_terms)
    return tuple(g[..., :s, :d].to(dtype) for g in grads)


def _inputs(s, d, dtype, seed, heads=2, min_elements=4096):
    """q, k, v, do [B, H, S, D] from a numpy seed, B large enough for a
    share of equal elements to mean something."""
    batch = max(2, -(-min_elements // (heads * s * d)))
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.standard_normal((batch, heads, s, d)).astype(np.float32)).to(dtype)
        for _ in range(4))


def _plain(q, k, v, do, causal, rounded):
    """The plain twin of the kernel with those rounding points, heads
    first: the packed-head one (which rounds), or the heads-first one in
    the form ``rounded`` names."""
    if rounded:
        grads = FA.mha_bwd_reference(*(_packed(t) for t in (q, k, v, do)),
                                     q.shape[1], causal)
        return tuple(FA._heads_view(g, q.shape[1]) for g in grads)
    return FA.flash_attention_bwd_reference(q, k, v, do, causal, False)


KINDS = pytest.mark.parametrize("rounded", [True, False],
                                ids=["mha_bwd", "flash_bwd"])


@KINDS
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGE_S)
def test_tiled_fp32_matches_plain_twin(s, causal, rounded):
    q, k, v, do = _inputs(s, 16, torch.float32, seed=s, min_elements=512)
    for got, ref in zip(tiled_backward(q, k, v, do, causal, rounded),
                        _plain(q, k, v, do, causal, rounded)):
        torch.testing.assert_close(got, ref, **FP32_TOL)


@KINDS
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGE_S)
def test_tiled_bf16_is_bit_equal_to_plain_twin(s, causal, rounded):
    q, k, v, do = _inputs(s, 16, torch.bfloat16, seed=100 + s)
    for got, ref in zip(tiled_backward(q, k, v, do, causal, rounded),
                        _plain(q, k, v, do, causal, rounded)):
        torch.testing.assert_close(got.float(), ref.float(), **BF16_TOL)
        assert _share(got, ref) >= MIN_EQUAL_SHARE


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [17, 50, 77, 128])
def test_pair_form_takes_short_rows_too(s, causal, dname):
    """The pair of kernels is the same function at any length: the launch
    gives it the long rows only because the one block is faster."""
    dtype = getattr(torch, dname)
    q, k, v, do = _inputs(s, 16, dtype, seed=400 + s)
    for got, ref in zip(tiled_backward(q, k, v, do, causal, True, "pair"),
                        _plain(q, k, v, do, causal, True)):
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, **FP32_TOL)
        else:
            assert _share(got, ref) >= MIN_EQUAL_SHARE


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_tiled_head_dims(d, causal, dname):
    """Head dim 8 is padded to the mma depth with zeros; 32 and 64 take two
    and four steps."""
    dtype = getattr(torch, dname)
    q, k, v, do = _inputs(50, d, dtype, seed=d)
    for rounded in (True, False):
        for got, ref in zip(tiled_backward(q, k, v, do, causal, rounded),
                            _plain(q, k, v, do, causal, rounded)):
            if dtype == torch.float32:
                torch.testing.assert_close(got, ref, **FP32_TOL)
            else:
                assert _share(got, ref) >= MIN_EQUAL_SHARE, rounded


def _pallas(q, k, v, do, causal, rounded, jdtype):
    """The gradient through the TPU kernel of those rounding points in
    interpret mode: jax.vjp of mha_packed (packed-head backward) or of
    flash_attention (heads-first backward, keep_dtype off)."""
    if rounded:
        heads = q.shape[1]
        args = [jnp.asarray(_packed(t).float().numpy(), jdtype)
                for t in (q, k, v, do)]
        _, vjp = jax.vjp(lambda a, b, c: jfa.mha_packed(
            a, b, c, heads=heads, causal=causal, interpret=True,
            bwd="pallas"), *args[:3])
        return tuple(FA._heads_view(torch.from_numpy(
            np.array(g.astype(jnp.float32))), heads) for g in vjp(args[3]))
    args = [jnp.asarray(t.float().numpy(), jdtype) for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, interpret=True), *args[:3])
    return tuple(torch.from_numpy(np.array(g.astype(jnp.float32)))
                 for g in vjp(args[3]))


@KINDS
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGE_S)
def test_tiled_fp32_matches_pallas_interpret(s, causal, rounded):
    q, k, v, do = _inputs(s, 16, torch.float32, seed=200 + s,
                          min_elements=512)
    for got, ref in zip(tiled_backward(q, k, v, do, causal, rounded),
                        _pallas(q, k, v, do, causal, rounded, jnp.float32)):
        torch.testing.assert_close(got, ref, **FP32_TOL)


@KINDS
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGE_S)
def test_tiled_bf16_is_bit_equal_to_pallas_interpret(s, causal, rounded):
    q, k, v, do = _inputs(s, 16, torch.bfloat16, seed=300 + s)
    for got, ref in zip(tiled_backward(q, k, v, do, causal, rounded),
                        _pallas(q, k, v, do, causal, rounded, jnp.bfloat16)):
        torch.testing.assert_close(got.float(), ref, **BF16_TOL)
        assert _share(got.float(), ref) >= MIN_EQUAL_SHARE


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 32, 64])
def test_tiled_head_dims_match_pallas_interpret(d, causal):
    """The other head dims against the packed-head TPU kernel, bf16 (the
    rounding points) and fp32."""
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        q, k, v, do = _inputs(50, d, dtype, seed=500 + d)
        for got, ref in zip(tiled_backward(q, k, v, do, causal, True),
                            _pallas(q, k, v, do, causal, True, jdtype)):
            if dtype == torch.float32:
                torch.testing.assert_close(got, ref, **FP32_TOL)
            else:
                assert _share(got.float(), ref) >= MIN_EQUAL_SHARE


@pytest.mark.parametrize("causal", [False, True])
def test_rounding_points_show_in_the_bit_equal_share(causal):
    """Each form of the model is bit-equal to its own plain twin and clearly
    not to the other's: the share tells a pb or ds rounded at the wrong
    place apart, which two ulps cannot."""
    q, k, v, do = _inputs(50, 64, torch.bfloat16, seed=7,
                          min_elements=1 << 16)
    for rounded in (True, False):
        got = tiled_backward(q, k, v, do, causal, rounded)
        own = _plain(q, k, v, do, causal, rounded)
        other = _plain(q, k, v, do, causal, not rounded)
        assert min(map(_share, got, own)) >= MIN_EQUAL_SHARE, rounded
        assert min(map(_share, got, other)) < 0.9, rounded
        for g, o in zip(got, other):
            torch.testing.assert_close(g.float(), o.float(), **BF16_TOL)


@pytest.mark.parametrize("wrong", ["pb_in_delta", "ds_unrounded"])
def test_a_moved_rounding_point_falls_below_the_share(wrong):
    """delta taken from the rounded p, or ds left in two terms where the
    kernel rounds it: within two ulps of the plain twin, and bit-equal in
    far fewer elements than the share asks."""
    q, k, v, do = _inputs(50, 64, torch.bfloat16, seed=8,
                          min_elements=1 << 16)
    got = tiled_backward(q, k, v, do, False, True, wrong=wrong)
    ref = _plain(q, k, v, do, False, True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(), **BF16_TOL)
    assert min(map(_share, got, ref)) < MIN_EQUAL_SHARE
    right = tiled_backward(q, k, v, do, False, True)
    assert min(map(_share, right, ref)) >= MIN_EQUAL_SHARE


def test_padded_query_rows_add_nothing_to_dk_and_dv():
    """S = 17 pads 15 query rows in the second tile: their do is zero, so
    dp, delta and ds are exactly zero and pb meets a zero do; dk and dv equal
    those of the same head computed without the padding's tile partners."""
    q, k, v, do = _inputs(17, 16, torch.float32, seed=9, min_elements=512)
    _, dk, dv = tiled_backward(q, k, v, do, False, True)
    _, dk_ref, dv_ref = _plain(q, k, v, do, False, True)
    torch.testing.assert_close(dk, dk_ref, **FP32_TOL)
    torch.testing.assert_close(dv, dv_ref, **FP32_TOL)
    assert bool(torch.isfinite(dk).all()) and bool(torch.isfinite(dv).all())


def test_two_term_split_of_ds_meets_the_unrounded_twin():
    """bf16 inputs without rounding: ds and p enter as hi + lo, what is left
    out is below 2^-16 of each, far below a bf16 ulp of the outputs."""
    q, k, v, do = _inputs(77, 64, torch.bfloat16, seed=10,
                          min_elements=1 << 15)
    got = tiled_backward(q, k, v, do, True, False)
    ref = _plain(q, k, v, do, True, False)
    assert min(map(_share, got, ref)) >= MIN_EQUAL_SHARE


def test_scratch_only_where_the_rows_outgrow_one_block():
    """The wrappers allocate the statistics scratch only for rows the
    one-block kernel does not take, and refuse rows beyond the kernels'
    reach before a launch."""
    assert FA._bwd_stats_shape(256, 12, 50, torch.float32) == (3, 0)
    assert FA._bwd_stats_shape(1024, 8, 77, torch.float32) == (3, 0)
    assert FA._bwd_stats_shape(4, 2, 81, torch.float32) == (3, 4 * 2 * 81)
    assert FA._bwd_stats_shape(4, 2, 128, torch.bfloat16) == (3, 0)
    assert FA._bwd_stats_shape(128, 12, 197, torch.bfloat16) == \
        (3, 128 * 12 * 197)
    FA._check_fwd_seq(FA.MAX_FWD_SEQ, "backward")
    with pytest.raises(ValueError, match="backward"):
        FA._check_fwd_seq(FA.MAX_FWD_SEQ + 1, "backward")
