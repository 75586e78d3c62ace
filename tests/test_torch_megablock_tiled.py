"""The arithmetic of the block kernels' tensor-core product
(swat_tpu_torch/csrc/megablock_mma.cuh) and of the three entry points that
use it (megablock_fwd.cu, megablock_mlp_bwd.cu, megablock_attn_bwd.cu),
modelled in plain PyTorch
and held on the CPU against the kernels' plain twins and, through the same
inputs, against the Pallas kernels in interpret mode.

The CUDA kernels run only on a card (tests/test_torch_cuda.py holds them
there).  What can be proved without one is the product's number format and
the order of its sums: steps of DEPTH along the summed dimension, each a
product of bf16 terms summed in fp32 (bf16 operands as they are, an fp32
operand as three terms hi + mid + lo and a product as the six cross terms
of weight >= 2^-16, the leading one summed apart from the five
corrections); the weight gradients' depth cut into ``split_count`` splits
whose partials are added in order; the epilogues' rounding points; the
column sums in their fixed order (a warp's rows, lanes xor 4, 8, 16, the
warps of a block, the row blocks).  ``tiled_block_fwd``,
``tiled_mlp_bwd`` and ``tiled_attn_bwd`` below are that model, launch by
launch."""

import os
import re

import numpy as np
import pytest
import torch
from torch_port_lib import (MEGA_CASES, TORCH_THREADS, mega_case_inputs,
                            mega_reference_subprocess)

from swat_tpu_torch.kernels import flash_attention as FA
from swat_tpu_torch.kernels import megablock as MB

torch.set_num_threads(TORCH_THREADS)

DEPTH = MB._DEPTH
MMA_K = 16                  # depth of one mma.sync.m16n8k16
ROW_BLOCK = MB._ROW_BLOCK
# warps of a block along M (the rows of a column-sum partial): bf16 2 warps
# of 64 rows, fp32 4 of 32 (of 8 warps each)
WARPS_M = {torch.bfloat16: 2, torch.float32: 4}
assert all(MB._WARPS[t][0] == w for t, w in WARPS_M.items())
# (i, j) of the five correction terms a_i . b_j, in the kernel's order
CROSS = [(0, 1), (1, 0), (0, 2), (1, 1), (2, 0)]
# the model against a plain twin or the Pallas kernels: fp32 differs by the
# 2^-24 terms a split product leaves out and by summation order, so 2e-6 of
# an output's largest value forward (the bound of tests/test_megablock.py)
# and, for a gradient summed over all rows, 1e-5 of it + 1e-5 relative;
# bf16 outputs are bit-equal in MIN_EQUAL_SHARE of their elements (a
# rounding point moved leaves fewer: the last test) and within one bf16 ulp
# of the largest value; an fp32 gradient of bf16 operands within 2e-3 of its
# largest value (a few flipped roundings among the terms of each sum)
FWD_TOL, GRAD_TOL = 2e-6, 1e-5
MIN_EQUAL_SHARE = 0.99
BF16_ULP, BF16_GRAD_TOL = 8e-3, 2e-3
MMA_HEADER = os.path.join(os.path.dirname(MB.__file__), os.pardir, "csrc",
                          "megablock_mma.cuh")


def split_terms(x: torch.Tensor, terms: int):
    """fp32 ``x`` as ``terms`` bf16-valued fp32 tensors summing to it."""
    out = []
    for _ in range(terms):
        out.append(x.bfloat16().float())
        x = x - out[-1]
    return out


def tiled_product(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
                  steps_per_split=None) -> torch.Tensor:
    """a [M, K] @ b [K, N] (values of ``dtype``) -> fp32 [M, N] as the
    kernel sums it: per split, DEPTH-deep steps in order; bf16 sums each
    step's product afresh and adds it to its running sum, fp32 does so for
    the leading term of each k16 product and chains the corrections in an
    accumulator of their own, the two joined at the split's end; the splits'
    partials added in order."""
    planes = 1 if dtype == torch.bfloat16 else 3
    at, bt = split_terms(a.float(), planes), split_terms(b.float(), planes)
    m, k = a.shape
    n = b.shape[1]
    steps = -(-k // DEPTH)
    per = (steps_per_split or max(steps, 1)) * DEPTH
    total = None
    for s0 in range(0, max(k, 1), per):
        lead, corr = torch.zeros(m, n), torch.zeros(m, n)
        part = DEPTH if planes == 1 else MMA_K
        for k0 in range(s0, min(k, s0 + per), part):
            ks = slice(k0, min(k, k0 + part))
            lead = lead + at[0][:, ks] @ bt[0][ks]
            if planes == 3:
                for i, j in CROSS:
                    corr = corr + at[i][:, ks] @ bt[j][ks]
        part = lead + corr if planes == 3 else lead
        total = part if total is None else total + part
    return total


def wgrad_product(a_rows, b_rows, dtype, split=True):
    """a_rows [K, M], b_rows [K, N] -> a^T b [M, N], a weight gradient over
    K token rows, with the depth cut as split_count cuts it."""
    k, m = a_rows.shape
    splits, per = MB.split_count(m, b_rows.shape[1], k, dtype)
    return tiled_product(a_rows.t(), b_rows, dtype,
                         per if split and splits > 1 else None)


def rows_colsum(t: torch.Tensor) -> torch.Tensor:
    """colsum + colsum_join of megablock.cuh: each 128-row block summed row
    by row, then the blocks in order."""
    out = torch.zeros(t.shape[1])
    for r0 in range(0, t.shape[0], ROW_BLOCK):
        part = torch.zeros(t.shape[1])
        for r in range(r0, min(t.shape[0], r0 + ROW_BLOCK)):
            part = part + t[r]
        out = out + part
    return out


def epi_colsum(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The column sums of EpiDm: each thread its rows of a warp's tiles in
    order (row g, then g + 8, tile by tile), lanes xor 4, 8, 16 (a butterfly
    over g), the warps of the 128-row block in order, then the blocks."""
    rows, cols = t.shape
    warps = WARPS_M[dtype]
    tiles = ROW_BLOCK // warps // 16
    blocks = -(-rows // ROW_BLOCK)
    full = torch.zeros(blocks * ROW_BLOCK, cols)
    full[:rows] = t
    v = full.reshape(blocks, warps, tiles, 2, 8, cols)
    s = torch.zeros(blocks, warps, 8, cols)
    for i in range(tiles):
        for h in range(2):
            s = s + v[:, :, i, h]
    s = s[:, :, 0::2] + s[:, :, 1::2]       # lanes xor 4
    s = s[:, :, 0::2] + s[:, :, 1::2]       # xor 8
    s = s[:, :, 0] + s[:, :, 1]             # xor 16
    part = torch.zeros(blocks, cols)
    for w in range(warps):
        part = part + s[:, w]
    out = torch.zeros(cols)
    for blk in range(blocks):
        out = out + part[blk]
    return out


def _r(x, cd):
    """x rounded to the compute dtype, as fp32."""
    return x.to(cd).float()


def tiled_block_fwd(x, w, heads, causal, quick):
    """megablock_fwd.cu launch by launch -> (y, x2) in the compute dtype."""
    cd = x.dtype
    b, s, d = x.shape
    x = x.reshape(b * s, d)

    def ln(t, scale, bias):
        return MB._ln_fwd(t.float(), scale.float(), bias.float())[0].to(cd)

    h = ln(x, w.ln1_w, w.ln1_b)
    # EpiBias: (sum -> T) + bias in T
    qkv = (_r(tiled_product(h, w.in_w.t(), cd), cd)
           + w.in_b.float()).to(cd)
    o = FA.mha_packed_reference(*qkv.reshape(b, s, 3 * d).chunk(3, dim=-1),
                                heads, causal).reshape(b * s, d)
    # EpiBiasRes: res + ((sum -> T) + bias), each step in T
    t = _r(_r(tiled_product(o, w.out_w.t(), cd), cd) + w.out_b.float(), cd)
    x2 = (x.float() + t).to(cd)
    h = ln(x2, w.ln2_w, w.ln2_b)
    # EpiBiasAct: m1 = (sum -> T) + bias in T, g = act(fp32 m1) -> T
    m1 = _r(_r(tiled_product(h, w.fc_w.t(), cd), cd) + w.fc_b.float(), cd)
    g = MB._act(m1, quick).to(cd)
    t = _r(_r(tiled_product(g, w.proj_w.t(), cd), cd) + w.proj_b.float(), cd)
    y = (x2.float() + t).to(cd)
    return y.reshape(b, s, d), x2.reshape(b, s, d)


def tiled_mlp_bwd(x2, dy, w, quick, split=True, round_dm=True):
    """megablock_mlp_bwd.cu launch by launch -> mlp_bwd_reference's tuple.
    ``round_dm=False`` moves a rounding point: dm enters dWfc and dh2
    unrounded."""
    cd = x2.dtype
    b, s, d = x2.shape
    x2, dy = x2.reshape(b * s, d), dy.reshape(b * s, d)
    ln_w = w.ln2_w.float()
    h2_32, xhat, rstd = MB._ln_fwd(x2.float(), ln_w, w.ln2_b.float())
    h2 = h2_32.to(cd)
    m1 = _r(_r(tiled_product(h2, w.fc_w.t(), cd), cd) + w.fc_b.float(), cd)
    g = MB._act(m1, quick).to(cd)
    d_proj_b = rows_colsum(dy.float())
    d_proj_w = wgrad_product(dy, g, cd, split)
    # EpiDm: dm = sum * act'(fp32 m1), stored rounded over m1; its column
    # sums are the fc bias gradient
    dm = tiled_product(dy, w.proj_w, cd) * MB._act_grad(m1, quick)
    d_fc_b = epi_colsum(dm, cd)
    # unrounded, dm would enter both products as an fp32 operand
    dm_c, dm_dt = (dm.to(cd), cd) if round_dm else (dm, torch.float32)
    d_fc_w = wgrad_product(dm_c, h2, dm_dt, split)
    dh2 = tiled_product(dm_c, w.fc_w, dm_dt)
    n = d
    dyh = dh2 * ln_w
    s1 = dyh.sum(dim=-1, keepdim=True)
    s2 = (dyh * xhat).sum(dim=-1, keepdim=True)
    dx2 = (dy.float() + (rstd / n) * (n * dyh - s1 - xhat * s2)).to(cd)
    return (dx2.reshape(b, s, d), d_fc_w, d_fc_b, d_proj_w, d_proj_b,
            rows_colsum(dh2 * xhat), rows_colsum(dh2))


def tiled_attn_bwd(x, dx2, w, heads, causal, split=True, round_dqkv=True):
    """megablock_attn_bwd.cu launch by launch -> attn_bwd_reference's tuple.
    ``round_dqkv=False`` moves a rounding point: dq|dk|dv enter d
    in_proj_weight and dh1 unrounded."""
    cd = x.dtype
    b, s, d = x.shape
    x, dx2 = x.reshape(b * s, d), dx2.reshape(b * s, d)
    ln_w = w.ln1_w.float()
    h1_32, xhat, rstd = MB._ln_fwd(x.float(), ln_w, w.ln1_b.float())
    h1 = h1_32.to(cd)
    d_out_b = rows_colsum(dx2.float())
    # EpiBias: (sum -> T) + bias in T
    qkv = (_r(tiled_product(h1, w.in_w.t(), cd), cd)
           + w.in_b.float()).to(cd)
    q, k, v = qkv.reshape(b, s, 3 * d).chunk(3, dim=-1)
    o = FA.mha_packed_reference(q, k, v, heads, causal).reshape(b * s, d)
    d_out_w = wgrad_product(dx2, o, cd, split)
    # EpiRound: do = sum -> T
    do = tiled_product(dx2, w.out_w, cd).to(cd).reshape(b, s, d)
    grads = FA._bwd_math(*(FA._split_heads(t, heads) for t in (q, k, v, do)),
                         causal, cd)
    dqkv32 = torch.cat([FA._merge_heads(t, torch.float32) for t in grads],
                       dim=-1).reshape(b * s, 3 * d)
    # ColRound: the fp32 sums are the qkv bias gradient; in bf16 the rounded
    # copy feeds both products, in fp32 dqkv32 is read in place
    d_in_b = rows_colsum(dqkv32)
    dqkv, dqkv_dt = ((dqkv32.to(cd), cd) if round_dqkv
                     else (dqkv32, torch.float32))
    d_in_w = wgrad_product(dqkv, h1, dqkv_dt, split)
    dh1 = tiled_product(dqkv, w.in_w, dqkv_dt)
    n = d
    dyh = dh1 * ln_w
    s1 = dyh.sum(dim=-1, keepdim=True)
    s2 = (dyh * xhat).sum(dim=-1, keepdim=True)
    dx = (dx2.float() + (rstd / n) * (n * dyh - s1 - xhat * s2)).to(cd)
    return (dx.reshape(b, s, d), d_in_w, d_in_b, d_out_w, d_out_b,
            rows_colsum(dh1 * xhat), rows_colsum(dh1))


# ---------------------------------------------------------------------------
# the product alone

# (m, n, k): rows not a multiple of 128 (1, 127, 129, 1576), widths and
# depths below one tile (n = 40, 64), depths below one step (1, 5, 24) and
# ragged ones (33, 200)
EDGE_PRODUCTS = [(1, 8, 1), (127, 192, 24), (129, 40, 33), (1576, 64, 96),
                 (200, 256, 5), (64, 192, 200)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _matrix(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,n,k", EDGE_PRODUCTS)
def test_tiled_product_is_the_fp32_product(m, n, k, dtype):
    """bf16 operands: exact products summed in fp32; fp32 operands: the six
    cross terms leave out less than 2^-24 of a product.  Against the float64
    product, 1e-6 of the largest |a|.|b| sum."""
    dt = DTYPES[dtype]
    a, b = _matrix((m, k), dt, 1), _matrix((k, n), dt, 2)
    got = tiled_product(a, b, dt).double()
    ref = a.double() @ b.double()
    bound = 1e-6 * float((a.double().abs() @ b.double().abs()).max())
    assert float((got - ref).abs().max()) <= bound


def _header_constant(text, name):
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


def test_split_rule_mirrors_the_header():
    """megablock.py sizes the split partials with its own copy of the
    header's rule, and reckons the product's shared memory with its own copy
    of the tiles and stages: the constants must be the header's."""
    with open(MMA_HEADER) as f:
        text = f.read()
    assert _header_constant(text, "kDepth") == MB._DEPTH
    stages = re.search(r"kStages16 = (\d+), kStages32 = (\d+);", text)
    assert (int(stages.group(1)), int(stages.group(2))) == (
        MB._STAGES[torch.bfloat16], MB._STAGES[torch.float32])
    assert (_header_constant(text, "kSplitBlocks"), _header_constant(
        text, "kMinSplitSteps"), _header_constant(text, "kMaxSplits")) == (
        MB._SPLIT_BLOCKS, MB._MIN_SPLIT_STEPS, MB._MAX_SPLITS)
    tiles = re.findall(r"struct Cfg<(float|__nv_bfloat16)> \{\s*static "
                       r"constexpr int BM = (\d+), BN = (\d+), WM = (\d+), "
                       r"WN = (\d+)", text)
    assert {t: (int(bm), int(bn)) for t, bm, bn, _, _ in tiles} == {
        "__nv_bfloat16": MB._TILE[torch.bfloat16],
        "float": MB._TILE[torch.float32]}
    assert {t: (int(wm), int(wn)) for t, _, _, wm, wn in tiles} == {
        "__nv_bfloat16": MB._WARPS[torch.bfloat16],
        "float": MB._WARPS[torch.float32]}
    assert MB._TILE[torch.bfloat16][0] == MB._TILE[torch.float32][0] \
        == ROW_BLOCK


# (m, n, k, dtype) -> splits: the B/32 block's dWp and dWfc (144 bf16 and
# 288 fp32 tiles of the 768 x 3072 output), the text tower's, the B/16
# block's at 8 images, and depths too short to cut
SPLITS = [(768, 3072, 12800, "bfloat16", 4), (3072, 768, 12800, "bfloat16", 4),
          (768, 3072, 12800, "float32", 2), (3072, 768, 12800, "float32", 2),
          (512, 2048, 19712, "bfloat16", 9), (768, 3072, 1576, "float32", 2),
          (64, 256, 60, "bfloat16", 1), (768, 3072, 255, "float32", 1),
          (64, 192, 1576, "bfloat16", 6),
          # the B/32 block's dWo and d in_proj_weight (36 / 108 bf16 and
          # 72 / 216 fp32 tiles)
          (768, 768, 12800, "bfloat16", 15), (2304, 768, 12800, "bfloat16", 5),
          (768, 768, 12800, "float32", 8), (2304, 768, 12800, "float32", 3)]


@pytest.mark.parametrize("m,n,k,dtype,want", SPLITS)
def test_split_count(m, n, k, dtype, want):
    """Enough splits for 528 blocks (4 waves of 132 SMs), each at least 8
    steps deep, at most 16; the splits cover the depth with no empty one."""
    splits, per = MB.split_count(m, n, k, DTYPES[dtype])
    assert splits == want
    steps = -(-k // DEPTH)
    assert (splits - 1) * per < steps <= splits * per
    assert splits == 1 or per >= MB._MIN_SPLIT_STEPS


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k,m,n", [(1576, 64, 192), (3200, 96, 40),
                                   (600, 64, 256)])
def test_split_partials_against_one_split(k, m, n, dtype):
    """A weight gradient with its depth cut into splits and joined in order
    against one split: the same sum in another order, within 1e-6 of the
    largest |a|.|b| sum, and both within it of the float64 product."""
    dt = DTYPES[dtype]
    a, b = _matrix((k, m), dt, 3), _matrix((k, n), dt, 4)
    many = wgrad_product(a, b, dt).double()
    one = wgrad_product(a, b, dt, split=False).double()
    assert MB.split_count(m, n, k, dt)[0] > 1
    ref = a.double().t() @ b.double()
    bound = 1e-6 * float((a.double().abs().t() @ b.double().abs()).max())
    for got in (many, one):
        assert float((got - ref).abs().max()) <= bound


def test_epi_colsum_order():
    """The EpiDm column sum is an exact reordering of the plain sum: on
    integers (exact in fp32) it is the plain sum, and on random values it
    stays within fp32 summation error of it; rows past the edge add
    nothing."""
    for dtype in (torch.bfloat16, torch.float32):
        ints = torch.from_numpy(np.random.default_rng(5).integers(
            -50, 50, (300, 24)).astype(np.float32))
        assert torch.equal(epi_colsum(ints, dtype), ints.sum(0))
        vals = _matrix((1576, 40), torch.float32, 6)
        np.testing.assert_allclose(epi_colsum(vals, dtype).numpy(),
                                   vals.double().sum(0).numpy(), rtol=0,
                                   atol=1e-4)
    assert torch.equal(rows_colsum(ints), ints.sum(0))


# ---------------------------------------------------------------------------
# the two entry points against the plain twins

# b, s, d, heads, f, causal, quick: width 64 (the bf16 share's width), rows
# 1, 127, 129 and 1576, widths below one tile, depths below one step
BLOCK_SHAPES = [(2, 5, 64, 4, 256, False, True), (1, 1, 64, 4, 192, False,
                                                   False),
                (1, 127, 64, 4, 256, True, True),
                (3, 43, 96, 3, 192, False, False),
                (8, 197, 64, 4, 192, False, True),
                (5, 7, 24, 3, 40, True, False)]


def _inputs(b, s, d, f, dtype, seed):
    """x, x2, dy [B, S, D] and one block's weights (random LayerNorm scale
    and bias) in ``dtype``, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def normal(shape, std=1.0, mean=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * std
                                 + mean).astype(np.float32)).to(dtype)

    acts = [normal((b, s, d)) for _ in range(3)]
    w = MB.BlockWeights(
        normal((3 * d, d), d ** -0.5), normal((3 * d,), 0.1),
        normal((d, d), d ** -0.5), normal((d,), 0.1),
        normal((d,), 0.1, 1.0), normal((d,), 0.1), normal((d,), 0.1, 1.0),
        normal((d,), 0.1), normal((f, d), d ** -0.5), normal((f,), 0.1),
        normal((d, f), f ** -0.5), normal((d,), 0.1))
    return acts, w


def _close(name, got, ref, dtype, fwd):
    got32, ref32 = got.float(), ref.float()
    scale = max(float(ref32.abs().max()), 1e-30)
    err = float((got32 - ref32).abs().max())
    if dtype == torch.float32:
        tol = FWD_TOL * scale if fwd else GRAD_TOL * scale
        assert err <= tol + (0 if fwd else 1e-5 * float(ref32.abs().max())), (
            name, err, scale)
    elif got.dtype == torch.bfloat16:
        assert err <= BF16_ULP * scale, (name, err, scale)
        share = float((got == ref).float().mean())
        assert share >= MIN_EQUAL_SHARE, (name, share)
    else:
        assert err <= BF16_GRAD_TOL * scale, (name, err, scale)


MLP_NAMES = ("dx2", "d_fc_w", "d_fc_b", "d_proj_w", "d_proj_b", "d_ln2_w",
             "d_ln2_b")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,d,heads,f,causal,quick", BLOCK_SHAPES)
def test_tiled_block_fwd_matches_plain_twin(b, s, d, heads, f, causal, quick,
                                            dtype):
    dt = DTYPES[dtype]
    (x, _, _), w = _inputs(b, s, d, f, dt, seed=s)
    got = tiled_block_fwd(x, w, heads, causal, quick)
    ref = MB.block_fwd_reference(x, w, heads, causal, quick)
    for name, g, r in zip(("y", "x2"), got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        _close(name, g, r, dt, fwd=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,d,heads,f,causal,quick", BLOCK_SHAPES)
def test_tiled_mlp_bwd_matches_plain_twin(b, s, d, heads, f, causal, quick,
                                          dtype):
    dt = DTYPES[dtype]
    (_, x2, dy), w = _inputs(b, s, d, f, dt, seed=s + 1)
    got = tiled_mlp_bwd(x2, dy, w, quick)
    ref = MB.mlp_bwd_reference(x2, dy, w, quick)
    for name, g, r in zip(MLP_NAMES, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        _close(name, g, r, dt, fwd=False)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_mlp_bwd_split_against_one_split(dtype):
    """At 1576 rows (B/16's sequence at 8 images) the weight gradients are
    cut into splits: with and without, they agree within the fp32 tolerance
    and every other output is the same."""
    dt = DTYPES[dtype]
    (_, x2, dy), w = _inputs(8, 197, 64, 192, dt, seed=9)
    assert MB.split_count(64, 192, 1576, dt)[0] > 1
    many = tiled_mlp_bwd(x2, dy, w, True)
    one = tiled_mlp_bwd(x2, dy, w, True, split=False)
    for name, a, b in zip(MLP_NAMES, many, one):
        if name in ("d_fc_w", "d_proj_w"):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= GRAD_TOL * scale, name
        else:
            assert torch.equal(a, b), name


ATTN_NAMES = ("dx", "d_in_w", "d_in_b", "d_out_w", "d_out_b", "d_ln1_w",
              "d_ln1_b")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,d,heads,f,causal,quick", BLOCK_SHAPES)
def test_tiled_attn_bwd_matches_plain_twin(b, s, d, heads, f, causal, quick,
                                           dtype):
    dt = DTYPES[dtype]
    (x, dx2, _), w = _inputs(b, s, d, f, dt, seed=s + 2)
    got = tiled_attn_bwd(x, dx2, w, heads, causal)
    ref = MB.attn_bwd_reference(x, dx2, w, heads, causal)
    for name, g, r in zip(ATTN_NAMES, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        _close(name, g, r, dt, fwd=False)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_attn_bwd_split_against_one_split(dtype):
    """At 1576 rows dWo and d in_proj_weight are cut into splits: with and
    without, they agree within the fp32 tolerance and every other output is
    the same."""
    dt = DTYPES[dtype]
    (x, dx2, _), w = _inputs(8, 197, 64, 192, dt, seed=10)
    assert MB.split_count(64, 64, 1576, dt)[0] > 1
    assert MB.split_count(192, 64, 1576, dt)[0] > 1
    many = tiled_attn_bwd(x, dx2, w, 4, False)
    one = tiled_attn_bwd(x, dx2, w, 4, False, split=False)
    for name, a, b in zip(ATTN_NAMES, many, one):
        if name in ("d_in_w", "d_out_w"):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= GRAD_TOL * scale, name
        else:
            assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    """<case>/<dtype>/<name> -> float32 array, from the Pallas kernels."""
    return mega_reference_subprocess(
        tmp_path_factory.mktemp("mega_tiled") / "pallas.npz")


def _model(name, dtype, round_dm=True):
    """The modelled forward, MLP backward and attention backward on a
    MEGA_CASES case, chained as FusedBlock chains the kernels -> float32
    numpy arrays under the Pallas reference's names (parameter gradients
    cast to the compute dtype, as the block's VJP leaves them)."""
    b, s, d, heads, f, causal, quick = MEGA_CASES[name]
    x, dy, layer = mega_case_inputs(name)
    w = MB.BlockWeights(*(torch.from_numpy(layer[k]).to(dtype)
                          for k in MB.BlockWeights._fields))
    x, dy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    y, x2 = tiled_block_fwd(x, w, heads, causal, quick)
    dx2, d_fc_w, d_fc_b, d_proj_w, d_proj_b, d_ln2_w, d_ln2_b = \
        tiled_mlp_bwd(x2, dy, w, quick, round_dm=round_dm)
    dx, d_in_w, d_in_b, d_out_w, d_out_b, d_ln1_w, d_ln1_b = tiled_attn_bwd(
        x, dx2, w, heads, causal)
    out = {"y": y, "x2": x2, "dx": dx}
    out.update({k: g.to(dtype) for k, g in (
        ("fc_w", d_fc_w), ("fc_b", d_fc_b), ("proj_w", d_proj_w),
        ("proj_b", d_proj_b), ("ln2_w", d_ln2_w), ("ln2_b", d_ln2_b),
        ("in_w", d_in_w), ("in_b", d_in_b), ("out_w", d_out_w),
        ("out_b", d_out_b), ("ln1_w", d_ln1_w), ("ln1_b", d_ln1_b))})
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(MEGA_CASES))
def test_tiled_model_matches_pallas_interpret(pallas, case, dtype):
    """fp32: the bounds of tests/test_torch_megablock.py (forward 2e-6 of
    the scale, gradients 1e-5 relative + 1e-6 of it); bf16: 8e-3 of the
    scale and y, x2, dx bit-equal in MIN_EQUAL_SHARE of their elements."""
    got = _model(case, DTYPES[dtype])
    for name, g in got.items():
        ref = pallas[f"{case}/{dtype}/{name}"]
        scale = max(1.0, float(np.abs(ref).max()))
        if dtype == "bfloat16":
            np.testing.assert_allclose(g, ref, rtol=0, atol=BF16_ULP * scale,
                                       err_msg=name)
        elif name in ("y", "x2"):
            np.testing.assert_allclose(g, ref, rtol=0, atol=FWD_TOL * scale,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=name)
    if dtype == "bfloat16":
        for name in ("y", "x2", "dx"):
            share = np.mean(got[name] == pallas[f"{case}/{dtype}/{name}"])
            assert share >= MIN_EQUAL_SHARE, (name, share)


def test_moved_dqkv_rounding_point_falls_below():
    """dq|dk|dv left unrounded before d in_proj_weight and dh1 (in bf16 the
    kernel stores them rounded and both products read that copy): dx, and
    d in_proj_weight cast to bf16 as the block's VJP leaves it, are then
    bit-equal to the plain twin's in fewer than MIN_EQUAL_SHARE of their
    elements, while the model with the point in place keeps it."""
    dt = torch.bfloat16
    (x, dx2, _), w = _inputs(4, 50, 64, 256, dt, seed=12)
    ref = MB.attn_bwd_reference(x, dx2, w, 4, False)
    right = tiled_attn_bwd(x, dx2, w, 4, False)
    wrong = tiled_attn_bwd(x, dx2, w, 4, False, round_dqkv=False)
    for i, name in ((0, "dx"), (1, "d_in_w")):
        share = {k: float((g[i].to(dt) == ref[i].to(dt)).float().mean())
                 for k, g in (("right", right), ("wrong", wrong))}
        assert share["right"] >= MIN_EQUAL_SHARE > share["wrong"], (name,
                                                                    share)


def test_moved_rounding_point_falls_below():
    """dm left unrounded before dWfc and dh2 (in bf16 the kernel stores it
    rounded over m1 and both products read that): dx2, and d fc_w cast to
    bf16 as the block's VJP leaves it, are then bit-equal to the plain
    twin's in fewer than MIN_EQUAL_SHARE of their elements, and d fc_w is
    off by ten times what the order of the sums gives, though within twice
    the bf16 gradient bound of the twin tests."""
    dt = torch.bfloat16
    (_, x2, dy), w = _inputs(4, 50, 64, 256, dt, seed=11)
    ref = MB.mlp_bwd_reference(x2, dy, w, True)
    right = tiled_mlp_bwd(x2, dy, w, True)
    wrong = tiled_mlp_bwd(x2, dy, w, True, round_dm=False)
    for i, name in ((0, "dx2"), (1, "d_fc_w")):
        share = {k: float((g[i].to(dt) == ref[i].to(dt)).float().mean())
                 for k, g in (("right", right), ("wrong", wrong))}
        assert share["right"] >= MIN_EQUAL_SHARE > share["wrong"], (name,
                                                                    share)
    scale = float(ref[1].abs().max())
    err = {k: float((g[1] - ref[1]).abs().max()) / scale
           for k, g in (("right", right), ("wrong", wrong))}
    # right: a few roundings of dm flipped by the order of its sums
    assert err["right"] <= 10 * GRAD_TOL < err["wrong"] <= 2 * BF16_GRAD_TOL, (
        err)
