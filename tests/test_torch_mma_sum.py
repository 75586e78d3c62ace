"""The model of how an H100's tensor cores sum one mma.sync.m16n8k16 with
bf16 operands and an fp32 accumulator (tests/torch_port_lib.py,
``mma_sum`` and ``mma_sum_dot``), on the CPU.  tests/test_torch_cuda.py
holds the block kernels' tensor-core product to it bit for bit on the
card; here: where it is exact, the two rules that set what it cuts off,
and what it costs the plain attention backward's bf16 dx against a mere
change of summation order."""

import numpy as np
import pytest
import torch
from torch_port_lib import MMA_EXTRA_BITS, TORCH_THREADS, mma_sum_dot

from swat_tpu_torch.kernels import megablock as MB

torch.set_num_threads(TORCH_THREADS)

ULP = 2.0 ** -23            # fp32's ulp at 1


def _ints(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-8, 9, shape).astype(
        np.float32)).bfloat16()


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (5, 7, 16), (33, 8, 40),
                                   (130, 24, 288)])
def test_mma_sum_is_exact_where_the_sum_is(m, n, k):
    """Small integers: every product and every partial sum is an integer
    far below 2^24, so nothing lies below the aligned bits and the model
    gives the exact product, ragged steps and mma included."""
    a, b = _ints((m, k), 1), _ints((k, n), 2)
    assert torch.equal(mma_sum_dot(a, b).double(), a.double() @ b.double())


def _one_mma(a_col, b_col):
    a = torch.tensor([a_col], dtype=torch.bfloat16)
    b = torch.tensor(b_col, dtype=torch.bfloat16)[:, None]
    return float(mma_sum_dot(a, b)[0, 0])


def test_mma_sum_cuts_below_the_largest_product():
    """1 + 15 products of 1.5 * 2^-25: each is cut to 2^-25, the bits kept
    below 1's fp32 ulp (MMA_EXTRA_BITS = 2), and the sum, 1 + 3.75 ulp, is
    cut toward zero to 1 + 3 ulp (exact: 1 + 5.625 ulp)."""
    assert MMA_EXTRA_BITS == 2
    small = 1.5 * 2.0 ** -25
    assert _one_mma([1.0] + [small] * 15, [1.0] * 16) == 1 + 3 * ULP
    assert _one_mma([-1.0] + [-small] * 15, [1.0] * 16) == -(1 + 3 * ULP)


def test_mma_sum_aligns_to_the_factors_exponents():
    """1.5 * 1.5 = 2.25 counts as exponent 0 (the sum of its factors'),
    not 1: the small products keep their 2^-25 (15 of them, 1.875 of
    2.25's ulp of 2^-22) and the sum is cut to 2.25 + 2^-22.  Aligned to
    the true exponent they would be cut to nothing."""
    small = 1.5 * 2.0 ** -25
    assert _one_mma([1.5] + [small] * 15, [1.5] + [1.0] * 15) \
        == 2.25 + 2.0 ** -22


def _split_depth_dot(a, b):
    """megablock._dot with the depth summed in two halves."""
    a, b = a.float(), b.float()
    k = a.shape[-1] // 2
    return a[..., :k] @ b[:k] + a[..., k:] @ b[k:]


def _block_inputs(b, s, d, seed):
    rng = np.random.default_rng(seed)

    def normal(shape, std=1.0, mean=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * std
                                 + mean).astype(np.float32)).bfloat16()

    x, dx2 = normal((b, s, d)), normal((b, s, d))
    zero = torch.zeros(1, dtype=torch.bfloat16)
    w = MB.BlockWeights(normal((3 * d, d), d ** -0.5), normal((3 * d,), 0.1),
                        normal((d, d), d ** -0.5), normal((d,), 0.1),
                        normal((d,), 0.1, 1.0), normal((d,), 0.1),
                        zero, zero, zero, zero, zero, zero)
    return x, dx2, w


def test_mma_sums_flip_more_of_dx_than_a_reordering(monkeypatch):
    """The plain attention backward in bf16 at width 96 (the card test's
    shapes): with the card's sums as its products it differs from itself
    in more dx elements than with its products summed in another order.
    That is what the tensor-core #7 costs dx beside the CUDA-core one."""
    flips = {}
    for name, dot in (("mma", mma_sum_dot), ("reordered", _split_depth_dot)):
        flips[name] = 0
        for s, causal in ((50, False), (77, True), (197, False)):
            x, dx2, w = _block_inputs(4, s, 96, seed=s)
            ref = MB.attn_bwd_reference(x, dx2, w, 3, causal)[0]
            monkeypatch.setattr(MB, "_dot", dot)
            got = MB.attn_bwd_reference(x, dx2, w, 3, causal)[0]
            monkeypatch.undo()
            flips[name] += int((got != ref).sum())
    assert flips["mma"] > flips["reordered"], flips
