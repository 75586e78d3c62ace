"""The LayerNorm kernel pair (swat_tpu_torch/kernels/layer_norm.py over
csrc/layer_norm.cu) on the CPU: its plain twins against the towers' own
formula (``models/clip.py::layer_norm``) and against autograd of it, the
autograd Function, what it saves, and the kernels' arithmetic modelled
launch by launch (``torch_port_lib.ln_model_*``: row sums in lane order,
the warp's lanes xor 16 .. 1, the group's warps in order; column sums in
fixed row blocks, joined in a tree and then in order) against the twins.
The kernels themselves run only on a card (tests/test_torch_cuda.py holds
them to that model bit for bit)."""

import os
import re

import pytest
import torch
from torch import nn
from torch_port_lib import (TORCH_THREADS, ln_model_bwd, ln_model_colsum,
                            ln_model_fwd)

from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from swat_tpu_torch.kernels import layer_norm as LN
from swat_tpu_torch.models import clip

torch.set_num_threads(TORCH_THREADS)

POLICIES = {"fp32": FP32_PRECISION, "bf16": DEFAULT_PRECISION}
WIDTHS = (512, 768, 1024)
# odd row counts: a partial warp group, a partial 64-row block of the
# backward's column sums, and several blocks
ROWS = (3, 37, 131)
EPS = 1e-5
# twin or model against autograd of the towers' formula (or each other):
# fp32 differs in summation order only, a few ulps of values of order 1
# (dx, y) or of the column sums' largest value (dw, db); a bf16 output by a
# rounding flip, one bf16 ulp (2^-7 relative) of its element
FP32_TOL = 1e-5
BF16_ULP = 2 ** -7


def _ln(width: int, seed: int = 0) -> nn.LayerNorm:
    g = torch.Generator().manual_seed(seed)
    ln = nn.LayerNorm(width)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.5 * torch.randn(width, generator=g))
        ln.bias.copy_(0.5 * torch.randn(width, generator=g))
    return ln


def _x(rows: int, width: int, dtype, seed: int = 1, mean: float = 0.3):
    g = torch.Generator().manual_seed(seed)
    return (mean + 2 * torch.randn(rows, width, generator=g)).to(dtype)


def _close(got, ref, what=""):
    """Within FP32_TOL of ref's largest value (fp32 sums in two orders)."""
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape, what
    scale = max(ref.abs().max().item(), 1e-30)
    err = (got - ref).abs().max().item()
    assert err <= FP32_TOL * scale, (what, err, scale)


def _close_out(got, ref, what=""):
    """An output in its dtype: bf16 elements within one ulp of themselves
    (a rounding flip) and FP32_TOL of the largest (an element near 0 is
    the difference of larger fp32 terms), fp32 as ``_close``."""
    if got.dtype == torch.bfloat16:
        ref = ref.float()
        err = (got.float() - ref).abs()
        bound = BF16_ULP * ref.abs() + FP32_TOL * ref.abs().max()
        assert bool((err <= bound).all()), (what, err.max().item())
    else:
        _close(got, ref, what)


def _autograd_of_towers(ln, x, precision, dy):
    """dx, dw, db of the towers' formula on the CPU, by autograd."""
    x = x.detach().clone().requires_grad_(True)
    ln.zero_grad(set_to_none=True)
    y = clip.layer_norm(ln, x, precision)
    y.backward(dy)
    return y.detach(), x.grad, ln.weight.grad, ln.bias.grad


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("width", WIDTHS)
def test_forward_twin_is_the_towers_formula(policy, width):
    """The forward twin is clip.layer_norm's CPU formula, bit for bit."""
    p = POLICIES[policy]
    ln = _ln(width)
    x = _x(37, width, p.compute_dtype)
    y, mu, rstd = LN.layer_norm_reference(x, ln.weight, ln.bias,
                                          p.ln_fast_variance, EPS,
                                          p.compute_dtype)
    assert torch.equal(y, clip.layer_norm(ln, x, p))
    assert mu.shape == rstd.shape == (37,)
    assert mu.dtype == rstd.dtype == torch.float32


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_backward_twin_matches_autograd_of_the_towers(policy, width, rows):
    """The backward twin (the analytic gradient) against autograd of
    clip.layer_norm's formula: dx in x's dtype, fp32 dw and db."""
    p = POLICIES[policy]
    ln = _ln(width, seed=rows)
    x = _x(rows, width, p.compute_dtype, seed=width)
    dy = _x(rows, width, p.compute_dtype, seed=width + 1, mean=0.0)
    _, dx_ref, dw_ref, db_ref = _autograd_of_towers(ln, x, p, dy)
    _, mu, rstd = LN.layer_norm_reference(x, ln.weight, ln.bias,
                                          p.ln_fast_variance, EPS,
                                          p.compute_dtype)
    dx, dw, db = LN.layer_norm_bwd_reference(x, dy, mu, rstd,
                                             ln.weight.detach())
    assert dx.dtype == x.dtype and dw.dtype == db.dtype == torch.float32
    _close_out(dx, dx_ref, "dx")
    _close(dw, dw_ref, "dw")
    _close(db, db_ref, "db")


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_function_on_the_cpu_runs_the_twins(policy):
    """LayerNormFunction on CPU tensors: its forward is the twin's y, its
    gradients the backward twin's, exactly."""
    p = POLICIES[policy]
    ln = _ln(768)
    x = _x(13, 768, p.compute_dtype).requires_grad_(True)
    dy = _x(13, 768, p.compute_dtype, seed=5, mean=0.0)
    w, b = ln.weight, ln.bias
    y = LN.layer_norm(x, w, b, p.ln_fast_variance, EPS, p.compute_dtype)
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    y.backward(dy)
    y_ref, mu, rstd = LN.layer_norm_reference(x.detach(), w, b,
                                              p.ln_fast_variance, EPS,
                                              p.compute_dtype)
    dx, dw, db = LN.layer_norm_bwd_reference(x.detach(), dy, mu, rstd,
                                             w.detach())
    assert torch.equal(y, y_ref)
    assert torch.equal(x.grad, dx)
    assert torch.equal(w.grad, dw) and torch.equal(b.grad, db)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_strided_class_token_rows(policy):
    """ln_post's x[:, 0] (a strided [B, W] view of [B, S, W]) gives what its
    contiguous copy gives, forward and backward, through the Function and
    through the model of the kernels."""
    p = POLICIES[policy]
    ln = _ln(1024)
    seq = _x(9 * 5, 1024, p.compute_dtype).reshape(9, 5, 1024)
    view, copy = seq[:, 0], seq[:, 0].contiguous()
    assert view.stride() == (5 * 1024, 1)
    dy = _x(9, 1024, p.compute_dtype, seed=3, mean=0.0)
    outs = []
    for x in (view, copy):
        x = x.detach().requires_grad_(True)
        y = LN.layer_norm(x, ln.weight, ln.bias, p.ln_fast_variance, EPS,
                          p.compute_dtype)
        dx, = torch.autograd.grad(y, x, dy)
        outs.append((y, dx, *ln_model_fwd(x.detach(), ln.weight, ln.bias,
                                          p.ln_fast_variance, EPS,
                                          p.compute_dtype)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    # and the towers' formula on the view agrees with the twin
    _, dx_ref, _, _ = _autograd_of_towers(ln, view, p, dy)
    _close_out(outs[0][1], dx_ref, "dx")


def _clamping_row(width: int):
    """A constant fp32 row whose fast variance E[x^2] - mu^2 rounds below 0
    in fp32, both in the twin's sums and in the kernels' order (a constant
    bf16 row sums exactly, to a variance of 0)."""
    ones, zeros = torch.ones(width), torch.zeros(width)
    for k in range(1, 400):
        x = torch.full((1, width), 0.1 + 0.0137 * k)
        _, _, r_twin = LN.layer_norm_reference(x, ones, zeros, True, EPS,
                                               torch.bfloat16)
        _, _, r_model = ln_model_fwd(x, ones, zeros, True, EPS,
                                     torch.bfloat16)
        if r_twin.item() < 0 and r_model.item() < 0:
            return x
    raise AssertionError("no constant row clamps")


@pytest.mark.parametrize("width", WIDTHS)
def test_constant_row_hits_the_clamp(width):
    """A constant row whose fast variance rounds below 0: the clamp sets
    var to 0 (rstd = 1 / sqrt(eps)), the twin marks it (rstd negated), and
    the backward drops the variance term there, as autograd of the clamp
    does; the model of the kernels clamps the same row alike."""
    p = DEFAULT_PRECISION
    ln = _ln(width)
    g = torch.Generator().manual_seed(7)
    x = torch.cat([_clamping_row(width), _x(4, width, torch.float32)])
    dy = torch.randn(5, width, generator=g).bfloat16()
    y, mu, rstd = LN.layer_norm_reference(x, ln.weight, ln.bias, True, EPS,
                                          torch.bfloat16)
    assert rstd[0] < 0 and bool((rstd[1:] > 0).all())
    assert abs(-rstd[0].item() - EPS ** -0.5) < 1e-3 * EPS ** -0.5
    y_ref, dx_ref, dw_ref, db_ref = _autograd_of_towers(ln, x, p, dy)
    assert torch.equal(y, y_ref)
    dx, dw, db = LN.layer_norm_bwd_reference(x, dy, mu, rstd,
                                             ln.weight.detach())
    _close_out(dx, dx_ref, "dx")
    _close(dw, dw_ref, "dw")
    _close(db, db_ref, "db")
    ym, mum, rstdm = ln_model_fwd(x, ln.weight, ln.bias, True, EPS,
                                  torch.bfloat16)
    assert rstdm[0] < 0
    _close_out(ym, y, "y")
    dxm, _, _ = ln_model_bwd(x, dy, mum, rstdm, ln.weight.detach())
    _close_out(dxm, dx, "dx model")


def _saved(fn):
    """The tensors autograd saves while fn() runs, by count."""
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return packed


def test_no_grad_saves_nothing():
    """Where no input needs a gradient the forward alone runs: no graph,
    nothing saved; with one, the Function saves x, the weight and the two
    rows of statistics."""
    p = DEFAULT_PRECISION
    ln = _ln(512)
    x = _x(7, 512, p.compute_dtype)

    def run(x):
        return LN.layer_norm(x, ln.weight, ln.bias, True, EPS,
                             p.compute_dtype)

    with torch.no_grad():
        assert _saved(lambda: run(x)) == []
        assert run(x).grad_fn is None
    frozen = _ln(512)
    frozen.requires_grad_(False)
    y = []
    assert _saved(lambda: y.append(LN.layer_norm(
        x, frozen.weight, frozen.bias, True, EPS, p.compute_dtype))) == []
    assert y[0].grad_fn is None
    saved = _saved(lambda: run(x.requires_grad_(True)))
    assert [tuple(t.shape) for t in saved] == [(7, 512), (512,), (7,), (7,)]


def test_cpu_layer_norm_never_enters_the_function(monkeypatch):
    """clip.layer_norm on a CPU tensor runs its own formula: the kernels'
    wrappers and Function are never reached, and the graph is the plain
    formula's."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path was entered on the CPU")

    monkeypatch.setattr(LN.LayerNormFunction, "apply", refuse)
    monkeypatch.setattr(LN, "layer_norm_fwd", refuse)
    monkeypatch.setattr(clip, "fused_layer_norm", refuse)
    for p in POLICIES.values():
        ln = _ln(768)
        x = _x(5, 768, p.compute_dtype).requires_grad_(True)
        y = clip.layer_norm(ln, x, p)
        assert type(y.grad_fn).__name__ != "LayerNormFunctionBackward"
        y.float().sum().backward()
        assert x.grad is not None and ln.weight.grad is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("width", (64, 512, 768, 1001, 1024, 1280, 3000,
                                   6000))
def test_model_of_the_kernels_matches_the_twins(dtype, fast, width):
    """The kernels' arithmetic, launch by launch, against the plain twins:
    at the towers' widths, a width that is no whole number of vectors, and
    rows wide enough for 2, 4 or 8 warps."""
    ln = _ln(width)
    rows = 131
    x = _x(rows, width, dtype, seed=width)
    dy = _x(rows, width, dtype, seed=width + 1, mean=0.0)
    y, mu, rstd = ln_model_fwd(x, ln.weight, ln.bias, fast, EPS, dtype)
    y_ref, mu_ref, rstd_ref = LN.layer_norm_reference(
        x, ln.weight, ln.bias, fast, EPS, dtype)
    _close_out(y, y_ref, "y")
    _close(mu, mu_ref, "mu")
    _close(rstd, rstd_ref, "rstd")
    dx, dw, db = ln_model_bwd(x, dy, mu, rstd, ln.weight.detach())
    dx_ref, dw_ref, db_ref = LN.layer_norm_bwd_reference(
        x, dy, mu_ref, rstd_ref, ln.weight.detach())
    _close_out(dx, dx_ref, "dx")
    _close(dw, dw_ref, "dw")
    _close(db, db_ref, "db")


@pytest.mark.parametrize("rows", (1, 63, 64, 65, 513, 4100))
@pytest.mark.parametrize("groups", (1, 2, 4, 8))
def test_model_column_sums_keep_their_order(rows, groups):
    """The backward's column sums in their fixed order equal the plain sum
    up to order, and are exact where every partial is exact (integers):
    nothing is dropped or counted twice, whatever the rows, blocks and row
    groups."""
    g = torch.Generator().manual_seed(rows)
    ints = torch.randint(-50, 50, (rows, 24), generator=g).float()
    assert torch.equal(ln_model_colsum(ints, groups), ints.sum(0))
    p = torch.randn(rows, 24, generator=g)
    _close(ln_model_colsum(p, groups), p.double().sum(0).float(), "sum")


def _source_constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\w+);", text).group(1)
               .replace("kWarps", str(LN.WARPS)))


def test_plan_mirrors_the_source():
    """The Python side's constants and plan are the kernel source's."""
    path = os.path.join(os.path.dirname(LN.__file__), os.pardir, "csrc",
                        "layer_norm.cu")
    with open(path) as f:
        text = f.read()
    assert _source_constant(text, "kWarps") == LN.WARPS
    assert _source_constant(text, "kMaxPerLane") == LN.PER_LANE
    assert _source_constant(text, "kMaxGroup") == LN.WARPS
    assert _source_constant(text, "kRowsPerBlock") == LN.ROWS_PER_BLOCK
    assert _source_constant(text, "kJoinWarps") == LN.JOIN_WARPS
    f32, b16 = torch.float32, torch.bfloat16
    assert LN.plan(768, f32) == (1, 6)
    assert LN.plan(1024, f32) == (1, 8)
    assert LN.plan(768, b16) == (1, 3)
    assert LN.plan(1024, b16) == (1, 4)
    assert LN.plan(1280, f32) == (2, 5)
    assert LN.plan(3000, b16) == (4, 4)
    assert LN.plan(LN.MAX_WIDTH, f32) == (8, 8)
    with pytest.raises(ValueError, match="beyond"):
        LN.plan(LN.MAX_WIDTH + 1, f32)


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16)])
def test_wrapper_refuses_what_the_kernels_do_not_take(dtype, out_dtype):
    """The kernels take x, y, dy and dx in one dtype, fp32 or bf16: the
    wrapper's check refuses another pair before any launch (the towers
    always pass x in the compute dtype)."""
    ln = _ln(64)
    with pytest.raises(TypeError, match="x's dtype|float32 or bfloat16"):
        LN._check(_x(3, 64, dtype), ln.weight.detach(), ln.bias.detach(),
                  out_dtype)
    LN._check(_x(3, 64, torch.float32), ln.weight.detach(),
              ln.bias.detach(), torch.float32)
