"""The BatchNorm kernel set (swat_tpu_torch/kernels/batch_norm.py over
csrc/batch_norm.cu) on the CPU: its plain twins against ``AffineBN``'s own
train-mode path and autograd of it, and against swat_tpu's ``AffineBN``; the
autograd Function and what it saves; ``plan`` at every one of RN50's 55
BatchNorm shapes; and the RN50 tower's CPU route, which keeps the plain
passes bit for bit.  The kernels themselves run only on a card
(tests/test_torch_cuda.py holds them to the twins)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_lib import TORCH_THREADS, rn50_bn_shapes

from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.models.resnet import AffineBN as JaxAffineBN
from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from swat_tpu_torch.kernels import batch_norm as BN
from swat_tpu_torch.models import resnet
from swat_tpu_torch.models.configs import (MODEL_REGISTRY, ResNetConfig,
                                           get_model_config)

torch.set_num_threads(TORCH_THREADS)

POLICIES = {"fp32": FP32_PRECISION, "bf16": DEFAULT_PRECISION}
EPS = resnet.AffineBN.EPS
# twin against autograd of AffineBN's formula in fp32, by each output's
# norm: the same function summed in other orders, a few fp32 ulps
FP32_REL = 1e-6
# against swat_tpu's AffineBN (XLA's sums in yet another order), and for the
# gradients, whose terms cancel, a little more room
JAX_REL = 1e-5
# RN50's full depth at a small width and image: the 55 BatchNorms in order
RN50_SMALL = ResNetConfig(image_size=64, width=8, layers=(3, 4, 6, 3),
                          embed_dim=16, heads=2)


def _inputs(bsz, c, side, dtype, seed=0, layout="channels_last"):
    """x [B, C, side, side] (channels-last or contiguous), an fp32 weight
    and bias, and an output gradient, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((bsz, side, side, c)) * 2
                          + 0.7).astype(np.float32)).to(dtype)
    x = x.permute(0, 3, 1, 2)
    if layout == "contiguous":
        x = x.contiguous()
    w = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    b = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((bsz, side, side, c)).astype(
        np.float32)).to(dtype).permute(0, 3, 1, 2)
    return x, w, b, dy


def _plain(x, w, b, precision, relu):
    """AffineBN's own train-mode path with autograd -> (y, updates)."""
    bn = resnet.AffineBN(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    updates = {}
    y = bn._normalize(x, *bn._batch_stats(x, updates), precision)
    return (F.relu(y) if relu else y), updates[bn], bn


def _rel(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm())


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_twins_match_affine_bn_and_its_autograd(policy, relu):
    """The forward twin is AffineBN's train-mode formula (bit-equal output
    and statistics in both dtypes); the backward twin its gradient: within
    FP32_REL in fp32, and in bf16 no further from a float64 gradient of the
    same rounded function than autograd of the plain path is."""
    prec = POLICIES[policy]
    x, w, b, dy = _inputs(4, 24, 9, prec.compute_dtype)
    xg = x.detach().requires_grad_(True)
    y_p, (mean_p, var_p), bn = _plain(xg, w, b, prec, relu)
    dx_p, dw_p, db_p = torch.autograd.grad(y_p, (xg, bn.weight, bn.bias), dy)
    y, mean, var, rstd, a, bb = BN.batch_norm_reference(x, w, b, EPS, relu)
    assert torch.equal(y, y_p) and torch.equal(mean, mean_p)
    assert torch.equal(var, var_p)
    assert y.is_contiguous(memory_format=torch.channels_last)
    dx, dw, db = BN.batch_norm_bwd_reference(x, dy, mean, rstd, w, a, bb,
                                             relu)
    assert dx.dtype == x.dtype and dw.dtype == db.dtype == torch.float32
    if policy == "fp32":
        for got, ref in ((dx, dx_p), (dw, dw_p), (db, db_p)):
            assert _rel(got, ref) <= FP32_REL
        return
    # float64 gradient of y = relu(x * a + b) with a, b as functions of the
    # statistics (the roundings to bf16 passed straight through)
    x64 = x.double().requires_grad_(True)
    w64 = w.double().requires_grad_(True)
    b64 = b.double().requires_grad_(True)
    m64 = x64.mean(dim=(0, 2, 3), keepdim=True)
    v64 = x64.var(dim=(0, 2, 3), correction=0, keepdim=True)
    y64 = (x64 - m64) * torch.rsqrt(v64 + EPS) * w64.view(1, -1, 1, 1) \
        + b64.view(1, -1, 1, 1)
    dz64 = dy.double() * (y_p.double() > 0) if relu else dy.double()
    refs = torch.autograd.grad(y64, (x64, w64, b64), dz64)
    for got, plain, ref in zip((dx, dw, db), (dx_p, dw_p, db_p), refs):
        assert _rel(got, ref) <= _rel(plain, ref)


SWAT_SHAPES = [(32, 56), (64, 28), (256, 14), (1024, 7), (2048, 7)]


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c,side", SWAT_SHAPES)
def test_twins_match_swat_tpu_affine_bn(c, side, relu, layout):
    """On RN50 (C, H x W) shapes at 2 images, fp32: y, the gradients of x,
    the weight and the bias (through swat_tpu's AffineBN, then
    ``jax.nn.relu``), and the running statistics it sows (momentum 0.1,
    from 0 / 1) against the twins' folded the same way."""
    x, w, b, dy = _inputs(2, c, side, torch.float32, seed=c + side,
                          layout=layout)
    y, mean, var, rstd, a, bb = BN.batch_norm_reference(x, w, b, EPS, relu)
    dx, dw, db = BN.batch_norm_bwd_reference(x, dy, mean, rstd, w, a, bb,
                                             relu)
    module = JaxAffineBN(c, precision=JAX_FP32)
    nhwc = jnp.asarray(x.permute(0, 2, 3, 1).numpy())

    def forward(x_, scale, bias):
        params = {"scale": scale, "bias": bias, "mean": jnp.zeros(c),
                  "var": jnp.ones(c)}
        out, sown = module.apply({"params": params}, x_, train=True,
                                 mutable=["intermediates"])
        return (jax.nn.relu(out) if relu else out), sown

    y_j, vjp, sown = jax.vjp(forward, nhwc, jnp.asarray(w.numpy()),
                             jnp.asarray(b.numpy()), has_aux=True)
    dx_j, dw_j, db_j = vjp(jnp.asarray(dy.permute(0, 2, 3, 1).numpy()))
    as_nchw = lambda t: torch.from_numpy(np.array(t)).permute(0, 3, 1, 2)
    assert _rel(y, as_nchw(y_j)) <= JAX_REL
    assert _rel(dx, as_nchw(dx_j)) <= JAX_REL
    assert _rel(dw, torch.from_numpy(np.array(dw_j))) <= JAX_REL
    assert _rel(db, torch.from_numpy(np.array(db_j))) <= JAX_REL
    inter = sown["intermediates"]
    m = resnet.AffineBN.MOMENTUM
    assert _rel(m * mean, torch.from_numpy(np.array(
        inter["new_mean"][0]))) <= JAX_REL
    assert _rel((1 - m) + m * var, torch.from_numpy(np.array(
        inter["new_var"][0]))) <= JAX_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz", [4, 32, 256])
def test_plan_covers_every_rn50_shape(bsz, dtype):
    """At each of RN50's 55 BatchNorm shapes: the tiles cover the channels
    and the slabs the rows, none empty; a tile is whole row segments of
    16-byte vectors; every block is in the grid's range; where the batch
    gives every thread of TARGET_BLOCKS' worth of blocks MIN_ROWS rows, the
    grid fills the 132 SMs at least once; a thread takes MIN_ROWS rows or
    its slab is the only one."""
    shapes = rn50_bn_shapes(get_model_config("rn50_openclip_openai").vision)
    assert len(shapes) == 55 and sum(r for _, _, r in shapes) == 35
    # the BatchNorms' elements at bsz 256
    assert sum(256 * s * s * c for c, s, _ in shapes) == 3_185_573_888
    for c, side, _ in shapes:
        rows = bsz * side * side
        p = BN.plan(rows, c, dtype)
        assert p.vec == 16 // (torch.finfo(dtype).bits // 8)
        tile = p.tpr * p.vec
        assert p.tpr in (1, 2, 4, 8, 16, 32)
        assert p.tiles * tile >= c > (p.tiles - 1) * tile
        assert p.slabs * p.slab_rows >= rows > (p.slabs - 1) * p.slab_rows
        assert 1 <= p.slabs < 2 ** 31 and 1 <= p.tiles <= 65535
        assert p.blocks <= 2 * BN.TARGET_BLOCKS
        lanes = BN.THREADS // p.tpr
        assert p.slabs == 1 or p.slab_rows >= lanes * BN.MIN_ROWS
        if rows // (lanes * BN.MIN_ROWS) * p.tiles >= BN.SMS:
            assert p.blocks >= BN.SMS, (c, side, bsz, p)
    # the widest tile: a warp across 256 bf16 channels, 8 tiles of them
    assert BN.plan(100, 2048, torch.bfloat16) == (8, 32, 100, 1, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_refuses_channels_not_in_16_byte_vectors(dtype):
    """The kernels read 16 bytes of channels a thread (4 fp32, 8 bf16): the
    wrapper's check refuses another channel count before any launch, and
    takes every BatchNorm width of the registered ResNets."""
    per16 = 16 // (torch.finfo(dtype).bits // 8)
    w, b = torch.ones(per16 * 3 + 2), torch.zeros(per16 * 3 + 2)
    with pytest.raises(ValueError, match="16-byte"):
        BN._check(torch.zeros(2, per16 * 3 + 2, 3, 3, dtype=dtype), w, b)
    towers = [cfg.vision for cfg in MODEL_REGISTRY.values()
              if isinstance(cfg.vision, ResNetConfig)]
    assert towers
    for vision in towers:
        for c, _, _ in rn50_bn_shapes(vision):
            BN._check(torch.zeros(1, c, 1, 1, dtype=dtype), torch.ones(c),
                      torch.zeros(c))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_function_saves_no_fp32_copy(policy, relu):
    """BatchNormFunction on a CPU tensor (the twins inside): y and the
    update pair as batch_norm_reference gives them, the gradients as
    batch_norm_bwd_reference, only the weight's or x's where asked; it saves
    x, the weight and four [C] vectors, never an fp32 copy of a bf16 x; no
    launch counted."""
    prec = POLICIES[policy]
    x, w, b, dy = _inputs(3, 16, 5, prec.compute_dtype, seed=4)
    before = (BN.LAUNCHES_BN, BN.LAUNCHES_BN_BWD, BN.COPIES_BN)
    xg = x.detach().requires_grad_(True)
    wg, bg = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    y, mean, var = BN.batch_norm(xg, wg, bg, EPS, relu)
    ref = BN.batch_norm_reference(x, w, b, EPS, relu)
    assert torch.equal(y, ref[0]) and torch.equal(mean, ref[1])
    assert torch.equal(var, ref[2])
    assert not (mean.requires_grad or var.requires_grad)
    saved = y.grad_fn.saved_tensors
    assert [t.numel() for t in saved] == [x.numel(), 16] + [16] * 4
    assert all(t.dtype == x.dtype for t in saved if t.numel() == x.numel())
    grads = torch.autograd.grad(y, (xg, wg, bg), dy)
    refs = BN.batch_norm_bwd_reference(x, dy, *ref[1:2], ref[3], w, *ref[4:],
                                       relu)
    for got, want in zip(grads, refs):
        assert torch.equal(got, want)
    # the parameters alone, then x alone
    y, _, _ = BN.batch_norm(x, wg, bg, EPS, relu)
    assert torch.equal(torch.autograd.grad(y, wg, dy)[0], refs[1])
    y, _, _ = BN.batch_norm(xg, w, b, EPS, relu)
    assert torch.equal(torch.autograd.grad(y, xg, dy)[0], refs[0])
    with torch.no_grad():
        y, _, _ = BN.batch_norm(xg, wg, bg, EPS, relu)
    assert y.grad_fn is None and torch.equal(y, ref[0])
    assert (BN.LAUNCHES_BN, BN.LAUNCHES_BN_BWD, BN.COPIES_BN) == before


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_cpu_route_keeps_the_plain_passes(policy):
    """A train-mode forward and backward of RN50's 55 BatchNorms (full
    depth, small width) on the CPU: BN_BATCH_STATS advances by 55, no
    kernel call or copy is counted, every BatchNorm input is channels-last
    at the shape ``rn50_bn_shapes`` lists, the features, the update pairs
    and the gradients are bit for bit those of the tower written out with
    AffineBN's plain passes and a separate F.relu, and each update pair is
    (mean, unbiased variance) of its input."""
    prec = POLICIES[policy]
    torch.manual_seed(0)
    model = resnet.ModifiedResNet(RN50_SMALL)
    model.init_random(torch.Generator().manual_seed(1))
    model.precision = prec
    images = torch.randn(2, 64, 64, 3, generator=torch.Generator()
                         .manual_seed(2))
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append((args[0].shape[1], args[0].shape[2],
                                     args[0].is_contiguous(
                                         memory_format=torch.channels_last))))
        for m in model.modules() if isinstance(m, resnet.AffineBN)]
    before = (resnet.BN_BATCH_STATS, BN.LAUNCHES_BN, BN.LAUNCHES_BN_BWD,
              BN.COPIES_BN)
    updates = resnet.BNUpdates()
    feats = model(images, prec, updates=updates)
    grads = torch.autograd.grad(feats.sum(), list(model.parameters()))
    for h in hooks:
        h.remove()
    assert resnet.BN_BATCH_STATS - before[0] == 55 == len(updates)
    assert (BN.LAUNCHES_BN, BN.LAUNCHES_BN_BWD, BN.COPIES_BN) == before[1:]
    assert sorted(seen) == sorted((c, s, True) for c, s, _ in
                                  rn50_bn_shapes(RN50_SMALL))

    # the parent's tower: AffineBN's plain passes, F.relu after them
    inputs = {}

    def bn(mod, x, relu):
        inputs[mod] = x
        upd = {}
        y = mod._normalize(x, *mod._batch_stats(x, upd), prec)
        ref_updates[mod] = upd[mod]
        return F.relu(y) if relu else y

    def conv_bn(conv, mod, x, relu):
        return bn(mod, resnet._conv(conv, x, prec.compute_dtype), relu)

    ref_updates = {}
    x = images.to(prec.compute_dtype).permute(0, 3, 1, 2)
    for conv, mod in ((model.conv1, model.bn1), (model.conv2, model.bn2),
                      (model.conv3, model.bn3)):
        x = conv_bn(conv, mod, x, True)
    x = F.avg_pool2d(x, 2)
    for stage in range(4):
        for blk in getattr(model, f"layer{stage + 1}"):
            h = conv_bn(blk.conv1, blk.bn1, x, True)
            h = conv_bn(blk.conv2, blk.bn2, h, True)
            if blk.stride > 1:
                h = F.avg_pool2d(h, blk.stride)
            h = conv_bn(blk.conv3, blk.bn3, h, False)
            identity = x
            if blk.downsample is not None:
                if blk.stride > 1:
                    identity = F.avg_pool2d(identity, blk.stride)
                identity = conv_bn(blk.downsample["0"], blk.downsample["1"],
                                   identity, False)
            x = F.relu(h + identity)
    ref = model.attnpool(x, prec)
    ref_grads = torch.autograd.grad(ref.sum(), list(model.parameters()))
    assert torch.equal(feats, ref)
    for got, want in zip(grads, ref_grads):
        assert torch.equal(got, want)
    for mod, (mean, var) in updates.items():
        assert torch.equal(mean, ref_updates[mod][0])
        assert torch.equal(var, ref_updates[mod][1])
        x32 = inputs[mod].detach().float()
        n = x32.numel() // x32.shape[1]
        assert torch.equal(var, x32.var(dim=(0, 2, 3), correction=0)
                           * (n / (n - 1)))
