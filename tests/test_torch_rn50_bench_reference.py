"""The benchmark's RN50 pieces on the CPU: ``portbench/reference/resnet.py``
against the float64 oracle of tests/test_torch_oracle_rn50.py (two
independent writings of OpenCLIP's ModifiedResNet, train-mode
BatchNorm); the port's stage-1 cutmix steps through the
``train_resident_resnet`` entry against that reference in fp32 on a tiny
RN (width 8, layers (1, 1, 1, 1), image 64); ``portbench/weights_resnet.py``
loading into the port's RN50 ``CLIPModel`` (tiny on the CPU, RN50's
widths on the meta device); ``portbench/flops_resnet.py`` against the
port's own ``F.conv2d`` and ``torch.matmul`` shapes; the port's count of
batch-statistics BatchNorm calls and its ``resnet.*`` spans, which only a
profiler sees."""

import os

import torch
import torch.nn.functional as F
from test_torch_oracle_rn50 import (EMBED, HEADS, IMG, LAYERS, W,
                                    make_rn50_sd, oracle_rn50_encode_image)
from torch_port_lib import TORCH_THREADS

from portbench import flops_resnet, harness, weights_resnet
from portbench.reference import resnet as ref_resnet
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.models import resnet
from swat_tpu_torch.models.clip import CLIPModel

torch.set_num_threads(TORCH_THREADS)

SEED = 2 ** 31 + 77
DATA = os.path.join(harness.BENCH_DIR, "tests", "data")
RN50 = harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                      "rn50_openclip_openai.json"))
TINY = harness.load_json(os.path.join(DATA, "tiny_rn.json"))
# tiny RN: 3 stem + 3 a bottleneck + 4 downsamples
TINY_BNS = 19


def _entry():
    return harness.entry("train_resident_resnet")


def _model(cfg, device="cpu"):
    with torch.device(device):
        return CLIPModel(_entry().clip_config(cfg), precision=FP32_PRECISION)


def test_reference_matches_the_float64_oracle():
    """Train-mode features and every gradient of their sum, float64."""
    cfg = {"embed_dim": EMBED,
           "vision_cfg": {"image_size": IMG, "layers": list(LAYERS),
                          "width": W},
           "assumed": {"vision_head_width": W * 32 // HEADS}}
    sd = {k: v.double() for k, v in make_rn50_sd(3).items()}
    images = torch.randn(4, IMG, IMG, 3, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(1))
    leaves = {k: v.clone().requires_grad_(True) for k, v in sd.items()
              if ref_resnet.trained(k)}
    ours = ref_resnet.image_features(images, leaves, cfg)
    g_ours = torch.autograd.grad(ours.sum(), list(leaves.values()))
    theirs_sd = {k: v.clone() for k, v in sd.items()}
    theirs_sd.update({k: v.detach().clone().requires_grad_(True)
                      for k, v in leaves.items()})
    theirs = oracle_rn50_encode_image(theirs_sd, images, training=True,
                                      normalize=False)
    g_theirs = torch.autograd.grad(theirs.sum(),
                                   [theirs_sd[k] for k in leaves])
    torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-10)
    for name, a, b in zip(leaves, g_ours, g_theirs):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-10, msg=name)


def test_port_steps_match_the_reference_in_fp32():
    """3 stage-1 cutmix steps of the port (the entry's build and
    first_steps, the resident epoch) against the reference's: losses rel
    <= 1e-5, the first-gradient and change gaps under the fp32 cell's
    limits, the running statistics' change within 1e-5, one BatchNorm
    call a convolution a step."""
    entry = _entry()
    cell = harness.Cell(
        "tiny_rn", 1, TINY,
        dict(harness.load_json(os.path.join(DATA, "tiny_train.json")),
             entry="train_resident_resnet"),
        dict(harness.cell("vitb32-cutmix-fp32-b256").limits,
             running_stats_gap=1e-5))
    cpu = torch.device("cpu")
    prog = entry.build(cell, SEED, cpu)
    before = resnet.BN_BATCH_STATS
    readings, rows = entry.first_steps(prog, 3)
    assert resnet.BN_BATCH_STATS - before == 3 * TINY_BNS
    inputs = entry.reference_inputs(prog, rows)
    ref = entry.follow_reference(cell, SEED, inputs, prog.total_iter, cpu)
    for p, r in zip(readings.losses, ref.losses):
        assert abs(p - r) <= 1e-5 * abs(r)
    checks = entry.compare(readings, ref, cell.limits)
    assert set(checks) == set(cell.limits)
    assert all(v <= limit for v, limit in checks.values()), checks


def test_weights_load_strictly_into_the_port():
    cpu = torch.device("cpu")
    w = weights_resnet.make_weights(TINY, 5, cpu)
    _model(TINY).load_state_dict(w, strict=True)
    assert w["visual.layer1.0.bn3.weight"].std() > 0
    # RN50's widths: every name and shape, loaded on the meta device
    model = _model(RN50, "meta")
    spec = {name: tuple(shape) for name, shape, _, _ in
            weights_resnet.leaves(RN50)}
    state = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tracked = {k for k in spec if k.endswith("num_batches_tracked")}
    assert len(tracked) == 55 and {k: v for k, v in spec.items()
                                   if k not in tracked} == state
    model.load_state_dict({k: torch.empty(s, device="meta")
                           for k, s in spec.items()}, strict=True)


def _products(monkeypatch, cfg, batch):
    """-> the multiply-adds of one image of each F.conv2d and each
    torch.matmul of the port's RN50 train forward on the meta device."""
    convs, mms = [], []
    conv2d, matmul = F.conv2d, torch.matmul

    def counted_conv(x, w, *args, **kwargs):
        y = conv2d(x, w, *args, **kwargs)
        convs.append(y[0].numel() * w[0].numel())
        return y

    def counted_mm(a, b):
        y = matmul(a, b)
        mms.append(y.numel() // batch * a.shape[-1])
        return y

    monkeypatch.setattr(F, "conv2d", counted_conv)
    monkeypatch.setattr(torch, "matmul", counted_mm)
    model = _model(cfg, "meta")
    images = torch.empty(batch, 224, 224, 3, device="meta")
    model.encode_image(images, updates=resnet.BNUpdates())
    return convs, mms


def test_operation_counts_are_the_ports_shapes(monkeypatch):
    convs, mms = _products(monkeypatch, RN50, 2)
    assert convs == [c.macs for c in flops_resnet.convs(RN50)]
    assert sum(convs) == flops_resnet.conv_forward_macs(RN50) \
        == 5_367_226_368
    assert sum(mms) == flops_resnet.pool_forward_macs(RN50) == 425_926_656
    first = convs[0]
    assert flops_resnet.train_flops_per_image(RN50) == \
        2 * (3 * (sum(convs) + sum(mms)) - first)


def test_bn_batch_stats_counts_train_mode_calls():
    model = _model(RN50, "meta")
    images = torch.empty(2, 224, 224, 3, device="meta")
    before = resnet.BN_BATCH_STATS
    model.encode_image(images, updates=resnet.BNUpdates())
    assert resnet.BN_BATCH_STATS - before == 55 == \
        flops_resnet.batch_norms(RN50)
    model.encode_image(images)
    assert resnet.BN_BATCH_STATS - before == 55


def _step(model, images):
    """A train-mode forward and backward -> features and gradients."""
    feats = model.encode_image(images, updates=resnet.BNUpdates())
    params = list(model.visual.parameters())
    return feats.detach(), torch.autograd.grad(feats.square().sum(), params)


def test_spans_appear_only_under_a_profiler(monkeypatch):
    """Under a profiler: a ``resnet.bn`` and a ``resnet.bn_backward`` span
    a train-mode BatchNorm, the backward ones apart in time, and one
    ``resnet.attnpool``; the numbers bit-equal to the run without one,
    which opens no range at all."""
    from torch.profiler import ProfilerActivity, profile

    model = _model(TINY)
    model.load_state_dict(weights_resnet.make_weights(TINY, 5, "cpu"))
    images = torch.randn(4, 64, 64, 3,
                         generator=torch.Generator().manual_seed(2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _step(model, images)
    events = [e for e in prof.events() if e.name.startswith("resnet.")]
    names = [e.name for e in events]
    assert names.count("resnet.bn") == TINY_BNS
    assert names.count("resnet.bn_backward") == TINY_BNS
    assert names.count("resnet.attnpool") == 1
    bwd = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.name == "resnet.bn_backward")
    assert all(a[1] <= b[0] for a, b in zip(bwd, bwd[1:]))

    def no_range(name):
        raise AssertionError(f"a range {name!r} opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    plain = _step(model, images)
    assert torch.equal(traced[0], plain[0])
    assert all(torch.equal(a, b) for a, b in zip(traced[1], plain[1]))
