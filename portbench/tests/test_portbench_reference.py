"""The plain reference against the port on a tiny ViT on the CPU: the
tower, the frozen draws, the train transform, and a whole train run under
the fp32 policy, which comes out correct."""

import time

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from portbench import harness, pools, weights
from portbench.reference import train as ref_train
from portbench.reference.vit import image_features


def test_tower_matches_the_port(cpu):
    from swat_tpu_torch.core.precision import FP32_PRECISION
    from swat_tpu_torch.models.clip import CLIPModel

    cell = tiny_cell("tiny_train", "vitb32-cutmix-fp32-b256")
    w = weights.make_weights(cell.config, 5, cpu)
    model = CLIPModel(harness.clip_config(cell.config),
                      precision=FP32_PRECISION)
    model.load_state_dict(w)
    images = torch.randn(3, 64, 64, 3, generator=torch.Generator()
                         .manual_seed(0))
    with torch.no_grad():
        theirs = model.encode_image(images)
        ours = image_features(images, w, cell.config)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_frozen_draws_are_the_samplers():
    from swat_tpu_torch.train.steps import make_sampler

    valid_hw = np.array([[256, 170], [160, 256], [256, 256], [200, 256]])
    sample = make_sampler("cutmix", mix_prob=0.5, cutmix_beta=1.0,
                          image_size=224)
    theirs, ours = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(5):
        d = sample(theirs, {"canvases": None, "valid_hw": valid_hw,
                            "labels": np.zeros(4)})
        boxes = ref_train.draw_crops(ours, valid_hw)
        flips = ours.random(4) < 0.5
        mix = ref_train.draw_cutmix(ours, 4, 224, 1.0, 0.5)
        np.testing.assert_array_equal(boxes, d.crops.boxes)
        np.testing.assert_array_equal(flips, d.crops.flips)
        assert (mix.gate, tuple(mix.perm), mix.box) == (
            d.mix.gate, tuple(d.mix.perm), d.mix.box)


def test_transform_matches_the_ports_augment(cpu):
    from swat_tpu_torch.kernels import augment

    valid_hw = np.array([[80, 60], [52, 80], [80, 80]], np.int32)
    labels = np.array([0, 1, 1])
    canvases = pools.train_canvases(valid_hw, labels, 80, 3, cpu)
    rng = np.random.default_rng(4)
    boxes = ref_train.draw_crops(rng, valid_hw)
    flips = np.array([True, False, True])
    theirs = augment.train_augment(canvases, augment.CropDraws(boxes, flips),
                                   64)
    ours = ref_train.transform(canvases, boxes, flips, 64)
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("traffic,limits_of", [
    ("tiny_train", "vitb32-cutmix-fp32-b256")])
def test_run_comes_out_correct(traffic, limits_of, run_on_cpu):
    cell = tiny_cell(traffic, limits_of)
    out = harness.entry(cell.traffic["entry"]).run(
        cell, 2 ** 31 + 11, 0.2, False, run_on_cpu, time.time())
    assert out.attempted >= 1 and out.failed == 0
    assert out.correct, out.checks
