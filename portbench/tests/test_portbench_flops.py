"""The operation counts and the attention bound against hand counts and
against ``chip_smoke._bound_ms``."""

import os

import pytest

from portbench import flops, harness


def _config(name):
    return harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                          name + ".json"))


def test_vitb32_forward_multiply_adds():
    # 49 patches of 3*32*32 onto 768; 12 blocks of 50 tokens: qkv
    # 50*768*2304, scores and values 2*50*50*768, out 50*768*768, MLP
    # 2*50*768*3072; the class token's projection 768*512
    hand = (49 * 3072 * 768
            + 12 * (50 * 768 * 2304 + 2 * 50 * 50 * 768 + 50 * 768 * 768
                    + 2 * 50 * 768 * 3072)
            + 768 * 512)
    assert hand == 4_408_811_520
    assert flops.image_forward_macs(_config("vitb32_openclip_laion400m")) \
        == hand
    assert flops.train_flops_per_image(_config(
        "vitb32_openclip_laion400m")) == 6 * hand


def test_vitl14_forward_multiply_adds():
    hand = (256 * 588 * 1024
            + 24 * (257 * 1024 * 3072 + 2 * 257 * 257 * 1024
                    + 257 * 1024 * 1024 + 2 * 257 * 1024 * 4096)
            + 1024 * 768)
    assert hand == 81_012_768_768
    assert flops.image_forward_macs(_config("vitl14_openclip_laion400m")) \
        == hand


@pytest.mark.parametrize("shape", [(256, 50, 12, 64), (64, 257, 16, 64)])
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bound_is_chip_smokes(shape, kind, dtype):
    import chip_smoke

    b, s, h, d = shape
    ms, by = chip_smoke._bound_ms(kind, b, s, h, d, dtype, False)
    seconds, mine = flops.attention_bound_s(kind, b, s, h, d, dtype)
    assert seconds * 1e3 == pytest.approx(ms, rel=1e-12)
    assert mine == by
