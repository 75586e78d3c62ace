"""The port's losses, head and evaluation arithmetic (swat_tpu_torch.train.
losses, models.head, eval.validate) against the JAX package's on the same
numpy inputs: the eval loss of every LossFn, validate_features, and the
streaming Evaluator over padded, masked feature batches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import TORCH_THREADS

from swat_tpu.data.pipeline import FeatureBatches
from swat_tpu.eval.validate import Evaluator as JaxEvaluator
from swat_tpu.eval.validate import validate_features as jax_validate_features
from swat_tpu.models.clip import CLIPModel as FlaxCLIP
from swat_tpu.models.configs import get_model_config
from swat_tpu.train.losses import set_loss as jax_set_loss
from swat_tpu_torch.eval.validate import Evaluator, validate_features
from swat_tpu_torch.models.head import (head_logits, init_head_from_prompts,
                                        init_head_random)
from swat_tpu_torch.train.losses import set_loss

torch.set_num_threads(TORCH_THREADS)

NUM_CLASSES = 7
LOSSES = {
    "CE": {},
    "WeightedCE": {"fewshot_weight": 2.5},
    "Focal": {"focal_alpha": 0.5, "focal_gamma": 1.5},
    "BalancedSoftmax": {"cls_num_list": [5, 1, 9, 3, 3, 12, 2]},
}


def _data(n=45, d=16, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    head = rng.standard_normal((NUM_CLASSES, d)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
    source = rng.integers(0, 2, n).astype(np.int32)
    return feats, head, labels, source


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    feats, head, labels, source = _data()
    logits = (feats @ head.T * 100.0).astype(np.float32)
    ref = jax_set_loss(name, **LOSSES[name])(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(source))
    loss = set_loss(name, **LOSSES[name])
    args = (torch.from_numpy(logits), torch.from_numpy(labels),
            torch.from_numpy(source))
    assert float(loss(*args)) == pytest.approx(float(ref), rel=1e-5)
    assert loss.per_sample(*args).shape == (len(labels),)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_validate_features_matches_jax(name):
    feats, head, labels, source = _data(seed=1)
    log100 = float(np.log(100.0))
    ref = jax_validate_features(jnp.asarray(head), log100, feats, labels,
                                NUM_CLASSES, jax_set_loss(name, **LOSSES[name]),
                                source=source)
    got = validate_features(torch.from_numpy(head), log100, feats, labels,
                            NUM_CLASSES, set_loss(name, **LOSSES[name]),
                            source=source)
    assert got[0] == pytest.approx(ref[0], abs=1e-4)
    assert got[1] == pytest.approx(ref[1], rel=1e-5)
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("name", ["CE", "WeightedCE"])
def test_streaming_evaluator_matches_jax_on_padded_batches(name):
    """45 samples in batches of 16: the last batch is padded and masked;
    the loss is the mean of per-batch means on both sides."""
    feats, head, labels, source = _data(seed=2)
    log100 = float(np.log(100.0))

    def batches():
        return FeatureBatches(feats, labels, batch_size=16, source=source)

    jax_model = FlaxCLIP(get_model_config("test_tiny"))
    ref = JaxEvaluator(jax_model, NUM_CLASSES,
                       loss=jax_set_loss(name, **LOSSES[name])).validate(
        None, jnp.asarray(head), log100, batches(), return_confusion=True)
    got = Evaluator(NUM_CLASSES, loss=set_loss(name, **LOSSES[name])).validate(
        None, torch.from_numpy(head), log100, batches(),
        return_confusion=True)
    assert got[0] == pytest.approx(ref[0], abs=1e-9)
    assert got[1] == pytest.approx(ref[1], rel=1e-5)
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[2].sum() == len(labels)


def test_head_init_and_logits():
    emb = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    head = init_head_from_prompts(emb, torch.device("cpu"))
    assert head.dtype == torch.float32
    np.testing.assert_array_equal(head.numpy(), emb)
    a = init_head_random(4, 5, 64, torch.device("cpu"))
    b = init_head_random(4, 5, 64, torch.device("cpu"))
    assert torch.equal(a, b) and a.shape == (5, 64)
    assert float(a.abs().max()) <= 1 / 8            # U(-1/sqrt(64), +)
    feats = torch.randn(3, 8, dtype=torch.bfloat16)
    logits = head_logits(head, feats)
    assert logits.dtype == torch.float32
    torch.testing.assert_close(logits, feats.float() @ head.T)
