"""The port's RN50 image tower (swat_tpu_torch.models.resnet, on the CPU)
against swat_tpu's Flax ModifiedResNet, on a tiny tower and on one at
RN50's own widths (224 px, width 64, 32 attnpool heads, embed 1024) with
one bottleneck a stage (torch_port_lib.RN50_TEST_TOWERS), in both
precision policies: the eval-mode and train-mode features, the train
mode's new BN running statistics (swat_tpu's sown updates, folded), the
attention pool's tokens (``tokens_out``), the loader both ways, the
bundles' bytes and the fingerprint.  The bf16 references run in a
subprocess with ``--xla_allow_excess_precision=false`` (XLA on the CPU
otherwise keeps some bf16 roundings in fp32).  AffineBN is also held
against torch's own ``F.batch_norm``, an independent oracle of the BN
semantics."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_lib import (RN50_TEST_TOWERS, TORCH_THREADS, cosine,
                            excess_precision_subprocess,
                            jax_params_from_state_dict, jax_rn50_outputs,
                            port_bn_updates, random_state_dict, rn50_configs)

from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.data.features import params_fingerprint as jax_fingerprint
from swat_tpu.train import checkpoint as JC
from swat_tpu_torch.core import precision as TP
from swat_tpu_torch.data.features import params_fingerprint
from swat_tpu_torch.kernels import flash_attention as FA
from swat_tpu_torch.models import loader as L
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.resnet import AffineBN, fold_bn_updates
from swat_tpu_torch.train import checkpoint as C

torch.set_num_threads(TORCH_THREADS)

N_IMAGES = 3
POLICIES = {"fp32": TP.FP32_PRECISION, "bf16": TP.DEFAULT_PRECISION}
# features: the towers' bounds (tests/test_torch_towers.py); bf16 convs
# round at other points in XLA's and torch's CPU convolutions (measured gap
# ~1e-12 fp32, <= 4e-4 bf16, the tokens included)
MIN_COS = {"fp32": 1 - 1e-5, "bf16": 1 - 1e-3}
# the new running statistics, relative to each tensor's largest value:
# fp32 sums of up to 100k activations in other orders (measured 3e-7);
# bf16 activations a bf16 ulp (2^-8) apart here and there (measured 2.4e-3)
BN_REL = {"fp32": 1e-5, "bf16": 1e-2}


@pytest.fixture(scope="module")
def towers():
    """Per tower: its configs, a seeded state dict, swat_tpu's params, the
    images and swat_tpu's outputs in fp32 (here) and bf16 (in the
    excess-precision subprocess)."""
    import os
    import tempfile

    out = {}
    arrays = {}
    for i, name in enumerate(sorted(RN50_TEST_TOWERS)):
        cfg, jax_cfg = rn50_configs(name)
        sd = random_state_dict(cfg, seed=i)
        params, _ = jax_params_from_state_dict(sd, cfg)
        n_px = cfg.vision.image_size
        images = np.random.default_rng(i).standard_normal(
            (N_IMAGES, n_px, n_px, 3)).astype(np.float32)
        out[name] = dict(cfg=cfg, jax_cfg=jax_cfg, sd=sd, params=params,
                         images=images, fp32=jax_rn50_outputs(
                             jax_cfg, params, images, JAX_FP32))
        arrays[f"{name}/images"] = images
        for k, v in sd.items():
            arrays[f"{name}/sd/{k}"] = v.numpy()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, **arrays)
        result = os.path.join(tmp, "bf16.npz")
        bf16 = excess_precision_subprocess(
            f"rn50_bf16_reference({inputs!r}, {result!r})", result)
    for name, tower in out.items():
        tower["bf16"] = {k[len(name) + 1:]: v for k, v in bf16.items()
                         if k.startswith(name + "/")}
    return out


def _model(tower, policy):
    model = CLIPModel(tower["cfg"], precision=POLICIES[policy])
    model.load_state_dict(tower["sd"])
    return model


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", sorted(RN50_TEST_TOWERS))
def test_eval_features_match_swat_tpu(towers, name, policy):
    tower = towers[name]
    model = _model(tower, policy)
    before = FA.LAUNCHES
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(tower["images"]),
                                 normalize=True)
    assert FA.LAUNCHES == before
    assert got.dtype == torch.float32
    assert got.shape == (N_IMAGES, tower["cfg"].embed_dim)
    assert cosine(got.numpy(), tower[policy]["eval"]).min() >= \
        MIN_COS[policy]


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", sorted(RN50_TEST_TOWERS))
def test_train_features_and_bn_updates_match_swat_tpu(towers, name, policy):
    """Batch-statistics BN: the features, and every AffineBN's new running
    mean and variance (momentum 0.1, unbiased variance) as swat_tpu sows
    and folds them; the module's own buffers stay as they were."""
    tower = towers[name]
    ref = tower[policy]
    model = _model(tower, policy)
    with torch.no_grad():
        updates = {}
        got = model.encode_image(torch.from_numpy(tower["images"]),
                                 normalize=True, updates=updates)
    assert cosine(got.numpy(), ref["train"]).min() >= MIN_COS[policy]
    # batch statistics differ from the running ones
    assert cosine(got.numpy(), ref["eval"]).min() < MIN_COS[policy]
    new = port_bn_updates(model, updates)
    assert sorted(new) == sorted(k[3:] for k in ref if k.startswith("bn/"))
    for k, v in new.items():
        assert _rel(v, ref["bn/" + k]) <= BN_REL[policy], k
        assert not np.array_equal(v, tower["sd"][k].numpy()), k
    for k, v in model.state_dict().items():
        assert torch.equal(v, tower["sd"][k]), k


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", sorted(RN50_TEST_TOWERS))
def test_attnpool_tokens_match_swat_tpu(towers, name, policy):
    """``encode_image_tokens``: c_proj(v_proj(token)) of the mean token and
    every grid position, eval-mode BN."""
    tower = towers[name]
    model = _model(tower, policy)
    with torch.no_grad():
        got = model.encode_image_tokens(torch.from_numpy(tower["images"]))
    cfg = tower["cfg"].vision
    assert got.shape == (N_IMAGES, cfg.seq_len, cfg.embed_dim)
    assert got.dtype == torch.float32
    cos = cosine(got.numpy().reshape(-1, cfg.embed_dim),
                 tower[policy]["tokens"].reshape(-1, cfg.embed_dim))
    assert cos.min() >= MIN_COS[policy]


@pytest.mark.parametrize("name", sorted(RN50_TEST_TOWERS))
def test_loader_both_ways_is_swat_tpus(towers, name):
    """jax_params_from_state_dict bit for bit swat_tpu's
    torch_state_dict_to_params (a ModifiedResNet tree: conv kernels
    [kh, kw, in, out], layer{s}_{i}, down_conv / down_bn, BN scale / bias /
    mean / var), and back to the same state dict; swat_tpu's
    params_to_torch_state_dict of the tree gives the same tensors too."""
    from swat_tpu.models.loader import params_to_torch_state_dict

    tower = towers[name]
    sd = tower["sd"]
    got, _ = L.jax_params_from_state_dict(sd)
    _assert_trees_equal(got, tower["params"])
    assert sorted(got["visual"]["layer2_0"]) == [
        "bn1", "bn2", "bn3", "conv1", "conv2", "conv3", "down_bn",
        "down_conv"]
    back = L.state_dict_from_jax_params(got, 2.5)
    jax_back = params_to_torch_state_dict(tower["params"], 2.5)
    assert sorted(back) == sorted(sd) == sorted(jax_back)
    for k in sd:
        if k != "logit_scale":
            assert torch.equal(back[k], sd[k]), k
        np.testing.assert_array_equal(back[k].numpy(),
                                      np.asarray(jax_back[k], np.float32))


def _assert_trees_equal(got, ref, path=()):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], path + (k,))
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, path
    np.testing.assert_array_equal(got, ref, err_msg=str(path))


@pytest.mark.parametrize("name", sorted(RN50_TEST_TOWERS))
def test_rn50_bundles_are_byte_equal_and_read_across(towers, name, tmp_path):
    """A stage bundle of an RN50 tree (BN statistics as trained, not
    the init's): the same bytes from both packages' save_bundle, each reads
    the other's, and the feature-cache fingerprint of the tree is
    swat_tpu's."""
    import jax
    import jax.numpy as jnp

    tower = towers[name]
    params = tower["params"]
    folded = {"visual": dict(params["visual"]), "text": params["text"]}
    for k in ("bn1", "bn2"):
        folded["visual"][k] = dict(params["visual"][k],
                                   mean=params["visual"][k]["mean"] + 0.5)
    head = np.random.default_rng(3).standard_normal(
        (3, tower["cfg"].embed_dim)).astype(np.float32)
    arrays = {"clip": folded, "head": head,
              "logit_scale": np.asarray(np.float32(4.60517)),
              "best_tau_head": {"w": head}, "wsft_head": {},
              "wsft_backbone": params}
    C.save_bundle(str(tmp_path / "port.msgpack"), arrays, {"a": 1})
    JC.save_bundle(str(tmp_path / "jax.msgpack"), arrays, {"a": 1})
    assert ((tmp_path / "port.msgpack").read_bytes()
            == (tmp_path / "jax.msgpack").read_bytes())
    for got, _ in (JC.load_bundle(str(tmp_path / "port.msgpack")),
                   C.load_bundle(str(tmp_path / "jax.msgpack"))):
        _assert_trees_equal(got, arrays)
    assert params_fingerprint(folded) == jax_fingerprint(
        jax.tree_util.tree_map(jnp.asarray, folded))
    assert params_fingerprint(folded) != params_fingerprint(params)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_affine_bn_against_torch_batch_norm(policy):
    """AffineBN against ``F.batch_norm`` (torch's own BatchNorm, momentum
    0.1, eps 1e-5): the running-statistics update of training mode and the
    normalized output of both modes.  F.batch_norm rounds at other points
    in bf16, so the outputs agree to a bf16 ulp there."""
    rng = np.random.default_rng(5)
    c = 24
    x = torch.from_numpy(rng.standard_normal((4, 9, 7, c)).astype(
        np.float32) * 3 + 1).permute(0, 3, 1, 2)
    bn = AffineBN(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(c)))
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(c)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
    prec = POLICIES[policy]
    cd = prec.compute_dtype
    tol = 1e-5 if policy == "fp32" else 3e-2
    for train in (False, True):
        rm, rv = bn.running_mean.clone(), bn.running_var.clone()
        updates = {} if train else None
        with torch.no_grad():
            got = bn(x.to(cd), prec, updates)
        assert got.dtype == cd
        assert got.is_contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            ref = F.batch_norm(x.to(cd).float(), rm, rv, bn.weight,
                               bn.bias, training=train, momentum=0.1,
                               eps=1e-5)
        np.testing.assert_allclose(got.float().detach().numpy(),
                                   ref.detach().numpy(), rtol=0,
                                   atol=tol * float(ref.abs().max()))
        if train:
            fold_bn_updates(updates)
            np.testing.assert_allclose(bn.running_mean.numpy(), rm.numpy(),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(bn.running_var.numpy(), rv.numpy(),
                                       rtol=1e-6)
