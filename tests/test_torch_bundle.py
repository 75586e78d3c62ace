"""The bundles across the two packages: the port's hand-written flax-msgpack
codec (swat_tpu_torch.train.msgpack_tree) against flax's and the msgpack
package's bytes, each package's save_bundle / load_bundle reading the
other's files, the JAX param tree of a port state dict
(jax_params_from_state_dict) against swat_tpu's converter, the feature-cache
fingerprint, load_best_model's three formats and the port's train
checkpoints."""

import io
import json

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from torch_port_lib import (TORCH_THREADS, jax_params_from_state_dict,
                            random_state_dict)

from swat_tpu.data.features import params_fingerprint as jax_fingerprint
from swat_tpu.train import checkpoint as JC
from swat_tpu_torch.data.features import params_fingerprint, tree_leaves
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.models import loader as L
from swat_tpu_torch.train import checkpoint as C
from swat_tpu_torch.train import msgpack_tree as M
from swat_tpu_torch.train.state import create_train_state

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def weights():
    cfg = get_model_config("test_tiny")
    sd = random_state_dict(cfg, seed=0)
    params, logit_scale = jax_params_from_state_dict(sd, cfg)
    return cfg, sd, params, logit_scale


def packb(tree) -> bytes:
    buf = io.BytesIO()
    M.write(buf, tree)
    return buf.getvalue()


def _stage_arrays(params, rng, tau=True, wsft=True):
    """A stage bundle's arrays as swat_tpu's save_best_model builds them."""
    head = rng.standard_normal((3, 32)).astype(np.float32)
    return {"clip": params, "head": head,
            "logit_scale": np.asarray(np.float32(4.60517)),
            "best_tau_head": {"w": head * 2} if tau else {},
            "wsft_head": {"w": head / 2} if wsft else {},
            "wsft_backbone": params if wsft else {}}


def _assert_trees_equal(got, ref, path=()):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], path + (k,))
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, path
    np.testing.assert_array_equal(got, ref, err_msg=str(path))


@pytest.mark.parametrize("case", ["stage", "stage_without_artifacts",
                                  "scalars_and_types"])
def test_bundle_bytes_equal_swat_tpu(weights, tmp_path, case):
    """save_bundle of the same arrays and meta: the same .msgpack bytes and
    the same .json sidecar as swat_tpu.train.checkpoint.save_bundle."""
    _, _, params, _ = weights
    rng = np.random.default_rng(1)
    if case == "scalars_and_types":
        arrays = {"i8": np.arange(-5, 5, dtype=np.int8),
                  "u16": np.arange(70000, dtype=np.int64).reshape(2, -1),
                  "f64": rng.standard_normal((3, 1, 2)),
                  "flag": np.array([True, False]), "empty": np.zeros((0, 4)),
                  "scalar": np.float32(2.5), "zero_d": np.asarray(7),
                  "long_" + "k" * 40: {"nested": {"a": np.ones(1)}}}
    else:
        arrays = _stage_arrays(params, rng, *(
            (True, True) if case == "stage" else (False, False)))
    meta = {"best_val_acc": 100.00000762939453, "best_epoch": 2,
            "test_acc": 66.667, "best_tau": None}
    C.save_bundle(str(tmp_path / "port.msgpack"), arrays, meta)
    JC.save_bundle(str(tmp_path / "jax.msgpack"), arrays, meta)
    for suffix in ("", ".json"):
        assert ((tmp_path / f"port.msgpack{suffix}").read_bytes()
                == (tmp_path / f"jax.msgpack{suffix}").read_bytes()), suffix


def test_each_package_reads_the_others_bundle(weights, tmp_path):
    _, _, params, _ = weights
    arrays = _stage_arrays(params, np.random.default_rng(2))
    C.save_bundle(str(tmp_path / "port.msgpack"), arrays, {"a": 1})
    JC.save_bundle(str(tmp_path / "jax.msgpack"), arrays, {"a": 1})
    for got, meta in (JC.load_bundle(str(tmp_path / "port.msgpack")),
                      C.load_bundle(str(tmp_path / "jax.msgpack"))):
        _assert_trees_equal(got, arrays)
        assert meta == {"a": 1}


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 1.5, -0.0, 1e300, True, False, None, "", "x" * 31, "y" * 32,
    "z" * 256, "naïve", b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536,
    [], [1, "a", None], list(range(16)), list(range(70000)),
    {"b": 1, "a": {"d": [2], "c": b"x"}}, {str(i): i for i in range(16)},
])
def test_codec_values_match_the_msgpack_package(value):
    """Every plain msgpack type at the edges of its encodings: the same bytes
    as msgpack.packb (maps compared with their keys in sorted order, the
    order the codec writes), and read back as written."""
    def sort(v):
        if isinstance(v, dict):
            return {k: sort(v[k]) for k in sorted(v)}
        return [sort(x) for x in v] if isinstance(v, list) else v

    assert packb(value) == msgpack.packb(sort(value), use_bin_type=True)
    assert M.unpackb(packb(value)) == value
    assert M.unpackb(msgpack.packb(value, use_bin_type=True)) == value


def test_codec_reads_flax_chunked_arrays(monkeypatch):
    """Arrays over the chunk size (2**30 bytes; 64 here) are read from
    flax's __msgpack_chunked_array__ form, and refused by the writer."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(M, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((7, 5, 3)).astype(np.float32),
            "small": np.arange(4.0), "in_list": [np.zeros(8)]}
    _assert_trees_equal(M.unpackb(serialization.msgpack_serialize(tree)),
                        tree)
    with pytest.raises(ValueError, match="chunk size"):
        packb(tree)


def test_codec_reads_scalars_and_bfloat16():
    """ext 3 (a numpy scalar) comes back a scalar; a bfloat16 array, which
    numpy has no dtype for, comes back float32 holding it exactly."""
    import jax.numpy as jnp

    h = np.asarray(jnp.asarray([1.5, -2.25, 3e-3, 1e30], jnp.bfloat16))
    got = M.unpackb(serialization.msgpack_serialize(
        {"h": h, "s": np.float32(2.0)}))
    assert got["s"] == np.float32(2.0) and got["s"].dtype == np.float32
    np.testing.assert_array_equal(got["h"], h.astype(np.float32))
    assert got["h"].dtype == np.float32


def test_jax_params_from_state_dict_is_swat_tpus_converter(weights):
    """Bit-equal to swat_tpu.models.loader.torch_state_dict_to_params,
    dtypes and memory order included, and back to the same state dict."""
    _, sd, params, logit_scale = weights
    got, got_scale = L.jax_params_from_state_dict(sd)
    assert got_scale == logit_scale
    _assert_trees_equal(got, params)
    assert ([a.strides for a in tree_leaves(got)]
            == [a.strides for a in tree_leaves(params)])
    back = L.state_dict_from_jax_params(got, got_scale)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_params_fingerprint_is_swat_tpus(weights):
    import jax
    import jax.numpy as jnp

    _, sd, params, _ = weights
    ours = params_fingerprint(L.jax_params_from_state_dict(sd)[0])
    assert ours == jax_fingerprint(jax.tree_util.tree_map(jnp.asarray,
                                                          params))
    moved = dict(params, text=dict(params["text"]))
    moved["text"]["text_projection"] = params["text"]["text_projection"] + 1
    assert params_fingerprint(moved) != ours


@pytest.mark.parametrize("fmt", ["full", "visual_only", "tau_head_only"])
def test_load_best_model_formats_match_swat_tpu(weights, tmp_path, fmt):
    """load_best_model's three formats give the same tree, head and
    logit_scale in both packages for a file of either."""
    cfg, sd, params, _ = weights
    rng = np.random.default_rng(4)
    other, _ = jax_params_from_state_dict(
        random_state_dict(cfg, seed=5), cfg)
    head = rng.standard_normal((3, 32)).astype(np.float32)
    template_head = np.zeros((3, 32), np.float32)
    arrays = {"full": _stage_arrays(other, rng),
              "visual_only": {"model": {"visual": other["visual"]}},
              "tau_head_only": {"best_tau_head": {"w": head}}}[fmt]
    for writer in (C.save_bundle, JC.save_bundle):
        path = str(tmp_path / f"{writer.__module__}.msgpack")
        writer(path, arrays, {"best_epoch": 3})
        got = C.load_best_model(path, params, template_head)
        ref = JC.load_best_model(path, params, template_head)
        _assert_trees_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == pytest.approx(float(np.asarray(ref[2])), abs=0)
        assert got[3] == ref[3] == {"best_epoch": 3}
    if fmt == "visual_only":
        _assert_trees_equal(got[0]["text"], params["text"])
        _assert_trees_equal(got[0]["visual"], other["visual"])


def _state(cfg, sd, seed):
    model = CLIPModel(cfg)
    model.load_state_dict(sd)
    head = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (3, cfg.embed_dim)).astype(np.float32))
    return create_train_state(model, head, "cutmix", lr_classifier=1e-2,
                              lr_backbone=1e-4, total_iter=10)


def test_train_ckpt_restores_the_port_state(weights, tmp_path):
    """A train checkpoint after two AdamW steps restores model, head,
    logit_scale, step and the AdamW moments exactly, and the next step
    from it equals the next step of the original."""
    cfg, sd, _, _ = weights
    images = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))

    def step(state):
        feats = state.model.encode_image(images, normalize=True)
        loss = (feats @ state.head.t()).square().mean() * state.logit_scale
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_update()

    a = _state(cfg, sd, 0)
    step(a)
    step(a)
    path = C.save_train_ckpt(str(tmp_path), "ep2_it2", a,
                             {"best_epoch": 2, "best_scores": {"x": 1}})
    assert path.endswith("ckpt_ep2_it2.msgpack")
    b = _state(cfg, random_state_dict(cfg, seed=9), 1)
    _, meta = C.load_train_ckpt(path, b)
    assert meta == {"best_epoch": 2} and b.step == a.step == 2
    for sa, sb in ((a, b),):
        for (n, pa), pb in zip(sa.model.named_parameters(),
                               sb.model.parameters()):
            assert torch.equal(pa, pb), n
        assert torch.equal(sa.head, sb.head)
        assert torch.equal(sa.logit_scale, sb.logit_scale)
    for ga, gb in zip(a.optimizer.param_groups, b.optimizer.param_groups):
        for pa, pb in zip(ga["params"], gb["params"]):
            for k, v in a.optimizer.state[pa].items():
                assert torch.equal(v, b.optimizer.state[pb][k]), k
    step(a)
    step(b)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    assert torch.equal(a.head, b.head)


def test_train_ckpt_of_swat_tpu_is_refused(weights, tmp_path):
    """optax's state does not map onto torch's AdamW: a checkpoint of the
    JAX package raises instead of resuming half a state."""
    import jax.numpy as jnp

    from swat_tpu.train.state import create_train_state as jax_state

    cfg, sd, params, _ = weights
    state, _ = jax_state(params, np.zeros((3, 32), np.float32), "cutmix",
                         total_iter=10)
    path = JC.save_train_ckpt(str(tmp_path), "ep1_it3", state,
                              {"best_epoch": 1})
    assert int(jnp.asarray(state.step)) == 0
    with pytest.raises(ValueError, match="Queue C"):
        C.load_train_ckpt(path, _state(cfg, sd, 0))
    with open(path + ".json") as f:
        assert json.load(f) == {"best_epoch": 1}
