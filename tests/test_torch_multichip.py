"""The port's sharded steps on a gloo CPU cluster of 4 ranks against
swat_tpu's one-device steps (the counterpart of tests/test_multichip.py,
whose GSPMD meshes the port's process groups replace).

One cluster runs every case once (``cluster``; tests/torch_dist_worker.py
imports no JAX): data parallelism over 4 ranks (cutmix for 2 steps,
finetune with ``--accum 2``, FLYP, FixMatch from canvases with its mask
partly engaged, a resident cutmix epoch and a resident cutmix-fs epoch
with both splits sharded, validate, one RN50 cutmix step with the global
batch's BatchNorm statistics), tensor parallelism over 2 ranks (the
forward at dp 2 x tp 2, also through ``use_mega``, cutmix at dp 2 x tp 2
and dp 1 x tp 2, FLYP at dp 2 x tp 2).  Every rank feeds its own rows.  Each case is held against
swat_tpu's step on the same weights, canvases and draws (the JAX steps'
own, torch_port_lib.jax_step_draws and kin), and against the port's
one-device run of the same case (torch_dist_worker.run_case):

* losses: rtol 1e-4 / atol 1e-5 against swat_tpu (the crop resample
  differs by ~1e-2 of 255 between the frameworks), rel 1e-5 against the
  port's one device (the sharded encode sums its products in another
  order);
* trained tensors by the gradient-conditioned delta rule
  (torch_port_lib.delta_check) against both, on the one-device port's
  first gradients; frozen tensors bit-unchanged;
* RN50's running statistics rel 1e-5, its attention pool's K bias (whose
  gradient is rounding noise) within Adam's walk; validate's confusion
  matrix exact,
  its accuracy to 1e-9 and loss rel 1e-6;
* every rank of a data group ends with bit-equal weights.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_lib import (TORCH_THREADS, delta_check, jax_crop_draws,
                            jax_fixmatch_draws, jax_params_from_state_dict,
                            jax_step_draws, random_state_dict, rn50_configs)

import torch_dist_worker as W
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train import steps as JS
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.optim import default_warmup_lr, make_lr_schedule

torch.set_num_threads(TORCH_THREADS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
WORLD = 4
MODEL = "test_tiny"
BSZ, CANVAS, N_PX = 8, 40, 32
LR_HEAD, LR_BB, TOTAL_ITER = 1e-2, 1e-4, 10
THRESHOLD = 0.435   # the mask engages 3 of 8 unlabeled rows here


def _canvases(rng, n, size=CANVAS):
    hw = rng.integers(size * 3 // 5, size + 1, (n, 2)).astype(np.int32)
    hw[rng.random(n) < 0.5, 0] = size
    canvases = np.zeros((n, size, size, 3), np.uint8)
    for i, (h, w) in enumerate(hw):
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    return canvases, hw


def _batch(rng, n, classes=3, size=CANVAS):
    canvases, hw = _canvases(rng, n, size)
    return {"canvases": canvases, "valid_hw": hw,
            "labels": rng.integers(0, classes, n).astype(np.int32),
            "source": rng.integers(0, 2, n).astype(np.int32)}


def _head(rng, dim):
    head = rng.standard_normal((3, dim)).astype(np.float32)
    return head / np.linalg.norm(head, axis=-1, keepdims=True)


def _jax_steps(method, jcfg, params, head, batches, keys, image_size=N_PX,
               accum=1):
    """swat_tpu's one-device steps -> (losses, aux, torch-named model
    arrays, head, logit_scale)."""
    import jax.numpy as jnp

    model = JaxCLIPModel(jcfg, precision=JAX_FP32)
    state, tx = jax_create_state(params, head, method,
                                 lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                                 total_iter=TOTAL_ITER)
    if method in ("finetune", "finetune-mixed"):
        step = JS.make_ce_step(model, tx, image_size=image_size, accum=accum,
                               concat_fs=method == "finetune-mixed")
    elif method == "FLYP":
        step = JS.make_flyp_step(model, tx, image_size=image_size)
    elif method == "fixmatch":
        step = JS.make_fixmatch_step(model, tx, threshold=THRESHOLD,
                                     image_size=image_size, aux=True)
    else:
        step = JS.make_mixing_step(model, tx, method, mix_prob=1.0,
                                   image_size=image_size)
    losses, aux = [], []
    for batch, key in zip(batches, keys):
        state, out = step(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()}, key)
        if isinstance(out, tuple):
            aux.append([float(v) for v in out[1:]])
            out = out[0]
        losses.append(float(out))
    model_np = {k: np.asarray(v) for k, v in params_to_torch_state_dict(
        state.model, 0.0).items()}
    return {"losses": losses, "aux": aux, "model": model_np,
            "head": np.asarray(state.head),
            "logit_scale": float(state.logit_scale)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cluster(cases, world, tmp):
    """The cases on a gloo cluster of ``world`` worker processes -> each
    rank's outputs."""
    path = os.path.join(tmp, "cases.pt")
    torch.save(cases, path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, path, tmp, address, str(world), str(r)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """(cases by name, every rank's outputs, swat_tpu's references by
    name, the port's one-device outputs by name)."""
    import jax

    cfg = get_model_config(MODEL)
    jcfg = jax_model_config(MODEL)
    sd = random_state_dict(cfg, seed=0)
    params, _ = jax_params_from_state_dict(sd, cfg)
    rng = np.random.default_rng(0)
    head = _head(rng, cfg.embed_dim)
    keys = list(jax.random.split(jax.random.PRNGKey(42), 4))
    base = dict(cfg=cfg, sd=sd, head=head, image_size=N_PX,
                lr_head=LR_HEAD, lr_backbone=LR_BB, total_iter=TOTAL_ITER)
    cases, refs = {}, {}

    # cutmix: 2 steps (dp 4, and the tp meshes); the resident epoch trains
    # the same two batches from a split of both
    mix = [_batch(rng, BSZ) for _ in range(2)]
    mix_draws = [jax_step_draws(k, b["valid_hw"], N_PX, 1.0, 1.0,
                                method="cutmix") for k, b in zip(keys, mix)]
    cut = dict(base, run="step", method="cutmix", batches=mix,
               draws=mix_draws)
    refs["cutmix"] = _jax_steps("cutmix", jcfg, params, head, mix, keys[:2])
    cases["dp_cutmix"] = dict(cut, mesh=(4, 1))
    cases["tp_cutmix_dp2xtp2"] = dict(cut, mesh=(2, 2))
    cases["tp_cutmix_tp2"] = dict(cut, mesh=(1, 2))
    split = tuple(np.concatenate([b[k] for b in mix]) for k in
                  ("canvases", "valid_hw", "labels", "source"))
    cases["dp_resident"] = dict(base, run="resident", method="cutmix",
                                mesh=(4, 1), data=split, draws=mix_draws,
                                perm=np.arange(2 * BSZ).reshape(2, BSZ))

    # finetune, --accum 2 sharded against swat_tpu's single pass
    ft = [mix[0]]
    cases["dp_accum"] = dict(base, run="step", method="finetune", accum=2,
                             mesh=(4, 1), batches=ft, draws=[jax_step_draws(
                                 keys[0], ft[0]["valid_hw"], N_PX,
                                 method="finetune")])
    refs["dp_accum"] = _jax_steps("finetune", jcfg, params, head, ft,
                                  keys[:1])

    # the twin resident epoch: cutmix-fs over a sharded split and a
    # sharded few-shot twin (8 + 4 rows joined a step)
    twin = _batch(rng, 8)
    tperm = np.asarray([[0, 3, 5, 6], [2, 7, 1, 4]])
    fs_batches = [dict(b, **{f"{k}_fs": twin[k][tp] for k in twin})
                  for b, tp in zip(mix, tperm)]
    fs_draws = [jax_step_draws(k, b["valid_hw"], N_PX, 1.0, 1.0,
                               method="cutmix-fs",
                               twin_valid_hw=b["valid_hw_fs"])
                for k, b in zip(keys, fs_batches)]
    refs["dp_twin_resident"] = _jax_steps("cutmix-fs", jcfg, params, head,
                                          fs_batches, keys[:2])
    cases["dp_twin_resident"] = dict(
        base, run="resident", method="cutmix-fs", mesh=(4, 1), data=split,
        draws=fs_draws, perm=np.arange(2 * BSZ).reshape(2, BSZ),
        twin=tuple(twin[k] for k in ("canvases", "valid_hw", "labels",
                                     "source")), twin_perm=tperm)

    # FLYP: both towers, the [B, B] logits over the gathered features
    fb = dict(mix[1], prompt_tokens=rng.integers(
        1, 511, (BSZ, 16)).astype(np.int32))
    fb["prompt_tokens"][:, -1] = 511
    flyp = dict(base, run="step", method="FLYP", batches=[fb],
                draws=[jax_crop_draws(keys[2], fb["valid_hw"])])
    refs["flyp"] = _jax_steps("FLYP", jcfg, params, head, [fb], keys[2:3])
    cases["dp_flyp"] = dict(flyp, mesh=(4, 1))
    cases["tp_flyp"] = dict(flyp, mesh=(2, 2))

    # FixMatch from canvases: 4 labeled + 2 x 8 unlabeled rows, one BN
    # batch; the mask rate is a mean over the global unlabeled batch
    lab = _batch(rng, 4)
    ub = _batch(rng, 8)
    fx = dict(lab, canvases_u=ub["canvases"], valid_hw_u=ub["valid_hw"])
    cases["dp_fixmatch"] = dict(
        base, run="step", method="fixmatch", threshold=THRESHOLD,
        mesh=(4, 1), batches=[fx], draws=[jax_fixmatch_draws(
            keys[3], lab["valid_hw"], ub["valid_hw"])])
    refs["dp_fixmatch"] = _jax_steps("fixmatch", jcfg, params, head, [fx],
                                     keys[3:4])

    # tp forward; validate over 3 batches, the last ragged
    images = rng.normal(size=(8, N_PX, N_PX, 3)).astype(np.float32)
    cases["tp_forward"] = dict(base, run="forward", mesh=(2, 2),
                               images=images)
    # use_mega under tp: each block's whole weights gathered, the fused
    # block on every rank (as GSPMD replicates swat_tpu's Pallas block)
    cases["tp_forward_mega"] = dict(cases["tp_forward"], use_mega=True)
    vb = []
    for b in range(3):
        mask = np.ones(16, bool)
        if b == 2:
            mask[10:] = False
        vb.append({"images": rng.normal(size=(16, N_PX, N_PX, 3)
                                        ).astype(np.float32),
                   "labels": rng.integers(0, 3, 16).astype(np.int32),
                   "source": rng.integers(0, 2, 16).astype(np.int32),
                   "mask": mask})
    cases["dp_validate"] = dict(base, run="validate", mesh=(4, 1),
                                num_classes=3, batches=vb)
    # the resident eval engine: 3 batches of 16, the last ragged, each
    # rank holding its rows of every batch
    u8 = rng.integers(0, 256, (42, N_PX, N_PX, 3)).astype(np.uint8)
    cases["dp_resident_validate"] = dict(
        base, run="resident_validate", mesh=(4, 1), num_classes=3,
        batch_size=16, images=u8,
        labels=rng.integers(0, 3, 42).astype(np.int64),
        source=rng.integers(0, 2, 42).astype(np.int64))

    # RN50 (tiny): the global batch's BN statistics and their fold
    rcfg, rjcfg = rn50_configs("rn50_tiny")
    rsd = random_state_dict(rcfg, seed=0)
    rparams, _ = jax_params_from_state_dict(rsd, rcfg)
    rhead = _head(rng, rcfg.embed_dim)
    rb = _batch(rng, BSZ, size=80)
    cases["dp_rn50"] = dict(
        base, cfg=rcfg, sd=rsd, head=rhead, image_size=64, run="step",
        method="cutmix", mesh=(4, 1), batches=[rb], draws=[jax_step_draws(
            keys[0], rb["valid_hw"], 64, 1.0, 1.0, method="cutmix")])
    refs["dp_rn50"] = _jax_steps("cutmix", rjcfg, rparams, rhead, [rb],
                                 keys[:1], image_size=64)

    for name in ("dp_cutmix", "tp_cutmix_dp2xtp2", "tp_cutmix_tp2",
                 "dp_resident"):
        refs[name] = refs["cutmix"]
    for name in ("dp_flyp", "tp_flyp"):
        refs[name] = refs["flyp"]
    named = [dict(c, name=n) for n, c in cases.items()]
    outs = run_cluster(named, WORLD, str(tmp_path_factory.mktemp("gloo")))
    one = {n: W.run_case(c, None) for n, c in cases.items()}
    return cases, outs, refs, one


def _lr_sum(base, steps):
    schedule = make_lr_schedule(base, TOTAL_ITER,
                                warmup_lr=default_warmup_lr(LR_BB))
    return sum(schedule(i) for i in range(steps))


def _check_trained(case, got, ref, one):
    """Losses and every tensor of a trained case against swat_tpu's (ref)
    and the port's one-device run (one)."""
    steps = len(got["losses"])
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5,
                               atol=1e-6)
    assert got["logit_scale"] == pytest.approx(ref["logit_scale"], abs=1e-5)
    lr_bb, lr_head = _lr_sum(LR_BB, steps), _lr_sum(LR_HEAD, steps)
    for other in (ref, one):
        if "head" in one["g0"]:
            delta_check("head", case["head"], other["head"], got["head"],
                        one["g0"]["head"], lr_head, 0.0)
        else:       # FLYP's head is rebuilt after the epoch, not trained
            np.testing.assert_array_equal(got["head"], case["head"])
    moved = 0
    for k, init in case["sd"].items():
        init = init.numpy()
        if k == "logit_scale":
            continue
        g0 = one["g0"].get(f"model.{k}")
        if g0 is None:
            if "running_" in k:     # RN50's BN statistics, folded
                for other in (ref, one):
                    np.testing.assert_allclose(got["model"][k],
                                               other["model"][k], rtol=1e-5,
                                               atol=1e-7, err_msg=k)
                continue
            # frozen (the text tower of the image-only methods)
            np.testing.assert_array_equal(got["model"][k], init, err_msg=k)
            np.testing.assert_array_equal(ref["model"][k], init, err_msg=k)
            continue
        if k == "visual.attnpool.k_proj.bias":
            # rounding noise (softmax is shift invariant): at most Adam's
            # walk, as tests/test_torch_rn50_train.py bounds it
            assert np.abs(got["model"][k] - init).max() <= 2.05 * lr_bb
            continue
        for other in (ref, one):
            d = delta_check(k, init, other["model"][k], got["model"][k], g0,
                            lr_bb, steps * LR_BB * 1.5)
        moved += d
    assert moved > 0


def _ranks_agree(case, outs):
    """Every rank of a data group holds the same trained weights (the
    tensor-parallel cases join their shards on each rank first)."""
    name = case["name"]
    first = outs[0][name]
    for out in outs[1:]:
        for k, v in first["model"].items():
            np.testing.assert_array_equal(out[name]["model"][k], v,
                                          err_msg=k)
        np.testing.assert_array_equal(out[name]["head"], first["head"])


@pytest.mark.parametrize("name", ["dp_cutmix", "dp_accum", "dp_resident",
                                  "dp_twin_resident", "dp_flyp",
                                  "dp_fixmatch", "dp_rn50"])
def test_dp_step_matches_swat_tpu(cluster, name):
    cases, outs, refs, one = cluster
    case = dict(cases[name], name=name)
    _check_trained(case, outs[0][name], refs[name], one[name])
    _ranks_agree(case, outs)
    if name == "dp_fixmatch":
        (rate, loss_u), = outs[0][name]["aux"]
        (j_rate, j_loss_u), = refs[name]["aux"]
        # the consistency term engages partly, so a per-shard mean shows
        assert 0.0 < j_rate < 1.0 and j_loss_u > 0.0
        assert rate == pytest.approx(j_rate, abs=1e-9)
        assert loss_u == pytest.approx(j_loss_u, rel=1e-4)
    if name.endswith("resident"):
        (mean,), = outs[0][name]["aux"]
        assert mean == pytest.approx(np.mean(outs[0][name]["losses"]),
                                     rel=1e-6)


@pytest.mark.parametrize("name", ["tp_cutmix_dp2xtp2", "tp_cutmix_tp2",
                                  "tp_flyp"])
def test_tp_step_matches_swat_tpu(cluster, name):
    """The tensor-parallel steps: the shards' updates, joined, are the
    one-device update; the text tower's vocabulary-sharded embedding
    trains under FLYP."""
    cases, outs, refs, one = cluster
    case = dict(cases[name], name=name)
    _check_trained(case, outs[0][name], refs[name], one[name])
    _ranks_agree(case, outs)


@pytest.mark.parametrize("name", ["tp_forward", "tp_forward_mega"])
def test_tp_forward_matches_swat_tpu(cluster, name):
    import jax
    import jax.numpy as jnp

    from swat_tpu.models import functional as F

    cases, outs, refs, one = cluster
    case = cases[name]
    params, _ = jax_params_from_state_dict(case["sd"], case["cfg"])
    model = JaxCLIPModel(jax_model_config(MODEL), precision=JAX_FP32)
    ref = np.asarray(jax.jit(lambda p, x: F.encode_image(
        model, p, x, normalize=True))(params, jnp.asarray(case["images"])))
    for out in outs:
        np.testing.assert_allclose(out[name]["features"], ref,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out[name]["features"],
                                   one[name]["features"], rtol=1e-5,
                                   atol=1e-6)


def test_dp_resident_validate_matches_swat_tpu(cluster):
    """swat_tpu's scan eval over the same uint8 split (its mean over
    samples, the last batch padded and masked) against the port's resident
    engine with each rank holding its rows of every batch."""
    from swat_tpu.train.scan_loop import ResidentEval as JaxResidentEval
    from swat_tpu.train.scan_loop import make_scan_eval as jax_scan_eval

    cases, outs, refs, one = cluster
    case = cases["dp_resident_validate"]
    params, _ = jax_params_from_state_dict(case["sd"], case["cfg"])
    model = JaxCLIPModel(jax_model_config(MODEL), precision=JAX_FP32)
    n, bs = len(case["labels"]), case["batch_size"]
    pad = (-n) % bs
    ev = JaxResidentEval(
        np.concatenate([case["images"], np.zeros((pad,) + case["images"]
                                                 .shape[1:], np.uint8)]),
        np.r_[case["labels"], np.zeros(pad, np.int64)].astype(np.int32),
        np.arange(n + pad) < n, 3,
        np.r_[case["source"], np.zeros(pad, np.int64)].astype(np.int32))
    acc, loss, cm = jax_scan_eval(model, 3, batch_size=bs)(
        params, case["head"], np.log(100.0), ev)
    for out in outs:
        got = out["dp_resident_validate"]
        np.testing.assert_array_equal(got["cm"], np.asarray(cm))
        assert got["acc"] == pytest.approx(float(acc), abs=1e-4)
        assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
        np.testing.assert_array_equal(got["cm"],
                                      one["dp_resident_validate"]["cm"])
        assert got["loss"] == pytest.approx(
            one["dp_resident_validate"]["loss"], rel=1e-6)


def test_dp_validate_matches_swat_tpu(cluster):
    from swat_tpu.eval.validate import Evaluator as JaxEvaluator

    cases, outs, refs, one = cluster
    case = cases["dp_validate"]
    params, _ = jax_params_from_state_dict(case["sd"], case["cfg"])
    ev = JaxEvaluator(JaxCLIPModel(jax_model_config(MODEL),
                                   precision=JAX_FP32), num_classes=3)
    acc, loss, cm = ev.validate(params, case["head"], np.log(100.0),
                                case["batches"], return_confusion=True)
    for out in outs:
        got = out["dp_validate"]
        assert got["acc"] == pytest.approx(acc, abs=1e-9)
        assert got["loss"] == pytest.approx(loss, rel=1e-6)
        np.testing.assert_array_equal(got["cm"], cm)
        assert got["acc"] == one["dp_validate"]["acc"]
        np.testing.assert_array_equal(got["cm"], one["dp_validate"]["cm"])
