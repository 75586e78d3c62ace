"""Gradient accumulation (--accum), remat (--remat) and the automatic
memory policy of the port on the CPU: accumulated steps lock-step against
swat_tpu's (mean and summed criteria, 2 and 4 microbatches) and against
the port's own single pass; every remat policy's gradients bit-equal to no
remat, with the blocks' forward run again as the policy says;
auto_memory_policy and _pick_accum against swat_tpu's on a grid; and a
stage-1 run with --accum and --remat through both pipelines."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_steps import (LR_BB, LR_HEAD, MODEL, N_STEPS,
                                    TOTAL_ITER, _grads, _lr_sum, _port_state)
from torch_port_lib import (RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, cosine, delta_check,
                            jax_params_from_state_dict, jax_step_draws,
                            loss_rows, make_dataset, random_state_dict,
                            register_dataset, run_kwargs)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train import stages as JST
from swat_tpu.train import steps as JS
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from swat_tpu_torch.kernels import flash_attention as FA
from swat_tpu_torch.models.clip import CLIPModel, resolve_remat_policy
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train import stages
from swat_tpu_torch.train.stages import SwatPipeline
from swat_tpu_torch.train.steps import make_mixing_step

torch.set_num_threads(TORCH_THREADS)

BATCH = 8


@pytest.fixture(scope="module")
def accum_setup():
    """test_tiny weights, a random head and N_STEPS batches of BATCH
    normalized images (no crops: the batches carry images)."""
    import jax

    cfg = get_model_config(MODEL)
    sd = random_state_dict(cfg, seed=0)
    params, _ = jax_params_from_state_dict(sd, cfg)
    rng = np.random.default_rng(2)
    head = rng.standard_normal((3, cfg.embed_dim)).astype(np.float32)
    head /= np.linalg.norm(head, axis=-1, keepdims=True)
    batches = [{"images": rng.standard_normal(
                    (BATCH, 32, 32, 3)).astype(np.float32),
                "labels": rng.integers(0, 3, BATCH).astype(np.int32),
                "source": rng.integers(0, 2, BATCH).astype(np.int32)}
               for _ in range(N_STEPS)]
    keys = list(jax.random.split(jax.random.PRNGKey(7), N_STEPS))
    return sd, params, head, batches, keys


def _jax_accum_run(method, accum, params, head, batches, keys):
    model = JaxCLIPModel(jax_model_config(MODEL), precision=JAX_FP32)
    state, tx = jax_create_state(params, head, method,
                                 lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                                 total_iter=TOTAL_ITER)
    step = JS.make_mixing_step(model, tx, method, mix_prob=1.0,
                               image_size=32, accum=accum)
    losses = []
    for batch, key in zip(batches, keys):
        state, loss = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, key)
        losses.append(float(loss))
    model_np = {k: np.asarray(v) for k, v in params_to_torch_state_dict(
        state.model, 0.0).items()}
    return losses, model_np, np.asarray(state.head), float(state.logit_scale)


def _port_accum_run(method, accum, sd, head, batches, draws, steps=N_STEPS):
    state = _port_state(method, sd, head)
    step = make_mixing_step(method, image_size=32, accum=accum)
    losses, g0 = [], {}
    for batch, d in list(zip(batches, draws))[:steps]:
        losses.append(float(step(state, batch, d)))
        if not g0:
            g0.update(_grads(state))
    return losses, state, g0


@pytest.mark.parametrize("accum", [2, 4])
@pytest.mark.parametrize("method", ["cutmix", "saliencymix"])
def test_accum_steps_match_swat_tpu(accum_setup, method, accum):
    """3 steps at mix_prob 1 with ``accum`` microbatches against
    swat_tpu's accumulated step (cutmix: mean criterion, the summed
    gradients scaled once; saliencymix: the summed per-image-lambda
    criterion, nothing scaled): losses to rel 1e-5, logit_scale, the head
    and every visual tensor by the delta rule.  Then the first step's
    loss and gradients against the port's own single pass: the same sums
    in another order (fp32)."""
    sd, params, head, batches, keys = accum_setup
    draws = [jax_step_draws(k, np.zeros((BATCH, 2)), 32, 1.0, 1.0,
                            crops=False, method=method) for k in keys]
    assert all(d.mix.gate for d in draws)
    j_losses, j_model, j_head, j_ls = _jax_accum_run(
        method, accum, params, head, batches, keys)
    p_losses, state, g0 = _port_accum_run(method, accum, sd, head, batches,
                                          draws)
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-5)
    assert state.logit_scale.item() == pytest.approx(j_ls, abs=1e-5)
    sd_out = {k: v.detach().numpy() for k, v in state.model.state_dict(
        ).items()}
    moved = delta_check("head", head, j_head, state.head.detach().numpy(),
                        g0["head"], _lr_sum(LR_HEAD), 0.0)
    for k, ref in j_model.items():
        if k.startswith("visual."):
            moved += delta_check(k, sd[k].numpy(), ref, sd_out[k],
                                 g0[f"model.{k}"], _lr_sum(LR_BB),
                                 N_STEPS * LR_BB * 1.5)
    assert moved == sum(k.startswith("visual.") for k in j_model) + 1

    single_losses, _, single_g0 = _port_accum_run(method, 1, sd, head,
                                                  batches, draws, steps=1)
    assert p_losses[0] == pytest.approx(single_losses[0], rel=1e-6)
    assert sorted(g0) == sorted(single_g0)
    for k, g in g0.items():
        ref = single_g0[k].ravel()
        if np.abs(ref).max() == 0:
            continue
        assert cosine(g.ravel(), ref) >= 1 - 1e-6, k
        np.testing.assert_allclose(g.ravel(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


def test_accum_refuses_a_batch_it_does_not_divide(accum_setup):
    sd, params, head, batches, keys = accum_setup
    draws = [jax_step_draws(keys[0], np.zeros((BATCH, 2)), 32, crops=False,
                            method="cutmix")]
    with pytest.raises(ValueError, match="not divisible by accum=3"):
        _port_accum_run("cutmix", 3, sd, head, batches, draws, steps=1)
    with pytest.raises(ValueError, match="accum must be >= 1"):
        make_mixing_step("cutmix", accum=0)


# ---------------------------------------------------------------------------
# remat


def _deep_tiny():
    """test_tiny with a 4-block image tower, so that first2 is a part."""
    cfg = get_model_config(MODEL)
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=4))


def _remat_grads(remat, precision, images, weights, calls):
    """Gradients of every visual tensor of a weighted sum of the normalized
    features, the attention counting its calls."""
    model = CLIPModel(_deep_tiny(), precision=precision, remat=remat)
    model.init_random(torch.Generator().manual_seed(3))
    model.requires_grad_(False).visual.requires_grad_(True)

    def attention(qkv, heads, causal):
        calls.append(1)
        return FA.mha_qkv(qkv, heads, causal)

    feats = model.encode_image(images, normalize=True, attention=attention)
    (feats * weights).sum().backward()
    return {n: p.grad.clone() for n, p in model.visual.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat,recomputed", [
    (True, 4), ("full", 4), ("first2", 2), ("dots", 4), ("dots_all", 4)])
def test_remat_gradients_equal_no_remat(remat, recomputed, dtype):
    """Bit for bit: the recomputed forward is the same arithmetic on the
    same inputs.  The attention runs once a block, plus once again for
    every block the policy recomputes (the selective policies keep the
    products' outputs, not the attention's); no kernel launches on the
    CPU."""
    precision = FP32_PRECISION if dtype == "float32" else DEFAULT_PRECISION
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.standard_normal((3, 32, 32, 3)).astype(
        np.float32))
    weights = torch.from_numpy(rng.standard_normal((3, 32)).astype(
        np.float32))
    launches = (FA.LAUNCHES, FA.LAUNCHES_BWD)
    base_calls, calls = [], []
    base = _remat_grads(False, precision, images, weights, base_calls)
    got = _remat_grads(remat, precision, images, weights, calls)
    assert len(base_calls) == 4 and len(calls) == 4 + recomputed
    assert sorted(got) == sorted(base)
    for n, g in got.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, base[n]), n
    assert (FA.LAUNCHES, FA.LAUNCHES_BWD) == launches


def test_remat_acts_only_where_a_graph_is_built():
    """Inference encodes and the use_mega route run each block once."""
    model = CLIPModel(_deep_tiny(), remat="full").init_random(
        torch.Generator().manual_seed(0))
    images = torch.zeros(2, 32, 32, 3)
    calls = []

    def attention(qkv, heads, causal):
        calls.append(1)
        return FA.mha_qkv(qkv, heads, causal)

    with torch.no_grad():
        model.encode_image(images, attention=attention)
    assert len(calls) == 4
    model.requires_grad_(True)
    plain = CLIPModel(_deep_tiny()).init_random(
        torch.Generator().manual_seed(0)).requires_grad_(True)
    a = model.encode_image(images, use_mega=True, attention=attention)
    b = plain.encode_image(images, use_mega=True)
    assert len(calls) == 4 and torch.equal(a, b)


@pytest.mark.parametrize("bad", ["bogus", "first0", "firstx"])
def test_unknown_remat_policies_raise(bad):
    with pytest.raises(ValueError, match="remat"):
        CLIPModel(get_model_config(MODEL), remat=bad)
    with pytest.raises(ValueError, match="remat"):
        resolve_remat_policy(bad)


def test_remat_policies_resolve_as_swat_tpu():
    from swat_tpu.models.clip import resolve_remat_policy as jax_resolve

    for remat in (False, True, "full", "dots", "dots_all", "first3"):
        got, ref = resolve_remat_policy(remat), jax_resolve(remat)
        assert got[0] == ref[0] and got[2] == ref[2], remat
        assert (got[1] is None) == (ref[1] is None), remat
    assert set(resolve_remat_policy("dots")[1]) < set(
        resolve_remat_policy("dots_all")[1])
    with pytest.raises(ValueError, match="remat must be bool"):
        jax_resolve("bogus")


# ---------------------------------------------------------------------------
# the automatic memory policy


@pytest.mark.parametrize("model_cfg", ["vitb32_openclip_laion400m",
                                       "vitl14_openclip_laion400m"])
def test_auto_memory_policy_matches_swat_tpu(model_cfg):
    seen = set()
    for bsz in (16, 32, 48, 64, 96, 128, 200, 256):
        for accum in (1, 2, 4):
            for remat in (False, True, "dots", "first4"):
                for method in ("cutmix", "finetune-mixed", "CMO", "FLYP",
                               "fixmatch"):
                    for n_devices in (1, 4):
                        args = (model_cfg, remat, accum, bsz, n_devices,
                                method)
                        got = stages.auto_memory_policy(*args)
                        assert got == JST.auto_memory_policy(*args), args
                        seen.add(got != (remat, accum))
    assert seen == ({False, True} if "vitl14" in model_cfg else {False})
    for n in range(1, 300):
        assert stages._pick_accum(n) == JST._pick_accum(n), n


# ---------------------------------------------------------------------------
# through the pipelines

RUN = dict(method="cutmix", data_source="fewshot+retrieved",
           retrieval_split=RETRIEVAL_SPLIT, aug_mode="eval", mix_prob=0.0,
           epochs=2, skip_stage2=True, compute_dtype="float32",
           lr_classifier=1e-2, lr_backbone=1e-4, resident="off")


@pytest.mark.parametrize("kw", [{"accum": 2, "remat": "full"},
                                {"accum": 4, "remat": "dots"}])
def test_accum_and_remat_runs_match_swat_tpu(tmp_path_factory, kw):
    """Stage-1 cutmix at bsz 4 (--aug_mode eval --mix_prob 0, streaming)
    with --accum and --remat through both pipelines: the summary line and
    the loss.csv rows, and the same rows as the run without either to
    fp32 summation order."""
    undo = register_dataset()
    try:
        base = tmp_path_factory.mktemp("data")
        dataset_path = make_dataset(base, n_test_per_class=10,
                                    n_retrieved_per_class=10)
        ckpt = str(base / "tiny.pt")
        torch.save(random_state_dict(get_model_config(MODEL), seed=0), ckpt)
        out = {}
        for name, config, pipeline, extra, dev in (
                ("jax", JaxRunConfig, JaxPipeline, kw, {}),
                ("port", RunConfig, SwatPipeline, kw, {"device": "cpu"}),
                ("plain", RunConfig, SwatPipeline, {}, {"device": "cpu"})):
            pipe = pipeline(config(**dev, **run_kwargs(
                dataset_path, base / name, checkpoint_path=ckpt, **RUN,
                **extra)).derived())
            if name == "port":
                assert pipe.model.remat == kw["remat"]
                assert pipe.cfg.accum == kw["accum"]
            summary = pipe.run()
            pipe.loss_logger.close()
            out[name] = (summary, loss_rows(pipe.cfg.output_dir))
    finally:
        undo()
    assert out["port"][0] == out["jax"][0] == out["plain"][0]
    assert_rows_match(out["port"][1], out["jax"][1])
    assert_rows_match(out["port"][1], out["plain"][1])
