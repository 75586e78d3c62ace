"""RN50 training in the port on the CPU against swat_tpu, on a tiny RN50
(torch_port_lib.rn50_configs('rn50_tiny')) in fp32: 3 steps each of cutmix
(streaming, and through the resident epoch), finetune and attentivemix
(whose heatmaps read the attention pool's tokens with eval-mode BN) at
mix_prob 1 from the same weights and uint8 canvases, the port fed the JAX
steps' own draws: each step's loss, the BN running statistics after each
step's fold (rel <= 1e-5), the first step's gradients, the weights after the
first step by the gradient-conditioned delta rule
(torch_port_lib.delta_check), the text tower bit-unchanged.  The same three
steps are also held against an independent float64 oracle (OpenCLIP's
ModifiedResNet in torch functional ops with ``F.batch_norm``,
tests/test_torch_oracle_rn50.py) trained by AdamW on the port's mixed
batches: the first gradients of every tensor, the weights after each of the
3 steps by the delta rule, the BN statistics after each fold.  One step each
of the other steps that encode in train mode (finetune-multitask,
dataset-cls, FixMatch: the loss and the folded statistics) and of probing
(frozen: the statistics stay); FLYP refused on RN50 (swat_tpu's labels
fail on it); ``--accum 2`` refused by the step with swat_tpu's
ValueError.  The CLI runs are tests/test_torch_rn50_cli.py."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_oracle_rn50 import HEADS as ORACLE_HEADS
from test_torch_oracle_rn50 import LAYERS as ORACLE_LAYERS
from test_torch_oracle_rn50 import oracle_rn50_encode_image
from torch_port_lib import (TORCH_THREADS, delta_check, jax_crop_draws,
                            jax_fixmatch_draws, jax_params_from_state_dict,
                            jax_step_draws, random_state_dict, rn50_configs)

from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.eval.heatmap import clip_attention_heatmap as jax_heatmap
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train import steps as JS
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.core.precision import FP32_PRECISION
from swat_tpu_torch.eval.heatmap import clip_attention_heatmap
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.train.optim import (build_optimizer, default_warmup_lr,
                                        make_lr_schedule, set_lr)
from swat_tpu_torch.train.resident import ResidentData, make_resident_epoch
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import (batch_to_device, make_ce_step,
                                        make_dataset_cls_step,
                                        make_fixmatch_step,
                                        make_mix_fn, make_mixing_step,
                                        make_multitask_step,
                                        make_probing_step)

torch.set_num_threads(TORCH_THREADS)

MODEL = "rn50_tiny"
N_STEPS, BSZ, CANVAS, N_PX = 3, 6, 40, 64
LR_HEAD, LR_BB, TOTAL_ITER = 1e-2, 1e-4, 10
VALID_HW = [(40, 30), (28, 40), (40, 40), (40, 22), (33, 40), (40, 36)]
BN_REL = 1e-5
# the first step's gradients, relative to each tensor's largest
GRAD_REL = 1e-4
ACCUM_ERROR = "grad accumulation \\(accum>1\\) is ViT-only"


@pytest.fixture(scope="module")
def setup():
    cfg, jax_cfg = rn50_configs(MODEL)
    sd = random_state_dict(cfg, seed=0)
    params, _ = jax_params_from_state_dict(sd, cfg)
    rng = np.random.default_rng(0)
    head = rng.standard_normal((3, cfg.embed_dim)).astype(np.float32)
    head /= np.linalg.norm(head, axis=-1, keepdims=True)
    n = N_STEPS * BSZ
    canvases = np.zeros((n, CANVAS, CANVAS, 3), np.uint8)
    valid_hw = np.asarray(VALID_HW * N_STEPS, np.int32)
    for i, (h, w) in enumerate(valid_hw):
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    labels = rng.integers(0, 3, n).astype(np.int32)
    source = rng.integers(0, 2, n).astype(np.int32)
    batches = [{"canvases": canvases[s * BSZ:(s + 1) * BSZ],
                "valid_hw": valid_hw[s * BSZ:(s + 1) * BSZ],
                "labels": labels[s * BSZ:(s + 1) * BSZ],
                "source": source[s * BSZ:(s + 1) * BSZ]}
               for s in range(N_STEPS)]
    keys = list(jax.random.split(jax.random.PRNGKey(42), N_STEPS))
    data = (canvases, valid_hw, labels, source)
    return cfg, jax_cfg, sd, params, head, batches, keys, data


def _bn_stats(sd) -> dict:
    """The running statistics of a state dict, copied (the port folds them
    in place, and swat_tpu's steps donate their state's buffers)."""
    return {k: np.array(v, np.float32) for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _port_bn_stats(state) -> dict:
    return _bn_stats({k: v.numpy() for k, v in
                      state.model.state_dict().items()})


def _assert_bn_equal(got, ref, init=None, bound=BN_REL):
    assert sorted(got) == sorted(ref) and got
    for k, v in ref.items():
        rel = np.abs(got[k] - v).max() / np.abs(v).max()
        assert rel <= bound, (k, rel)
        if init is not None:
            assert not np.array_equal(v, init[k]), k


def _keep_grads():
    """An optax transformation that moves nothing (its state keeps the
    last gradients)."""
    import optax

    def update(grads, _state, _params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), update)


def _jax_run(jax_cfg, method, params, head, batches, keys, tree_head=None,
             keep=False):
    """swat_tpu's steps -> (losses, the model after each step as a torch
    state dict of numpy arrays, the final state).  ``keep``: an optimizer
    that moves no weight (its state keeps the gradients); the steps still
    fold their BN statistics."""
    model = JaxCLIPModel(jax_cfg, precision=JAX_FP32)
    # the steps donate their state: start from copies of the shared arrays
    params = jax.tree_util.tree_map(np.array, params)
    state, tx = jax_create_state(params, head if tree_head is None
                                 else tree_head,
                                 method,
                                 lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                                 total_iter=TOTAL_ITER)
    if keep:
        tx = _keep_grads()
        state = state.replace(opt_state=tx.init(state.trainable))
    if method == "finetune":
        step = JS.make_ce_step(model, tx, image_size=N_PX)
    elif method == "finetune-multitask":
        step = JS.make_multitask_step(model, tx, image_size=N_PX)
    elif method == "dataset-cls":
        step = JS.make_dataset_cls_step(model, tx, image_size=N_PX)
    elif method == "fixmatch":
        step = JS.make_fixmatch_step(model, tx, image_size=N_PX)
    elif method == "probing":
        step = JS.make_probing_step(model, tx, pre_extracted=False,
                                    image_size=N_PX)
    else:
        kw = {}
        if method == "attentivemix":
            kw["heatmap_fn"] = lambda p, images, labels: jax_heatmap(
                model, p, images)
        step = JS.make_mixing_step(model, tx, method, mix_prob=1.0,
                                   image_size=N_PX, **kw)
    losses, models = [], []
    for batch, key in zip(batches, keys):
        state, loss = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, key)
        losses.append(float(loss))
        models.append({k: np.array(v, np.float32) for k, v in
                       params_to_torch_state_dict(state.model, 0.0).items()})
    return losses, models, state


def _port_state(cfg, method, sd, head, dataset_head=None):
    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(sd)
    return create_train_state(
        model, torch.from_numpy(head), method, lr_classifier=LR_HEAD,
        lr_backbone=LR_BB, total_iter=TOTAL_ITER,
        dataset_head=(None if dataset_head is None
                      else torch.from_numpy(dataset_head)))


def _grads(state):
    out = {f"model.{k}": p.grad.detach().clone().numpy()
           for k, p in state.model.named_parameters() if p.grad is not None}
    out["head"] = state.head.grad.detach().clone().numpy()
    return out


def _port_run(cfg, method, sd, head, batches, all_draws, data=None):
    """The port's steps, streaming or (``data``) through the resident
    epoch -> (losses, the model after each step as a state dict of numpy
    arrays, state, first gradients, each step's mixed batch)."""
    state = _port_state(cfg, method, sd, head)
    heatmap_fn = (lambda model, images, labels:
                  clip_attention_heatmap(model, images))
    if method == "finetune":
        step = make_ce_step(image_size=N_PX)
    else:
        step = make_mixing_step(method, image_size=N_PX,
                                heatmap_fn=heatmap_fn)
    mix = make_mix_fn(method, image_size=N_PX, heatmap_fn=heatmap_fn)
    g0, losses, models, mixed = {}, [], [], []

    def recording(state, batch, draws):
        with torch.no_grad():       # the step's own mix, made beside it
            mixed.append(mix(state, batch_to_device(batch, "cpu"), draws))
        val = step(state, batch, draws)
        if not g0:
            g0.update(_grads(state))
        losses.append(float(val))
        models.append({k: v.numpy().copy() for k, v in
                       state.model.state_dict().items()})
        return val

    if data is None:
        for b, d in zip(batches, all_draws):
            recording(state, b, d)
    else:
        canvases, valid_hw, labels, source = data
        resident = ResidentData(torch.from_numpy(canvases), valid_hw,
                                torch.from_numpy(labels).long(),
                                torch.from_numpy(source).long())
        draws = iter(all_draws)
        epoch = make_resident_epoch(recording, lambda rng, batch: next(draws))
        perm = np.arange(N_STEPS * BSZ).reshape(N_STEPS, BSZ)
        mean = epoch(state, resident, perm, np.random.default_rng(0))
        assert float(mean) == pytest.approx(np.mean(losses), rel=1e-6)
    return losses, models, state, g0, mixed


def _oracle_run(sd, head, trained, mixed):
    """The independent float64 oracle trained on the port's mixed batches:
    OpenCLIP's ModifiedResNet in torch functional ops (``F.batch_norm`` in
    train mode folds the running statistics), the head and logit_scale, the
    mixing criterion, AdamW over the finetune groups with the port's rates
    -> (losses, the first gradients, the weights after each step as numpy
    arrays)."""
    sd64 = {k: v.detach().double().clone() for k, v in sd.items()}
    for k in trained:
        sd64[k].requires_grad_(True)
    head64 = torch.tensor(head, dtype=torch.float64, requires_grad=True)
    scale64 = torch.tensor(float(np.log(1 / 0.07)), dtype=torch.float64,
                           requires_grad=True)
    opt = build_optimizer({"backbone": [sd64[k] for k in trained],
                           "head": [head64, scale64]},
                          lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                          total_iter=TOTAL_ITER)
    losses, g0, models = [], {}, []
    for i, (images, y_a, y_b, lam, lam_vec, _) in enumerate(mixed):
        feats = oracle_rn50_encode_image(sd64, images.double(),
                                         training=True)
        logp = torch.log_softmax(feats @ head64.t() * torch.exp(scale64), -1)
        ce_a = -logp.gather(-1, y_a[:, None])[:, 0]
        ce_b = -logp.gather(-1, y_b[:, None])[:, 0]
        loss = (torch.sum(lam_vec * ce_a + (1 - lam_vec) * ce_b)
                if lam_vec is not None
                else lam * ce_a.mean() + (1 - lam) * ce_b.mean())
        opt.zero_grad()
        loss.backward()
        if not g0:
            g0 = {k: sd64[k].grad.numpy().copy() for k in trained}
            g0["head"] = head64.grad.numpy().copy()
        set_lr(opt, i)
        opt.step()
        losses.append(float(loss.detach()))
        models.append({k: v.detach().numpy().copy()
                       for k, v in sd64.items()})
    return losses, g0, models


@pytest.fixture(scope="module")
def jax_refs(setup):
    """swat_tpu's 3 steps of a method and its first step's gradients, made
    once a method (the streaming and resident runs share them)."""
    cfg, jax_cfg, sd, params, head, batches, keys, data = setup
    refs = {}

    def get(method):
        if method not in refs:
            losses, models, _ = _jax_run(jax_cfg, method, params, head,
                                         batches, keys)
            _, _, kept = _jax_run(jax_cfg, method, params, head, batches[:1],
                                  keys[:1], keep=True)
            grads = params_to_torch_state_dict(kept.opt_state["model"], 0.0)
            grads["head"] = kept.opt_state["head"]
            refs[method] = (losses, models, grads)
        return refs[method]

    return get


@pytest.mark.parametrize("method,runner", [
    ("cutmix", "streaming"), ("cutmix", "resident"),
    ("finetune", "streaming"), ("attentivemix", "streaming")])
def test_steps_match_swat_tpu(setup, jax_refs, method, runner):
    """3 steps against swat_tpu: each step's loss, and the BN statistics
    after each step's fold; the first step's gradients; the weights after
    the first step by the delta rule (Adam's first step is +-lr * sign(g),
    so every gradient-carrying element's sign is held).  The same 3 steps
    against the float64 oracle (``_oracle_run``): the losses, the first
    gradients of every tensor, the weights after each step by the delta
    rule, the BN statistics after each fold.

    swat_tpu's fp32 is not held to the oracle: where a ReLU's input lies
    within fp32 rounding of 0, the two frameworks can round it to opposite
    sides, and that one element of a channel's N*H*W moves the tensor's
    gradient by about 1/sqrt(N*H*W) of its largest (measured here:
    attentivemix's visual.layer4.0.conv1, swat_tpu 7.7e-2 from the oracle,
    the port 4.3e-6; every other case and tensor <= 2.6e-5 and <= 6.3e-6).
    Adam's m / sqrt(v) then carries such a difference into small-gradient
    elements, so swat_tpu's weights are held after the first step only.
    The port's gradients are held to swat_tpu's at GRAD_REL plus however
    far swat_tpu's own depart from the oracle's, and its first-step
    weights by the delta rule but in a tensor where swat_tpu's first step
    fails that rule against the oracle."""
    cfg, jax_cfg, sd, params, head, batches, keys, data = setup
    assert (cfg.vision.layers, cfg.vision.heads) == (ORACLE_LAYERS,
                                                     ORACLE_HEADS)
    draws = [jax_step_draws(k, b["valid_hw"], N_PX, 1.0, 1.0, method=method)
             for k, b in zip(keys, batches)]
    if method == "attentivemix":
        assert all(d.mix.gate for d in draws)
    j_losses, j_models, j_g0 = jax_refs(method)
    p_losses, p_models, state, g0, mixed = _port_run(
        cfg, method, sd, head, batches, draws,
        data if runner == "resident" else None)
    trained = [k for k, _ in state.model.named_parameters()
               if k.startswith("visual.")]
    o_losses, o_g0, o_models = _oracle_run(sd, head, trained, mixed)

    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p_losses, o_losses, rtol=1e-5)
    init = {k: v.numpy() for k, v in sd.items()}
    init_stats = _bn_stats(init)
    for got, ref, exact in zip(p_models, j_models, o_models):
        _assert_bn_equal(_bn_stats(got), _bn_stats(ref), init_stats)
        _assert_bn_equal(_bn_stats(got), _bn_stats(exact))

    # the first step's gradients, from swat_tpu's step with an optimizer
    # that keeps them, and the oracle's
    for k in trained + ["head"]:
        if k == "visual.attnpool.k_proj.bias":
            continue            # rounding noise (softmax is shift invariant)
        got = g0[k if k == "head" else f"model.{k}"]
        ref, exact = np.asarray(j_g0[k]), o_g0[k]
        scale = np.abs(exact).max()
        assert np.abs(got - exact).max() <= GRAD_REL * scale, k
        ref_err = np.abs(ref - exact).max() / scale
        assert (np.abs(got - ref).max()
                <= (GRAD_REL + ref_err) * np.abs(ref).max()), (k, ref_err)

    sched = make_lr_schedule(LR_BB, TOTAL_ITER,
                             warmup_lr=default_warmup_lr(LR_BB))
    for step_i, (p_model, o_model) in enumerate(zip(p_models, o_models)):
        lr_sum = sum(sched(i) for i in range(step_i + 1))
        moved = 0
        for k in trained:
            if k == "visual.attnpool.k_proj.bias":
                # its gradient is rounding noise: at most Adam's walk
                assert np.abs(p_model[k] - init[k]).max() <= 2.05 * lr_sum
                continue
            moved += delta_check(k, init[k], o_model[k].astype(np.float32),
                                 p_model[k], o_g0[k], lr_sum, 0.0)
        assert moved == len(trained) - 1, step_i

    j_model, p_model = j_models[0], p_models[0]
    # Adam's first step is +-lr * sign(g) at the first step's rate
    first_lr = sched(0)
    moved = 0
    for k, ref in j_model.items():
        if k == "logit_scale" or k in init_stats:
            continue
        if not k.startswith("visual."):
            # the text tower is frozen: bit-unchanged in both packages
            np.testing.assert_array_equal(p_model[k], init[k], err_msg=k)
            np.testing.assert_array_equal(ref, init[k], err_msg=k)
            continue
        if k == "visual.attnpool.k_proj.bias":
            # its gradient is rounding noise: both walk at most Adam's step
            bound = LR_BB * 1.5
            assert np.abs(p_model[k] - init[k]).max() <= bound
            assert np.abs(ref - init[k]).max() <= bound
            moved += 1
            continue
        try:
            moved += delta_check(k, init[k], ref, p_model[k],
                                 g0[f"model.{k}"], first_lr, 0.0)
        except AssertionError:
            # only where swat_tpu's own first step departs from the
            # oracle's by the same rule (the port's was held to it above)
            with pytest.raises(AssertionError):
                delta_check(k, init[k], o_models[0][k].astype(np.float32),
                            ref, o_g0[k], first_lr, 0.0)
            moved += 1
    assert moved == len(trained)       # every visual tensor


@pytest.mark.parametrize("method", ["finetune-multitask", "dataset-cls",
                                    "fixmatch", "probing"])
def test_other_steps_fold_bn_as_swat_tpu(setup, method):
    """One step of each other train step: the loss and the BN statistics
    after the update as swat_tpu's (whose step here moves no weight: the
    statistics come from the forward of the step's starting weights in
    both).  multitask, dataset-cls and FixMatch encode with batch
    statistics (FixMatch's labeled rows and both views as one BN batch);
    the probe encodes the frozen tower with the running ones and leaves
    them."""
    cfg, jax_cfg, sd, params, head, batches, keys, _ = setup
    batch, key = dict(batches[0]), keys[0]
    rng = np.random.default_rng(7)
    dataset_head = tree_head = None
    draws = jax_crop_draws(key, batch["valid_hw"])
    if method == "finetune-multitask":
        dataset_head = head[:2].copy()
        tree_head = {"cls": head, "dataset": dataset_head}
        step = make_multitask_step(image_size=N_PX)
    elif method == "dataset-cls":
        head = head[:2].copy()
        step = make_dataset_cls_step(image_size=N_PX)
    elif method == "fixmatch":
        for view in ("images_w", "images_s"):
            batch[view] = rng.standard_normal(
                (2 * BSZ, N_PX, N_PX, 3)).astype(np.float32)
        draws = jax_fixmatch_draws(key, batch["valid_hw"])
        step = make_fixmatch_step(image_size=N_PX)
    else:
        step = make_probing_step(pre_extracted=False, image_size=N_PX)
    j_losses, j_models, _ = _jax_run(jax_cfg, method, params, head,
                                     [batch], [key], tree_head, keep=True)
    j_stats = [_bn_stats(m) for m in j_models]
    state = _port_state(cfg, method, sd, head, dataset_head)
    loss = float(step(state, batch, draws))
    assert loss == pytest.approx(j_losses[0], rel=1e-4, abs=1e-5)
    init = _bn_stats({k: v.numpy() for k, v in sd.items()})
    if method == "probing":
        assert state.bn_updates is None
        for k, v in _port_bn_stats(state).items():
            np.testing.assert_array_equal(v, init[k])
            np.testing.assert_array_equal(j_stats[0][k], init[k])
    else:
        _assert_bn_equal(_port_bn_stats(state), j_stats[0], init)


def test_flyp_is_refused_on_rn50_as_in_swat_tpu(setup):
    """FLYP trains visual.proj as a projector, which the ResNet tower has
    none of: swat_tpu's train state fails on its labels, and the port
    refuses it with a ValueError that says why."""
    cfg, jax_cfg, sd, params, head, batches, keys, _ = setup
    with pytest.raises(ValueError, match="Dict key mismatch"):
        jax_create_state(params, head, "FLYP", total_iter=TOTAL_ITER)
    with pytest.raises(ValueError, match="no such tensor"):
        _port_state(cfg, "FLYP", sd, head)


def test_accum_is_refused_on_rn50_as_in_swat_tpu(setup):
    """--accum 2: swat_tpu's make_mixing_step raises; the port's step
    raises the same ValueError before it encodes anything."""
    cfg, jax_cfg, sd, params, head, batches, keys, _ = setup
    _, tx = jax_create_state(params, head, "cutmix", total_iter=TOTAL_ITER)
    with pytest.raises(ValueError, match=ACCUM_ERROR):
        JS.make_mixing_step(JaxCLIPModel(jax_cfg, precision=JAX_FP32), tx,
                            "cutmix", accum=2)
    state = _port_state(cfg, "cutmix", sd, head)
    step = make_mixing_step("cutmix", image_size=N_PX, accum=2)
    with pytest.raises(ValueError, match=ACCUM_ERROR):
        step(state, batches[0], jax_step_draws(keys[0],
                                               batches[0]["valid_hw"], N_PX))
    init = _bn_stats({k: v.numpy() for k, v in sd.items()})
    for k, v in _port_bn_stats(state).items():
        np.testing.assert_array_equal(v, init[k])
