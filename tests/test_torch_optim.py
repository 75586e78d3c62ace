"""The port's AdamW param groups and LR schedule (swat_tpu_torch.train.optim
and .state) on the CPU against swat_tpu.train.optim / .state: the
per-iteration warmup -> cosine schedule over 120 steps, the parameter
labels of create_train_state, and 60 AdamW updates fed the same gradients
against optax's adamw (multi_transform over the same labels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import (TORCH_THREADS, jax_params_from_state_dict,
                            random_state_dict)

from swat_tpu.train import optim as JO
from swat_tpu.train.state import make_labels as jax_make_labels
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train import optim as O
from swat_tpu_torch.train.state import create_train_state

torch.set_num_threads(TORCH_THREADS)


@pytest.mark.parametrize("base_lr,warmup_lr,total", [
    (1e-4, 1e-6, 100), (1e-6, 1e-6, 70), (1e-3, 1e-5, 64)])
def test_schedule_matches_make_lr_schedule(base_lr, warmup_lr, total):
    """Both in float32; jnp.cos and np.cos may differ in the last bit."""
    ref = JO.make_lr_schedule(base_lr, total, warmup_lr=warmup_lr)
    got = O.make_lr_schedule(base_lr, total, warmup_lr=warmup_lr)
    steps = range(120)
    np.testing.assert_allclose([got(i) for i in steps],
                               [float(ref(i)) for i in steps], rtol=1e-6)
    assert got(0) == pytest.approx(warmup_lr, rel=1e-7)   # absolute warmup
    assert got(25) == pytest.approx(base_lr * 25 / 50, rel=1e-6)
    assert got(49 + total) == pytest.approx(O.ETA_MIN, rel=1e-3)


def test_default_warmup_lr():
    for lr in (1e-6, 5e-5, 5.1e-5, 1e-3):
        assert O.default_warmup_lr(lr) == JO.default_warmup_lr(lr)


def _jax_label_sizes(labels, params):
    sizes = {}
    for label, leaf in zip(jax.tree_util.tree_leaves(labels),
                           jax.tree_util.tree_leaves(params)):
        sizes[label] = sizes.get(label, 0) + int(np.size(leaf))
    return sizes


@pytest.mark.parametrize("method", ["cutmix", "finetune"])
def test_param_groups_match_create_train_state_labels(method):
    cfg = get_model_config("test_tiny")
    sd = random_state_dict(cfg, seed=0)
    params, _ = jax_params_from_state_dict(sd, cfg)
    head = np.zeros((3, cfg.embed_dim), np.float32)
    labels = jax_make_labels(params, method, head)
    ref = _jax_label_sizes(labels["model"], params)
    assert labels["head"] == "head" and labels["logit_scale"] == "head"

    model = CLIPModel(cfg)
    model.load_state_dict(sd)
    state = create_train_state(model, torch.from_numpy(head), method,
                               total_iter=10)
    groups = {g["label"]: g["params"] for g in state.optimizer.param_groups}
    assert sorted(groups) == ["backbone", "head"]
    assert sum(p.numel() for p in groups["backbone"]) == ref["backbone"]
    assert groups["head"] == [state.head, state.logit_scale]
    # frozen: the text tower, plus the CLIP module's own logit_scale (the
    # JAX package keeps that outside the model tree)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert sum(model.get_parameter(n).numel() for n in frozen) == \
        ref["frozen"] + 1
    assert all(not n.startswith("visual.") for n in frozen)
    in_opt = {id(p) for g in groups.values() for p in g}
    assert all(id(model.get_parameter(n)) not in in_opt for n in frozen)
    assert state.logit_scale.item() == pytest.approx(np.log(1 / 0.07))


def test_unported_optimizer_options_raise():
    """A method no package knows raises, as swat_tpu's label_params does."""
    cfg = get_model_config("test_tiny")
    model = CLIPModel(cfg)
    head = torch.zeros(3, cfg.embed_dim)
    with pytest.raises(NotImplementedError, match="not implemented"):
        create_train_state(model, head, "no-such-method")
    with pytest.raises(NotImplementedError, match="not implemented"):
        JO.label_params({"visual": {}, "text": {}}, "no-such-method")


@pytest.mark.parametrize("lr_projector", [None, 3e-5])
@pytest.mark.parametrize("locked_text", [False, True])
def test_flyp_groups_and_rates(locked_text, lr_projector):
    """FLYP's groups: both towers at lr_backbone (the text tower frozen
    under --locked_text), both projections at lr_projector (lr_backbone
    when None) even when the text tower is locked, logit_scale at
    lr_classifier, the head in none; each group's rate over 120 steps
    equals swat_tpu's schedule for its label, the warmup from
    lr_backbone."""
    cfg = get_model_config("test_tiny")
    model = CLIPModel(cfg)
    kw = dict(lr_classifier=1e-3, lr_backbone=1e-4, total_iter=40)
    state = create_train_state(model, torch.zeros(3, cfg.embed_dim), "FLYP",
                               lr_projector=lr_projector,
                               locked_text=locked_text, **kw)
    groups = {g["label"]: g for g in state.optimizer.param_groups}
    assert sorted(groups) == ["backbone", "head", "projector"]
    assert {id(p) for p in groups["projector"]["params"]} == {
        id(model.visual.proj), id(model.text_projection)}
    assert [id(p) for p in groups["head"]["params"]] == [
        id(state.logit_scale)]
    assert not state.head.requires_grad
    text = [p for n, p in model.named_parameters()
            if not n.startswith("visual.") and n not in
            ("text_projection", "logit_scale")]
    in_backbone = {id(p) for p in groups["backbone"]["params"]}
    assert all((id(p) in in_backbone) != locked_text for p in text)
    assert all(p.requires_grad != locked_text for p in text)
    assert all(id(p) in in_backbone for n, p in model.named_parameters()
               if n.startswith("visual.") and n != "visual.proj")
    base = {"backbone": kw["lr_backbone"], "head": kw["lr_classifier"],
            "projector": kw["lr_backbone"] if lr_projector is None
            else lr_projector}
    for label, group in groups.items():
        ref = JO.make_lr_schedule(base[label], kw["total_iter"],
                                  warmup_lr=JO.default_warmup_lr(1e-4))
        got = [group["schedule"](i) for i in range(120)]
        np.testing.assert_allclose(got, [float(ref(i)) for i in range(120)],
                                   rtol=1e-6, err_msg=label)


def test_adamw_matches_optax_over_60_steps():
    """Two groups (backbone, head) with their own schedules, fed the same
    gradients: optax decays as lr * wd * p inside the update, torch scales
    p by (1 - lr * wd) first, so the two round differently; over 60 steps
    of ~lr-sized moves on weights of order 1, 2e-6 absolute."""
    rng = np.random.default_rng(0)
    a0 = rng.standard_normal(50).astype(np.float32)
    b0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [(rng.standard_normal(50).astype(np.float32),
              rng.standard_normal((3, 4)).astype(np.float32))
             for _ in range(60)]
    kw = dict(lr_classifier=1e-3, lr_backbone=1e-4, total_iter=40, wd=1e-2)

    tx = JO.build_optimizer({"a": "backbone", "b": "head"}, **kw)
    jp = {"a": jnp.asarray(a0), "b": jnp.asarray(b0)}
    opt_state = tx.init(jp)
    pa = torch.nn.Parameter(torch.from_numpy(a0.copy()))
    pb = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    opt = O.build_optimizer({"backbone": [pa], "head": [pb]}, **kw)
    for step, (ga, gb) in enumerate(grads):
        updates, opt_state = tx.update(
            {"a": jnp.asarray(ga), "b": jnp.asarray(gb)}, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        pa.grad, pb.grad = torch.from_numpy(ga), torch.from_numpy(gb)
        O.set_lr(opt, step)
        opt.step()
        np.testing.assert_allclose(pa.detach().numpy(), np.asarray(jp["a"]),
                                   rtol=0, atol=2e-6, err_msg=str(step))
        np.testing.assert_allclose(pb.detach().numpy(), np.asarray(jp["b"]),
                                   rtol=0, atol=2e-6, err_msg=str(step))
    assert np.abs(pa.detach().numpy() - a0).max() > 1e-3   # it did move
