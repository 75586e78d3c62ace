"""The port's block-fused transformer layer on the CPU
(swat_tpu_torch.kernels.megablock: the three kernels' plain twins, the
autograd Function, ``fused_transformer`` and the towers' ``use_mega`` route)
against the JAX package's megablock Pallas kernels in interpret mode.

Kernel level: every case of torch_port_lib.MEGA_CASES (width 64, 4 heads,
S = 5 image / 12 causal text, quick-gelu and the rational-erf gelu, random
LayerNorm scale and bias), fp32 and bf16.  The Pallas side runs in a
subprocess that keeps XLA from dropping bf16 casts (see
``mega_pallas_reference``).  Tower level: ``encode_image`` / ``encode_text``
with ``use_mega=True`` against ``functional.vit_encode_image`` /
``text_encode(use_mega=True)``, forward and every parameter gradient, and
three finetune steps in lock step with a JAX step built around
``vit_encode_image(use_mega=True)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import (MEGA_CASES, TORCH_THREADS, delta_check,
                            jax_params_from_state_dict, mega_case_inputs,
                            mega_reference_subprocess, random_state_dict)

from swat_tpu.core.precision import DEFAULT_PRECISION as JAX_BF16
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.kernels import megablock as JM
from swat_tpu.models import functional as F
from swat_tpu.models import configs as jax_configs
from swat_tpu.models.head import head_logits as jax_head_logits
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train.losses import cross_entropy as jax_cross_entropy
from swat_tpu.train.losses import mixup_criterion as jax_mixup_criterion
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from swat_tpu_torch.kernels import flash_attention as FA
from swat_tpu_torch.kernels import megablock as MB
from swat_tpu_torch.models import configs
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.train.optim import default_warmup_lr, make_lr_schedule
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import make_ce_step

torch.set_num_threads(TORCH_THREADS)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# bf16: with the same rounding points the two sides differ only where a last
# fp32 bit flips a bf16 rounding; a rounding point moved leaves far fewer
# elements bit-equal (test_moved_rounding_point_falls_below)
MIN_EQUAL_SHARE = 0.99


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    """<case>/<dtype>/<name> -> float32 array, from the Pallas kernels."""
    return mega_reference_subprocess(
        tmp_path_factory.mktemp("mega") / "pallas.npz")


def _weights(layer, dtype, ln_dtype=None):
    """BlockWeights from a numpy layer; ``ln_dtype`` leaves the LayerNorm
    parameters in another type than the compute dtype (a rounding point
    done wrong)."""
    return MB.BlockWeights(*(
        torch.from_numpy(layer[k]).to(
            ln_dtype if ln_dtype and k.startswith("ln") else dtype)
        for k in MB.BlockWeights._fields))


def _port(name, dtype, ln_dtype=None):
    """The three plain twins chained as FusedBlock chains the kernels ->
    float32 numpy arrays under the Pallas reference's names."""
    b, s, d, heads, f, causal, quick = MEGA_CASES[name]
    x, dy, layer = mega_case_inputs(name)
    w = _weights(layer, dtype, ln_dtype)
    x, dy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    y, x2 = MB.block_fwd_reference(x, w, heads, causal, quick)
    dx2, d_fc_w, d_fc_b, d_proj_w, d_proj_b, d_ln2_w, d_ln2_b = \
        MB.mlp_bwd_reference(x2, dy, w, quick)
    dx, d_in_w, d_in_b, d_out_w, d_out_b, d_ln1_w, d_ln1_b = \
        MB.attn_bwd_reference(x, dx2, w, heads, causal)
    grads = MB.BlockWeights(d_in_w, d_in_b, d_out_w, d_out_b, d_ln1_w,
                            d_ln1_b, d_ln2_w, d_ln2_b, d_fc_w, d_fc_b,
                            d_proj_w, d_proj_b)
    out = {"y": y, "x2": x2, "dx": dx}
    # the parameter gradients leave the block cast to the compute dtype
    out.update({k: g.to(dtype) for k, g in zip(grads._fields, grads)})
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("case", sorted(MEGA_CASES))
def test_fp32_plain_twins_match_pallas_interpret(pallas, case):
    """fp32: the same math summed in another order.  Forward 2e-6 and
    gradients 1e-5 relative + 1e-6, each of its array's scale (the bounds of
    tests/test_megablock.py)."""
    got = _port(case, torch.float32)
    for name, g in got.items():
        ref = pallas[f"{case}/float32/{name}"]
        scale = max(1.0, float(np.abs(ref).max()))
        if name in ("y", "x2"):
            np.testing.assert_allclose(g, ref, rtol=0, atol=2e-6 * scale,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=name)


@pytest.mark.parametrize("case", sorted(MEGA_CASES))
def test_bf16_plain_twins_match_pallas_interpret(pallas, case):
    """bf16: 8e-3 of each array's scale (one bf16 ulp of its largest
    value), and y, x2 and dx bit-equal in MIN_EQUAL_SHARE of their
    elements: the rounding points are the Pallas kernels'."""
    got = _port(case, torch.bfloat16)
    for name, g in got.items():
        ref = pallas[f"{case}/bfloat16/{name}"]
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(g, ref, rtol=0, atol=8e-3 * scale,
                                   err_msg=name)
    for name in ("y", "x2", "dx"):
        share = np.mean(got[name] == pallas[f"{case}/bfloat16/{name}"])
        assert share >= MIN_EQUAL_SHARE, (name, share)


def _unrounded_p(q, k, v, heads, causal=False):
    """mha_packed_reference with p left in fp32 before p.v."""
    out = FA._fwd_math(*(FA._split_heads(t, heads) for t in (q, k, v)),
                       causal, None)
    return FA._merge_heads(out, q.dtype)


@pytest.mark.parametrize("wrong", ["ln_params_unrounded", "p_unrounded"])
def test_moved_rounding_point_falls_below(pallas, monkeypatch, wrong):
    """One rounding point moved (the LayerNorm scale and bias used in fp32
    instead of rounded to bf16 first; p not rounded before p.v): every
    output still meets the bf16 bound, but y, x2 or dx is bit-equal to the
    Pallas kernels in fewer than MIN_EQUAL_SHARE of its elements (0.31-0.74
    of them, against all of them with the points in place)."""
    case = "image_quick"
    if wrong == "p_unrounded":
        monkeypatch.setattr(FA, "mha_packed_reference", _unrounded_p)
        got = _port(case, torch.bfloat16)
    else:
        got = _port(case, torch.bfloat16, ln_dtype=torch.float32)
    shares = []
    for name in ("y", "x2", "dx"):
        ref = pallas[f"{case}/bfloat16/{name}"]
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got[name], ref, rtol=0,
                                   atol=2 * 8e-3 * scale, err_msg=name)
        shares.append(np.mean(got[name] == ref))
    assert min(shares) < MIN_EQUAL_SHARE, shares


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_block_function_chains_the_plain_twins(dtype):
    """fused_block on CPU tensors is the autograd Function of the card with
    the plain twins inside: its y and its 13 gradients are exactly theirs
    (parameter gradients cast to the compute dtype), no launch is counted,
    and between forward and backward it keeps x, x2 and its weight inputs,
    nothing else."""
    case = "text_gelu"
    b, s, d, heads, f, causal, quick = MEGA_CASES[case]
    x_np, dy_np, layer = mega_case_inputs(case)
    dt = DTYPES[dtype]
    w = MB.BlockWeights(*(t.requires_grad_(True)
                          for t in _weights(layer, dt)))
    x = torch.from_numpy(x_np).to(dt).requires_grad_(True)
    before = (MB.LAUNCHES_MEGA, MB.LAUNCHES_MEGA_MLP_BWD,
              MB.LAUNCHES_MEGA_ATTN_BWD)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = MB.fused_block(x, w, heads, causal, quick)
    grads = torch.autograd.grad(y, (x, *w), torch.from_numpy(dy_np).to(dt))
    assert (MB.LAUNCHES_MEGA, MB.LAUNCHES_MEGA_MLP_BWD,
            MB.LAUNCHES_MEGA_ATTN_BWD) == before
    ref = _port(case, dt)
    np.testing.assert_array_equal(y.detach().float().numpy(), ref["y"])
    for name, g in zip(("dx",) + MB.BlockWeights._fields, grads):
        assert g.dtype == dt, name
        np.testing.assert_array_equal(g.float().numpy(), ref[name],
                                      err_msg=name)
    inputs = {t.data_ptr() for t in (x, *w)}
    extra = [t for t in saved if t.data_ptr() not in inputs]
    assert len(saved) == 14 and len(extra) == 1          # x2 alone
    np.testing.assert_array_equal(extra[0].float().numpy(), ref["x2"])
    assert type(y.grad_fn).__name__ == "FusedBlockBackward"


def test_pick_block_imgs_matches_swat_tpu():
    for batch in (1, 3, 4, 5, 7, 96, 256):
        for sp in (8, 16, 56, 80, 200, 264):
            assert MB.pick_block_imgs(batch, sp) == JM.pick_block_imgs(
                batch, sp)


# ---------------------------------------------------------------------------
# tower level: the configs of tests/test_megablock.py in both packages


def _cfg(mod, quick: bool):
    return mod.CLIPConfig(
        name="tiny-mega",
        vision=mod.VisionConfig(image_size=32, patch_size=16, width=64,
                                layers=3, heads=4, embed_dim=48,
                                quick_gelu=quick),
        text=mod.TextConfig(context_length=12, vocab_size=100, width=64,
                            layers=2, heads=4, embed_dim=48,
                            quick_gelu=quick))


@pytest.fixture(scope="module", params=[True, False],
                ids=["quickgelu", "gelu"])
def towers(request):
    """One seeded state dict (LayerNorm scale and bias random) as the port's
    model and the JAX package's param tree, with images and token ids."""
    quick = request.param
    cfg, jcfg = _cfg(configs, quick), _cfg(jax_configs, quick)
    sd = random_state_dict(cfg, seed=3)
    rng = np.random.default_rng(7)
    for k, v in sd.items():
        if "ln_" in k:      # ln_1, ln_2, ln_pre, ln_post, ln_final
            v += torch.from_numpy(
                (0.1 * rng.standard_normal(tuple(v.shape))).astype(
                    np.float32))
    params, _ = jax_params_from_state_dict(sd, cfg)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(0, 99, (5, 12))
    tokens[:, 7] = 99
    return cfg, jcfg, sd, params, images, tokens


def _model(cfg, sd, precision):
    model = CLIPModel(cfg, precision=precision)
    model.load_state_dict(sd)
    return model


PRECISIONS = {"float32": (FP32_PRECISION, JAX_FP32, 2e-6),
              "bfloat16": (DEFAULT_PRECISION, JAX_BF16, 8e-3)}


@pytest.mark.parametrize("dtype", sorted(PRECISIONS))
def test_towers_forward_match_functional_use_mega(towers, dtype):
    """Normalized features of both towers through use_mega, fp32 2e-6 and
    bf16 8e-3 absolute (the bounds of tests/test_megablock.py)."""
    cfg, jcfg, sd, params, images, tokens = towers
    precision, jprecision, atol = PRECISIONS[dtype]
    model = _model(cfg, sd, precision)
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images), normalize=True,
                                 use_mega=True).numpy()
        txt = model.encode_text(torch.from_numpy(tokens), normalize=True,
                                use_mega=True).numpy()
    jimg = F.vit_encode_image(params["visual"], jnp.asarray(images),
                              jcfg.vision, jprecision, normalize=True,
                              use_mega=True)
    jtxt = F.text_encode(params["text"], jnp.asarray(tokens), jcfg.text,
                         jprecision, normalize=True, use_mega=True)
    np.testing.assert_allclose(img, np.asarray(jimg), rtol=0, atol=atol)
    np.testing.assert_allclose(txt, np.asarray(jtxt), rtol=0, atol=atol)


def test_use_mega_matches_the_ordinary_route(towers):
    """fp32: the fused route is the ordinary one's math (its exact gelu
    through the rational erf, within 1.5e-7 of erf)."""
    cfg, _, sd, _, images, tokens = towers
    model = _model(cfg, sd, FP32_PRECISION)
    with torch.no_grad():
        for encode, inp in ((model.encode_image, images),
                            (model.encode_text, tokens)):
            np.testing.assert_allclose(
                encode(torch.from_numpy(inp), normalize=True,
                       use_mega=True).numpy(),
                encode(torch.from_numpy(inp), normalize=True).numpy(),
                rtol=0, atol=2e-6)


def test_fused_transformer_matches_swat_tpu_and_ignores_block_imgs(towers):
    """The block stack alone on random x [3, 5, 64], fp32: equal to the JAX
    package's fused_transformer (which pads S = 5 to 8), whatever
    ``block_imgs``; a ``block_imgs`` that does not divide the batch raises,
    as there."""
    cfg, jcfg, sd, params, _, _ = towers
    model = _model(cfg, sd, FP32_PRECISION)
    x = np.random.default_rng(5).standard_normal((3, 5, 64)).astype(
        np.float32)
    v = cfg.vision
    kw = dict(heads=v.heads, quick_gelu=v.quick_gelu, causal=False,
              compute_dtype=torch.float32)
    blocks = model.visual.transformer.resblocks
    with torch.no_grad():
        got = MB.fused_transformer(blocks, torch.from_numpy(x), **kw)
        for bi in (1, 3):
            assert torch.equal(got, MB.fused_transformer(
                blocks, torch.from_numpy(x), block_imgs=bi, **kw))
        with pytest.raises(ValueError, match="must divide batch"):
            MB.fused_transformer(blocks, torch.from_numpy(x), block_imgs=2,
                                 **kw)
    ref = JM.fused_transformer(
        params["visual"]["transformer"], jnp.asarray(x), heads=v.heads,
        layers=v.layers, quick_gelu=v.quick_gelu, causal=False,
        compute_dtype=jnp.float32, block_imgs=1)
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6 * scale)


def _torch_grads(model, prefix):
    return {k: p.grad.numpy() for k, p in model.named_parameters()
            if p.grad is not None and k.startswith(prefix)}


def _assert_grads_match(got, jgrads, prefix, n_min):
    """Every gradient of the tower against the JAX package's, each to 1e-5
    of its own scale (fp32 summation order; the bound of
    tests/test_megablock.py's text test)."""
    ref = {k: np.asarray(v) for k, v in params_to_torch_state_dict(
        jgrads, 0.0).items()}
    names = [k for k in ref if k.startswith(prefix) and k in got]
    assert len(names) >= n_min and set(got) <= set(ref)
    for k in names:
        tol = 1e-5 * max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=tol,
                                   err_msg=k)


def test_image_tower_gradients_match_functional_use_mega(towers):
    cfg, jcfg, sd, params, images, _ = towers
    rng = np.random.default_rng(11)
    head = rng.standard_normal((7, cfg.embed_dim)).astype(np.float32)
    labels = np.asarray([0, 1, 2, 3])

    def jloss(p):
        f = F.vit_encode_image(p["visual"], jnp.asarray(images), jcfg.vision,
                               JAX_FP32, normalize=True, use_mega=True)
        logp = jax.nn.log_softmax(f @ jnp.asarray(head).T)
        return -jnp.mean(logp[jnp.arange(4), jnp.asarray(labels)])

    jval, jgrads = jax.value_and_grad(jloss)(params)
    model = _model(cfg, sd, FP32_PRECISION)
    feats = model.encode_image(torch.from_numpy(images), normalize=True,
                               use_mega=True)
    loss = torch.nn.functional.cross_entropy(
        feats @ torch.from_numpy(head).t(), torch.from_numpy(labels))
    loss.backward()
    assert loss.item() == pytest.approx(float(jval), rel=1e-6)
    # 12 tensors a block, and the tower's own
    _assert_grads_match(_torch_grads(model, "visual."), jgrads, "visual.",
                        12 * cfg.vision.layers + 7)


def test_text_tower_gradients_match_functional_use_mega(towers):
    """The causal backward path."""
    cfg, jcfg, sd, params, _, tokens = towers
    ramp = np.arange(cfg.embed_dim, dtype=np.float32)

    def jloss(p):
        f = F.text_encode(p["text"], jnp.asarray(tokens), jcfg.text,
                          JAX_FP32, normalize=True, use_mega=True)
        return jnp.sum(f * ramp)

    jval, jgrads = jax.value_and_grad(jloss)(params)
    model = _model(cfg, sd, FP32_PRECISION)
    feats = model.encode_text(torch.from_numpy(tokens), normalize=True,
                              use_mega=True)
    loss = (feats * torch.from_numpy(ramp)).sum()
    loss.backward()
    assert loss.item() == pytest.approx(float(jval), rel=1e-5)
    got = {k: v for k, v in _torch_grads(model, "").items()
           if not k.startswith("visual.")}
    _assert_grads_match(got, jgrads, "", 12 * cfg.text.layers + 5)


# ---------------------------------------------------------------------------
# three finetune steps in lock step

N_STEPS, BSZ = 3, 6
LR_HEAD, LR_BB, TOTAL_ITER = 1e-2, 1e-4, 10


def _lr_sum(base):
    schedule = make_lr_schedule(base, TOTAL_ITER,
                                warmup_lr=default_warmup_lr(LR_BB))
    return sum(schedule(i) for i in range(N_STEPS))


def test_use_mega_steps_match_a_swat_tpu_use_mega_step(towers):
    """Three finetune (CE) steps on normalized image batches with the image
    tower through use_mega, against a JAX step built as
    scripts/ablate_mega.py builds it (value_and_grad of the loss through
    vit_encode_image(use_mega=True), then create_train_state's optimizer;
    swat_tpu's step makers take no use_mega): the losses, logit_scale, and
    the head and every visual tensor by the gradient-conditioned delta rule
    of tests/test_torch_train_steps.py; the text tower stays bit-unchanged."""
    cfg, jcfg, sd, params, _, _ = towers
    rng = np.random.default_rng(21)
    head = rng.standard_normal((3, cfg.embed_dim)).astype(np.float32)
    head /= np.linalg.norm(head, axis=-1, keepdims=True)
    images = rng.standard_normal((N_STEPS, BSZ, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (N_STEPS, BSZ))

    jstate, tx = jax_create_state(params, head, "finetune",
                                  lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                                  total_iter=TOTAL_ITER)

    def jloss(tr, x, y):
        feats = F.vit_encode_image(tr["model"]["visual"], x, jcfg.vision,
                                   JAX_FP32, normalize=True, use_mega=True)
        logits = jax_head_logits(tr["head"], feats) * jnp.exp(
            tr["logit_scale"])
        return jax_mixup_criterion(jax_cross_entropy, logits, y, y, 1.0,
                                   None)

    @jax.jit
    def jstep(st, x, y):
        val, grads = jax.value_and_grad(jloss)(st.trainable, x, y)
        updates, new_opt = tx.update(grads, st.opt_state, st.trainable)
        new_tr = jax.tree_util.tree_map(lambda p, u: p + u, st.trainable,
                                        updates)
        return st.replace_trainable(new_tr, opt_state=new_opt,
                                    step=st.step + 1), val

    j_losses = []
    for x, y in zip(images, labels):
        jstate, val = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        j_losses.append(float(val))
    j_model = {k: np.asarray(v) for k, v in params_to_torch_state_dict(
        jstate.model, 0.0).items()}

    model = _model(cfg, sd, FP32_PRECISION)
    state = create_train_state(model, torch.from_numpy(head), "finetune",
                               lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                               total_iter=TOTAL_ITER)
    step = make_ce_step(image_size=32, use_mega=True)
    g0, p_losses = {}, []
    for x, y in zip(images, labels):
        batch = {"images": torch.from_numpy(x), "labels": y,
                 "source": np.zeros(BSZ, np.int64)}
        p_losses.append(float(step(state, batch, None)))
        if not g0:
            g0 = {f"model.{k}": p.grad.detach().clone().numpy()
                  for k, p in model.named_parameters() if p.grad is not None}
            g0["head"] = state.head.grad.detach().clone().numpy()

    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-5, atol=1e-6)
    assert state.logit_scale.item() == pytest.approx(
        float(jstate.logit_scale), abs=1e-5)
    sd_out = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    moved = delta_check("head", head, np.asarray(jstate.head),
                        state.head.detach().numpy(), g0["head"],
                        _lr_sum(LR_HEAD), 0.0)
    for k, ref in j_model.items():
        if k == "logit_scale":
            continue
        init = sd[k].numpy()
        if not k.startswith("visual."):
            np.testing.assert_array_equal(sd_out[k], init, err_msg=k)
            np.testing.assert_array_equal(ref, init, err_msg=k)
            continue
        moved += delta_check(k, init, ref, sd_out[k], g0[f"model.{k}"],
                             _lr_sum(LR_BB), N_STEPS * LR_BB * 1.5)
    assert moved == sum(k.startswith("visual.") for k in j_model) + 1
