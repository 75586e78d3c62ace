"""FLYP (contrastive finetuning of both towers) on the CPU against
swat_tpu: its labels and optimizer groups with --locked_text on and off,
the prompt rows TrainLoader draws for each sample, 3 fp32 steps through
make_flyp_step held by the gradient-conditioned delta rule on both towers,
both projections and logit_scale (the head bit-unchanged), the head the
validating epochs rebuild from the text tower, a stage-1 run through the
port's CLI on into stage 2 (summary line, loss.csv rows, the WiSE-FT
blend of both towers in the stage-1 bundle), and one bf16 step against
swat_tpu's through its Pallas attention kernels (interpret mode) in a
process with XLA's excess precision off."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_steps import (BSZ, LR_BB, LR_HEAD, MODEL,  # noqa: F401
                                    N_STEPS, TOTAL_ITER, setup)
from torch_port_lib import (DATASET, RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, cosine, delta_check,
                            excess_precision_subprocess, jax_crop_draws,
                            loss_rows, make_dataset, random_state_dict,
                            register_dataset, run_kwargs, summary_line)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.data import pipeline as JP
from swat_tpu.data.features import make_text_encoder as jax_text_encoder
from swat_tpu.data.splits import read_split as jax_read_split
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train import stages as JST
from swat_tpu.train import steps as JS
from swat_tpu.train.checkpoint import load_bundle as jax_load_bundle
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu.train.state import make_labels as jax_make_labels
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from swat_tpu_torch.data import pipeline as P
from swat_tpu_torch.data.splits import read_split
from swat_tpu_torch.models.clip import CLIPModel
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.models.head import wise_ft_params
from swat_tpu_torch.models.loader import state_dict_from_jax_params
from swat_tpu_torch.train.checkpoint import load_bundle
from swat_tpu_torch.train.optim import default_warmup_lr, make_lr_schedule
from swat_tpu_torch.train.stages import SwatPipeline
from swat_tpu_torch.train.state import create_train_state
from swat_tpu_torch.train.steps import make_flyp_step

torch.set_num_threads(TORCH_THREADS)

LR_PROJ = 3e-4
LABELS = ("backbone", "projector", "frozen")


def _tokens(rng, n, cfg):
    """``n`` prompt rows of random length: SOT, words, EOT (the largest
    id, where the tower pools), zeros."""
    ctx, vocab = cfg.text.context_length, cfg.text.vocab_size
    tokens = np.zeros((n, ctx), np.int32)
    for i, length in enumerate(rng.integers(2, ctx - 1, n)):
        tokens[i, 0] = vocab - 2
        tokens[i, 1:length] = rng.integers(1, vocab - 3, length - 1)
        tokens[i, length] = vocab - 1
    return tokens


@pytest.mark.parametrize("locked_text", [False, True])
def test_flyp_labels_match_make_labels(setup, locked_text):
    """Every model tensor carries swat_tpu's label: both towers backbone
    (the text tower frozen under --locked_text), visual.proj and
    text_projection projector even then; the head is frozen (in no group)
    and logit_scale trains, in the head group."""
    cfg, sd, params, head = setup[:4]
    ref = jax_make_labels(params, "FLYP", head, locked_text)
    assert ref["head"] == "frozen" and ref["logit_scale"] == "head"
    coded = jax.tree_util.tree_map(
        lambda lab, p: np.full(np.shape(p), LABELS.index(lab), np.float32),
        ref["model"], params)
    ref_sd = params_to_torch_state_dict(coded, 0.0)

    model = CLIPModel(cfg)
    model.load_state_dict(sd)
    state = create_train_state(model, torch.from_numpy(head), "FLYP",
                               total_iter=10, locked_text=locked_text)
    label_of = {id(p): g["label"] for g in state.optimizer.param_groups
                for p in g["params"]}
    for name, p in model.named_parameters():
        got = label_of.get(id(p), "frozen")
        assert p.requires_grad == (got != "frozen"), name
        if name == "logit_scale":          # the module's own, never trained
            assert got == "frozen"
            continue
        assert np.all(ref_sd[name] == LABELS.index(got)), (name, got)
    assert label_of[id(model.text_projection)] == "projector"
    assert label_of[id(state.logit_scale)] == "head"
    assert id(state.head) not in label_of and not state.head.requires_grad


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10,
                                n_retrieved_per_class=10)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config(MODEL), seed=0), ckpt)
    yield dataset_path, ckpt
    undo()


@pytest.mark.parametrize("mode", ["canvas", "host"])
def test_prompt_tokens_match_swat_tpu(dataset, mode):
    """For the same seed, TrainLoader's batches carry the same prompt rows
    (drawn after the batch's order and, in host mode, its images' seeds),
    the same labels and images, over two epochs."""
    root = f"{dataset[0]}/{DATASET}"
    spec = (["fewshot4_seed1.txt", RETRIEVAL_SPLIT], [root] * 2)
    rng = np.random.default_rng(3)
    tokenized = {str(c): rng.integers(0, 500, (2 + c, 16)).astype(np.int32)
                 for c in range(3)}
    kw = dict(batch_size=5, seed=4, mode=mode, n_px=32, num_workers=2,
              tokenized_prompts=tokenized)
    got = P.TrainLoader(read_split(root, spec), **kw)
    ref = JP.TrainLoader(jax_read_split(root, spec), **kw)
    n = 0
    for _ in range(2):
        for g, r in zip(got, ref):
            assert g["prompt_tokens"].dtype == np.int32
            assert g["prompt_tokens"].shape == (5, 16)
            for k in ("prompt_tokens", "labels", "source"):
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            for c, row in zip(g["labels"], g["prompt_tokens"]):
                assert (tokenized[str(c)] == row).all(1).any()
            key = "canvases" if mode == "canvas" else "images"
            np.testing.assert_allclose(g[key], r[key], atol=1.5e-6)
            n += 1
    assert n == 2 * len(got) > 0


def _flyp_batches(setup):
    cfg, batches = setup[0], setup[4]
    rng = np.random.default_rng(9)
    return [dict(b, prompt_tokens=_tokens(rng, BSZ, cfg)) for b in batches]


def _jax_flyp(params, head, batches, keys, locked_text, lr_projector,
              precision=JAX_FP32):
    model = JaxCLIPModel(jax_model_config(MODEL), precision=precision)
    state, tx = jax_create_state(params, head, "FLYP",
                                 lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                                 total_iter=TOTAL_ITER,
                                 lr_projector=lr_projector,
                                 locked_text=locked_text)
    step = JS.make_flyp_step(model, tx, image_size=32)
    losses = []
    for batch, key in zip(batches, keys):
        state, loss = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, key)
        losses.append(float(loss))
    return model, state, losses


@pytest.fixture(scope="module")
def jax_runs(setup):
    """run(locked_text, lr_projector) -> _jax_flyp's (model, state,
    losses) on the setup's weights and FLYP batches, each run once."""
    params, head, keys = setup[2], setup[3], setup[5]
    runs = {}

    def run(locked_text, lr_projector):
        if (locked_text, lr_projector) not in runs:
            runs[locked_text, lr_projector] = _jax_flyp(
                params, head, _flyp_batches(setup), keys, locked_text,
                lr_projector)
        return runs[locked_text, lr_projector]

    return run


def _port_flyp(sd, head, batches, keys, locked_text, lr_projector):
    model = CLIPModel(get_model_config(MODEL), precision=FP32_PRECISION)
    model.load_state_dict(sd)
    state = create_train_state(model, torch.from_numpy(head), "FLYP",
                               lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                               total_iter=TOTAL_ITER,
                               lr_projector=lr_projector,
                               locked_text=locked_text)
    step = make_flyp_step(image_size=32)
    losses, g0 = [], {}
    for batch, key in zip(batches, keys):
        losses.append(float(step(state, batch,
                                 jax_crop_draws(key, batch["valid_hw"]))))
        if not g0:
            g0 = {k: p.grad.detach().clone().numpy()
                  for k, p in model.named_parameters() if p.grad is not None}
    return state, losses, g0


def _lr_sum(base):
    schedule = make_lr_schedule(base, TOTAL_ITER,
                                warmup_lr=default_warmup_lr(LR_BB))
    return sum(schedule(i) for i in range(N_STEPS))


@pytest.mark.parametrize("locked_text,lr_projector", [(False, None),
                                                      (True, LR_PROJ)])
def test_flyp_steps_match_swat_tpu(setup, jax_runs, locked_text,
                                   lr_projector):
    """3 FLYP steps in fp32 from the same weights, canvases (the JAX steps'
    own crops) and prompt rows: the per-step losses (rtol 1e-4: the crop
    resample differs by up to ~1e-2 of 255 between the frameworks),
    logit_scale (1e-5, 0.1 % of one lr_classifier step), every trained
    tensor of both towers and both projections by the delta rule at its
    own summed lr; the text tower but text_projection bit-unchanged under
    --locked_text, and the head bit-unchanged in both packages."""
    cfg, sd, params, head, _, keys, _ = setup
    batches = _flyp_batches(setup)
    _, jstate, j_losses = jax_runs(locked_text, lr_projector)
    state, losses, g0 = _port_flyp(sd, head, batches, keys, locked_text,
                                   lr_projector)

    np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-5)
    assert state.logit_scale.item() == pytest.approx(
        float(jstate.logit_scale), abs=1e-5)
    assert state.logit_scale.item() != pytest.approx(np.log(1 / 0.07),
                                                     abs=1e-4)
    np.testing.assert_array_equal(state.head.detach().numpy(), head)
    np.testing.assert_array_equal(np.asarray(jstate.head), head)
    j_model = params_to_torch_state_dict(jstate.model, 0.0)
    got = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    projector = ("visual.proj", "text_projection")
    moved = 0
    for k, ref in j_model.items():
        if k == "logit_scale":
            continue
        init = sd[k].numpy()
        if locked_text and not k.startswith("visual.") and k not in projector:
            np.testing.assert_array_equal(got[k], init, err_msg=k)
            np.testing.assert_array_equal(ref, init, err_msg=k)
            continue
        lr = (lr_projector or LR_BB) if k in projector else LR_BB
        moved += delta_check(k, init, ref, got[k], g0[k], _lr_sum(lr),
                             N_STEPS * LR_BB * 1.5)
    n_text = sum(not k.startswith("visual.") for k in j_model) - 1
    assert moved == len(j_model) - 1 - (n_text - 1 if locked_text else 0)
    # the embedding's gradient reaches the rows of the tokens up to each
    # prompt's EOT (the tower is causal and pools there) and no other; the
    # rows no batch reaches are decayed by AdamW as optax decays them (the
    # gather's gradient is dense)
    if not locked_text:
        def live(tokens):
            eot = tokens.argmax(1)
            return np.unique(np.concatenate(
                [t[:e + 1] for t, e in zip(tokens, eot)]))

        emb = "token_embedding.weight"
        first = live(batches[0]["prompt_tokens"])
        assert g0[emb][first].any(1).all()
        assert not np.delete(g0[emb], first, axis=0).any()
        unused = np.setdiff1d(np.arange(cfg.text.vocab_size), np.concatenate(
            [live(b["prompt_tokens"]) for b in batches]))
        assert not np.array_equal(got[emb][unused], sd[emb].numpy()[unused])


def test_post_epoch_head_matches_swat_tpu(setup, jax_runs):
    """The head rebuilt from a trained text tower (3 FLYP steps of
    swat_tpu, loaded into both packages): swat_tpu's _flyp_post_epoch
    against the port's, fp32 text encodes summed in other orders (atol
    1e-5 on unit-norm rows); it moved away from the initial head."""
    cfg, head = setup[0], setup[3]
    jmodel, jstate, _ = jax_runs(False, None)
    rng = np.random.default_rng(11)
    tokenized = {str(c): _tokens(rng, 2 + c, cfg) for c in (2, 0, 1)}
    jpipe = types.SimpleNamespace(
        tokenized_prompts=tokenized,
        _encode_text_fn=lambda p: jax_text_encoder(jmodel, p))
    ref = np.asarray(JST.SwatPipeline._flyp_post_epoch(jpipe)(
        jstate, 1).head)

    model = CLIPModel(cfg, precision=FP32_PRECISION)
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.model), 0.0))
    state = create_train_state(model, torch.from_numpy(head), "FLYP",
                               total_iter=TOTAL_ITER)
    SwatPipeline._flyp_post_epoch(
        types.SimpleNamespace(tokenized_prompts=tokenized), state, 1)
    got = state.head.detach().numpy()
    assert got.shape == ref.shape == (3, cfg.embed_dim)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.abs(got - head).max() > 0.1


def test_flyp_train_checkpoint_round_trip(setup, tmp_path):
    """--save_ckpt / --resume of a FLYP run: its optimizer holds no head
    (logit_scale stands for it), and a checkpoint restores the weights,
    logit_scale, the step and the AdamW moments of every group."""
    from swat_tpu_torch.train.checkpoint import (load_train_ckpt,
                                                 save_train_ckpt)

    cfg, sd, params, head, _, keys, _ = setup
    batch = _flyp_batches(setup)[0]
    states = []
    for _ in range(2):
        model = CLIPModel(cfg, precision=FP32_PRECISION)
        model.load_state_dict(sd)
        states.append(create_train_state(
            model, torch.from_numpy(head), "FLYP", total_iter=TOTAL_ITER,
            lr_projector=LR_PROJ))
    saved, fresh = states
    make_flyp_step(image_size=32)(saved, batch,
                                  jax_crop_draws(keys[0], batch["valid_hw"]))
    path = save_train_ckpt(str(tmp_path), "ep1_it1", saved, {})
    load_train_ckpt(path, fresh)
    assert fresh.step == saved.step == 1
    assert fresh.logit_scale.item() == saved.logit_scale.item()
    for k, v in saved.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for g_saved, g_fresh in zip(saved.optimizer.param_groups,
                                fresh.optimizer.param_groups):
        assert g_saved["label"] == g_fresh["label"]
        for p, q in zip(g_saved["params"], g_fresh["params"]):
            for slot in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(saved.optimizer.state[p][slot],
                                   fresh.optimizer.state[q][slot])


STAGE1 = dict(data_source="fewshot+retrieved", retrieval_split=RETRIEVAL_SPLIT,
              epochs=2, compute_dtype="float32", lr_classifier=1e-2,
              lr_backbone=1e-4, aug_mode="eval", bsz=8)


def _bundle(output_dir, stage):
    import glob

    (path,) = glob.glob(f"{output_dir}/stage{stage}_model_best-epoch_*"
                        "_best.msgpack")
    return path


def test_flyp_cli_matches_swat_tpu(dataset, tmp_path, capsys):
    """FLYP through the port's CLI and swat_tpu's pipeline, --aug_mode eval,
    2 epochs at bsz 8, then stage 2 (probing, few-shot finetuning): the
    summary line, all 22 loss.csv rows, and the stage-1 bundle's WiSE-FT
    backbone: both towers blended halfway with the pretrained ones (the
    text tower too), in both packages, and equal across them to the
    towers' own agreement (the trained towers differ by the delta rule's
    2 % of their deltas: atol 1e-5; the K bias, which has no gradient, by
    Adam's walk)."""
    from swat_tpu_torch.cli.main import main

    dataset_path, ckpt = dataset
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt, method="FLYP",
        **STAGE1)).derived())
    jax_summary = jax_pipe.run()
    jax_pipe.loss_logger.close()
    capsys.readouterr()
    yml = tmp_path / "config.yml"
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    main(["--dataset", DATASET, "--method", "FLYP", "--data_source",
          "fewshot+retrieved", "--retrieval_split", RETRIEVAL_SPLIT,
          "--model_cfg", MODEL, "--shots", "4", "--config_yml", str(yml),
          "--checkpoint_path", ckpt, "--num_workers", "2", "--folder",
          str(tmp_path / "port"), "--mesh_data", "1", "--device", "cpu",
          "--recal_prompt", "--bsz", "8", "--epochs", "2",
          "--lr_classifier", "1e-2", "--lr_backbone", "1e-4",
          "--aug_mode", "eval"])
    summary = summary_line(capsys.readouterr().out)
    assert summary == jax_summary
    fields = summary.split(",")
    assert fields[1] == "FLYP" and all(float(x) >= 0 for x in fields[7:])
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", method="FLYP", **STAGE1)).derived()
    got, ref = loss_rows(cfg.output_dir), loss_rows(jax_pipe.cfg.output_dir)
    assert len(got) == 22
    assert_rows_match(got, ref)
    assert got[0][4] == -1 and got[1][4] >= 0   # validates at epoch 2 only

    pretrained = torch.load(ckpt)
    for out_dir, load in ((cfg.output_dir, load_bundle),
                          (jax_pipe.cfg.output_dir, jax_load_bundle)):
        arrays = load(_bundle(out_dir, 1))[0]
        trained, blend = (state_dict_from_jax_params(arrays[key], 0.0)
                          for key in ("clip", "wsft_backbone"))
        want = wise_ft_params(trained, pretrained, 0.5)
        for k in ("text_projection", "token_embedding.weight",
                  "transformer.resblocks.0.attn.in_proj_weight",
                  "visual.proj"):
            assert not torch.equal(trained[k], pretrained[k]), k
            torch.testing.assert_close(blend[k], want[k], rtol=0,
                                       atol=1e-7)
        if load is load_bundle:
            port_blend = blend
    steps = 2 * (len(read_split(cfg.dataset_root, cfg.train_split)) // 8)
    for k, v in blend.items():
        if k == "logit_scale":
            continue
        got = port_blend[k]
        if k.endswith("attn.in_proj_bias"):
            # the K third has exactly zero gradient: Adam walks it on
            # rounding noise by up to lr a step in either package, halved
            # by the blend
            d = v.shape[0] // 3
            assert (got[d:2 * d] - v[d:2 * d]).abs().max() <= steps * LR_BB
            got, v = got[np.r_[0:d, 2 * d:3 * d]], v[np.r_[0:d, 2 * d:3 * d]]
        torch.testing.assert_close(got, v, rtol=0, atol=1e-5)


# one bf16 step against swat_tpu: both run the attention kernels' rounding
# points (the port's plain versions, swat_tpu's Pallas kernels in interpret
# mode) and round every matmul operand and the residual stream to bf16, but
# sum in other orders, so a rounding can land one bf16 ulp apart: each
# gradient is held at the towers' bf16 bound (tests/test_torch_towers.py)
# and the loss, a mean of fp32 cross-entropies over bf16 features scaled by
# 1/0.07, to 1e-2 relative (measured at test_tiny: min cosine 0.99978, the
# losses 1.4e-3 apart).  At these widths the same step in fp32 is as close
# (0.9997-0.9999): the check holds the step's structure in the bf16 policy,
# not its rounding points, which the kernels' plain versions hold bit for
# bit against the Pallas kernels (tests/test_torch_attention_bwd.py)
BF16_MIN_COS = 1 - 1e-3
BF16_LOSS_RTOL = 1e-2


def test_flyp_bf16_step_matches_swat_tpu(setup, tmp_path):
    """One FLYP step in the bf16 policy: the loss, and the gradient of every
    tensor of both towers and of logit_scale, the port's (its attention
    kernels' plain versions) against swat_tpu's make_flyp_step with its
    Pallas kernels in interpret mode, run in a subprocess with
    ``--xla_allow_excess_precision=false`` (by default XLA on the CPU drops
    a cast to bf16 that a cast back follows)."""
    cfg, sd, params, head, _, keys, _ = setup
    batch = _flyp_batches(setup)[0]
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, model_cfg=MODEL, head=head, key_seed=7,
             **{f"sd/{k}": v.numpy() for k, v in sd.items()},
             **{k: batch[k] for k in ("canvases", "valid_hw", "labels",
                                      "source", "prompt_tokens")})
    out = tmp_path / "ref.npz"
    ref = excess_precision_subprocess(
        f"flyp_bf16_reference({str(inputs)!r}, {str(out)!r})", out)

    model = CLIPModel(cfg, precision=DEFAULT_PRECISION)
    model.load_state_dict(sd)
    state = create_train_state(model, torch.from_numpy(head), "FLYP",
                               total_iter=10)
    loss = float(make_flyp_step(image_size=32)(
        state, batch, jax_crop_draws(jax.random.PRNGKey(7),
                                     batch["valid_hw"])))
    assert loss == pytest.approx(float(ref["loss"]), rel=BF16_LOSS_RTOL)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()
             if p.grad is not None}
    grads["logit_scale"] = state.logit_scale.grad.numpy()
    assert len(grads) == len(ref) - 1
    worst = 1.0
    for k, g in grads.items():
        r = ref["logit_scale" if k == "logit_scale" else f"model/{k}"]
        if not np.abs(r).max():
            continue
        c = float(cosine(g.reshape(1, -1), r.reshape(1, -1))[0])
        assert c >= BF16_MIN_COS, (k, c)
        worst = min(worst, c)
    assert worst < 1.0          # bf16: the two differ somewhere
