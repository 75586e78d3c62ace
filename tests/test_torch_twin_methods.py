"""The twin-loader methods of the port (finetune-mixed, cutmix-fs, mixup-fs,
CMO) on the CPU against swat_tpu: CMO's and mixup-fs's mixes bit for bit
in fp32 and bf16, fed the JAX package's own draws
(torch_port_lib.jax_mix_draws); the second loaders (CyclingLoader,
WeightedSampler, WeightedTrainLoader) batch for batch; the host samplers;
3 lock-step train steps of each method at mix_prob 1 through the streaming
step and the resident epoch, held by the delta rule of
tests/test_torch_train_steps.py; the resident epochs' primary and twin
permutations; and a stage-1 cutmix-fs run through the CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_steps import (BSZ, CANVAS, LR_BB, LR_HEAD, MODEL,
                                    N_STEPS, TOTAL_ITER, _grads, _lr_sum,
                                    _port_state, setup)  # noqa: F401
from torch_port_lib import (DATASET, RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, delta_check, jax_mix_draws,
                            jax_step_draws, loss_rows, make_dataset,
                            random_state_dict, register_dataset, run_kwargs,
                            summary_line)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.core.precision import FP32_PRECISION as JAX_FP32
from swat_tpu.data import pipeline as JP
from swat_tpu.data.splits import read_split as jax_read_split
from swat_tpu.kernels import augment as jaug
from swat_tpu.models.clip import CLIPModel as JaxCLIPModel
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu.models.loader import params_to_torch_state_dict
from swat_tpu.train import steps as JS
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu.train.state import create_train_state as jax_create_state
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.data import pipeline as P
from swat_tpu_torch.data.splits import read_split
from swat_tpu_torch.kernels import augment as aug
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.resident import ResidentData, make_resident_epoch
from swat_tpu_torch.train.stages import SwatPipeline
from swat_tpu_torch.train.steps import (StepDraws, make_ce_step,
                                        make_mix_fn, make_mixing_step,
                                        make_sampler)

torch.set_num_threads(TORCH_THREADS)

B, SIZE = 5, 16
TWIN_METHODS = ("finetune-mixed", "cutmix-fs", "mixup-fs", "CMO")
# the twin batch: half the batch for the joining methods (fewshot_ratio
# 0.5), the whole batch for the two that mix row against row
TWIN_BSZ = {"finetune-mixed": 3, "cutmix-fs": 3, "mixup-fs": BSZ,
            "CMO": BSZ}
N_TWIN = 10


def _batch(seed, size=SIZE, b=B):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    images[0, 0, 0] = [-0.0, 0.0, -1.0]          # signed zeros on both sides
    labels = rng.integers(0, 3, b).astype(np.int32)
    return images, labels


def _same(got, ref):
    assert got.dtype == {jnp.float32: torch.float32,
                         jnp.bfloat16: torch.bfloat16}[ref.dtype.type]
    g = got.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(np.signbit(g), np.signbit(r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mix_prob,beta", [(1.0, 1.0), (0.5, 1.0),
                                           (0.0, 1.0), (1.0, 0.0)])
def test_cutmix_from_matches(seed, mix_prob, beta, dtype):
    """CMO's paste from the second batch: images (signed zeros too), labels
    and lambda exactly, in the images' dtype."""
    x1, y1 = _batch(seed)
    x2, y2 = _batch(seed + 50)
    k_mix = jax.random.PRNGKey(600 + seed)
    draws = jax_mix_draws("CMO", k_mix, B, SIZE, beta, mix_prob)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    ref = jaug.cutmix_from(jnp.asarray(x1, jd), jnp.asarray(y1),
                           jnp.asarray(x2, jd), jnp.asarray(y2), k_mix, beta,
                           mix_prob)
    got = aug.cutmix_from(torch.from_numpy(x1).to(td), torch.from_numpy(y1),
                          torch.from_numpy(x2).to(td), torch.from_numpy(y2),
                          draws)
    _same(got[0], ref[0])
    for g, r in zip(got[1:3], ref[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert np.float32(got[3]) == np.float32(ref[3])
    if not draws.gate or beta <= 0:
        assert got[3] == 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mix_prob", [1.0, 0.5, 0.0])
def test_mixup_fs_matches(seed, mix_prob, dtype):
    """One of the two batches whole, through the blend: images bit for bit
    with their signed zeros, in the images' dtype (the weakly typed lambda
    does not promote bf16), labels and lambda."""
    x1, y1 = _batch(seed)
    x2, y2 = _batch(seed + 50)
    x2[0, 0, 0] = [0.0, -0.0, -0.0]
    k_mix = jax.random.PRNGKey(700 + seed)
    draws = jax_mix_draws("mixup-fs", k_mix, B, SIZE, mix_prob=mix_prob)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    ref = jaug.mixup_fs(jnp.asarray(x1, jd), jnp.asarray(y1),
                        jnp.asarray(x2, jd), jnp.asarray(y2), k_mix,
                        mix_prob=mix_prob)
    got = aug.mixup_fs(torch.from_numpy(x1).to(td), torch.from_numpy(y1),
                       torch.from_numpy(x2).to(td), torch.from_numpy(y2),
                       draws)
    _same(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), y1)
    np.testing.assert_array_equal(got[2].numpy(), y2)
    assert got[3] == float(ref[3]) and got[3] in (0.0, 1.0)
    want = x2 if got[3] == 0.0 else x1
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  torch.from_numpy(want).to(td).float())


def test_host_samplers_of_the_twin_mixes():
    rng = np.random.default_rng(3)
    cmo = [aug.sample_cutmix_from(rng, 224, 224, 1.0, 0.5)
           for _ in range(600)]
    assert abs(np.mean([d.gate for d in cmo]) - 0.5) < 0.07
    assert abs(np.mean([d.lam0 for d in cmo]) - 0.5) < 0.05
    assert all(0 <= d.box[0] <= d.box[1] <= 224 for d in cmo)
    assert aug.sample_cutmix_from(rng, 224, 224, 0.0, 1.0).lam0 == 1.0
    fs = [aug.sample_mixup_fs(rng, 0.3).lam for _ in range(600)]
    assert set(fs) == {0.0, 1.0} and abs(fs.count(0.0) / 600 - 0.3) < 0.07
    assert aug.sample_mixup_fs(rng, 1.0).lam == 0.0


@pytest.mark.parametrize("method,draws_type", [
    ("finetune-mixed", type(None)), ("cutmix-fs", aug.CutmixDraws),
    ("mixup-fs", aug.MixupFsDraws), ("CMO", aug.CutmixFromDraws)])
def test_sampler_and_mix_fn_of_twin_batches(method, draws_type):
    """make_sampler draws the twin's crops after the batch's and sizes
    cutmix-fs's permutation to the joined batch; make_mix_fn joins the
    batches primary first (finetune-mixed, cutmix-fs) or keeps the
    batch's size (mixup-fs, CMO)."""
    rng = np.random.default_rng(0)
    tb = TWIN_BSZ[method]
    valid_hw = rng.integers(20, 41, (BSZ, 2)).astype(np.int32)
    twin_hw = rng.integers(20, 41, (tb, 2)).astype(np.int32)
    batch = {"canvases": torch.from_numpy(rng.integers(
                 0, 256, (BSZ, CANVAS, CANVAS, 3), dtype=np.uint8)),
             "valid_hw": valid_hw,
             "labels": torch.arange(BSZ) % 3,
             "source": torch.zeros(BSZ, dtype=torch.long),
             "canvases_fs": torch.from_numpy(rng.integers(
                 0, 256, (tb, CANVAS, CANVAS, 3), dtype=np.uint8)),
             "valid_hw_fs": twin_hw, "labels_fs": torch.arange(tb) % 3,
             "source_fs": torch.ones(tb, dtype=torch.long)}
    draws = make_sampler(method, mix_prob=1.0, image_size=32)(
        np.random.default_rng(1), batch)
    assert isinstance(draws.mix, draws_type)
    assert draws.crops.boxes.shape == (BSZ, 4)
    assert draws.twin_crops.boxes.shape == (tb, 4)
    if method == "cutmix-fs":
        assert sorted(draws.mix.perm) == list(range(BSZ + tb))
    images, y_a, y_b, lam, lam_vec, source = make_mix_fn(
        method, image_size=32)(None, batch, draws)
    n = BSZ + tb if method in ("finetune-mixed", "cutmix-fs") else BSZ
    assert images.shape == (n, 32, 32, 3) and lam_vec is None
    assert y_a.shape == y_b.shape == source.shape == (n,)
    if n > BSZ:
        assert source.tolist() == [0] * BSZ + [1] * tb
    with pytest.raises(ValueError, match="make_ce_step"):
        make_mixing_step("finetune-mixed")


# ---------------------------------------------------------------------------
# the second loaders


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10,
                                n_retrieved_per_class=10)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config("test_tiny"), seed=0), ckpt)
    yield dataset_path, ckpt
    undo()


def _split(dataset_path, name, reader):
    import os

    root = os.path.join(dataset_path, DATASET)
    return reader(root, ((name,), (root,)))


def _unbalanced(samples):
    """Two thirds of class 0 dropped: the inverse-frequency weights differ
    per class."""
    return [s for i, s in enumerate(samples) if s.label or i % 3 == 0]


@pytest.mark.parametrize("cmo_alpha", [1.0, 0.5])
def test_weighted_sampler_matches(dataset, cmo_alpha):
    """The probabilities exactly, and the draws of the same seed."""
    dataset_path, _ = dataset
    got_s = _unbalanced(_split(dataset_path, RETRIEVAL_SPLIT, read_split))
    ref_s = _unbalanced(_split(dataset_path, RETRIEVAL_SPLIT,
                               jax_read_split))
    got = P.WeightedSampler(got_s, 3, cmo_alpha, seed=9)
    ref = JP.WeightedSampler(ref_s, 3, cmo_alpha, seed=9)
    np.testing.assert_array_equal(got.p, ref.p)
    assert got.p[0] > got.p[-1]                     # class 0 is rarer
    for _ in range(3):
        assert [s.path for s in got.draw(7)] == [s.path for s in ref.draw(7)]


@pytest.mark.parametrize("kind", ["cycling", "weighted"])
def test_second_loaders_match(dataset, kind):
    """Five batches (three epochs' worth of a two-batch loader) through
    CyclingLoader over a TrainLoader, or over a WeightedTrainLoader (its
    sampler seeded from the loader's own generator): the same labels,
    source and eval-preprocessed images, batch for batch."""
    dataset_path, _ = dataset
    kw = dict(batch_size=4, seed=3, mode="eval", n_px=32, num_workers=1)
    loaders = []
    for pkg, reader in ((P, read_split), (JP, jax_read_split)):
        samples = _unbalanced(_split(dataset_path, RETRIEVAL_SPLIT, reader))
        if kind == "weighted":
            loader = pkg.WeightedTrainLoader(samples, 3, 1.0, **kw)
        else:
            loader = pkg.TrainLoader(samples[:9], **kw)
        loaders.append(pkg.CyclingLoader(loader))
    for _ in range(5):
        got, ref = (c.next() for c in loaders)
        for key in ("labels", "source", "images"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


# ---------------------------------------------------------------------------
# lock-step train steps


@pytest.fixture(scope="module")
def twin_data():
    """A few-shot twin split of N_TWIN uint8 canvases and, for each method,
    the twin rows of each step."""
    rng = np.random.default_rng(1)
    canvases = np.zeros((N_TWIN, CANVAS, CANVAS, 3), np.uint8)
    valid_hw = rng.integers(20, CANVAS + 1, (N_TWIN, 2)).astype(np.int32)
    for i, (h, w) in enumerate(valid_hw):
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    labels = rng.integers(0, 3, N_TWIN).astype(np.int32)
    source = np.ones(N_TWIN, np.int32)
    rows = {m: (np.arange(N_STEPS * tb) * 3 % N_TWIN).reshape(N_STEPS, tb)
            for m, tb in TWIN_BSZ.items()}
    return (canvases, valid_hw, labels, source), rows


def _with_twin(batch, arrays, rows):
    canvases, valid_hw, labels, source = arrays
    out = dict(batch)
    out.update(canvases_fs=canvases[rows], valid_hw_fs=valid_hw[rows],
               labels_fs=labels[rows], source_fs=source[rows])
    return out


_JAX_RUNS = {}


def _jax_twin_run(method, params, head, batches, keys):
    """swat_tpu's 3 steps, once a method (the streaming and the resident
    test hold the port against the same run)."""
    if method not in _JAX_RUNS:
        _JAX_RUNS[method] = _jax_twin_steps(method, params, head, batches,
                                            keys)
    return _JAX_RUNS[method]


def _jax_twin_steps(method, params, head, batches, keys):
    model = JaxCLIPModel(jax_model_config(MODEL), precision=JAX_FP32)
    state, tx = jax_create_state(params, head, method,
                                 lr_classifier=LR_HEAD, lr_backbone=LR_BB,
                                 total_iter=TOTAL_ITER)
    if method == "finetune-mixed":
        step = JS.make_ce_step(model, tx, concat_fs=True, image_size=32)
    else:
        step = JS.make_mixing_step(model, tx, method, mix_prob=1.0,
                                   image_size=32)
    losses = []
    for batch, key in zip(batches, keys):
        state, loss = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, key)
        losses.append(float(loss))
    model_np = {k: np.asarray(v) for k, v in params_to_torch_state_dict(
        state.model, 0.0).items()}
    return (losses, model_np, np.asarray(state.head),
            float(state.logit_scale))


def _port_twin_run(method, sd, head, batches, all_draws, runner, data,
                   twin_arrays, rows):
    state = _port_state(method, sd, head)
    step = (make_ce_step(image_size=32, concat_fs=True)
            if method == "finetune-mixed"
            else make_mixing_step(method, image_size=32))
    g0 = {}
    losses = []

    def recording(state, batch, draws):
        val = step(state, batch, draws)
        if not g0:
            g0.update(_grads(state))
        losses.append(float(val))
        return val

    if runner == "streaming":
        for b, d in zip(batches, all_draws):
            recording(state, _with_twin(b, twin_arrays, rows[len(losses)]),
                      d)
        return losses, state, g0

    def resident(arrays):
        canvases, valid_hw, labels, source = arrays
        return ResidentData(torch.from_numpy(canvases), valid_hw,
                            torch.from_numpy(labels).long(),
                            torch.from_numpy(source).long())

    draws = iter(all_draws)
    epoch = make_resident_epoch(recording, lambda rng, batch: next(draws))
    perm = np.arange(N_STEPS * BSZ).reshape(N_STEPS, BSZ)
    mean = epoch(state, resident(data), perm, np.random.default_rng(0),
                 resident(twin_arrays), rows)
    assert float(mean) == pytest.approx(np.mean(losses), rel=1e-6)
    return losses, state, g0


@pytest.mark.parametrize("runner", ["streaming", "resident"])
@pytest.mark.parametrize("method", TWIN_METHODS)
def test_twin_steps_match_swat_tpu(setup, twin_data, method,  # noqa: F811
                                   runner):
    """3 lock-step steps at mix_prob 1 against swat_tpu's
    make_mixing_step / make_ce_step(concat_fs=True), the twin batch under
    *_fs keys, the port fed the JAX step's own draws (the twin's crops from
    its k_aug2): per-step losses to rel 1e-5, logit_scale, the head and
    every visual tensor by the delta rule; the text tower bit-unchanged."""
    cfg, sd, params, head, batches, keys, data = setup
    twin_arrays, all_rows = twin_data
    rows = all_rows[method]
    jax_batches = [_with_twin(b, twin_arrays, r)
                   for b, r in zip(batches, rows)]
    draws = [jax_step_draws(k, b["valid_hw"], 32, 1.0, 1.0, method=method,
                            twin_valid_hw=b["valid_hw_fs"])
             for k, b in zip(keys, jax_batches)]
    if method == "cutmix-fs":
        assert all(d.mix.gate and len(d.mix.perm) == BSZ + 3 for d in draws)
    elif method == "CMO":
        assert all(d.mix.gate and d.mix.box[1] > d.mix.box[0]
                   for d in draws)
    elif method == "mixup-fs":
        assert all(d.mix.lam == 0.0 for d in draws)    # mix_prob 1
    j_losses, j_model, j_head, j_ls = _jax_twin_run(
        method, params, head, jax_batches, keys)
    p_losses, state, g0 = _port_twin_run(
        method, sd, head, batches, draws, runner, data, twin_arrays, rows)

    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-5)
    assert state.logit_scale.item() == pytest.approx(j_ls, abs=1e-5)
    sd_out = {k: v.detach().numpy() for k, v in state.model.state_dict(
        ).items()}
    moved = delta_check("head", head, j_head, state.head.detach().numpy(),
                        g0["head"], _lr_sum(LR_HEAD), 0.0)
    lr_sum_bb = _lr_sum(LR_BB)
    for k, ref in j_model.items():
        if k == "logit_scale":
            continue
        init = sd[k].numpy()
        if not k.startswith("visual."):
            np.testing.assert_array_equal(sd_out[k], init, err_msg=k)
            np.testing.assert_array_equal(ref, init, err_msg=k)
            continue
        moved += delta_check(k, init, ref, sd_out[k], g0[f"model.{k}"],
                             lr_sum_bb, N_STEPS * LR_BB * 1.5)
    assert moved == sum(k.startswith("visual.") for k in j_model) + 1


def test_twin_batch_of_images_draws_no_crops():
    """Under --aug_mode eval / host the twin carries images: no crops are
    drawn for either batch, and the twin's images are used as they are."""
    x1, y1 = _batch(1)
    x2, y2 = _batch(2)
    batch = {"images": torch.from_numpy(x1), "labels": torch.from_numpy(y1),
             "source": torch.zeros(B, dtype=torch.long),
             "images_fs": torch.from_numpy(x2),
             "labels_fs": torch.from_numpy(y2),
             "source_fs": torch.ones(B, dtype=torch.long)}
    draws = make_sampler("mixup-fs", mix_prob=1.0, image_size=SIZE)(
        np.random.default_rng(0), batch)
    assert draws.crops is None and draws.twin_crops is None
    assert isinstance(draws, StepDraws) and draws.mix.lam == 0.0
    images, y_a, y_b, lam, _, _ = make_mix_fn("mixup-fs", image_size=SIZE)(
        None, batch, draws)
    np.testing.assert_array_equal(images.numpy(), x2)
    assert lam == 0.0 and y_b.tolist() == y2.tolist()


# ---------------------------------------------------------------------------
# through the pipelines

STAGE1 = dict(data_source="fewshot+retrieved", retrieval_split=RETRIEVAL_SPLIT,
              epochs=2, skip_stage2=True, compute_dtype="float32",
              lr_classifier=1e-2, lr_backbone=1e-4)


@pytest.mark.parametrize("method", ["cutmix-fs", "mixup-fs", "CMO",
                                    "finetune-mixed"])
def test_resident_permutations_match_swat_tpu(dataset, tmp_path,
                                              monkeypatch, method):
    """Each package's resident epochs with the training replaced by a
    recorder: the primary permutation and the twin's (few-shot cycles, or
    CMO's weighted draws with replacement) of both epochs, equal.  Both
    pipelines load a twin split beside the train split."""
    import swat_tpu.train.scan_loop as jax_scan
    from swat_tpu_torch.train import stages

    dataset_path, ckpt = dataset
    seen = {"jax": [], "port": []}

    def jax_make(*args, **kw):
        def run(state, data, perm, key, twin_data=None, twin_perm=None):
            seen["jax"].append((np.asarray(perm), np.asarray(twin_perm),
                                data.n, twin_data.n))
            return state, jnp.float32(0.0)
        return run

    def port_make(step_fn, sample_fn):
        def run(state, data, perm, rng, twin=None, twin_perm=None):
            seen["port"].append((perm, twin_perm, data.n, twin.n))
            return torch.zeros(())
        return run

    monkeypatch.setattr(jax_scan, "make_scan_epoch", jax_make)
    monkeypatch.setattr(stages, "make_resident_epoch", port_make)
    args = dict(STAGE1, method=method, aug_mode="canvas", resident="on",
                bsz=8, no_wsft=True, no_tau=True)
    for name, config, pipeline, kw in (
            ("jax", JaxRunConfig, JaxPipeline, {}),
            ("port", RunConfig, SwatPipeline, {"device": "cpu"})):
        pipe = pipeline(config(**kw, **run_kwargs(
            dataset_path, tmp_path / name, checkpoint_path=ckpt,
            **args)).derived())
        if name == "jax":
            pipe.train_method(pipe.cfg, pipe.params, pipe.head)
        else:
            pipe.train_method(pipe.cfg, pipe.zeroshot_head)
        pipe.loss_logger.close()
    assert len(seen["jax"]) == len(seen["port"]) == 2
    for (gp, gt, gn, gtn), (rp, rt, rn, rtn) in zip(seen["port"],
                                                    seen["jax"]):
        np.testing.assert_array_equal(gp, rp)
        np.testing.assert_array_equal(gt, rt)
        assert (gn, gtn) == (rn, rtn)
    perm, tperm, n, tn = seen["port"][0]
    bsz = perm.shape[1]                # finetune-mixed's config halves it
    assert perm.shape == (n // bsz, bsz) and bsz == (
        4 if method == "finetune-mixed" else 8)
    assert tperm.shape == (n // bsz, bsz if method in ("mixup-fs", "CMO")
                           else bsz // 2)
    assert tn == (n if method == "CMO" else 12)


def test_cutmix_fs_cli_matches_swat_tpu(dataset, tmp_path, capsys):
    """Stage-1 cutmix-fs through the port's CLI and swat_tpu's pipeline,
    --aug_mode eval --mix_prob 0 (no draw decides anything): the summary
    line and both loss.csv rows."""
    from swat_tpu_torch.cli.main import main

    dataset_path, ckpt = dataset
    args = dict(STAGE1, method="cutmix-fs", aug_mode="eval", mix_prob=0.0)
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **args)).derived())
    jax_summary = jax_pipe.run()
    jax_pipe.loss_logger.close()
    capsys.readouterr()
    yml = tmp_path / "config.yml"
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    main(["--dataset", DATASET, "--method", "cutmix-fs", "--data_source",
          "fewshot+retrieved", "--retrieval_split", RETRIEVAL_SPLIT,
          "--model_cfg", "test_tiny", "--shots", "4", "--config_yml",
          str(yml), "--checkpoint_path", ckpt, "--num_workers", "2",
          "--folder", str(tmp_path / "port"), "--mesh_data", "1",
          "--device", "cpu", "--recal_prompt", "--bsz", "4",
          "--aug_mode", "eval", "--mix_prob", "0", "--epochs", "2",
          "--skip_stage2", "--lr_classifier", "1e-2", "--lr_backbone",
          "1e-4"])
    summary = summary_line(capsys.readouterr().out)
    assert summary == jax_summary
    assert summary.split(",")[1] == "cutmix-fs"
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", **args)).derived()
    got, ref = loss_rows(cfg.output_dir), loss_rows(jax_pipe.cfg.output_dir)
    assert len(got) == 2
    assert_rows_match(got, ref)
    assert got[0][4] >= 0            # cutmix-fs validates every epoch
