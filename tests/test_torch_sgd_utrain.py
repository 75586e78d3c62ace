"""--optim SGD and --utrain in the port on the CPU against swat_tpu: SGD
with momentum against optax's add_decayed_weights -> trace(0.9) -> lr
chain over 20 steps; the train samples with pseudo-labeled ones appended
and CMO's sampling probabilities over them; stage-1 runs of CMO with
--utrain and of finetune-mixed with --optim SGD through the port's CLI and
swat_tpu's pipeline; and --optim SGD --save_ckpt then --resume in both
packages, the momentum buffers in the port's checkpoint."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_lib import (DATASET, RETRIEVAL_SPLIT, TORCH_THREADS,
                            assert_rows_match, loss_rows, make_dataset,
                            random_state_dict, register_dataset, run_kwargs,
                            summary_line)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.data.pipeline import WeightedSampler as JaxWeightedSampler
from swat_tpu.train import optim as JO
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.data.pipeline import WeightedSampler
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train import optim as O
from swat_tpu_torch.train.checkpoint import load_bundle
from swat_tpu_torch.train.stages import SwatPipeline

torch.set_num_threads(TORCH_THREADS)


def test_sgd_matches_optax_over_20_steps():
    """Two groups with their own schedules, fed the same gradients: the
    first step's momentum buffer is the decayed gradient g + wd * p (optax's
    trace starts from zeros), and the weights follow optax's to 2e-6 over
    20 steps of lr-sized moves on weights of order 1."""
    rng = np.random.default_rng(1)
    a0 = rng.standard_normal(50).astype(np.float32)
    b0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [(rng.standard_normal(50).astype(np.float32),
              rng.standard_normal((3, 4)).astype(np.float32))
             for _ in range(20)]
    kw = dict(lr_classifier=1e-3, lr_backbone=1e-4, total_iter=15, wd=1e-2,
              optim_type="SGD")

    tx = JO.build_optimizer({"a": "backbone", "b": "head"}, **kw)
    jp = {"a": jnp.asarray(a0), "b": jnp.asarray(b0)}
    opt_state = tx.init(jp)
    pa = torch.nn.Parameter(torch.from_numpy(a0.copy()))
    pb = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    opt = O.build_optimizer({"backbone": [pa], "head": [pb]}, **kw)
    assert isinstance(opt, torch.optim.SGD)
    for step, (ga, gb) in enumerate(grads):
        updates, opt_state = tx.update(
            {"a": jnp.asarray(ga), "b": jnp.asarray(gb)}, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        if step == 0:
            buf_a = pa.detach().numpy() * np.float32(1e-2) + ga
        pa.grad, pb.grad = torch.from_numpy(ga), torch.from_numpy(gb)
        O.set_lr(opt, step)
        opt.step()
        if step == 0:
            np.testing.assert_allclose(
                opt.state[pa]["momentum_buffer"].numpy(), buf_a, rtol=1e-6)
        np.testing.assert_allclose(pa.detach().numpy(), np.asarray(jp["a"]),
                                   rtol=0, atol=2e-6, err_msg=str(step))
        np.testing.assert_allclose(pb.detach().numpy(), np.asarray(jp["b"]),
                                   rtol=0, atol=2e-6, err_msg=str(step))
    assert np.abs(pb.detach().numpy() - b0).max() > 1e-3   # it did move
    with pytest.raises(ValueError, match="AdamW or SGD"):
        O.build_optimizer({"head": [pb]}, **dict(kw, optim_type="Adam"))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The synthetic dataset, a checkpoint and a pseudo-label file over 9
    test images (``<path> <label>`` lines, as swat_tpu's dump writes
    them)."""
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10,
                                n_retrieved_per_class=10)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config("test_tiny"), seed=0), ckpt)
    root = os.path.join(dataset_path, DATASET)
    with open(os.path.join(root, "test.txt")) as f:
        lines = f.read().split("\n")
    pseudo = str(base / "pseudo.txt")
    with open(pseudo, "w") as f:
        for ln in lines[::3][:9]:
            path, label, _ = ln.split(" ")
            # pseudo-labels: the true one, except for every third image
            f.write(f"{os.path.join(root, path)} "
                    f"{(int(label) + (len(path) % 3 == 0)) % 3}\n")
    yield dataset_path, ckpt, pseudo
    undo()


STAGE1 = dict(data_source="fewshot+retrieved", retrieval_split=RETRIEVAL_SPLIT,
              aug_mode="eval", mix_prob=0.0, epochs=2, skip_stage2=True,
              compute_dtype="float32", lr_classifier=1e-2, lr_backbone=1e-4)


def test_train_samples_with_utrain_match_swat_tpu(dataset, tmp_path):
    """The train split plus the pseudo-labeled samples (retrieved, unless
    the file says otherwise), and CMO's inverse-frequency probabilities
    over them, exactly."""
    dataset_path, ckpt, pseudo = dataset
    args = dict(STAGE1, method="CMO", utrain=pseudo)
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **args)).derived())
    port = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port", checkpoint_path=ckpt,
        **args)).derived())
    got = port._train_samples(port.cfg)
    ref = jax_pipe._train_samples(jax_pipe.cfg)
    for pipe in (jax_pipe, port):
        pipe.loss_logger.close()
    assert [(s.path, s.label, s.is_fewshot) for s in got] == [
        (s.path, s.label, s.is_fewshot) for s in ref]
    assert len(got) == 12 + 30 + 9 and got[-1].is_fewshot == 0
    p = WeightedSampler(got, 3, 0.7).p
    np.testing.assert_array_equal(p, JaxWeightedSampler(ref, 3, 0.7).p)
    assert len(set(p.round(12))) > 1


def _cli_args(dataset_path, ckpt, folder, method, extra):
    return ["--dataset", DATASET, "--method", method, "--data_source",
            "fewshot+retrieved", "--retrieval_split", RETRIEVAL_SPLIT,
            "--model_cfg", "test_tiny", "--shots", "4", "--config_yml",
            os.path.join(folder, "config.yml"), "--checkpoint_path", ckpt,
            "--num_workers", "2", "--folder", folder, "--mesh_data", "1",
            "--device", "cpu", "--recal_prompt", "--bsz", "4",
            "--aug_mode", "eval", "--mix_prob", "0", "--epochs", "2",
            "--skip_stage2", "--lr_classifier", "1e-2", "--lr_backbone",
            "1e-4", *extra]


@pytest.mark.parametrize("method,extra,kw", [
    ("CMO", ["--utrain", None], {"utrain": None}),
    ("finetune-mixed", ["--optim", "SGD"], {"optim": "SGD"})])
def test_cli_runs_match_swat_tpu(dataset, tmp_path, capsys, method, extra,
                                 kw):
    """Stage 1 through the port's CLI and swat_tpu's pipeline, --aug_mode
    eval --mix_prob 0 (no draw decides anything; CMO's twin batches come
    from the weighted loader, finetune-mixed's from the few-shot loader):
    the summary line and both loss.csv rows."""
    from swat_tpu_torch.cli.main import main

    dataset_path, ckpt, pseudo = dataset
    extra = [pseudo if x is None else x for x in extra]
    kw = {k: pseudo if v is None else v for k, v in kw.items()}
    args = dict(STAGE1, method=method, **kw)
    jax_pipe = JaxPipeline(JaxRunConfig(**run_kwargs(
        dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
        **args)).derived())
    jax_summary = jax_pipe.run()
    jax_pipe.loss_logger.close()
    capsys.readouterr()
    folder = str(tmp_path / "port")
    os.makedirs(folder)
    with open(os.path.join(folder, "config.yml"), "w") as f:
        f.write(f"dataset_path: {dataset_path}\n"
                f"retrieved_path: {dataset_path}\n")
    main(_cli_args(dataset_path, ckpt, folder, method, extra))
    out = capsys.readouterr().out
    assert summary_line(out) == jax_summary
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, folder, **args)).derived()
    got, ref = loss_rows(cfg.output_dir), loss_rows(jax_pipe.cfg.output_dir)
    assert len(got) == 2
    assert_rows_match(got, ref)
    # CMO: 42 train + 9 pseudo-labeled samples at bsz 4; finetune-mixed:
    # 42 at the bsz its config halves to 2, the few-shot twin beside
    assert got[0][1] == (12 if method == "CMO" else 21)


RUN = dict(STAGE1, method="cutmix", optim="SGD", epochs=3)
FIRST = dict(stop_epochs=2, save_ckpt=True, save_freq=1)
RESUMED = dict(FIRST, stop_epochs=200, resume=True)


def test_sgd_save_ckpt_then_resume_matches_swat_tpu(dataset, tmp_path):
    """--optim SGD --save_ckpt through 2 of 3 epochs, then --resume: each
    package restores its own newest checkpoint (the port's holds the
    momentum buffers) and trains epoch 3 alone; the summary lines and
    loss.csv rows of both runs agree, and the resumed row is epoch 3."""
    dataset_path, ckpt, _ = dataset
    out = {}
    for name, config, pipeline, kw in (
            ("jax", JaxRunConfig, JaxPipeline, {}),
            ("port", RunConfig, SwatPipeline, {"device": "cpu"})):
        out[name] = []
        for extra in (FIRST, RESUMED):
            pipe = pipeline(config(**kw, **run_kwargs(
                dataset_path, tmp_path / name, checkpoint_path=ckpt, **RUN,
                **extra)).derived())
            summary = pipe.run()
            pipe.loss_logger.close()
            out[name].append((summary, loss_rows(pipe.cfg.output_dir),
                              pipe.cfg.output_dir))
    for got, ref in zip(out["port"], out["jax"]):
        assert got[0] == ref[0]
        assert_rows_match(got[1], ref[1])
    assert [r[:2] for r in out["port"][1][1]] == [[3, 30]]
    arrays, _ = load_bundle(os.path.join(out["port"][0][2], "model_ckpts",
                                         "ckpt_ep2_it20.msgpack"))
    opt = arrays["opt_state"]
    assert sorted(opt["head"]) == ["momentum_buffer"]
    assert all(sorted(v) == ["momentum_buffer"]
               for v in opt["model"].values())
    assert np.abs(opt["head"]["momentum_buffer"]).max() > 0
