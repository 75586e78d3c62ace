"""Multi-process runs of the port (the counterpart of
tests/test_multihost.py): separate processes joined by gloo over
localhost, each feeding its own rows.

* A two-process cluster started by ``maybe_initialize_distributed`` from
  explicit arguments, over ``create_multislice_mesh(2, 1, 1)``, each process
  feeding ``process_local_slice`` of every batch (no process decodes the
  whole batch): test_multihost.py's three checks, the cluster formed, the
  cross-process steps equal to one process (losses and head rel 1e-5, as
  there) and to swat_tpu's one-device steps (the losses rtol 1e-4, the
  crop resample differing between the frameworks), the processes equal
  bit for bit.
* The flagship cutmix run with stage 2 through ``torch.distributed.run
  --nproc_per_node 2`` on the CLI, ``--mesh_data 2``, canvases augmented on
  the device with cutmix at mix_prob 1, the splits resident (sharded) and
  streamed (each process decoding its rows):
  its summary line equals the one-process run's, its ``loss.csv`` rows too
  (epoch, iteration and accuracies exactly, the losses rel 1e-5: the
  sharded encode sums its products in another order), rank 0 alone wrote
  the log.
* ``retrieval.cli extract --mesh_data 2`` and ``sample`` through
  the launcher against one process.
* ``swat_tpu_torch.dryrun.dryrun_multichip(4)`` in a process that never
  initializes CUDA.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_multichip import (BSZ, N_PX, _batch, _head, _jax_steps,
                                  run_cluster)
from torch_port_lib import (DATASET, NUM_CLASSES, RETRIEVAL_SPLIT,
                            TORCH_THREADS, jax_params_from_state_dict,
                            jax_step_draws, loss_rows, make_dataset,
                            random_state_dict, register_dataset,
                            summary_line)

import torch_dist_worker as W
from swat_tpu.models.configs import get_model_config as jax_model_config
from swat_tpu_torch.cli.main import main as cli_main
from swat_tpu_torch.models.configs import get_model_config

torch.set_num_threads(TORCH_THREADS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
NPROC = 2
MODEL = "test_tiny"


@pytest.fixture(scope="module")
def worker_outputs(tmp_path_factory):
    """(each process's outputs, swat_tpu's steps, the port's one process)
    of 2 cutmix steps on a two-process cluster."""
    import jax

    cfg = get_model_config(MODEL)
    sd = random_state_dict(cfg, seed=0)
    params, _ = jax_params_from_state_dict(sd, cfg)
    rng = np.random.default_rng(1)
    head = _head(rng, cfg.embed_dim)
    keys = list(jax.random.split(jax.random.PRNGKey(7), 2))
    batches = [_batch(rng, BSZ) for _ in range(2)]
    case = dict(name="multihost", cfg=cfg, sd=sd, head=head,
                image_size=N_PX, lr_head=1e-2, lr_backbone=1e-4,
                total_iter=10, run="step", method="cutmix",
                multislice=(2, 1, 1), batches=batches,
                draws=[jax_step_draws(k, b["valid_hw"], N_PX, 1.0, 1.0,
                                      method="cutmix")
                       for k, b in zip(keys, batches)])
    outs = run_cluster([case], NPROC, str(tmp_path_factory.mktemp("mh")))
    ref = _jax_steps("cutmix", jax_model_config(MODEL), params, head,
                     batches, keys)
    return [o["multihost"] for o in outs], ref, W.run_case(case, None)


def test_cluster_formed(worker_outputs):
    outs, _, _ = worker_outputs
    for r in outs:
        assert r["world"] == NPROC
        assert tuple(r["mesh"]) == (NPROC, 1)


def test_cross_process_training_matches_single_process(worker_outputs):
    outs, ref, one = worker_outputs
    for r in outs:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4,
                                   atol=1e-5)
        assert float(r["head"].sum()) == pytest.approx(
            float(one["head"].sum()), rel=1e-5)
        assert float(np.abs(r["head"]).max()) == pytest.approx(
            float(np.abs(one["head"]).max()), rel=1e-5)
        assert float(r["head"].sum()) == pytest.approx(
            float(ref["head"].sum()), rel=1e-4)


def test_processes_agree(worker_outputs):
    (a, b), _, _ = worker_outputs
    assert a["losses"] == b["losses"]
    np.testing.assert_array_equal(a["head"], b["head"])
    for k, v in a["model"].items():
        np.testing.assert_array_equal(b["model"][k], v, err_msg=k)


CLI = ["--dataset", DATASET, "--method", "cutmix", "--data_source",
       "fewshot+retrieved", "--retrieval_split", RETRIEVAL_SPLIT,
       "--model_cfg", MODEL, "--shots", "4", "--num_workers", "1",
       "--device", "cpu", "--recal_prompt", "--recal_fea", "--bsz", "4",
       "--aug_mode", "canvas", "--mix_prob", "1", "--epochs", "2",
       "--lr_classifier", "1e-2", "--lr_backbone", "1e-4"]


@pytest.mark.parametrize("resident", ["on", "off"])
def test_cli_run_on_two_processes_equals_one(tmp_path, capsys, resident):
    """The flagship run with stage 2 through the launcher on 2 processes
    equals the run without a launcher: with the splits resident (each
    process decodes its shard of the train split and its rows of every eval
    batch) and streamed (each decodes its rows of every batch)."""
    undo = register_dataset()
    try:
        dataset_path = make_dataset(tmp_path / "data", n_test_per_class=6,
                                    n_retrieved_per_class=6)
        ckpt = str(tmp_path / "tiny.pt")
        torch.save(random_state_dict(get_model_config(MODEL), seed=0), ckpt)
        with open(tmp_path / "config.yml", "w") as f:
            json.dump({"dataset_path": dataset_path,
                       "retrieved_path": dataset_path}, f)
        common = CLI + ["--checkpoint_path", ckpt, "--resident", resident,
                        "--config_yml", str(tmp_path / "config.yml")]
        cli_main(common + ["--folder", str(tmp_path / "one"),
                           "--mesh_data", "1"])
        one = summary_line(capsys.readouterr().out)
    finally:
        undo()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(NPROC), WORKER, "cli", DATASET,
         str(NUM_CLASSES), *common, "--folder", str(tmp_path / "two"),
         "--mesh_data", str(NPROC)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert summary_line(proc.stdout) == one
    (one_dir,) = [d for d, _, files in os.walk(tmp_path / "one")
                  if "loss.csv" in files]
    (two_dir,) = [d for d, _, files in os.walk(tmp_path / "two")
                  if "loss.csv" in files]
    got, ref = loss_rows(two_dir), loss_rows(one_dir)
    assert len(got) == len(ref) == 22
    for g, r in zip(got, ref):
        assert g[:2] == r[:2] and g[4:] == r[4:]
        assert g[2] == pytest.approx(r[2], rel=1e-5, abs=2e-6)
        assert g[3] == pytest.approx(r[3], rel=1e-5, abs=2e-6)
    with open(os.path.join(two_dir, "main.log")) as f:
        log = f.read()
    assert "Data-parallel over 2 x 1 ranks (2 processes)" in log
    assert log.count("logging started") == 1
    assert ("resident epochs" in log) == (resident == "on")


def test_retrieval_extract_and_sample_on_two_processes(tmp_path):
    """``retrieval.cli extract --mesh_data 2`` through the launcher: each
    process decodes and encodes its rows of every batch (bsz 8 over 12
    mined images: a padded last batch), rank 0 writes the bundle, equal to
    the one-process bundle (features to 1e-6, the rest byte for byte);
    ``sample`` on it, over the launcher's two processes, writes the
    one-process split file."""
    from PIL import Image

    from swat_tpu_torch.retrieval import cli as rcli

    rng = np.random.default_rng(0)
    cmap = {}
    for c in range(3):
        os.makedirs(tmp_path / "mined" / str(c))
        cmap[str(c)] = {}
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40 + 6 * i, 48, 3),
                                         dtype=np.uint8)).save(
                tmp_path / "mined" / str(c) / f"{i}.jpg")
            cmap[str(c)][str(i)] = f"photo {i} of thing {c}"
    (tmp_path / "cmap.json").write_text(json.dumps(cmap))
    ckpt = str(tmp_path / "tiny.pt")
    torch.save(random_state_dict(get_model_config(MODEL), seed=0), ckpt)
    prompts = {str(c): {"all": rng.normal(size=(2, 32)).astype(np.float32),
                        "mean": rng.normal(size=32).astype(np.float32)}
               for c in range(3)}
    from swat_tpu_torch.data.prompts import save_prompt_tensors

    save_prompt_tensors(str(tmp_path / "prompts.npz"), prompts)

    def argv(tag):
        return [["extract", "--mined_dir", str(tmp_path / "mined"),
                 "--caption_map", str(tmp_path / "cmap.json"), "--bsz", "8",
                 "--model_cfg", MODEL, "--checkpoint_path", ckpt,
                 "--device", "cpu", "--output",
                 str(tmp_path / f"mined_{tag}.npz")],
                ["sample", "--features", str(tmp_path / f"mined_{tag}.npz"),
                 "--prompts", str(tmp_path / "prompts.npz"),
                 "--num_samples", "3", "--device", "cpu", "--output",
                 str(tmp_path / tag / "split.txt")]]

    for args in argv("one"):
        rcli.main(args)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    extract, sample = argv("two")
    for args in (extract + ["--mesh_data", str(NPROC)], sample):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(NPROC), "-m",
             "swat_tpu_torch.retrieval.cli", *args], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    with np.load(tmp_path / "mined_one.npz") as a, \
            np.load(tmp_path / "mined_two.npz") as b:
        assert a.files == b.files
        for k in a.files:
            if k.endswith("_features"):
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(b[k], a[k])
    assert ((tmp_path / "two" / "split.txt").read_bytes()
            == (tmp_path / "one" / "split.txt").read_bytes())


def test_dryrun_multichip_hermetic():
    """The port's dry run on 4 gloo ranks (dp 2 x tp 2) in a process that
    never initializes CUDA (its children see no device)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch; from swat_tpu_torch.dryrun import dryrun_multichip;"
         " dryrun_multichip(4); assert not torch.cuda.is_initialized();"
         " print('HERMETIC')"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "dp 2 x tp 2" in proc.stdout and "HERMETIC" in proc.stdout
