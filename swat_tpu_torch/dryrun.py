"""The multi-process dry run of the port (counterpart of ``swat_tpu``'s
``__graft_entry__.dryrun_multichip``): a cutmix train step and a resident
cutmix epoch over a dp x tp mesh of gloo processes on the CPU, held
against the same step and epoch in one process.

``dryrun_multichip(n_ranks)`` starts ``n_ranks`` processes as dp
``n_ranks / 2`` x tp 2 (tp 1 for an odd count) on a small CLIP of two
layers and four heads a tower (``__graft_entry__.py:104-112``'s), each
feeding its rows of a batch of ``2 * dp`` canvases, in the default bf16
compute policy.  The children never touch CUDA (``CUDA_VISIBLE_DEVICES``
is empty for them) and the parent computes on the CPU alone.  The gate is
``swat_tpu``'s: the sharded loss within 1e-3 + 1e-2 x the one-process
loss (bf16 reassociation across shards moves it a few tenths of a
percent; a sharding fault moves it by orders more), every rank's the same.

    python -c "from swat_tpu_torch.dryrun import dryrun_multichip; \\
        dryrun_multichip(4)"
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

from swat_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig

CFG = CLIPConfig(
    name="dryrun",
    vision=VisionConfig(image_size=64, patch_size=16, width=128, layers=2,
                        heads=4, embed_dim=64, quick_gelu=True),
    text=TextConfig(context_length=16, vocab_size=512, width=64, layers=2,
                    heads=4, embed_dim=64, quick_gelu=True),
)
CANVAS = 80


def _mesh_shape(n_ranks: int):
    tp = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    return n_ranks // tp, tp


def _inputs(dp: int):
    """The batch, the resident split, their draws and the head, from
    seeds (the same in every process)."""
    from swat_tpu_torch.train.steps import make_sampler

    bsz = 2 * dp
    rng = np.random.default_rng(0)

    def batch(n):
        return {"canvases": rng.integers(0, 255, (n, CANVAS, CANVAS, 3)
                                         ).astype(np.uint8),
                "valid_hw": np.full((n, 2), CANVAS, np.int32),
                "labels": rng.integers(0, 10, n).astype(np.int32),
                "source": rng.integers(0, 2, n).astype(np.int32)}

    step_batch, split = batch(bsz), batch(2 * bsz)
    sample = make_sampler("cutmix", mix_prob=1.0,
                          image_size=CFG.vision.image_size)
    draws_rng = np.random.default_rng(1)
    step_draws = sample(draws_rng, step_batch)
    perm = np.random.default_rng(2).permutation(2 * bsz).reshape(2, bsz)
    epoch_draws = [sample(draws_rng, {k: v[p] for k, v in split.items()})
                   for p in perm]
    head = np.random.default_rng(3).standard_normal(
        (10, CFG.embed_dim)).astype(np.float32)
    return step_batch, step_draws, split, perm, epoch_draws, head


def _run(mesh, dp: int):
    """The step and the epoch on this process's rank of ``mesh`` (None:
    one process) -> [step loss, epoch mean loss]."""
    from swat_tpu_torch.core.mesh import (active, resident_sharding,
                                          shard_batch)
    from swat_tpu_torch.data.pipeline import local_keys
    from swat_tpu_torch.models.clip import (CLIPModel, TensorParallel,
                                            tp_shard_state_dict)
    from swat_tpu_torch.train.resident import (ResidentData,
                                               make_resident_epoch)
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import make_mixing_step

    cpu = torch.device("cpu")
    step_batch, step_draws, split, perm, epoch_draws, head = _inputs(dp)
    losses = []
    for phase in ("step", "epoch"):
        model = CLIPModel(CFG).init_random(torch.Generator().manual_seed(0))
        sd = model.state_dict()
        if mesh is not None and mesh.model > 1:
            model = CLIPModel(CFG).tensor_parallel_(TensorParallel.of(mesh))
            model.load_state_dict(tp_shard_state_dict(
                sd, CFG, mesh.model, mesh.model_rank))
        model.eval().requires_grad_(False)
        state = create_train_state(model, torch.from_numpy(head), "cutmix",
                                   lr_classifier=1e-3, lr_backbone=1e-5,
                                   total_iter=10, mesh=mesh)
        step = make_mixing_step("cutmix", image_size=CFG.vision.image_size)
        if phase == "step":
            batch = shard_batch(mesh, step_batch, local_keys(step_batch))
            if active(mesh) is not None:
                batch = mesh.gather_batch(batch, cpu, local_keys(batch))
            losses.append(float(step(state, batch, step_draws)))
        else:
            shard = resident_sharding(mesh, len(split["labels"]))
            canvases = (split["canvases"] if shard is None
                        else split["canvases"][shard])
            data = ResidentData(
                torch.from_numpy(canvases), split["valid_hw"],
                torch.from_numpy(split["labels"]).long(),
                torch.from_numpy(split["source"]).long(), mesh, shard)
            draws = iter(epoch_draws)
            epoch = make_resident_epoch(step, lambda rng, b: next(draws))
            losses.append(float(epoch(state, data, perm,
                                      np.random.default_rng(0))))
    return losses


def _child(world: int, rank: int, address: str, out_path: str) -> None:
    from swat_tpu_torch.core.distributed import maybe_initialize_distributed
    from swat_tpu_torch.core.mesh import MeshSpec, create_mesh

    torch.set_num_threads(1)
    maybe_initialize_distributed(address, world, rank, device="cpu")
    dp, tp = _mesh_shape(world)
    mesh = create_mesh(MeshSpec(dp, tp))
    losses = _run(mesh, dp)
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "losses": losses}, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_ranks: int) -> None:
    """Runs the sharded step and epoch on ``n_ranks`` gloo processes and
    checks them against one process; raises AssertionError on a
    mismatch."""
    dp, tp = _mesh_shape(n_ranks)
    ref = _run(None, dp)
    assert all(np.isfinite(ref)), f"non-finite one-process losses {ref}"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    address = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(n_ranks)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "swat_tpu_torch.dryrun", str(n_ranks),
             str(r), address, outs[r]], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n_ranks)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, f"dry-run rank failed:\n{log[-4000:]}"
        got = []
        for path in outs:
            with open(path) as f:
                got.append(json.load(f)["losses"])
    for losses in got:
        assert losses == got[0], f"ranks disagree: {got}"
    for name, g, r in zip(("step", "resident epoch"), got[0], ref):
        assert np.isfinite(g), f"non-finite {name} loss {g}"
        assert abs(g - r) <= 1e-3 + 1e-2 * abs(r), (
            f"dp {dp} x tp {tp} sharded {name} loss {g} != one-process "
            f"loss {r}")
    print(f"dryrun_multichip({n_ranks}): dp {dp} x tp {tp}, step loss "
          f"{got[0][0]:.6f} (one process {ref[0]:.6f}), resident epoch "
          f"{got[0][1]:.6f} ({ref[1]:.6f})")


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
