"""One rank of a gloo CPU cluster that runs the port's sharded cases
(tests/test_torch_multichip.py, tests/test_torch_multihost.py).  Imports
torch and the port only, never JAX: the test process computes the
references and writes the cases' inputs; the ranks run them sharded and
write what they got.

    python tests/torch_dist_worker.py <cases.pt> <out_dir> <host:port> \
        <world> <rank>
    python -m torch.distributed.run --standalone --nproc_per_node N \
        tests/torch_dist_worker.py cli <dataset> <classes> <cli.main args>

A case is a dict: ``name``; ``mesh`` (data, model), the cluster split into
replicas of that many ranks when it is smaller, or ``multislice`` (the
arguments of ``create_multislice_mesh``, every rank fed by
``process_local_slice``); ``run`` ("step", "resident", "validate",
"resident_validate", "forward", "rank"); the port config ``cfg``, state dict
``sd``, head and the inputs of its run (``run_case``).  Every rank feeds
its own rows: a step's batch reaches it as its rows of the decoded keys,
gathered by ``Mesh.gather_batch`` as the trainer gathers a loader's; a
resident split as its shard.  ``run_case(case, None)`` is the one-device
run of the same case, in the test process.
"""

import os
import sys

os.environ["CUDA_VISIBLE_DEVICES"] = ""

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from swat_tpu_torch.core.distributed import (  # noqa: E402
    create_multislice_mesh, maybe_initialize_distributed,
    process_local_slice)
from swat_tpu_torch.core.mesh import (Mesh, active, on_rows,  # noqa: E402
                                      resident_sharding, shard_batch)
from swat_tpu_torch.core.precision import FP32_PRECISION  # noqa: E402
from swat_tpu_torch.data.pipeline import local_keys  # noqa: E402
from swat_tpu_torch.eval.resident import (ResidentEval,  # noqa: E402
                                          held_rows, make_scan_eval)
from swat_tpu_torch.eval.validate import Evaluator  # noqa: E402
from swat_tpu_torch.models.clip import (CLIPModel,  # noqa: E402
                                        TensorParallel,
                                        tp_join_state_dicts,
                                        tp_shard_state_dict)
from swat_tpu_torch.retrieval.rank import rank_candidates  # noqa: E402
from swat_tpu_torch.train.resident import (ResidentData,  # noqa: E402
                                           make_resident_epoch)
from swat_tpu_torch.train.state import create_train_state  # noqa: E402
from swat_tpu_torch.train.steps import (make_ce_step,  # noqa: E402
                                        make_fixmatch_step, make_flyp_step,
                                        make_mixing_step)

CPU = torch.device("cpu")


def replica_mesh(data: int, model: int) -> Mesh:
    """A data x model mesh over each block of data * model consecutive
    ranks of the world (every rank makes every group, in one order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    size = data * model
    mine = {}
    for base in range(0, world, size):
        for axis, groups in (
                ("data", [[base + d * model + m for d in range(data)]
                          for m in range(model)]),
                ("model", [[base + d * model + m for m in range(model)]
                           for d in range(data)])):
            for ranks in groups:
                g = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    mine[axis] = g
    return Mesh(data, model, rank % size, mine["data"], mine["model"])


def _model(case, mesh):
    cfg = case["cfg"]
    model = CLIPModel(cfg, precision=FP32_PRECISION)
    sd = case["sd"]
    if mesh is not None and mesh.model > 1:
        model.tensor_parallel_(TensorParallel.of(mesh))
        sd = tp_shard_state_dict(sd, cfg, mesh.model, mesh.model_rank)
    model.load_state_dict(sd)
    return model


def _whole_state_dict(model, case, mesh) -> dict:
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if mesh is not None and mesh.model > 1:
        parts = [None] * mesh.model
        dist.all_gather_object(parts, sd, group=mesh.model_group)
        sd = tp_join_state_dicts(parts, case["cfg"])
    return {k: v.numpy() for k, v in sd.items()}


def _local(batch, mesh, per_process=False):
    """This rank's rows of a global batch's decoded keys, the rest whole
    (what a sharded loader yields); ``per_process``: the rows of
    ``process_local_slice``, the multi-host feeding."""
    if per_process and active(mesh) is not None:
        mine = local_keys(batch)
        return {k: v[process_local_slice(len(v))] if k in mine else v
                for k, v in batch.items()}
    return shard_batch(mesh, batch, local_keys(batch))


def _step_fn(case):
    method = case["method"]
    if method == "FLYP":
        return make_flyp_step(image_size=case["image_size"])
    if method == "fixmatch":
        return make_fixmatch_step(case["threshold"], 1.0,
                                  image_size=case["image_size"], aux=True)
    if method in ("finetune", "finetune-mixed"):
        return make_ce_step(image_size=case["image_size"],
                            accum=case.get("accum", 1),
                            concat_fs=method == "finetune-mixed")
    return make_mixing_step(method, image_size=case["image_size"],
                            accum=case.get("accum", 1))


def _grads(state) -> dict:
    out = {f"model.{k}": p.grad.detach().clone().numpy()
           for k, p in state.model.named_parameters() if p.grad is not None}
    for name in ("head", "logit_scale"):
        p = getattr(state, name)
        if p.grad is not None:
            out[name] = p.grad.detach().clone().numpy()
    return out


def run_case(case, mesh=None) -> dict:
    """The case on this rank of ``mesh`` (None: one device) -> outputs."""
    torch.manual_seed(0)
    run = case["run"]
    if run == "rank":
        idx, sim = rank_candidates(case["prompts"], case["cands"],
                                   case["cls"], case["top_k"], mesh=mesh,
                                   chunk=case.get("chunk"), device=CPU)
        return {"idx": idx, "sim": sim}
    model = _model(case, mesh)
    if run == "forward":
        images = torch.from_numpy(case["images"])
        with torch.no_grad():
            feats = on_rows(mesh, lambda x: model.encode_image(
                x, normalize=True, use_mega=case.get("use_mega", False)),
                images)
        return {"features": feats.numpy()}
    if run == "resident_validate":
        # the split as ResidentEval.from_samples holds it: this rank's rows
        # of every batch, pad rows zero
        images, labels = case["images"], case["labels"]
        n, bs = len(labels), case["batch_size"]
        total = n + (-n) % bs
        rows = (np.arange(total) if active(mesh) is None
                else held_rows(n, bs, mesh))
        mine = np.zeros((len(rows),) + images.shape[1:], np.uint8)
        mine[rows < n] = images[rows[rows < n]]
        pad = np.zeros(total - n, np.int64)
        ev = ResidentEval(torch.from_numpy(mine),
                          torch.from_numpy(np.r_[labels, pad]),
                          torch.from_numpy(np.arange(total) < n),
                          torch.from_numpy(np.r_[case["source"], pad]), mesh)
        acc, loss, cm = make_scan_eval(case["num_classes"], bs)(
            model, torch.from_numpy(case["head"]), float(np.log(100.0)), ev)
        return {"acc": acc, "loss": loss, "cm": cm}
    if run == "validate":
        ev = Evaluator(case["num_classes"], device=CPU, mesh=mesh)
        acc, loss, cm = ev.validate(
            model, torch.from_numpy(case["head"]), float(np.log(100.0)),
            [_local(b, mesh) for b in case["batches"]],
            return_confusion=True)
        return {"acc": acc, "loss": loss, "cm": cm}
    model.eval().requires_grad_(False)
    state = create_train_state(
        model, torch.from_numpy(case["head"]), case["method"],
        lr_classifier=case["lr_head"], lr_backbone=case["lr_backbone"],
        total_iter=case["total_iter"], mesh=mesh)
    step = _step_fn(case)
    g0, aux = {}, []

    def recording(state, batch, draws):
        val = step(state, batch, draws)
        if isinstance(val, tuple):
            aux.append([float(v) for v in val[1:]])
            val = val[0]
        if not g0:
            g0.update(_grads(state))
        return val

    losses = []
    if run == "step":
        for batch, draws in zip(case["batches"], case["draws"]):
            batch = _local(batch, mesh, "multislice" in case)
            if mesh is not None:
                batch = mesh.gather_batch(batch, CPU, local_keys(batch))
            losses.append(float(recording(state, batch, draws)))
    else:   # resident: the split sharded as resident_sharding cuts it
        def resident(arrays):
            canvases, valid_hw, labels, source = arrays
            shard = resident_sharding(mesh, len(labels))
            mine = canvases if shard is None else canvases[shard]
            return ResidentData(torch.from_numpy(mine), valid_hw,
                                torch.from_numpy(labels).long(),
                                torch.from_numpy(source).long(), mesh, shard)

        draws = iter(case["draws"])

        def step_loss(state, batch, d):
            val = recording(state, batch, d)
            losses.append(float(val))
            return val

        epoch = make_resident_epoch(step_loss, lambda rng, b: next(draws))
        twin = case.get("twin")
        mean = epoch(state, resident(case["data"]), case["perm"],
                     np.random.default_rng(0),
                     None if twin is None else resident(twin),
                     case.get("twin_perm"))
        aux.append([float(mean)])
    return {"losses": losses, "aux": aux, "g0": g0,
            "model": _whole_state_dict(state.model, case, mesh),
            "head": state.head.detach().numpy(),
            "logit_scale": float(state.logit_scale.detach())}


def main(argv):
    cases_path, out_dir, address, world, rank = argv
    torch.set_num_threads(1)
    # the port's own start-up, from explicit arguments
    assert maybe_initialize_distributed(address, int(world), int(rank),
                                        device="cpu")
    cases = torch.load(cases_path, weights_only=False)
    meshes, out = {}, {}
    for case in cases:
        if "multislice" in case:
            mesh = create_multislice_mesh(*case["multislice"])
        else:
            shape = tuple(case["mesh"])
            if shape not in meshes:
                meshes[shape] = replica_mesh(*shape)
            mesh = meshes[shape]
        out[case["name"]] = dict(run_case(case, mesh),
                                 world=dist.get_world_size(),
                                 mesh=(mesh.data, mesh.model))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def cli(argv):
    """One rank of a CLI run under a launcher: registers the synthetic
    dataset (``name``, its class count, two templates) in the port's
    registry, as the tests register it in-process, then runs
    ``swat_tpu_torch.cli.main`` on the rest of the arguments."""
    from swat_tpu_torch.cli.main import main as cli_main
    from swat_tpu_torch.data import prompts, registry

    name, classes = argv[0], int(argv[1])
    torch.set_num_threads(1)
    registry.NUM_CLASSES_DICT[name] = classes
    prompts.TEMPLATES[name] = ["a photo of a {}.", "a blurry photo of a {}."]
    cli_main(argv[2:])


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        cli(sys.argv[2:])
    else:
        main(sys.argv[1:])
