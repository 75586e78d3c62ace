"""Multi-process start-up (counterpart of ``swat_tpu/core/distributed.py``).

``swat_tpu`` starts ``jax.distributed`` from explicit arguments or the TPU
pod's variables.  The port starts ``torch.distributed``: from explicit
arguments, or from the variables a launcher sets (``torch.distributed.run``
/ ``torchrun``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), with NCCL when the run's device is
CUDA and gloo on the CPU.  Each process then drives one GPU,
``cuda:LOCAL_RANK`` (``local_device``), and feeds its own rows of every
batch (``process_local_slice``).

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m swat_tpu_torch.cli.main ... --mesh_data 4
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from swat_tpu_torch.core.mesh import Mesh, create_mesh, MeshSpec

_LAUNCHER_VARS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def launched() -> bool:
    """True when a launcher's variables are set."""
    return all(v in os.environ for v in _LAUNCHER_VARS)


def local_device(name: str) -> torch.device:
    """``name`` with this process's GPU under a launcher: 'cuda' becomes
    ``cuda:LOCAL_RANK``; anything else is returned as it is."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None \
            and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> bool:
    """Starts the default process group when running multi-process.

    Triggers when explicit arguments are given (``coordinator_address`` as
    ``host:port`` or an ``init_method`` URL) or when a launcher's variables
    are present; otherwise does nothing.  The backend is NCCL for a CUDA
    ``device`` and gloo for the CPU.  Returns True when a group is started
    (or was already), whatever its size."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and not launched():
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda"))
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=int(num_processes),
                                rank=int(process_id))
    else:
        dist.init_process_group(backend)
    return True


def create_multislice_mesh(dcn_data: int, ici_data: int,
                           ici_model: int = 1) -> Mesh:
    """The mesh of a multi-node run: the data axis spans the nodes
    (``dcn_data`` of them, ``ici_data`` data ranks each), the model axis
    stays inside a node.  A launcher numbers ranks node after node, so with
    the row-major grid a model group is ``ici_model`` consecutive ranks of
    one node; the world must be ``dcn_data * ici_data * ici_model`` and a
    node's process count (``LOCAL_WORLD_SIZE``) a multiple of
    ``ici_model``, or this raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = dcn_data * ici_data * ici_model
    if world != need:
        raise ValueError(
            f"multislice mesh {dcn_data}x{ici_data}x{ici_model} needs "
            f"{need} processes, got {world}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world // dcn_data))
    if local % ici_model:
        raise ValueError(
            f"a model group of {ici_model} ranks would span nodes of "
            f"{local} processes")
    return create_mesh(MeshSpec(dcn_data * ici_data, ici_model))


def process_local_slice(n_items: int) -> slice:
    """This process's contiguous shard of a length-n dataset (every process
    feeds only its shard; the collectives assemble the global batch)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = n_items // world
    return slice(rank * per, rank * per + per)
