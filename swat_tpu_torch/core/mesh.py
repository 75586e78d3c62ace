# MeshSpec and pad_to_multiple copied from swat_tpu/core/mesh.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""The device mesh of the port: a ``data x model`` grid of processes, one a
GPU (counterpart of ``swat_tpu/core/mesh.py``).

``swat_tpu`` is one controller over many devices: GSPMD shards a jitted
step and inserts the collectives.  The port runs one process a GPU, as
PyTorch runs multi-GPU work, and writes the collectives itself over
``torch.distributed`` (NCCL on the card, gloo on the CPU).  Ranks are laid
out row-major, ``rank = d * model + m``, as ``create_mesh`` reshapes the
devices: the ranks of one data group hold the same model shard, the ranks
of one model group the same rows of the batch.

What each rank does under data parallelism:

* it loads its contiguous rows of every global batch (``rows``);
* the decoded rows are gathered (``gather``), so that the step's host-side
  draws, mixes and losses see the global batch exactly as one device does;
* the towers encode only the local rows, and their features are gathered
  into the global batch (``gather_rows``: the gradient flowing back is the
  local rows' slice, since every rank computes the same global loss);
* the gradients of the towers are then partial sums over the local rows,
  all-reduced over the data group in one flat bucket (``sync_grads``); the
  head and ``logit_scale``, which act on the gathered features, have the
  whole gradient on every rank already and stay out of it.

A mesh that does not fit the processes there are runs on all of them,
``world // model`` data ranks, with a WARNING naming both sizes (``swat_tpu``
falls back to no mesh, ``swat_tpu/train/stages.py:143-148``; N processes
without a mesh would be N copies of one run writing the same files).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_LOG = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``data`` × ``model`` must equal #devices used."""

    data: int = -1   # -1 = all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model > n_devices:
            raise ValueError(
                f"mesh {data}x{model} needs {data * model} devices, "
                f"have {n_devices}")
        return data, model


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class _GatherRows(torch.autograd.Function):
    """all_gather of each rank's rows along dim 0; the gradient is this
    rank's slice of the incoming one (every rank differentiates the same
    global loss, so the slice is the whole gradient of its rows)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows = mesh.rows(x.shape[0] * mesh.data)
        return mesh.gather(x)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None


class _ReduceSum(torch.autograd.Function):
    """all-reduce SUM over the data group, forward and backward (a sum
    that every rank's rows feed and every rank's rows read)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous().clone()), None


class Mesh:
    """This process's place in a ``data x model`` grid and the process
    groups of its axes (None where an axis has one rank, or spans the
    default group)."""

    def __init__(self, data: int, model: int, rank: int = 0,
                 data_group=None, model_group=None):
        self.data, self.model = data, model
        self.rank = rank
        self.data_rank, self.model_rank = divmod(rank, model)
        self.data_group, self.model_group = data_group, model_group

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def live(self) -> bool:
        """Whether the collectives run: a data axis of more than one rank,
        or a one-rank axis given its group (a check on one card drives
        every collective that way)."""
        return self.data > 1 or self.data_group is not None

    def __repr__(self):
        return (f"Mesh(data={self.data}, model={self.model}, "
                f"rank={self.rank})")

    # ---- rows of the batch axis

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a leading axis of ``n``, which
        the data axis must divide (``swat_tpu``'s ``shard_batch``
        contract)."""
        if n % self.data:
            raise ValueError(
                f"leading size {n} is not divisible by the data axis "
                f"({self.data}); pad to a multiple (pad_to_multiple)")
        per = n // self.data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    # ---- collectives over the data group

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` joined along dim 0 in data-rank order (no
        gradient)."""
        if not self.live:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.data)]
        dist.all_gather(parts, x, group=self.data_group)
        return torch.cat(parts)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``gather`` with the gradient of the local rows (``_GatherRows``)."""
        if not self.live:
            return x
        if not torch.is_grad_enabled() or not x.requires_grad:
            return self.gather(x)
        return _GatherRows.apply(x, self)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """SUM over the data group, in place (no gradient) -> ``x``."""
        if self.live:
            dist.all_reduce(x, group=self.data_group)
        return x

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """SUM over the data group with the gradient of a sum."""
        if not self.live:
            return x
        if not torch.is_grad_enabled() or not x.requires_grad:
            return self.all_reduce(x.clone())
        return _ReduceSum.apply(x, self)

    def barrier(self) -> None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    def sync_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Sums the gradients of ``params`` over the data group in one flat
        bucket, in the order given."""
        with_grad = [p for p in params if p.grad is not None]
        if not with_grad:
            return
        flat = torch.cat([p.grad.reshape(-1).float() for p in with_grad])
        self.all_reduce(flat)
        ofs = 0
        for p in with_grad:
            n = p.grad.numel()
            p.grad.copy_(flat[ofs: ofs + n].view_as(p.grad))
            ofs += n

    # ---- batches

    def gather_batch(self, batch: Mapping, device: torch.device,
                     local_keys: Sequence[str]) -> dict:
        """The global batch from this rank's: every key in ``local_keys``
        (``data.pipeline.local_keys``) holds local rows and is gathered on
        ``device`` (integer rows come back to the host as numpy, where the
        draws are made); the other keys are global already and pass
        through."""
        if not self.live:
            return dict(batch)
        out = {}
        for key, value in batch.items():
            if key not in local_keys:
                out[key] = value
                continue
            host = not isinstance(value, torch.Tensor)
            t = torch.as_tensor(np.asarray(value) if host else value)
            g = self.gather(t.to(device))
            out[key] = (g.cpu().numpy()
                        if host and not t.is_floating_point()
                        and t.dtype != torch.uint8 else g)
        return out


def _new_groups(ranks_of: List[List[int]], mine: int, world: int):
    """Makes every group (all ranks must call ``new_group`` for each, in
    one order) -> this rank's, or None where it has one rank or is the
    whole world."""
    found = None
    for ranks in ranks_of:
        if len(ranks) == 1 or len(ranks) == world:
            continue
        g = dist.new_group(ranks)
        if mine in ranks:
            found = g
    return found


def create_mesh(spec: Optional[MeshSpec] = None,
                world: Optional[int] = None,
                rank: Optional[int] = None,
                logger: Optional[logging.Logger] = None) -> Mesh:
    """The ``data x model`` mesh over the started process group (or one
    process).  A spec that does not match the world runs on every rank
    there is: ``world // model`` data ranks (model 1 when it does not
    divide the world), with a WARNING naming both sizes."""
    started = dist.is_initialized()
    world = world if world is not None else (
        dist.get_world_size() if started else 1)
    rank = rank if rank is not None else (dist.get_rank() if started else 0)
    spec = spec or MeshSpec()
    try:
        data, model = spec.resolve(world)
        ok = data * model == world
    except ValueError:
        ok = False
    if not ok:
        model = max(1, spec.model)
        if world % model:
            model = 1
        data = world // model
        (logger or _LOG).warning(
            f"mesh {spec.data}x{spec.model} does not fit the {world} "
            f"process(es) of this run; running on a {data}x{model} mesh")
    data_group = model_group = None
    if started and world > 1:
        data_group = _new_groups(
            [[d * model + m for d in range(data)] for m in range(model)],
            rank, world)
        model_group = _new_groups(
            [[d * model + m for m in range(model)] for d in range(data)],
            rank, world)
    return Mesh(data, model, rank, data_group, model_group)


def active(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when its collectives run (``Mesh.live``), else None."""
    return mesh if mesh is not None and mesh.live else None


def on_rows(mesh: Optional[Mesh], fn, *xs, local: bool = False):
    """``fn`` of this rank's rows of ``xs`` (leading axes of one length),
    its output gathered into the whole batch, with the gradient of the
    local rows; ``local``: ``xs`` hold this rank's rows already.  Without
    an active mesh, ``fn(*xs)``."""
    mesh = active(mesh)
    if mesh is None:
        return fn(*xs)
    if not local:
        sl = mesh.rows(xs[0].shape[0])
        xs = tuple(x[sl] for x in xs)
    return mesh.gather_rows(fn(*xs))


def encode_batch(mesh: Optional[Mesh], model, batch,
                 device: torch.device) -> torch.Tensor:
    """The normalized image features of an eval batch, whole: under a mesh
    its ``images`` are this rank's rows (a sharded loader's) or the whole
    batch (cut here), encoded by ``model.encode_image`` and gathered."""
    images = torch.from_numpy(batch["images"]).to(device)
    return on_rows(mesh, lambda x: model.encode_image(x, normalize=True),
                   images, local=images.shape[0] != len(batch["mask"]))


def shard_batch(mesh: Optional[Mesh], batch: Mapping,
                keys: Optional[Sequence[str]] = None) -> dict:
    """This rank's rows of a global host batch (what a sharded loader
    yields): of every array, or of those in ``keys``, the others whole; the
    data axis must divide the leading size of each it cuts."""
    mesh = active(mesh)
    if mesh is None:
        return dict(batch)
    return {k: v[mesh.rows(len(v))] if keys is None or k in keys
            else v for k, v in batch.items()}


def resident_sharding(mesh: Optional[Mesh], n: int) -> Optional[slice]:
    """The rows of a resident split of ``n`` examples that this rank holds:
    its contiguous shard when the data axis divides ``n``, else None (the
    whole split, on every rank)."""
    if active(mesh) is None or n % mesh.data:
        return None
    return mesh.rows(n)
