"""The process group as a device mesh (``parallel/mesh.py`` of the JAX
package).

JAX lays its chips out as a ``(data, model)`` mesh, shards batches along
``data`` and replicates the parameters; GSPMD then inserts the
collectives. The port runs one process a card (``torchrun``), so its
mesh is the ``torch.distributed`` process group seen from one rank: the
world is ``n_data × n_model`` ranks, rank ``r`` holds data shard ``r //
n_model`` (JAX's ``devices.reshape(n_data, n_model)`` order), and the
``n_model`` ranks of one data shard are replicas of it, as JAX's
``model`` axis replicates under ``P("data")``.

``shard_batch`` slices this rank's contiguous rows of a global batch and
``replicate_state`` broadcasts rank 0's train state. The collectives the
train steps, the synchronised BatchNorm and the sharded kNN share are
here too: ``all_reduce_mean_`` (one flat buffer, in a fixed order),
``sum_over_ranks`` and ``all_gather_rows`` (differentiable), and
``gather_uneven`` (row counts that differ by rank). A mesh without a
process group (one process, no launcher) runs none of them; a mesh over
a process group of one rank runs them all, and they leave every value as
it is.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

RANK_STREAM = 2  # the rank's words in a step generator's seed (train.loop)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the ``(data, model)`` mesh: the axis sizes, this
    rank, its device and the process group of its data axis (the ranks of
    its model index; None when that is the whole world). ``distributed``
    is False for a mesh of one process without a process group."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    distributed: bool = False
    data_group: Any = None

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    def host_shard(self) -> tuple:
        """``(data index, n_data)``: the ``Loader``'s ``host_shard``."""
        return self.data_index, self.n_data

    def rank_words(self) -> tuple:
        """The words a step generator's seed takes for this rank's draws:
        none on one data shard, so one process draws as it always has;
        else the data index, as JAX's ``fold_in(axis_index("data"))``
        (replicas of one shard draw alike)."""
        return () if self.n_data == 1 else (RANK_STREAM, self.data_index)


def local_device(device: torch.device | str = "cuda") -> torch.device:
    """``device`` with a card index: ``cuda`` becomes ``cuda:LOCAL_RANK``
    (the launcher's; 0 without one); an indexed device or the CPU stay."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                device: torch.device | str = "cuda") -> Mesh:
    """The mesh of the initialised process group (one rank without one):
    ``n_data`` defaults to the world over ``n_model``, and ``n_data ×
    n_model`` must be the world. With ``n_model`` > 1 every rank makes the
    data-axis groups (all ranks must call this together)."""
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model != world:
        raise ValueError(
            f"a mesh of data {n_data} x model {n_model} needs "
            f"{n_data * n_model} processes, and this run has {world}; "
            f"launch it with torchrun --nproc_per_node "
            f"{n_data * n_model}")
    data_group = None
    if distributed and n_model > 1:
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                data_group = group
    return Mesh(n_data, n_model, rank, local_device(device), distributed,
                data_group)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's contiguous rows of a global batch (numpy arrays or
    tensors), as JAX places a batch sharded along ``data``. The rows must
    divide by ``n_data``."""
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % mesh.n_data:
            raise ValueError(f"batch of {rows} rows does not shard over "
                             f"{mesh.n_data} data ranks")
        local = rows // mesh.n_data
        out[k] = v[mesh.data_index * local:(mesh.data_index + 1) * local]
    return out


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh,
               src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, one flat buffer a dtype."""
    if not mesh.distributed:
        return
    for group in _by_dtype(tensors).values():
        flat = _flatten_dense_tensors(group)
        dist.broadcast(flat, src)
        for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(v)


@torch.no_grad()
def replicate_state(state, mesh: Mesh):
    """Rank 0's train state on every rank: its step, f32 masters,
    optimizer state (momentum buffers), pending gradient mean and
    BatchNorm statistics (``replicate_state`` of the JAX package). The
    state's structure must be the same on every rank."""
    if not mesh.distributed:
        return state
    step = torch.tensor([state.step], dtype=torch.int64, device=mesh.device)
    tensors = [*state.params.values(), *state.batch_stats.values()]
    for per_param in state.opt.state.values():
        tensors += [v for v in per_param.values()
                    if isinstance(v, torch.Tensor) and v.dim() > 0]
    if state.grad_acc is not None:
        tensors += list(state.grad_acc.values())
    broadcast_([step, *tensors], mesh)
    state.step = int(step.item())
    return state


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor replaced by its mean over the world's ranks, reduced as
    one flat buffer a dtype in the order given: the same bits on every
    rank, and from run to run."""
    if not mesh.distributed:
        return
    for group in _by_dtype(tensors).values():
        flat = _flatten_dense_tensors(group)
        dist.all_reduce(flat)
        flat /= mesh.world
        for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(v)


class _SumOverRanks(torch.autograd.Function):
    """Sum over the data axis; its backward sums the cotangents the same
    way (each rank's cotangent is its own loss's, and the step averages
    the gradients over the ranks after)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the data axis, differentiably (the synchronised
    BatchNorm's sums). The identity on one data shard."""
    if not mesh.distributed or mesh.n_data == 1:
        return x
    return _SumOverRanks.apply(x, mesh.data_group)


class _AllGatherRows(torch.autograd.Function):
    """The data axis's rows in rank order, gathered in f32 (exact for
    bf16, and what every backend takes); the backward sums the cotangents
    over the ranks and keeps this rank's rows, as the transpose of JAX's
    ``all_gather``."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.index, ctx.rows, ctx.dtype = group, index, \
            x.shape[0], x.dtype
        xf = x.float().contiguous()
        parts = [torch.empty_like(xf) for _ in range(n)]
        dist.all_gather(parts, xf, group=group)
        return torch.cat(parts).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.float().contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        rows = g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows]
        return rows.to(ctx.dtype), None, None, None


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's rows of ``x`` (equal counts), in rank order,
    differentiably. ``x`` itself on one data shard."""
    if not mesh.distributed or mesh.n_data == 1:
        return x
    return _AllGatherRows.apply(x, mesh.data_group, mesh.n_data,
                                mesh.data_index)


@torch.no_grad()
def gather_uneven(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's rows of ``x`` in rank order, where the ranks'
    row counts may differ (a split trailing batch; a rank may have none).
    No gradient."""
    if not mesh.distributed or mesh.n_data == 1:
        return x
    counts = torch.zeros(mesh.n_data, dtype=torch.int64, device=x.device)
    counts[mesh.data_index] = x.shape[0]
    dist.all_reduce(counts, group=mesh.data_group)
    counts = counts.tolist()
    width = max(counts)
    padded = torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=x.device)
    padded[:x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in counts]
    dist.all_gather(parts, padded, group=mesh.data_group)
    return torch.cat([p[:n] for p, n in zip(parts, counts)])


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        dist.barrier()


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """Rank ``src``'s ``obj`` (anything picklable) on every rank."""
    if not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]
