"""Starting the process group (``parallel/multihost.py`` of the JAX
package).

JAX runs one process a host, each driving its host's chips; the port
runs one process a card, so the JAX package's "host" is a rank here.
Launch N ranks on one machine with

    torchrun --nproc_per_node N scripts/train_multi_torch.py -d ... -m CARD

``initialize`` then starts the group from ``torchrun``'s environment
(``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), or from explicit arguments (``init_method`` such as
``tcp://localhost:29500`` or ``file:///path``, ``world_size``, ``rank``):
``nccl`` for a card, ``gloo`` for the CPU. With neither it does nothing,
and the run is one process, as ``jax.distributed`` is left alone on one
host. A rank's ``host_shard`` for the ``Loader`` is its mesh's
(``Mesh.host_shard``: its data shard, which the replicas of one shard
share).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, local_device

_STARTED = False  # whether initialize() made the group shutdown() ends


def _launched() -> bool:
    return "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device: torch.device | str = "cuda",
               backend: Optional[str] = None) -> bool:
    """Start the process group for ``device`` (nccl on a card, else gloo,
    unless ``backend`` names one) and bind this rank's card; True if this
    call started it. Nothing when a group is already up, or when there is
    neither a launcher's environment nor an ``init_method``."""
    global _STARTED
    if dist.is_initialized():
        return False
    if init_method is None and not _launched():
        return False
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)
    _STARTED = True
    return True


def shutdown() -> None:
    """End the group ``initialize`` started (a group made elsewhere is
    left to its maker)."""
    global _STARTED
    if _STARTED and dist.is_initialized():
        dist.destroy_process_group()
    _STARTED = False


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_batch(local_batch: Dict[str, np.ndarray],
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's shard of a global batch on its device. The port's
    global batch is the ranks' shards together (no array spans cards), so
    this places the rows the ``host_shard`` loader gave and checks that
    every data rank holds as many."""
    out = {k: torch.as_tensor(np.asarray(v)).to(mesh.device)
           for k, v in local_batch.items()}
    rows = next(iter(out.values())).shape[0]
    if mesh.distributed and mesh.n_data > 1:
        seen = torch.tensor([rows, -rows], device=mesh.device)
        dist.all_reduce(seen, op=dist.ReduceOp.MAX,
                        group=mesh.data_group)
        if int(seen[0]) != -int(seen[1]):
            raise ValueError(
                f"data ranks hold between {-int(seen[1])} and "
                f"{int(seen[0])} rows of one global batch; each must "
                f"contribute global_bs / {mesh.n_data}")
    return out
