"""
Multi-host (multi-process) plant-batch sharding (port of
``ics_wt_physicsengine_tpu/parallel/multihost.py``).

One process per host, each owning its local devices; ``torch.distributed``
links the processes (NCCL between CUDA devices, gloo when the caller asks
for the CPU). The workload is pure data parallelism over plants, so a step
needs no communication at all: every process builds the same global batch
(identical seeds give identical batches), keeps its own contiguous slice of
the plant axis (``local_plant_slice``, hosts-major) on its local devices
(``shard_batch_multihost``) and steps it. Only ensemble reductions would
cross processes.

Nothing on a machine tells a process of its cluster: the caller gives the
coordinator's address (``host:port``), the number of processes and this
process's rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch.parallel.mesh import Mesh, _map, shard_batch


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, device: Optional[str] = None) -> None:
    """Join this process into a multi-process run: call once on every
    process, e.g. ``initialize_multihost("10.0.0.1:8476", 4, rank)``.

    ``device`` ``None`` (the CUDA cards) joins with NCCL; ``"cpu"`` with
    gloo (asked for explicitly; never a fallback)."""
    import torch.distributed as dist

    dev = torch.device("cuda" if device is None else device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available; pass device='cpu' to "
                           "join with gloo on the CPU")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def _world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_plant_slice(n_plants: int) -> slice:
    """The half-open slice of the global plant axis this process owns under
    the hosts-major layout (``n_plants`` must divide evenly)."""
    rank, world = _world()
    if n_plants % world:
        raise ValueError(f"{n_plants} plants do not divide over {world} "
                         "processes")
    per = n_plants // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch_multihost(tree, mesh: Mesh):
    """This process's part of a *globally identical* batch: every process
    passes the same full ``[n_plants, ...]`` tree (NumPy arrays or
    tensors); each keeps its ``local_plant_slice`` and shards it over its
    local ``mesh`` (``shard_batch``). Returns one tree per local device."""
    tree = _to_tensors(tree)

    def local(x):
        if x.ndim == 0:
            return x
        return x[local_plant_slice(int(x.shape[0]))]

    return shard_batch(_map(local, tree), mesh)


def _to_tensors(tree):
    """NumPy leaves as CPU tensors, the tree's structure kept."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to_tensors(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree
