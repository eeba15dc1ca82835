"""
Plant-batch sharding over several devices (port of
``ics_wt_physicsengine_tpu/parallel/mesh.py``).

The workload's parallel axis is the plant batch: parameter-randomized
plants advance in lockstep with no coupling between them, so a batch splits
into contiguous blocks of plants, one block per device, and each device
steps its own block. Nothing crosses devices in a step: no collective runs,
and every plant's arithmetic is what it is on one device, so a sharded
result equals the unsharded one bit for bit.

A ``Mesh`` is an ordered list of ``torch.device``s. A batched tree (a
dataclass of tensors with a leading ``[n_plants]`` axis, such as
``ReactorState`` or ``PlantState``) is *sharded* as a list of trees, one per
mesh device in mesh order, each holding its contiguous block of plants on
its device (``shard_batch``); ``gather_batch`` joins them again. The
sharded functions issue every device's work before they wait for any: CUDA
launches are asynchronous, so the devices run side by side.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ics_wt_physicsengine_torch.core import reactor as R

PLANTS_AXIS = "plants"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the plant axis (``PLANTS_AXIS``): ``devices`` in
    shard order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device; a CPU
    device only when the caller names one), cut to its first ``n_devices``
    when given."""
    if devices is None:
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError(
                "no CUDA device is visible; name the devices (e.g. "
                "devices=[torch.device('cpu')]) to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices={n_devices} of {len(devices)} "
                             "devices")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


def _map(fn, tree):
    """``fn`` over the tensors of ``tree`` (dataclasses, dicts, lists and
    tuples rebuilt; other values kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def batch_size(tree) -> int:
    """The leading-axis length every non-scalar tensor of ``tree`` shares."""
    sizes = {int(x.shape[0]) for x in _leaves(tree) if x.ndim >= 1}
    if len(sizes) != 1:
        raise ValueError(f"a batched tree needs one leading axis length, "
                         f"got {sorted(sizes)}")
    return sizes.pop()


def shard_bounds(n_plants: int, mesh: Mesh) -> List[slice]:
    """The contiguous block of plants of each mesh device (the plant count
    must divide evenly, as a JAX ``NamedSharding`` requires)."""
    if n_plants % mesh.size:
        raise ValueError(f"{n_plants} plants do not divide over "
                         f"{mesh.size} devices")
    per = n_plants // mesh.size
    return [slice(k * per, (k + 1) * per) for k in range(mesh.size)]


def shard_batch(tree, mesh: Mesh) -> list:
    """Split every tensor with a leading axis into contiguous per-device
    blocks; scalar tensors are replicated to every device. Returns one tree
    per mesh device, in mesh order. A list of trees (already sharded) is
    returned as it is."""
    if isinstance(tree, list) and len(tree) == mesh.size and not \
            isinstance(tree[0], torch.Tensor):
        return tree
    bounds = shard_bounds(batch_size(tree), mesh)

    def piece(k):
        dev = mesh.devices[k]
        return _map(lambda x: (x if x.ndim == 0 else x[bounds[k]])
                    .to(dev).contiguous(), tree)

    return [piece(k) for k in range(mesh.size)]


def replicate(tree, mesh: Mesh) -> list:
    """``tree`` whole on every mesh device (a replicated operand)."""
    return [_map(lambda x, d=d: x.to(d), tree) for d in mesh.devices]


def gather_batch(shards: list, device=None, dim: int = 0):
    """Join per-device trees along ``dim`` (the plant axis) on ``device``
    (default: the first shard's device); scalar tensors come from the first
    shard."""
    device = torch.device(device) if device is not None else None

    def join(*xs):
        dev = device if device is not None else xs[0].device
        if xs[0].ndim == 0:
            return xs[0].to(dev)
        return torch.cat([x.to(dev) for x in xs], dim=dim)

    return _zip_map(join, shards)


def _zip_map(fn, trees):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _zip_map(fn, [getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first) if f.init})
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    return first


def _operand(x, mesh: Mesh) -> list:
    """A per-device operand: a sharded list as it is, anything else
    replicated."""
    if isinstance(x, list) and len(x) == mesh.size:
        return x
    return replicate(x, mesh)


def sharded_step(mesh: Mesh, dt: float, substeps: int):
    """``fn(params, state, boundary)``: ``core.reactor.step`` on each shard
    on its own device. ``params``/``state`` are sharded (``shard_batch``)
    or whole batches (sharded here); ``boundary`` is replicated unless it
    is a list of per-device boundaries. Returns the sharded state."""

    def fn(params, state, boundary):
        ps, ss = shard_batch(params, mesh), shard_batch(state, mesh)
        bs = _operand(boundary, mesh)
        return [R.step(p, s, b, dt=dt, substeps=substeps)
                for p, s, b in zip(ps, ss, bs)]

    return fn


def sharded_rollout(mesh: Mesh, dt: float, substeps: int, n_steps: int,
                    record: bool = False):
    """``fn(params, state, boundary) -> (states, trajectories)``:
    ``core.reactor.rollout`` on each shard on its own device, the sharded
    final state and, with ``record``, each shard's trajectory (its plant
    axis second, ``[n_steps, n_shard, Z]``; None otherwise)."""

    def fn(params, state, boundary):
        ps, ss = shard_batch(params, mesh), shard_batch(state, mesh)
        bs = _operand(boundary, mesh)
        outs = [R.rollout(p, s, b, dt=dt, substeps=substeps,
                          n_steps=n_steps, record=record)
                for p, s, b in zip(ps, ss, bs)]
        return ([o[0] for o in outs],
                [o[1] for o in outs] if record else None)

    return fn
