"""
The fused kernels over several devices: one launch per device on its block
of plants (port of ``ics_wt_physicsengine_tpu/parallel/fused.py``).

Kernels B1/B2 (``ops/fused_rollout.py``) and B3 (``ops/fused_plant.py``)
are single-device programs. Across devices the plant batch splits into
contiguous blocks (``parallel.mesh.shard_batch``) and each device runs its
block through its own launch; every device's launch is issued before any
result is awaited. No plant is coupled to another inside a rollout, so no
collective runs and each block's result equals the same block through the
single-device wrapper bit for bit. On CPU devices the wrappers run their
plain versions, as they do on one device.
"""

from __future__ import annotations

from dataclasses import fields

from ics_wt_physicsengine_torch.parallel.mesh import (  # noqa: F401
    PLANTS_AXIS, Mesh, _operand, batch_size, shard_batch)


def _is_schedule(boundary) -> bool:
    return any(getattr(getattr(boundary, f.name), "ndim", 0) >= 1
               for f in fields(boundary))


def sharded_rollout_fused(mesh: Mesh, *, dt: float, substeps: int,
                          n_steps: int, stages=None, record_every=None):
    """``fn(params, state, boundary)``: each device runs kernel B1 on its
    shard, or B2 when ``boundary`` is a ``[n_steps]`` schedule (replicated
    to every device; the JAX wrapper takes constant forcing only). Returns
    the sharded final state, or ``(states, trajectories)`` with
    ``record_every``."""
    from ics_wt_physicsengine_torch.ops import fused_rollout as F

    def fn(params, state, boundary):
        ps, ss = shard_batch(params, mesh), shard_batch(state, mesh)
        bs = _operand(boundary, mesh)
        outs = []
        for p, s, b in zip(ps, ss, bs):
            if _is_schedule(b):
                outs.append(F.rollout_scheduled_fused(
                    p, s, b, dt=dt, substeps=substeps, stages=stages,
                    record_every=record_every))
            else:
                outs.append(F.rollout_fused(
                    p, s, b, dt=dt, substeps=substeps, n_steps=n_steps,
                    stages=stages, record_every=record_every))
        if record_every is None:
            return outs
        return [o[0] for o in outs], [o[1] for o in outs]

    return fn


def sharded_plant_rollout_fused(mesh: Mesh, params, *, dt: float,
                                substeps: int, n_steps: int, stages=None,
                                record_every: int = 1, rng: str = "philox",
                                seed: int = 0, bits=None):
    """``fn(params, plant, boundary) -> (plants, readings)``: kernel B3 on
    each device's shard of the instrumented plant, physics and all seven
    instruments, one launch per device.

    ``params`` is the batched ``PlantParams``; a configuration the kernel
    does not support (an extension axis) is refused here, before any
    launch. Randomness: with ``rng="philox"`` every shard draws the Philox
    stream of ``seed`` from its first plant's index in the whole batch
    (B3's ``plant0``), so a shard's noise, and with it its result, equals
    its lanes of the one-device call (the JAX package seeds device k with
    ``seed + k * 1_000_003`` instead); ``rng="bits"`` replicates the given
    words ``[n_steps, 76, n_shard]`` to every shard.
    ``boundary`` is constant or a ``[n_steps]`` schedule, replicated.
    Returns the sharded final plant and, per shard, the readings (each
    sensor's ``[n_steps // record_every, n_shard]``: the plant axis
    second)."""
    from ics_wt_physicsengine_torch.ops import fused_plant as FP

    reason = FP.unsupported_reason(params)
    if reason is not None:
        raise ValueError(reason)
    if rng not in ("philox", "bits") or (rng == "bits") != (bits is not None):
        raise ValueError("rng must be 'philox', or 'bits' with bits=")

    def fn(p, plant, boundary):
        ps, pls = shard_batch(p, mesh), shard_batch(plant, mesh)
        bs = _operand(boundary, mesh)
        words = None if bits is None else _operand(bits, mesh)
        outs, plant0 = [], 0
        for k, (pk, plk, bk) in enumerate(zip(ps, pls, bs)):
            outs.append(FP.plant_rollout_fused(
                pk, plk, bk, dt=dt, substeps=substeps, n_steps=n_steps,
                stages=stages, record_every=record_every, rng=rng,
                bits=None if words is None else words[k], seed=seed,
                plant0=plant0))
            plant0 += batch_size(plk)
        return [o[0] for o in outs], [o[1] for o in outs]

    return fn
