"""
Zone-axis model parallelism: one column of zones split over devices (port
of ``ics_wt_physicsengine_tpu/parallel/spatial.py``).

The plant batch is the natural scaling axis (``parallel/mesh.py``), but one
very high-resolution plant (hundreds of zones: a contactor resolved at cm
scale) can be too fine for one device. Here the *zone* axis splits: each
device owns a contiguous block of zones, and at every integrator stage each
block is padded with one ghost zone a side, its neighbours' edge zones.

Design (one controller, as ``parallel/mesh.py``):
- A ``ZoneMesh`` is a grid of ``torch.device``s: one row of zone shards
  (``make_zone_mesh``), or rows over plants x columns over zones
  (``make_plant_zone_mesh``). A device may be listed more than once: the
  halos then stay on that device, which is how one card (or the CPU) runs
  several shards.
- A zone-sharded state is a list of ``ReactorState``s, one per device of a
  row, each holding its block of zones (``shard_state_zones``); the clock,
  the flow and the sludge inventory (which has no zone axis) are whole on
  every shard. ``shard_batch_zones`` splits a plant batch over a 2-D mesh
  into rows of such lists.
- Halos are exchanged at every stage, so the shards advance in lockstep:
  one integrator call (``ops/integrators.py``) runs over the flat tuple of
  every shard's fields. Its arithmetic is elementwise per tuple entry, so
  each entry stays on its device. The tuple's derivative pads each block
  (the neighbours' edge zones, copied device to device without blocking the
  host; mirror ghosts at the column's ends, whose exchange flux is zero),
  evaluates ``core.reactor.derivatives`` on it with the inlet and outlet on
  the shards that own them (``inlet_mask``/``outlet_mask``), and trims the
  ghosts. The sludge tendency, gated to the bottom shard, is summed over
  the shards in order (shard 0 first) and every shard integrates the same
  sum. Each shard then ends its step alone (``core.reactor.finish_step``),
  with the UV bank on the outlet shard's last zone. Every shard's work is
  issued before any result is awaited.

``lax.ppermute`` and ``psum`` in a ``shard_map`` become these copies and
this sum in one process; there is no multi-process path, as there is none in
the JAX module.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.ops import integrators
from ics_wt_physicsengine_torch.parallel.mesh import (PLANTS_AXIS, _leaves,
                                                      _map, _zip_map)

ZONE_AXIS = "zone"

# ReactorState fields without a zone axis: whole on every zone shard
_NO_ZONE_AXIS = ("time", "flow_rate", "sludge")


@dataclasses.dataclass(frozen=True)
class ZoneMesh:
    """A grid of devices: ``rows`` holds one tuple of devices per plant
    shard, each in zone order. ``axis_names`` is ``(zone,)`` for a 1-D zone
    mesh (one row) and ``(plants, zone)`` for a 2-D mesh."""

    rows: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        sizes = (len(self.rows[0]),) if len(self.axis_names) == 1 \
            else (len(self.rows), len(self.rows[0]))
        return dict(zip(self.axis_names, sizes))

    @property
    def devices(self) -> tuple:
        """Every device, row by row."""
        return tuple(d for row in self.rows for d in row)


def _visible_devices(devices):
    if devices is None:
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError(
                "no CUDA device is visible; name the devices (e.g. "
                "devices=[torch.device('cpu')] * 4) to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(count)]
    return [torch.device(d) for d in devices]


def make_zone_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None,
                   axis_name: str = ZONE_AXIS) -> ZoneMesh:
    """A 1-D mesh over the zone axis: ``devices`` in zone order (default:
    every visible CUDA device; the CPU only when the caller lists it), cut
    to the first ``n_devices``."""
    devices = _visible_devices(devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices={n_devices} of {len(devices)} "
                             "devices")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return ZoneMesh((tuple(devices),), (axis_name,))


def make_plant_zone_mesh(n_plant_shards: int, n_zone_shards: int,
                         devices: Optional[Sequence] = None,
                         plants_axis: str = PLANTS_AXIS,
                         zone_axis: str = ZONE_AXIS) -> ZoneMesh:
    """A 2-D mesh: ``n_plant_shards`` rows over the plant batch, each of
    ``n_zone_shards`` devices over the zones (the first ``n`` devices,
    row-major). Raises ``ValueError`` when there are fewer devices."""
    devices = _visible_devices(devices)
    n = n_plant_shards * n_zone_shards
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    rows = tuple(tuple(devices[r * n_zone_shards:(r + 1) * n_zone_shards])
                 for r in range(n_plant_shards))
    return ZoneMesh(rows, (plants_axis, zone_axis))


def _zone_block(x, k: int, n: int):
    z = x.shape[-1]
    if z % n:
        raise ValueError(f"n_zones={z} not divisible by mesh size {n}")
    per = z // n
    return x[..., k * per:(k + 1) * per]


def _split_zones(state: R.ReactorState, devices) -> List[R.ReactorState]:
    """One state per device, each with its block of zones."""
    n = len(devices)

    def piece(k):
        out = {}
        for f in dataclasses.fields(state):
            x = getattr(state, f.name)
            if x is not None and f.name not in _NO_ZONE_AXIS:
                x = _zone_block(x, k, n)
            out[f.name] = None if x is None \
                else x.to(devices[k]).contiguous()
        return dataclasses.replace(state, **out)

    return [piece(k) for k in range(n)]


def _row_of(mesh: ZoneMesh, axis_name: str):
    if len(mesh.axis_names) != 1 or mesh.axis_names[0] != axis_name:
        raise ValueError(f"a 1-D mesh over {axis_name!r} is needed, got the "
                         f"axes {mesh.axis_names} (shard a plant batch over "
                         "a 2-D mesh with shard_batch_zones)")
    return mesh.rows[0]


def shard_state_zones(state: R.ReactorState, mesh: ZoneMesh,
                      axis_name: str = ZONE_AXIS) -> List[R.ReactorState]:
    """Split a state's trailing zone axis over a 1-D zone mesh: one
    ``ReactorState`` per mesh device, in zone order. Leading batch axes stay
    whole; the clock, flow and sludge inventory are copied whole."""
    return _split_zones(state, _row_of(mesh, axis_name))


def gather_zones(shards, device=None) -> R.ReactorState:
    """Join zone shards (a list of states, or the rows of a 2-D mesh) into
    one state on ``device`` (default: the first shard's)."""
    if isinstance(shards[0], list):
        rows = [gather_zones(row, device) for row in shards]
        dev = rows[0].pH.device
        return _zip_map(lambda *xs: torch.cat([x.to(dev) for x in xs])
                        if xs[0].ndim else xs[0], rows)
    dev = torch.device(device) if device is not None \
        else shards[0].pH.device
    out = {}
    for f in dataclasses.fields(shards[0]):
        xs = [getattr(s, f.name) for s in shards]
        if xs[0] is None or f.name in _NO_ZONE_AXIS:
            out[f.name] = None if xs[0] is None else xs[0].to(dev)
        else:
            out[f.name] = torch.cat([x.to(dev) for x in xs], dim=-1)
    return dataclasses.replace(shards[0], **out)


def shard_batch_zones(tree, mesh: ZoneMesh, plants_axis: str = PLANTS_AXIS,
                      zone_axis: str = ZONE_AXIS) -> list:
    """Split a plant-batched tree over a 2-D mesh: rank-0 tensors are
    copied whole, rank-1 tensors (per-plant parameters, the clock, the
    flow) split over plants, tensors of rank 2 and more ([plants, ...,
    zones]) over plants and zones. The exceptions, whose trailing axis is a
    class axis and not a zone axis, split over plants only: the sludge
    inventory (``ReactorState.sludge``, [plants, C]) and every particle and
    disinfection parameter. Returns ``rows[r][c]``: the tree of plant shard
    r and zone shard c on its device."""
    if mesh.axis_names != (plants_axis, zone_axis):
        raise ValueError(f"a 2-D mesh over ({plants_axis!r}, {zone_axis!r})"
                         f" is needed, got {mesh.axis_names}")
    plants_only = set()
    if isinstance(tree, R.ReactorState) and tree.sludge is not None:
        plants_only.add(id(tree.sludge))
    if isinstance(tree, R.ReactorParams):
        for axis in ("particles", "disinfection"):
            if getattr(tree, axis) is not None:
                plants_only.update(id(x)
                                   for x in _leaves(getattr(tree, axis)))
    n_p, n_z = len(mesh.rows), len(mesh.rows[0])

    def cut(x, r, c):
        if x.ndim == 0:
            return x.to(mesh.rows[r][c])
        if x.shape[0] % n_p:
            raise ValueError(f"{x.shape[0]} plants do not divide over "
                             f"{n_p} plant shards")
        per = x.shape[0] // n_p
        block = x[r * per:(r + 1) * per]
        if x.ndim >= 2 and id(x) not in plants_only:
            block = _zone_block(block, c, n_z)
        return block.to(mesh.rows[r][c]).contiguous()

    return [[_map(lambda x, r=r, c=c: cut(x, r, c), tree)
             for c in range(n_z)] for r in range(n_p)]


def _replicated(tree, devices) -> list:
    if isinstance(tree, list):
        if len(tree) != len(devices):
            raise ValueError(f"{len(tree)} operands for {len(devices)} "
                             "shards")
        return tree
    return [_map(lambda x, d=d: x.to(d), tree) for d in devices]


def _one_hot(size: int, index: Optional[int], dtype, device):
    mask = torch.zeros(size, dtype=dtype, device=device)
    if index is not None:
        mask[index] = 1.0
    return mask


def _zone_step(params, states, boundaries, *, dt: float, substeps: int,
               stages, capable: dict, state_ndim: int, n_zones: int):
    """One step of a column split over ``len(states)`` zone shards (the
    shards of one plant row), all integrated in lockstep."""
    n = len(states)
    devs = [s.pH.device for s in states]
    local = n_zones // n
    for s in states:
        if s.pH.ndim != state_ndim or s.pH.shape[-1] != local:
            raise ValueError(
                f"a shard holds pH of shape {tuple(s.pH.shape)}; expected "
                f"rank {state_ndim} with {local} zones ({n_zones} zones "
                f"over {n} shards)")
    layouts = [R.species_layout(p, s) for p, s in zip(params, states)]
    spans = layouts[0][1]
    R.check_deriv_fn_axes(spans, capable)
    width = len(layouts[0][0])
    sludge = spans["particles"].start + 1 if "particles" in spans else -1
    dtype = states[0].pH.dtype
    # the inlet on the first shard's first zone, the outlet (and the free
    # surface) on the last shard's last zone, in padded coordinates
    inlet = [_one_hot(local + 2, 1 if k == 0 else None, dtype, devs[k])
             for k in range(n)]
    outlet = [_one_hot(local + 2, local if k == n - 1 else None, dtype,
                       devs[k]) for k in range(n)]
    uv = [None if params[k].disinfection is None else
          _one_hot(local, local - 1 if k == n - 1 else None, dtype, devs[k])
          for k in range(n)]

    def pad(ys, k, i):
        x = ys[k][i]
        left = x[..., :1] if k == 0 else \
            ys[k - 1][i][..., -1:].to(devs[k], non_blocking=True)
        right = x[..., -1:] if k == n - 1 else \
            ys[k + 1][i][..., :1].to(devs[k], non_blocking=True)
        return torch.cat([left, x, right], dim=-1)

    def f(flat):
        ys = [flat[k * width:(k + 1) * width] for k in range(n)]
        ds = []
        for k in range(n):
            y = tuple(ys[k][i] if i == sludge else pad(ys, k, i)
                      for i in range(width))
            ds.append(R.derivatives(
                params[k], y[0], y[1], y[2], boundaries[k],
                inlet_mask=inlet[k], outlet_mask=outlet[k],
                **{axis: y[sl] for axis, sl in spans.items()}))
        if sludge >= 0:
            total = ds[0][sludge]
            for k in range(1, n):
                total = total + ds[k][sludge].to(devs[0], non_blocking=True)
            sums = [total.to(d, non_blocking=True) for d in devs]
        return tuple(sums[k] if i == sludge else d[..., 1:-1]
                     for k in range(n) for i, d in enumerate(ds[k]))

    flat = tuple(x for y, _ in layouts for x in y)
    if stages is None:
        out = integrators.integrate_fixed(f, flat, dt, substeps)
    else:
        out = integrators.integrate_rkc(f, flat, dt, substeps, stages)
    return [R.finish_step(params[k], states[k], boundaries[k],
                          out[k * width:(k + 1) * width], spans, dt,
                          uv_mask=uv[k]) for k in range(n)]


def _check_divisible(n_zones: int, n_shards: int, what: str = "mesh size"):
    if n_zones % n_shards:
        raise ValueError(f"n_zones={n_zones} not divisible by "
                         f"{what} {n_shards}")


def _capable(nitrogen, gas, particles, disinfection, biofilm) -> dict:
    return dict(nitrogen=nitrogen, gas=gas, particles=particles,
                disinfection=disinfection, biofilm=biofilm)


def zone_sharded_step(mesh: ZoneMesh, n_zones: int, dt: float,
                      substeps: int, state_ndim: int = 1,
                      axis_name: str = ZONE_AXIS, stages=None,
                      nitrogen: bool = False, gas: bool = False,
                      particles: bool = False, disinfection: bool = False,
                      biofilm: bool = False):
    """``fn(params, state, boundary)``: one ``dt`` step of ``core.reactor.
    step`` with the zone axis split over a 1-D zone mesh. ``state`` is
    zone-sharded (``shard_state_zones``) or whole (sharded here);
    ``params`` and ``boundary`` are copied to every shard (or given as one
    per shard). Returns the zone-sharded state.

    ``n_zones`` must divide by the mesh size (``ValueError``).
    ``state_ndim`` is the rank of the primary fields (1: one plant, 2:
    ``[plants, zones]``). An enabled extension axis must be declared
    (``nitrogen=True``, ...), or the step raises ``ValueError``; ``stages``
    selects RKC2 as in ``step``."""
    row = _row_of(mesh, axis_name)
    _check_divisible(n_zones, len(row))
    capable = _capable(nitrogen, gas, particles, disinfection, biofilm)

    def fn(params, state, boundary):
        states = state if isinstance(state, list) else \
            _split_zones(state, row)
        return _zone_step(_replicated(params, row), states,
                          _replicated(boundary, row), dt=dt,
                          substeps=substeps, stages=stages, capable=capable,
                          state_ndim=state_ndim, n_zones=n_zones)

    return fn


def zone_sharded_rollout(mesh: ZoneMesh, n_zones: int, dt: float,
                         substeps: int, n_steps: int, state_ndim: int = 1,
                         axis_name: str = ZONE_AXIS, stages=None,
                         nitrogen: bool = False, gas: bool = False,
                         particles: bool = False, disinfection: bool = False,
                         biofilm: bool = False):
    """``fn(params, state, boundary)``: ``n_steps`` zone-sharded steps
    (``zone_sharded_step``'s arguments); returns the final zone-sharded
    state."""
    step = zone_sharded_step(mesh, n_zones, dt, substeps,
                             state_ndim=state_ndim, axis_name=axis_name,
                             stages=stages, nitrogen=nitrogen, gas=gas,
                             particles=particles, disinfection=disinfection,
                             biofilm=biofilm)
    row = mesh.rows[0]

    def fn(params, state, boundary):
        params, boundary = _replicated(params, row), \
            _replicated(boundary, row)
        for _ in range(n_steps):
            state = step(params, state, boundary)
        return state

    return fn


def _split_params(params, mesh: ZoneMesh) -> list:
    """Per-plant parameters (every tensor of rank >= 1) split over the plant
    shards and whole over the zone shards: ``rows[r][c]``."""
    n_p = len(mesh.rows)

    def cut(x, r, dev):
        if x.ndim == 0:
            return x.to(dev)
        per = x.shape[0] // n_p
        return x[r * per:(r + 1) * per].to(dev).contiguous()

    return [[_map(lambda x, r=r, d=d: cut(x, r, d), params) for d in row]
            for r, row in enumerate(mesh.rows)]


def plant_zone_sharded_step(mesh: ZoneMesh, n_zones: int, dt: float,
                            substeps: int, params_example=None,
                            plants_axis: str = PLANTS_AXIS,
                            zone_axis: str = ZONE_AXIS, stages=None,
                            nitrogen: bool = False, gas: bool = False,
                            particles: bool = False,
                            disinfection: bool = False,
                            biofilm: bool = False):
    """``fn(params, state, boundary)``: one batched step over a 2-D (plants
    x zones) mesh. Each row of the mesh steps its block of plants with their
    zones split over the row's devices; halos cross the zone shards only.
    ``state`` (and ``params``) are given as ``shard_batch_zones`` rows, or
    whole and split here: the state over plants and zones, the parameters
    (each tensor of rank >= 1 per plant) over plants only, as the JAX
    package's ``params_example`` specs do (the argument is kept for its
    signature; the split follows each tensor's own rank). ``boundary`` is
    copied to every shard. Returns the rows of zone-sharded states."""
    if mesh.axis_names != (plants_axis, zone_axis):
        raise ValueError(f"a 2-D mesh over ({plants_axis!r}, {zone_axis!r})"
                         f" is needed, got {mesh.axis_names}")
    _check_divisible(n_zones, len(mesh.rows[0]), "zone mesh size")
    capable = _capable(nitrogen, gas, particles, disinfection, biofilm)

    def fn(params, state, boundary):
        prow = params if isinstance(params, list) else \
            _split_params(params, mesh)
        srow = state if isinstance(state, list) else \
            shard_batch_zones(state, mesh, plants_axis, zone_axis)
        return [_zone_step(prow[r], srow[r], _replicated(boundary, row),
                           dt=dt, substeps=substeps, stages=stages,
                           capable=capable, state_ndim=2, n_zones=n_zones)
                for r, row in enumerate(mesh.rows)]

    return fn
