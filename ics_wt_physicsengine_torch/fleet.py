"""
Fleet serving: one Modbus/TCP endpoint, N independently controlled plants
(port of ``ics_wt_physicsengine_tpu/fleet.py``).

The device steps a batched instrumented plant (``models/plant.py``: physics
and all seven instruments per lane); the Modbus plane maps unit id ``u`` to
plant lane ``u - 1`` (``ModbusSlave(units=[1..N])``). Each unit has its own
register space, and its actuator commands are gathered on the host into one
``BoundaryConditions`` with ``[N]`` fields for the next step.

Run: ``python -m ics_wt_physicsengine_torch --fleet 8`` (the CUDA card;
``--device cpu`` for the plain PyTorch path on the CPU).

What runs where:
- the per-tick step (``step_masked``): ``plant_step_batched``, then each
  lane whose own ``simulation_running`` coil is cleared keeps its carry,
  every field of the plant included. Plain PyTorch on the plant's device;
  the instruments draw from the fleet's ``torch.Generator``, seeded from
  ``--seed``, for every lane at once (``draw_rand``).
- the fast-time chunk (``--serve-chunk N``, ``serve_chunk_masked``): one
  launch of kernel B3 a chunk for the whole fleet
  (``models.plant.plant_serve_chunk``), its plain version on the CPU. B3
  has no per-lane freeze, but the pause mask is constant over a chunk: every
  lane runs, and the paused lanes' carries (the whole plant, clock and
  sample-line rings included) are put back afterwards; their records are
  never read. B3 runs each lane on its own clock and its own slewing
  schedule. A fleet with an extension axis, which B3 refuses, takes the
  masked ``plant_step`` loop instead; the choice is made before any launch
  from what the plant shows, and a failed launch raises.
- ``--network`` (``step_masked_network``): each stage's inlet is blended
  from the routed, delayed outlet ring before the step, one step at a time
  (B3 cannot), so a network chunk is a loop of that step. A paused stage
  holds its carry and its held outlet keeps feeding downstream.
- sharding: with several visible cards and no ``--fleet-no-shard``, the
  lanes split over the largest divisor of N not above the card count
  (``parallel.mesh``), one B3 launch per card per chunk, each with its
  first lane as ``plant0``: B3's Philox counter takes the global lane, so a
  sharded fleet's noise equals the one-card fleet's, and the per-tick draws
  are made for every lane on the first card and split. The plain-loop
  fleets (``--network``, an extension axis) stay on one card.

Checkpoints hold the fleet's parameters and plant, the instruments'
generator state, the pipe ring of a network, and in the metadata the step
count (B3's noise is indexed by it), so that a resumed fleet continues its
noise. They do not load into the JAX package, nor its into the port (the
JAX plant carries PRNG keys).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from dataclasses import replace as dc_replace
from types import SimpleNamespace
import numpy as np
import torch

from ics_wt_physicsengine_torch.core.reactor import (BoundaryConditions,
                                                     IntegratedCSTR,
                                                     ReactorConfiguration)
from ics_wt_physicsengine_torch.device import numpy_dtype
from ics_wt_physicsengine_torch.models import plant as PL
from ics_wt_physicsengine_torch.parallel.mesh import (Mesh, gather_batch,
                                                      make_mesh, shard_batch,
                                                      shard_bounds)
from ics_wt_physicsengine_torch.sensors import ammonia as SA
from ics_wt_physicsengine_torch.sensors import oxygen as SO
from ics_wt_physicsengine_torch.sensors import turbidity as STB
from ics_wt_physicsengine_torch.sensors.types import (FAULT_FROM_CODE,
                                                      STATUS_FROM_CODE,
                                                      SensorFault,
                                                      SensorReading)

logger = logging.getLogger("ics_wt_physicsengine_torch.fleet")

# the extension instruments and their draws (the base seven:
# models.plant.draw_packed_rand)
_EXTRA_RAND = (("ammonia_outlet", SA), ("oxygen_outlet", SO),
               ("turbidity_outlet", STB))
# the reactor fields each extension axis publishes to the registers
_AXIS_FIELDS = (("ammonia", ("ammonia", "nitrite", "nitrate", "chloramine")),
                ("oxygen", ("oxygen", "carbonate")),
                ("tss", ("tss", "sludge")),
                ("pathogens", ("pathogens", "ct", "age", "toc", "thm")),
                ("bacteria", ("bacteria", "bdoc", "biofilm")))


# ---------------------------------------------------------------------------
# Boundaries
# ---------------------------------------------------------------------------

def _stack_boundaries(boundaries, dtype, device=None) -> BoundaryConditions:
    """Per-unit BoundaryConditions -> one with ``[N]`` tensor fields on
    ``device`` (a field None on every unit stays None)."""
    out = {}
    for f in dataclasses.fields(boundaries[0]):
        values = [getattr(b, f.name) for b in boundaries]
        out[f.name] = None if all(v is None for v in values) else \
            torch.from_numpy(np.array(values, numpy_dtype(dtype))).to(device)
    return BoundaryConditions(**out)


def _stack_boundary_schedule(applied, commanded, n_steps: int, dt: float,
                             tau: float, dtype, device=None):
    """Per-unit (applied, commanded) boundaries -> one chunk schedule with
    ``[n_steps, N]`` fields, plus the end-of-chunk per-unit boundaries.

    The fleet counterpart of ``__main__.build_chunk_schedule``: commands
    are held over the chunk, and each lane's actuator flows follow the
    closed-form first-order lag ``cmd + (applied_0 - cmd) * exp(-j dt /
    tau)``, computed in float64 NumPy and rounded once."""
    from ics_wt_physicsengine_torch import __main__ as M

    decay, end_decay = M._slew_decay(n_steps, dt, tau)
    decay = decay[:, None]
    held = _stack_boundaries(commanded, dtype, device)
    sched = {f.name: (None if getattr(held, f.name) is None else
                      getattr(held, f.name).expand(
                          (n_steps,) + tuple(getattr(held, f.name).shape)))
             for f in dataclasses.fields(held)}
    end = {}
    for f in M._ACTUATOR_FIELDS:
        a0 = np.array([getattr(a, f) for a in applied], np.float64)
        cmd = np.array([getattr(c, f) for c in commanded], np.float64)
        path = cmd[None, :] + (a0 - cmd)[None, :] * decay
        sched[f] = torch.from_numpy(
            path.astype(numpy_dtype(dtype))).to(device)
        end[f] = cmd + (a0 - cmd) * end_decay
    ends = [dc_replace(c, **{f: float(end[f][i]) for f in end})
            for i, c in enumerate(commanded)]
    return BoundaryConditions(**sched), ends


def _lane_rows(boundary: BoundaryConditions, lanes: slice, device):
    """Lanes ``lanes`` (the last axis) of a per-lane boundary or schedule,
    on ``device``; a scalar field holds for every lane."""
    def rows(x):
        if x is None or np.ndim(x) == 0:
            return x
        return torch.as_tensor(x)[..., lanes].to(device)

    return BoundaryConditions(**{f.name: rows(getattr(boundary, f.name))
                                 for f in dataclasses.fields(boundary)})


# ---------------------------------------------------------------------------
# Masked steps and chunks
# ---------------------------------------------------------------------------

def select_lanes(mask: torch.Tensor, new, old):
    """``new`` on the lanes where ``mask`` ([N] bool) is set, ``old`` on the
    others, in every tensor of two plant trees of one structure."""
    if isinstance(new, torch.Tensor):
        mk = mask.reshape(tuple(mask.shape) + (1,) * (new.ndim - 1))
        return torch.where(mk, new, old)
    if dataclasses.is_dataclass(new) and not isinstance(new, type):
        return dc_replace(new, **{
            f.name: select_lanes(mask, getattr(new, f.name),
                                 getattr(old, f.name))
            for f in dataclasses.fields(new) if f.init})
    return new


def draw_rand(generator: torch.Generator, params, n_lanes: int, dtype,
              device) -> dict:
    """Every instrument's draws for one step of ``n_lanes`` lanes from one
    generator: the base seven (``models.plant.draw_packed_rand``), then
    each extension instrument ``params`` carries."""
    rand = PL.draw_packed_rand(generator, (n_lanes,), dtype, device)
    for name, mod in _EXTRA_RAND:
        if getattr(params, name) is not None:
            rand[name] = (
                torch.randn((n_lanes, mod.N_NORMALS), generator=generator,
                            dtype=dtype, device=device),
                torch.rand((n_lanes, mod.N_UNIFORMS), generator=generator,
                           dtype=dtype, device=device))
    return rand


def step_masked(params, plant, boundary, mask, *, dt: float, substeps: int,
                stages=None, rand=None):
    """One batched step with per-lane freeze (JAX fleet.py:192-207): lanes
    where ``mask`` is False keep their carry. ``rand``: every instrument's
    draws (``draw_rand``)."""
    new, outputs = PL.plant_step_batched(
        params, plant, boundary, dt, substeps, stages=stages, rand=rand,
        boundary_axes=0)
    return select_lanes(mask, new, plant), outputs


def step_masked_network(params, plant, boundary, mask, ring, ring_index,
                        net, *, dt: float, substeps: int, stages=None,
                        rand=None):
    """The network step (JAX fleet.py:209-237): blend each stage's inlet
    from routed, delayed upstream effluent, step every stage, freeze the
    paused ones, then push the (held) outlets into the pipe ring slot
    ``ring_index % D``. Returns ``(plant, outputs, ring, ring_index +
    1)``."""
    from ics_wt_physicsengine_torch.core.network import (NetworkState,
                                                         _blended_boundary,
                                                         _outlet_sample)

    W, Minv, delays = net["arrays"]
    ns = NetworkState(reactor=plant.reactor, ring=ring,
                      ring_index=ring_index)
    pf = (params.reactor.particles.inlet_fractions
          if plant.reactor.tss is not None else None)
    eff, _ = _blended_boundary(W, Minv, delays, ns, boundary,
                               plant.reactor.ammonia is not None,
                               particle_fractions=pf)
    merged, outputs = step_masked(params, plant, eff, mask, dt=dt,
                                  substeps=substeps, stages=stages,
                                  rand=rand)
    sample = _outlet_sample(merged.reactor).to(ring.dtype)
    slot = torch.remainder(ring_index, ring.shape[0]).reshape(1)
    ring = ring.index_copy(0, slot, sample[None])
    return merged, outputs, ring, ring_index + 1


def _loop_chunk(step, plant, schedule, n_steps: int, record_every: int
                ) -> PL.ServeChunk:
    """A chunk as a loop of ``step(plant, row) -> (plant, outputs)`` over
    the rows of a ``[n_steps, N]`` schedule, recorded as
    ``plant_serve_chunk`` records."""
    rows, fault_rows = [], []
    for j in range(n_steps):
        row = BoundaryConditions(**{
            f.name: (None if getattr(schedule, f.name) is None else
                     getattr(schedule, f.name)[j])
            for f in dataclasses.fields(schedule)})
        plant, outputs = step(plant, row)
        if (j + 1) % record_every == 0:
            rows.append(torch.stack([o.value for o in outputs.values()]))
            fault_rows.append(torch.stack([o.fault.to(torch.int32)
                                           for o in outputs.values()]))
    names = tuple(outputs)
    ref = plant.reactor.pH
    shape = (0, len(names), ref.shape[0])
    values = torch.stack(rows) if rows else ref.new_empty(shape)
    faults = torch.stack(fault_rows) if fault_rows else torch.empty(
        shape, dtype=torch.int32, device=ref.device)
    last = {name: (o.value, o.status, o.fault)
            for name, o in outputs.items()}
    return PL.ServeChunk(plant, names, values, faults, last)


def serve_chunk_masked(params, plant, schedule, mask, *, dt: float,
                       substeps: int, stages=None, record_every: int = 1,
                       seed: int = 0, step0: int = 0, plant0: int = 0,
                       rand_fn=None, rng: str = "philox", bits=None
                       ) -> PL.ServeChunk:
    """A fleet's chunk over a ``[n_steps, N]`` schedule with the paused
    lanes (``mask`` False) frozen.

    Where kernel B3 supports the plant, one ``plant_serve_chunk`` (B3 on the
    card, its plain version on the CPU) over every lane, with the Philox
    stream of ``seed`` from step ``step0`` and lane ``plant0``, then the
    paused lanes' carries put back. Otherwise (an extension axis) the
    masked ``plant_step`` loop, each step's draws from ``rand_fn()``. A
    paused lane's records are not meaningful."""
    from ics_wt_physicsengine_torch.core.reactor import schedule_length
    from ics_wt_physicsengine_torch.ops import fused_plant as FP

    n_steps = schedule_length(schedule)
    if FP.unsupported_reason(params) is None:
        # read before the launch: a read after it would wait for the card
        # and serialize a sharded fleet's cards
        paused = not bool(mask.all())
        out = PL.plant_serve_chunk(
            params, plant, schedule, dt=dt, substeps=substeps, stages=stages,
            record_every=record_every, seed=seed, step0=step0,
            plant0=plant0, rng=rng, bits=bits)
        if paused:
            out.plant = select_lanes(mask, out.plant, plant)
        return out
    if bits is not None:
        raise ValueError("injected words need the fused plant kernel's "
                         "configuration (no extension axis)")

    def step(p, row):
        rand = rand_fn() if rand_fn is not None else None
        return step_masked(params, p, row, mask, dt=dt, substeps=substeps,
                           stages=stages, rand=rand)

    return _loop_chunk(step, plant, schedule, n_steps, record_every)


def serve_chunk_network(params, plant, schedule, mask, ring, ring_index,
                        net, *, dt: float, substeps: int, stages=None,
                        record_every: int = 1, rand_fn=None):
    """A network chunk (JAX fleet.py:264-273): the network step over the
    rows of a ``[n_steps, N]`` schedule, each step's draws from
    ``rand_fn()``. Returns ``(chunk, ring, ring_index)``."""
    from ics_wt_physicsengine_torch.core.reactor import schedule_length

    pipe = [ring, ring_index]

    def step(p, row):
        rand = rand_fn() if rand_fn is not None else None
        p, out, pipe[0], pipe[1] = step_masked_network(
            params, p, row, mask, pipe[0], pipe[1], net, dt=dt,
            substeps=substeps, stages=stages, rand=rand)
        return p, out

    out = _loop_chunk(step, plant, schedule, schedule_length(schedule),
                      record_every)
    return out, pipe[0], pipe[1]


# ---------------------------------------------------------------------------
# Host-side views of a step's or a chunk's results
# ---------------------------------------------------------------------------

def _host_outputs(outputs_list) -> tuple:
    """Per-tick outputs of every shard as host arrays: the names, floats
    ``[S, 6, N]`` (``__main__._FLOAT_OUTPUT_FIELDS``) and codes ``[S, 2,
    N]`` (status, fault); two device-to-host copies a shard."""
    from ics_wt_physicsengine_torch import __main__ as M

    names = list(outputs_list[0])
    floats, codes = [], []
    for outputs in outputs_list:
        floats.append(torch.stack([
            torch.stack([getattr(outputs[n], f).to(torch.float64)
                         for f in M._FLOAT_OUTPUT_FIELDS])
            for n in names]).cpu().numpy())
        codes.append(torch.stack([
            torch.stack([getattr(outputs[n], f).to(torch.int64)
                         for f in ("status", "fault")])
            for n in names]).cpu().numpy())
    return names, np.concatenate(floats, -1), np.concatenate(codes, -1)


def _host_chunks(chunks) -> dict:
    """Chunk results of every shard as host arrays, lanes last: the record
    (``values``/``faults`` ``[n_rec, S, N]``) and the last step's
    ``last`` ``[3, S, N]`` (value, status, fault)."""
    names = chunks[0].names
    last = [torch.stack([torch.stack([c.last[n][k].to(torch.float64)
                                      for n in names]) for k in range(3)])
            .cpu().numpy() for c in chunks]
    return dict(
        names=names,
        values=np.concatenate([c.values.cpu().numpy() for c in chunks], -1),
        faults=np.concatenate([c.faults.cpu().numpy() for c in chunks], -1),
        last=np.concatenate(last, -1))


def _lane_readings(names, floats, codes, lane: int) -> dict:
    from ics_wt_physicsengine_torch import __main__ as M

    return {name: SensorReading(
        **dict(zip(M._FLOAT_OUTPUT_FIELDS, map(float, floats[k, :, lane]))),
        status=STATUS_FROM_CODE[int(codes[k, 0, lane])],
        fault=FAULT_FROM_CODE[int(codes[k, 1, lane])])
        for k, name in enumerate(names)}


def _lane_chunk_readings(host: dict, lane: int, t: float) -> dict:
    nan = float("nan")
    value, status, fault = host["last"][:, :, lane]
    return {name: SensorReading(
        timestamp=t, value=float(value[k]), raw_value=nan, noise=nan,
        drift=nan, status=STATUS_FROM_CODE[int(status[k])], uncertainty=nan,
        fault=FAULT_FROM_CODE[int(fault[k])])
        for k, name in enumerate(host["names"])}


def _shard_count(n: int, n_devices: int) -> int:
    """The largest divisor of the fleet size not above the device count
    (JAX fleet.py:182-183)."""
    return max((k for k in range(2, min(n, n_devices) + 1) if n % k == 0),
               default=1)


def _network(spec, n: int, dtype, device) -> dict:
    from ics_wt_physicsengine_torch.core.network import (NetworkTopology,
                                                         topology_arrays)

    topo = NetworkTopology(
        routing=np.asarray(spec["routing"], np.float64),
        delay_steps=np.asarray(spec.get("delay_steps", 1), np.int64))
    if topo.n_plants != n:
        raise ValueError(f"network topology is {topo.n_plants} plants, "
                         f"fleet is {n}")
    ext_flow = [float(x) for x in spec.get(
        "external_inlet_flow", [5.0] + [0.0] * (n - 1))]
    if len(ext_flow) != n:
        raise ValueError("external_inlet_flow length mismatch")
    logger.info("Connected network: %d stages, %d live pipes, max delay %d "
                "ticks", n, int((topo.routing > 0).sum()), topo.max_delay)
    return {"arrays": topology_arrays(topo, dtype, device),
            "D": topo.max_delay, "ext_flow": ext_flow}


def _network_ring(plant, net):
    """The pipe ring filled with the stages' outlets, and its index."""
    from ics_wt_physicsengine_torch.core.network import _outlet_sample

    sample = _outlet_sample(plant.reactor)
    ring = sample[None].expand((net["D"],) + tuple(sample.shape)).clone()
    return ring, torch.zeros((), dtype=torch.int64, device=sample.device)


# ---------------------------------------------------------------------------
# The serving loop
# ---------------------------------------------------------------------------

def main_fleet(args, device: torch.device, orchestrator=None) -> int:
    """Fleet serving loop: main()'s five phases for N plants.
    ``orchestrator`` is the running ``__main__`` module, whose ``running``
    flag its signal handler clears (the loop stops on it)."""
    from ics_wt_physicsengine_torch import __main__ as M
    from ics_wt_physicsengine_torch.ops import fused_plant as FP
    from ics_wt_physicsengine_torch.modbus import (ModbusRegisterMap,
                                                   ModbusServerConfig,
                                                   ModbusSlave)
    from ics_wt_physicsengine_torch.utils.checkpoint import (load_metadata,
                                                             load_pytree,
                                                             merge_lanes,
                                                             save_pytree)

    orchestrator = orchestrator or M
    n = args.fleet
    units = list(range(1, n + 1))
    seed = args.seed or 0
    if args.fused_sensors:
        logger.warning("--fused-sensors is implied in fleet mode (the "
                       "batched step runs physics and instruments together) "
                       "— flag ignored")

    logger.info("=" * 70)
    logger.info("WATER TREATMENT PLANT FLEET (PYTORCH, %s) — %d plants",
                device.type.upper(), n)
    logger.info("=" * 70)

    # PHASE 1: batched physics + instruments (parameter-randomized lanes)
    logger.info("[PHASE 1] Initializing %d-plant batched engine...", n)
    try:
        config = ReactorConfiguration(
            volume=1000.0, n_zones=args.zones, flow_rate=5.0,
            initial_pH=7.2, initial_chlorine=2.0, temperature=20.0,
            enable_nitrogen=args.enable_nitrogen,
            initial_ammonia=args.initial_ammonia
            if args.enable_nitrogen else 0.0,
            enable_gas=args.enable_gas,
            enable_particles=args.enable_particles,
            initial_tss=args.initial_tss,
            enable_disinfection=args.enable_disinfection,
            initial_pathogens=args.initial_pathogens
            if args.enable_disinfection else 0.0,
            initial_toc=args.initial_toc,
            enable_biofilm=args.enable_biofilm,
            initial_bacteria=M._hpc_to_mgC(args.initial_hpc)
            if args.enable_biofilm else 0.0,
            initial_bdoc=args.initial_bdoc if args.enable_biofilm else 0.0,
            enable_phase=args.enable_phase)
        m, s = IntegratedCSTR(config, integrator=args.integrator,
                              device=device)._plan_for(args.dt)
        params, plant = PL.make_plant_batch(config, n, seed=seed,
                                            warmed_up=True, device=device)
        dtype = plant.reactor.pH.dtype

        spec = getattr(args, "network_spec", None)
        net = None if spec is None else _network(spec, n, dtype, device)

        # Shard the lanes over the visible cards (JAX fleet.py:164-188):
        # data parallelism, each card steps its block of lanes.
        mesh = Mesh((device,))
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        if net is not None and n_dev > 1:
            logger.info("Network mode: lane sharding disabled (%d devices "
                        "visible)", n_dev)
        elif n_dev > 1 and FP.unsupported_reason(params) is not None:
            logger.info("Extension axes: the masked plain loop stays on one "
                        "device (%d devices visible)", n_dev)
        elif n_dev > 1 and not args.fleet_no_shard:
            d = _shard_count(n, n_dev)
            if d > 1:
                from ics_wt_physicsengine_torch.utils.backend_select import (
                    select_devices)
                deadline = float(os.environ.get("WT_BACKEND_PROBE_DEADLINE",
                                                "60"))
                mesh = make_mesh(devices=select_devices(
                    d, probe_deadline=deadline, log=logger.info))
                logger.info("Fleet lanes sharded across %d devices (%d "
                            "plants/device)", d, n // d)
        bounds = shard_bounds(n, mesh)
        # the instruments' draws of the per-tick step and of the masked
        # loop, for every lane at once
        generator = torch.Generator(device=device).manual_seed(seed)

        chunk = max(1, int(args.serve_chunk))
        if chunk > 1:
            logger.info("Fast-time fleet serving enabled: %d steps per "
                        "register exchange in one device call", chunk)
        logger.info("Fleet engine initialized (%d zones, %s: substeps=%d%s, "
                    "one batched step/tick)", args.zones, args.integrator, m,
                    "" if s is None else f" x {s} stages")
    except Exception as e:  # noqa: BLE001
        logger.error("Fleet engine initialization failed: %s",
                     type(e).__name__)
        raise SystemExit(1)

    # PHASE 2: per-unit boundary conditions (network mode: inlet_* fields
    # are each stage's EXTERNAL source; routed inflow is blended per step)
    ext_flows = net["ext_flow"] if net is not None else [5.0] * n
    boundaries = [BoundaryConditions(
        inlet_flow_rate=ext_flows[i], inlet_pH=7.5, inlet_chlorine=0.0,
        inlet_temperature=20.0, acid_flow_rate=0.0, acid_concentration=0.1,
        chlorine_flow_rate=0.0,
        inlet_ammonia=args.initial_ammonia if args.enable_nitrogen else 0.0,
        inlet_pathogens=args.initial_pathogens
        if args.enable_disinfection else 0.0,
        inlet_toc=args.initial_toc if args.enable_disinfection else 0.0,
        inlet_bacteria=M._hpc_to_mgC(args.initial_hpc)
        if args.enable_biofilm else 0.0,
        inlet_bdoc=args.initial_bdoc if args.enable_biofilm else 0.0,
        ambient_temperature=args.ambient_temperature,
        ambient_humidity=args.ambient_humidity,
        wind_speed=args.wind_speed,
        heat_loss_coefficient=args.heat_loss_coefficient)
        for i in range(n)]

    # PHASE 3: sensors are in the batched carries (nothing host-side)
    # PHASE 4: one Modbus endpoint, one unit id per plant
    slave = None
    if not args.no_modbus:
        logger.info("[PHASE 4] Initializing Modbus server (units %d..%d)...",
                    units[0], units[-1])
        try:
            # fleet masters often hold one connection per unit
            server_config = ModbusServerConfig(
                host=args.host, port=args.port, unit_id=1,
                max_connections=max(32, 2 * n + 4),
                tls=getattr(args, "tls_config", None))
            register_map = ModbusRegisterMap(
                extended_nitrogen=args.enable_nitrogen,
                extended_gas=args.enable_gas,
                extended_particles=args.enable_particles,
                extended_disinfection=args.enable_disinfection,
                extended_biofilm=args.enable_biofilm,
                extended_phase=args.enable_phase)
            if args.native_modbus:
                from ics_wt_physicsengine_torch.modbus import (
                    NativeModbusSlave)
                slave = NativeModbusSlave(register_map, server_config,
                                          units=units)
            else:
                slave = ModbusSlave(register_map, server_config, units=units)
            # the listener starts after the checkpoint restore (below), so
            # that no master reads pre-restore defaults
            for i, u in enumerate(units):
                _init_unit_registers(slave, args, u, ext_flows[i])
            logger.info("Modbus register store initialized (%d units)", n)
        except Exception as e:  # noqa: BLE001
            logger.error("Modbus server startup failed: %s",
                         type(e).__name__)
            logger.warning("Continuing in no-Modbus mode")
            slave = None
    else:
        logger.info("[PHASE 4] Skipping Modbus (--no-modbus)")

    # PHASE 5: fleet loop
    logger.info("[PHASE 5] Starting fleet loop...")
    sim_time = 0.0
    step_count = 0
    log_interval = 60
    modbus_error_count = 0
    max_modbus_errors = 10
    recal_interval_s = args.recal_hours * 3600.0 if args.recal_hours > 0 \
        else float("inf")
    next_recal = recal_interval_s

    csv_file = None
    if args.log_csv:
        csv_file = open(args.log_csv, "a", buffering=1)
        if csv_file.tell() == 0:
            csv_file.write("sim_time,unit,pH_inlet,pH_outlet,"
                           "chlorine_inlet,chlorine_outlet,flow_main,"
                           "temp_inlet,temp_outlet,acid_cmd,chlorine_cmd,"
                           "inlet_flow_cmd,any_fault\n")
    parquet_log = None
    if args.log_parquet:
        try:
            from ics_wt_physicsengine_torch.utils import ParquetHistoryLogger
            parquet_log = ParquetHistoryLogger(
                args.log_parquet,
                ["sim_time", "unit", "pH_inlet", "pH_outlet",
                 "chlorine_inlet", "chlorine_outlet", "flow_main",
                 "temp_inlet", "temp_outlet", "acid_cmd", "chlorine_cmd",
                 "inlet_flow_cmd", "any_fault"],
                int_fields=["unit", "any_fault"],
                rotate_groups=args.log_parquet_rotate or None)
        except Exception as e:  # noqa: BLE001
            logger.error("Parquet logging unavailable: %s — continuing "
                         "without it", type(e).__name__)

    def log_rows(names, values, faults, t_np, run_mask, b_rows=None):
        """One history row per running lane: ``values``/``faults`` ``[S,
        N]`` host arrays of one step. ``b_rows``: per-lane boundaries for
        the command columns (a chunk's scheduled, mid-slew values)."""
        if csv_file is None and parquet_log is None:
            return
        col = {name: k for k, name in enumerate(names)}
        for i, u in enumerate(units):
            if not run_mask[i]:
                continue
            b = b_rows[i] if b_rows is not None else boundaries[i]
            any_fault = int(any(FAULT_FROM_CODE[int(f)] != SensorFault.NONE
                                for f in faults[:, i]))

            def fv(name):
                return float(values[col[name], i])

            if csv_file is not None:
                def v(name):
                    x = fv(name)
                    return f"{x:.6g}" if x == x else ""
                csv_file.write(
                    f"{float(t_np[i]):.3f},{u},{v('pH_inlet')},"
                    f"{v('pH_outlet')},{v('chlorine_inlet')},"
                    f"{v('chlorine_outlet')},{v('flow_main')},"
                    f"{v('temp_inlet')},{v('temp_outlet')},"
                    f"{b.acid_flow_rate:.6g},{b.chlorine_flow_rate:.6g},"
                    f"{b.inlet_flow_rate:.6g},{any_fault}\n")
            if parquet_log is not None:
                parquet_log.log({
                    "sim_time": float(t_np[i]), "unit": u,
                    **{name: fv(name) for name in (
                        "pH_inlet", "pH_outlet", "chlorine_inlet",
                        "chlorine_outlet", "flow_main", "temp_inlet",
                        "temp_outlet")},
                    "acid_cmd": float(b.acid_flow_rate),
                    "chlorine_cmd": float(b.chlorine_flow_rate),
                    "inlet_flow_cmd": float(b.inlet_flow_rate),
                    "any_fault": any_fault})

    # the fleet on its devices: one shard per device
    params_s, plant_s = shard_batch(params, mesh), shard_batch(plant, mesh)
    net_ring = net_idx = None
    if net is not None:
        net_ring, net_idx = _network_ring(plant, net)

    # Checkpoint/resume: the per-lane params and the whole batched plant,
    # the instruments' generator, the network ring; sim_time, the step
    # count, the per-unit boundaries and IO snapshot in the metadata.
    checkpoint_interval_s = args.checkpoint_hours * 3600.0 \
        if args.checkpoint_hours > 0 else float("inf")
    next_checkpoint = checkpoint_interval_s
    if args.checkpoint_file and os.path.exists(args.checkpoint_file):
        try:
            # stage everything, then commit: a failure anywhere leaves the
            # fresh start intact
            meta = load_metadata(args.checkpoint_file)
            n_saved = int(meta.get("fleet", n))
            if bool(meta.get("network", False)) != (net is not None):
                logger.error(
                    "Checkpoint %s %s a connected network but this run %s "
                    "— refusing to mix modes.", args.checkpoint_file,
                    "holds" if meta.get("network") else "does not hold",
                    "is one" if net is not None else "is not")
                raise SystemExit(1)
            if net is not None and n_saved != n:
                logger.error(
                    "Network checkpoints cannot be resized (%d saved stages "
                    "vs %d): the routing couples every stage.", n_saved, n)
                raise SystemExit(1)
            if n_saved != n and not args.checkpoint_resize:
                logger.error(
                    "Checkpoint %s holds a %d-plant fleet but --fleet is %d. "
                    "Pass --checkpoint-resize to explicitly slice/grow the "
                    "ensemble (lanes beyond the saved fleet start fresh), or "
                    "match --fleet %d.", args.checkpoint_file, n_saved, n,
                    n_saved)
                raise SystemExit(1)
            if n_saved != n:
                old_params, old_plant = PL.make_plant_batch(
                    config, n_saved, seed=int(meta.get("seed", 0)),
                    warmed_up=True, device=device)
                restored = load_pytree(args.checkpoint_file, {
                    "params": old_params, "plant": old_plant,
                    "generator": generator})
                restored["params"] = merge_lanes(restored["params"], params)
                restored["plant"] = merge_lanes(restored["plant"], plant)
                logger.info("Fleet resized from %d to %d plants (%d lanes "
                            "restored, %d fresh)", n_saved, n,
                            min(n_saved, n), max(0, n - n_saved))
            else:
                template = {"params": params, "plant": plant,
                            "generator": generator}
                if net is not None:
                    template["net_ring"] = net_ring
                    template["net_index"] = net_idx
                restored = load_pytree(args.checkpoint_file, template)
            new_bounds = [BoundaryConditions(**b)
                          for b in meta.get("boundaries", [])[:n]]
            params, plant = restored["params"], restored["plant"]
            params_s = shard_batch(params, mesh)
            plant_s = shard_batch(plant, mesh)
            generator = restored["generator"]
            if net is not None:
                net_ring, net_idx = restored["net_ring"], \
                    restored["net_index"]
            for i, b in enumerate(new_bounds):
                boundaries[i] = b
            sim_time = float(meta.get("sim_time", 0.0))
            step_count = int(meta.get("step_count",
                                      round(sim_time / args.dt)))
            next_checkpoint = sim_time + checkpoint_interval_s
            # maintenance stays on the absolute k * interval schedule
            if recal_interval_s != float("inf"):
                next_recal = (math.floor(sim_time / recal_interval_s) + 1) \
                    * recal_interval_s
            # the registers are the command source of truth: push the
            # restored operator intent back (raw registers and coils when
            # the checkpoint has them)
            unit_io = meta.get("unit_io") or []
            if slave:
                for i, u in enumerate(units):
                    io = unit_io[i] if i < len(unit_io) else None
                    if io:
                        for r, v in io.get("registers", {}).items():
                            slave.write_holding_register(r, v, unit=u)
                        for c, v in io.get("coils", {}).items():
                            slave.write_coil(c, v, unit=u)
                        continue
                    b = boundaries[i]
                    for r in ("acid_flow_rate", "chlorine_flow_rate",
                              "inlet_flow_rate", "acid_concentration",
                              "chlorine_concentration"):
                        slave.write_holding_register(r, getattr(b, r),
                                                     unit=u)
            logger.info("Resumed fleet from checkpoint %s at t=%.0fs",
                        args.checkpoint_file, sim_time)
        except Exception as e:  # noqa: BLE001
            # keep the incompatible checkpoint: the shutdown write would
            # otherwise overwrite it with a fresh t ~ 0
            backup = args.checkpoint_file + ".incompatible"
            try:
                os.replace(args.checkpoint_file, backup)
                logger.error("Fleet checkpoint resume failed: %s — starting "
                             "fresh; the old checkpoint was preserved at %s",
                             type(e).__name__, backup)
            except OSError:
                logger.error("Fleet checkpoint resume failed: %s — "
                             "starting fresh", type(e).__name__)

    # serve only now: the register stores hold the restored intent
    opcua_server = None
    if slave is not None:
        try:
            slave.start(blocking=False)
            logger.info("Modbus server started on %s:%d (%d units)",
                        args.host, slave.port, n)
        except Exception as e:  # noqa: BLE001
            logger.error("Modbus server startup failed: %s",
                         type(e).__name__)
            logger.warning("Continuing in no-Modbus mode")
            slave = None
    if args.opcua is not None and slave is not None:
        try:
            from ics_wt_physicsengine_torch.opcua import OPCUAServer
            opcua_server = OPCUAServer(slave, host=args.host,
                                       port=args.opcua)
            opcua_server.start(blocking=False)
            logger.info("OPC UA server started on opc.tcp://%s:%d/plant "
                        "(%d units)", args.host, opcua_server.actual_port, n)
        except Exception as e:  # noqa: BLE001
            logger.error("OPC UA server startup failed: %s",
                         type(e).__name__)
            logger.warning("Continuing without OPC UA")
            opcua_server = None

    def snapshot_unit_io():
        """Per-unit operator IO: the raw commanded holding registers and
        the coils (a disabled pump keeps its commanded rate here)."""
        if not slave:
            return None
        regs = ["acid_flow_rate", "chlorine_flow_rate", "inlet_flow_rate",
                "acid_concentration", "chlorine_concentration"]
        for on, extra in ((args.enable_nitrogen, ("inlet_ammonia",)),
                          (args.enable_gas, ("aeration_kla",)),
                          (args.enable_particles,
                           ("coagulant_dose", "filter_flow_rate",
                            "sludge_blowdown")),
                          (args.enable_disinfection,
                           ("uv_intensity", "inlet_toc")),
                          (args.enable_biofilm, ("inlet_bdoc", "inlet_hpc")),
                          (args.enable_phase,
                           ("ambient_humidity", "wind_speed",
                            "ambient_temperature"))):
            if on:
                regs += extra
        coils = ("acid_pump_enable", "chlorine_pump_enable",
                 "simulation_running")
        try:
            return [{"registers": {r: float(slave.read_holding_register(
                                       r, unit=u)) for r in regs},
                     "coils": {c: bool(slave.read_coil(c, unit=u))
                               for c in coils}}
                    for u in units]
        except Exception:  # noqa: BLE001 — the snapshot is best-effort
            return None

    def write_checkpoint():
        if not args.checkpoint_file:
            return
        try:
            tree = {"params": gather_batch(params_s),
                    "plant": gather_batch(plant_s), "generator": generator}
            if net is not None:
                tree["net_ring"] = net_ring
                tree["net_index"] = net_idx
            save_pytree(args.checkpoint_file, tree, metadata={
                "sim_time": sim_time, "step_count": step_count, "fleet": n,
                "network": net is not None, "zones": args.zones,
                "dt": args.dt, "seed": seed,
                "boundaries": [
                    {k: float(v) for k, v in dataclasses.asdict(b).items()
                     if v is not None and np.ndim(v) == 0}
                    for b in boundaries],
                "unit_io": snapshot_unit_io()})
            logger.info("t=%.0fs | fleet checkpoint written", sim_time)
        except Exception as e:  # noqa: BLE001
            logger.error("Fleet checkpoint write failed: %s",
                         type(e).__name__)

    commanded_targets = list(boundaries)   # per-unit actuator slew targets

    def lane_masks(run_mask):
        return [torch.from_numpy(run_mask[b].copy()).to(d)
                for d, b in zip(mesh.devices, bounds)]

    def run_recal(run_mask):
        """Sensor maintenance of the RUNNING lanes: fresh calibrated
        carries anchored at the current sim time (a paused lane's freeze
        holds through maintenance)."""
        nonlocal plant_s
        _, fresh = PL.make_plant_batch(config, n, seed=seed, randomize=False,
                                       warmed_up=True, t0=sim_time,
                                       device=device)
        plant_s = [select_lanes(mk, dc_replace(f, reactor=p.reactor), p)
                   for mk, f, p in zip(lane_masks(run_mask),
                                       shard_batch(fresh, mesh), plant_s)]
        # the draws after maintenance are re-seeded, as the JAX package
        # re-keys its fresh carries
        generator.manual_seed(seed + int(sim_time))
        logger.info("t=%.0fs | fleet sensor maintenance/recalibration done "
                    "(%d/%d lanes)", sim_time, int(run_mask.sum()), n)

    def rand_for():
        """Every instrument's draws of one step for all lanes, from the
        fleet's generator, split over the shards."""
        rand = draw_rand(generator, params_s[0], n, dtype, device)
        return [{k: tuple(x[b].to(d) for x in v) for k, v in rand.items()}
                for d, b in zip(mesh.devices, bounds)]

    def host_state():
        """The plant fields the registers read, on the host, lanes first."""
        reactor = [p.reactor for p in plant_s]

        def cat(name):
            return np.concatenate([getattr(r, name).detach().cpu().numpy()
                                   for r in reactor], 0)

        fields = {"pH": cat("pH")}
        if args.enable_phase:
            fields["temperature"] = cat("temperature")
        for probe, names in _AXIS_FIELDS:
            if getattr(reactor[0], probe) is not None:
                fields.update({k: cat(k) for k in names})
        return cat("time").reshape(-1), fields

    def publish(run_mask, t_np, st, readings_of):
        """Push each running lane's readings and state to its unit."""
        nonlocal modbus_error_count, slave
        ok = True
        for i, u in enumerate(units):
            if not run_mask[i]:
                continue   # a frozen lane keeps its last registers
            st_ns = SimpleNamespace(**{k: v[i] for k, v in st.items()})
            ok &= M.update_modbus_inputs(slave, readings_of(i), st_ns,
                                         float(t_np[i]), unit=u)
        if not ok:
            modbus_error_count += 1
            if modbus_error_count >= max_modbus_errors:
                logger.error("Too many Modbus errors, disabling interface")
                slave = None

    failure = None
    try:
        while orchestrator.running and sim_time < args.duration:
            step_start = time.monotonic()

            # each unit's own simulation_running coil freezes its lane;
            # the tick is skipped only when every lane is paused
            run_mask = np.ones(n, dtype=bool)
            if slave:
                for i, u in enumerate(units):
                    try:
                        run_mask[i] = slave.read_coil("simulation_running",
                                                      unit=u)
                    except Exception:  # noqa: BLE001
                        pass
            paused = not run_mask.any()

            if not paused and chunk > 1:
                # Fast-time fleet serving: every lane advances n_this steps
                # in one device call per shard; commands held over the
                # chunk, each lane's actuator slew in its schedule. The
                # last chunk clamps to the remaining horizon; an endless
                # run (the default --duration) is never clamped.
                remaining = (args.duration - sim_time) / args.dt
                n_this = chunk if remaining == float("inf") \
                    else min(chunk, max(1, int(round(remaining))))
                sched, ends = _stack_boundary_schedule(
                    boundaries, commanded_targets, n_this, args.dt,
                    args.actuator_tau, dtype, device)
                masks = lane_masks(run_mask)
                dec = max(1, int(args.log_decimate))
                try:
                    if net is not None:
                        result, net_ring, net_idx = serve_chunk_network(
                            params_s[0], plant_s[0], sched, masks[0],
                            net_ring, net_idx, net, dt=args.dt, substeps=m,
                            stages=s, record_every=dec,
                            rand_fn=lambda: rand_for()[0])
                        results = [result]
                    else:
                        results = [serve_chunk_masked(
                            p, pl, _lane_rows(sched, b, d), mk, dt=args.dt,
                            substeps=m, stages=s, record_every=dec,
                            seed=seed, step0=step_count, plant0=b.start,
                            rand_fn=lambda: rand_for()[0])
                            for p, pl, mk, d, b in zip(
                                params_s, plant_s, masks, mesh.devices,
                                bounds)]
                    plant_s = [r.plant for r in results]
                    host = _host_chunks(results)
                except Exception as e:  # noqa: BLE001
                    logger.error("Fleet chunk failed: %s: %s",
                                 type(e).__name__, e)
                    raise
                boundaries = [ends[i] if run_mask[i] else boundaries[i]
                              for i in range(n)]
                t_np, st = host_state()
                if slave:
                    publish(run_mask, t_np, st,
                            lambda i: _lane_chunk_readings(host, i,
                                                           float(t_np[i])))
                for i, u in enumerate(units):
                    if not run_mask[i] or not slave:
                        continue
                    commanded_targets[i] = M.apply_boundary_conditions(
                        boundaries[i], M.read_modbus_commands(slave, unit=u))
                # decimated in-chunk history: per-step clocks back-derived
                # from each lane's final clock, command columns from the
                # step's scheduled (mid-slew) actuator values
                if csv_file is not None or parquet_log is not None:
                    act = {f: getattr(sched, f).cpu().numpy()
                           for f in M._ACTUATOR_FIELDS}
                    for row, j in enumerate(range(dec - 1, n_this, dec)):
                        t_j = t_np - (n_this - 1 - j) * args.dt * run_mask
                        b_rows = [dc_replace(boundaries[i], **{
                            f: float(act[f][j, i])
                            for f in M._ACTUATOR_FIELDS}) for i in range(n)]
                        log_rows(host["names"], host["values"][row],
                                 host["faults"][row], t_j, run_mask, b_rows)
                if step_count % (max(1, log_interval // chunk) * chunk) == 0:
                    ph_out = host["last"][0, list(host["names"]).index(
                        "pH_outlet")]
                    fin = np.isfinite(ph_out)
                    if fin.any():
                        logger.info(
                            "t=%.0fs | fleet pH_out %.2f..%.2f (mean %.2f) "
                            "| %d/%d reporting | chunk=%d", sim_time,
                            np.nanmin(ph_out), np.nanmax(ph_out),
                            np.nanmean(ph_out), int(fin.sum()), n, n_this)
                    else:
                        logger.info("t=%.0fs | Fleet sensors warming up...",
                                    sim_time)
                step_count += n_this
                sim_time += n_this * args.dt
                if sim_time >= next_recal:
                    run_recal(run_mask)
                    next_recal += recal_interval_s
                if args.checkpoint_file and sim_time >= next_checkpoint:
                    write_checkpoint()
                    next_checkpoint += checkpoint_interval_s
            elif not paused:
                try:
                    bc = _stack_boundaries(boundaries, dtype, device)
                    masks = lane_masks(run_mask)
                    rands = rand_for()
                    if net is not None:
                        new, out, net_ring, net_idx = step_masked_network(
                            params_s[0], plant_s[0], bc, masks[0], net_ring,
                            net_idx, net, dt=args.dt, substeps=m, stages=s,
                            rand=rands[0])
                        steps = [(new, out)]
                    else:
                        steps = [step_masked(
                            p, pl, _lane_rows(bc, b, d), mk, dt=args.dt,
                            substeps=m, stages=s, rand=r)
                            for p, pl, mk, r, d, b in zip(
                                params_s, plant_s, masks, rands,
                                mesh.devices, bounds)]
                    plant_s = [x[0] for x in steps]
                    names, floats, codes = _host_outputs(
                        [x[1] for x in steps])
                except Exception as e:  # noqa: BLE001
                    logger.error("Fleet step failed: %s: %s",
                                 type(e).__name__, e)
                    raise

                # per-lane clocks: a paused lane's published
                # simulation_time holds with it
                t_np, st = host_state()
                if slave:
                    publish(run_mask, t_np, st,
                            lambda i: _lane_readings(names, floats, codes, i))
                for i, u in enumerate(units):
                    if not run_mask[i]:
                        continue   # frozen lane: no command reads, no slew
                    if slave:
                        commanded_targets[i] = M.apply_boundary_conditions(
                            boundaries[i],
                            M.read_modbus_commands(slave, unit=u))
                    # slew toward the last command even if Modbus died
                    boundaries[i] = M.apply_actuator_dynamics(
                        boundaries[i], commanded_targets[i], args.dt,
                        args.actuator_tau)
                log_rows(names, floats[:, 1], codes[:, 1], t_np, run_mask)

                if step_count % log_interval == 0:
                    ph_out = floats[names.index("pH_outlet"), 1]
                    cl_out = floats[names.index("chlorine_outlet"), 1]
                    fin = np.isfinite(ph_out)
                    if fin.any():
                        logger.info(
                            "t=%.0fs | fleet pH_out %.2f..%.2f (mean %.2f) "
                            "| Cl_out mean %.2f | %d/%d reporting", sim_time,
                            np.nanmin(ph_out), np.nanmax(ph_out),
                            np.nanmean(ph_out),
                            float(np.nanmean(cl_out[np.isfinite(cl_out)]))
                            if np.isfinite(cl_out).any() else float("nan"),
                            int(fin.sum()), n)
                    else:
                        logger.info("t=%.0fs | Fleet sensors warming up...",
                                    sim_time)
                step_count += 1
                sim_time += args.dt
                if sim_time >= next_recal:
                    run_recal(run_mask)
                    next_recal += recal_interval_s
                if args.checkpoint_file and sim_time >= next_checkpoint:
                    write_checkpoint()
                    next_checkpoint += checkpoint_interval_s

            # real-time pacing (reference __main__.py:453-457); a chunk
            # paces against its whole simulated span
            if args.rtf > 0:
                elapsed = time.monotonic() - step_start
                sleep_time = max(0.0, args.dt * chunk / args.rtf - elapsed)
                if sleep_time > 0:
                    time.sleep(sleep_time)

    except KeyboardInterrupt:
        logger.info("Keyboard interrupt received")
    except Exception as e:  # noqa: BLE001
        # a failed chunk, tick or launch ends the run with an error, after
        # the checkpoint and the servers' shutdown below
        logger.error("Fleet error: %s: %s", type(e).__name__, e)
        failure = e
    finally:
        logger.info("Shutting down fleet...")
        write_checkpoint()
        for closer in (csv_file, parquet_log):
            if closer is not None:
                try:
                    closer.close()
                except Exception:  # noqa: BLE001
                    pass
        if opcua_server:
            logger.info("Stopping OPC UA server...")
            try:
                opcua_server.stop()
            except Exception:  # noqa: BLE001
                pass
        if slave:
            logger.info("Stopping Modbus server...")
            try:
                slave.stop()
            except Exception:  # noqa: BLE001
                pass
        if failure is None:
            logger.info("Fleet stopped cleanly (t=%.0fs, %d steps x %d "
                        "plants)", sim_time, step_count, n)
    if failure is not None:
        raise SystemExit(1) from failure
    return 0


def _init_unit_registers(slave, args, unit: int, inlet_flow: float) -> None:
    """A unit's writable registers and coils at their defaults (JAX
    fleet.py:355-403)."""
    w = slave.write_holding_register
    w("inlet_flow_rate", inlet_flow, unit=unit)
    w("acid_concentration", 0.1, unit=unit)
    w("chlorine_concentration", 50.0, unit=unit)
    w("simulation_timestep", args.dt, unit=unit)
    if args.enable_nitrogen:
        w("inlet_ammonia", args.initial_ammonia, unit=unit)
    if args.enable_gas:
        w("aeration_kla", 0.0, unit=unit)
    if args.enable_particles:
        for r in ("coagulant_dose", "filter_flow_rate", "sludge_blowdown"):
            w(r, 0.0, unit=unit)
    if args.enable_disinfection:
        w("uv_intensity", 0.0, unit=unit)
        w("inlet_toc", args.initial_toc, unit=unit)
    if args.enable_biofilm:
        w("inlet_bdoc", args.initial_bdoc, unit=unit)
        w("inlet_hpc", args.initial_hpc, unit=unit)
    if args.enable_phase:
        w("ambient_humidity", args.ambient_humidity, unit=unit)
        w("wind_speed", args.wind_speed, unit=unit)
        w("ambient_temperature", args.ambient_temperature, unit=unit)
    for c in ("acid_pump_enable", "chlorine_pump_enable",
              "simulation_running"):
        slave.write_coil(c, True, unit=unit)
