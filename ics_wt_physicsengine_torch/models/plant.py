"""
Integrated plant model: physics + the full sensor suite in one step (port
of ``ics_wt_physicsengine_tpu/models/plant.py``).

The reactor advances dt, then the seven base instruments (and the ammonia,
oxygen and turbidity instruments of the nitrogen, gas and particle axes when
those are on) read the new state through their carried pipelines (delays,
drift, fouling, faults). Every function is natively batched: a plant batch
is the same ``PlantParams`` / ``PlantState`` structure with leading
``[n_plants]`` axes.

Randomness is explicit. The sensor carries hold no generator state: a step
takes pre-drawn ``rand=`` or a ``torch.Generator``, and the fused kernel
takes an integer ``seed``.

A plant with an extension axis runs the ``plant_step`` loop: the fused
plant kernel refuses the axes (``ops.fused_plant.unsupported_reason``).

``plant_serve_chunk`` is the serving loop's chunk (``python -m
ics_wt_physicsengine_torch --fused-sensors --serve-chunk N``): one launch of
the fused plant kernel on the card, its plain version on the CPU, returning
only what the serving loop reads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Dict, Optional, Tuple

import torch

from ics_wt_physicsengine_torch.core import particles as PC
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.device import DEFAULT_DTYPE, resolve_device
from ics_wt_physicsengine_torch.ops import fused_plant as FP
from ics_wt_physicsengine_torch.sensors import ammonia as SA
from ics_wt_physicsengine_torch.sensors import base as SB
from ics_wt_physicsengine_torch.sensors import chlorine as SC
from ics_wt_physicsengine_torch.sensors import flow as SF
from ics_wt_physicsengine_torch.sensors import oxygen as SO
from ics_wt_physicsengine_torch.sensors import ph as SP
from ics_wt_physicsengine_torch.sensors import temperature as ST
from ics_wt_physicsengine_torch.sensors import turbidity as STB
from ics_wt_physicsengine_torch.sensors.types import (InstallationQuality,
                                                      SampleLine, SensorFault,
                                                      SensorStatus)
from ics_wt_physicsengine_torch.utils.dispatch import checkpointed, map_tensors
from ics_wt_physicsengine_torch.utils.profiling import span, spanned


@dataclass(frozen=True)
class PlantParams:
    reactor: R.ReactorParams
    ph_inlet: SP.PHSensorParams
    ph_outlet: SP.PHSensorParams
    chlorine_inlet: SC.ChlorineSensorParams
    chlorine_outlet: SC.ChlorineSensorParams
    flow_main: SF.FlowSensorParams
    temp_inlet: ST.TemperatureSensorParams
    temp_outlet: ST.TemperatureSensorParams
    # the extension axes' instruments (None unless enable_nitrogen,
    # enable_gas, enable_particles)
    ammonia_outlet: Optional[SA.AmmoniaSensorParams] = None
    oxygen_outlet: Optional[SO.OxygenSensorParams] = None
    turbidity_outlet: Optional[STB.TurbiditySensorParams] = None


@dataclass
class PlantState:
    reactor: R.ReactorState
    ph_inlet: SP.PHSensorCarry
    ph_outlet: SP.PHSensorCarry
    chlorine_inlet: SC.ChlorineSensorCarry
    chlorine_outlet: SC.ChlorineSensorCarry
    flow_main: SF.FlowSensorCarry
    temp_inlet: ST.TemperatureSensorCarry
    temp_outlet: ST.TemperatureSensorCarry
    ammonia_outlet: Optional[SA.AmmoniaSensorCarry] = None
    oxygen_outlet: Optional[SO.OxygenSensorCarry] = None
    turbidity_outlet: Optional[STB.TurbiditySensorCarry] = None


# (reading name, PlantParams/PlantState attribute) in reading order
SENSOR_NAMES = (("pH_inlet", "ph_inlet"), ("pH_outlet", "ph_outlet"),
                ("chlorine_inlet", "chlorine_inlet"),
                ("chlorine_outlet", "chlorine_outlet"),
                ("flow_main", "flow_main"), ("temp_inlet", "temp_inlet"),
                ("temp_outlet", "temp_outlet"))


def make_plant(config: R.ReactorConfiguration, dtype=DEFAULT_DTYPE,
               warmed_up: bool = True, t0: float = 0.0, device=None
               ) -> Tuple[PlantParams, PlantState]:
    """Build the canonical plant on ``device`` (``None``: the CUDA card):
    seven base instruments, plus an outlet ammonia ISE, optical DO probe
    and nephelometer when the nitrogen, gas and particle axes are on.

    ``warmed_up=True`` backdates power-on so instruments read immediately
    (otherwise the first 1800 s of readings are warm-up NaN). ``t0`` anchors
    the warm start: calibration age and warm-up count from it."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    reactor_params = R.make_params(config, **kw)

    good_installation = InstallationQuality(
        flow_velocity=0.5, air_bubble_frequency=0.0, grounding_quality=0.9,
        pipe_vibration_g=0.1, ambient_temperature=30.0)
    line = SampleLine(volume_mL=250, flow_rate_mL_min=500, ambient_temp=25.0)

    ph_in_p = SP.make_ph_params(zone_index=0, sample_line=line,
                                installation=good_installation, **kw)
    ph_out_p = SP.make_ph_params(zone_index=-1, sample_line=line,
                                 installation=good_installation, **kw)
    cl_in_p = SC.make_chlorine_params(zone_index=0,
                                      sensor_type=SC.AMPEROMETRIC,
                                      installation=good_installation, **kw)
    cl_out_p = SC.make_chlorine_params(zone_index=-1, sensor_type=SC.DPD,
                                       installation=good_installation, **kw)
    fl_p = SF.make_flow_params(sensor_type=SF.MAGNETIC,
                               full_scale=config.flow_rate * 2.0,
                               installation=good_installation, **kw)
    t_in_p = ST.make_temperature_params(zone_index=0,
                                        sensor_type=ST.RTD_PT100,
                                        sample_line=line,
                                        installation=good_installation, **kw)
    t_out_p = ST.make_temperature_params(zone_index=-1,
                                         sensor_type=ST.RTD_PT100,
                                         sample_line=line,
                                         installation=good_installation,
                                         **kw)

    am_p = ox_p = tb_p = None
    if config.enable_nitrogen:
        am_p = SA.make_ammonia_params(zone_index=-1,
                                      installation=good_installation, **kw)
    if config.enable_gas:
        ox_p = SO.make_oxygen_params(zone_index=-1, sensor_type=SO.OPTICAL,
                                     installation=good_installation, **kw)
    if config.enable_particles:
        tb_p = STB.make_turbidity_params(zone_index=-1,
                                         installation=good_installation,
                                         **kw)

    params = PlantParams(
        reactor=reactor_params,
        ph_inlet=ph_in_p, ph_outlet=ph_out_p,
        chlorine_inlet=cl_in_p, chlorine_outlet=cl_out_p,
        flow_main=fl_p, temp_inlet=t_in_p, temp_outlet=t_out_p,
        ammonia_outlet=am_p, oxygen_outlet=ox_p, turbidity_outlet=tb_p)

    def backdate(carry, base_params):
        if not warmed_up:
            return carry
        t_on = t0 - float(base_params.warmup_time_s.cpu().numpy()) - 1.0
        b = carry.base
        return replace(carry, base=replace(
            b,
            power_on_time=SB._as(t_on, b.power_on_time),
            last_calibration_time=SB._as(t0, b.power_on_time),
            has_calibration=torch.ones_like(b.has_calibration)))

    state = PlantState(
        reactor=R.make_initial_state(config, **kw),
        ph_inlet=backdate(SP.make_ph_carry(ph_in_p, **kw), ph_in_p.base),
        ph_outlet=backdate(SP.make_ph_carry(ph_out_p, **kw), ph_out_p.base),
        chlorine_inlet=backdate(SC.make_chlorine_carry(cl_in_p, **kw),
                                cl_in_p.base),
        chlorine_outlet=backdate(SC.make_chlorine_carry(cl_out_p, **kw),
                                 cl_out_p.base),
        flow_main=backdate(SF.make_flow_carry(fl_p, **kw), fl_p.base),
        temp_inlet=backdate(ST.make_temperature_carry(t_in_p, **kw),
                            t_in_p.base),
        temp_outlet=backdate(ST.make_temperature_carry(t_out_p, **kw),
                             t_out_p.base),
        ammonia_outlet=None if am_p is None else backdate(
            SA.make_ammonia_carry(am_p, **kw), am_p.base),
        oxygen_outlet=None if ox_p is None else backdate(
            SO.make_oxygen_carry(ox_p, **kw), ox_p.base),
        turbidity_outlet=None if tb_p is None else backdate(
            STB.make_turbidity_carry(tb_p, **kw), tb_p.base))
    return params, state


def _zone(arr, idx: int):
    return arr[..., idx]


def plant_step(params: PlantParams, plant: PlantState,
               boundary: R.BoundaryConditions, dt: float, substeps: int,
               stages=None, rand=None, delayed=None, generator=None
               ) -> Tuple[PlantState, Dict[str, SB.SensorOutput]]:
    """Advance physics by dt, then read every instrument; one plant or a
    batch. ``stages`` selects the RKC2 integrator for the physics.
    ``rand``: optional ``{sensor_name: (normals, uniforms)}`` supplying
    every instrument's randomness (the sensor modules'
    N_NORMALS/N_UNIFORMS layouts); a sensor it does not name draws from
    ``generator``. ``delayed``: optional ``{sensor_name: value}`` of
    externally resolved sample-line taps (pH/temperature sensors only); the
    caller must pass params with ``line_capacity=0`` for those sensors."""
    state = R.step(params.reactor, plant.reactor, boundary, dt=dt,
                   substeps=substeps, stages=stages)
    return _read_all(params, state, plant, rand=rand, delayed=delayed,
                     generator=generator)


def _read_all(params: PlantParams, state: R.ReactorState, plant: PlantState,
              rand=None, delayed=None, generator=None
              ) -> Tuple[PlantState, Dict[str, SB.SensorOutput]]:
    """Read every instrument against an already-stepped reactor state (the
    sensor half of ``plant_step``)."""
    t = state.time
    rand = rand or {}
    delayed = delayed or {}

    def ph(name, p, c):
        return SP.ph_read(
            p, c, _zone(state.pH, p.zone_index),
            _zone(state.temperature, p.zone_index), t, rand=rand.get(name),
            delayed_true=delayed.get(name), generator=generator)

    def chlorine(name, p, c):
        # total-chlorine sensors respond to free + combined; the combined
        # (chloramine) species exists only under the nitrogen chemistry
        combined = None if state.chloramine is None \
            else _zone(state.chloramine, p.zone_index)
        return SC.chlorine_read(
            p, c, _zone(state.chlorine, p.zone_index),
            _zone(state.pH, p.zone_index), t, combined_zone=combined,
            rand=rand.get(name), generator=generator)

    def temperature(name, p, c):
        return ST.temperature_read(
            p, c, _zone(state.temperature, p.zone_index), t,
            rand=rand.get(name), delayed_true=delayed.get(name),
            generator=generator)

    ph_in_c, ph_in = ph("pH_inlet", params.ph_inlet, plant.ph_inlet)
    ph_out_c, ph_out = ph("pH_outlet", params.ph_outlet, plant.ph_outlet)
    cl_in_c, cl_in = chlorine("chlorine_inlet", params.chlorine_inlet,
                              plant.chlorine_inlet)
    cl_out_c, cl_out = chlorine("chlorine_outlet", params.chlorine_outlet,
                                plant.chlorine_outlet)
    fl_c, fl = SF.flow_read(params.flow_main, plant.flow_main,
                            state.flow_rate, t, rand=rand.get("flow_main"),
                            generator=generator)
    t_in_c, t_in = temperature("temp_inlet", params.temp_inlet,
                               plant.temp_inlet)
    t_out_c, t_out = temperature("temp_outlet", params.temp_outlet,
                                 plant.temp_outlet)

    extra = {}
    am_c, ox_c, tb_c = (plant.ammonia_outlet, plant.oxygen_outlet,
                        plant.turbidity_outlet)
    ap = params.ammonia_outlet
    if ap is not None and state.ammonia is not None:
        am_c, extra["ammonia_outlet"] = SA.ammonia_read(
            ap, am_c, _zone(state.ammonia, ap.zone_index),
            _zone(state.pH, ap.zone_index),
            _zone(state.temperature, ap.zone_index), t,
            rand=rand.get("ammonia_outlet"), generator=generator)
    op = params.oxygen_outlet
    if op is not None and state.oxygen is not None:
        ox_c, extra["oxygen_outlet"] = SO.oxygen_read(
            op, ox_c, _zone(state.oxygen, op.zone_index),
            _zone(state.temperature, op.zone_index), state.flow_rate, t,
            rand=rand.get("oxygen_outlet"), generator=generator)
    tp = params.turbidity_outlet
    if tp is not None and state.tss is not None:
        true_ntu = PC.turbidity_ntu_tap(_zone(state.tss, tp.zone_index),
                                        params.reactor.particles)
        tb_c, extra["turbidity_outlet"] = STB.turbidity_read(
            tp, tb_c, true_ntu, t, rand=rand.get("turbidity_outlet"),
            generator=generator)

    new_plant = PlantState(
        reactor=state, ph_inlet=ph_in_c, ph_outlet=ph_out_c,
        chlorine_inlet=cl_in_c, chlorine_outlet=cl_out_c, flow_main=fl_c,
        temp_inlet=t_in_c, temp_outlet=t_out_c, ammonia_outlet=am_c,
        oxygen_outlet=ox_c, turbidity_outlet=tb_c)
    readings = {
        "pH_inlet": ph_in, "pH_outlet": ph_out,
        "chlorine_inlet": cl_in, "chlorine_outlet": cl_out,
        "flow_main": fl, "temp_inlet": t_in, "temp_outlet": t_out,
        **extra,
    }
    return new_plant, readings


def _stack_values(records):
    return {name: torch.stack([r[name] for r in records])
            for name in records[0]}


def plant_rollout(params: PlantParams, plant: PlantState,
                  boundary: R.BoundaryConditions, dt: float, substeps: int,
                  n_steps: int, record: bool = True, stages=None,
                  generator=None, remat: bool = False):
    """Loop ``plant_step`` over ``n_steps``. Returns ``(plant, readings)``
    where readings maps each sensor name to its measured values
    ``[n_steps, ...]`` (None when ``record=False``). ``remat=True``
    checkpoints each step for long-horizon gradients
    (``utils.dispatch.checkpointed``: the backward pass recomputes the
    step with the same noise)."""
    records = []
    for _ in range(n_steps):
        if remat:
            plant, readings = checkpointed(
                lambda p, generator: plant_step(
                    params, p, boundary, dt, substeps, stages=stages,
                    generator=generator), plant, generator=generator)
        else:
            plant, readings = plant_step(params, plant, boundary, dt,
                                         substeps, stages=stages,
                                         generator=generator)
        if record:
            records.append({k: v.value for k, v in readings.items()})
    return plant, (_stack_values(records) if record and records else None)


def _normalize_schedule(schedule: R.BoundaryConditions, device):
    """``(columns, n_steps)``: the schedule's ``[n_steps]`` fields as tensors
    on ``device``, scalar fields as they are."""
    n_steps = R.schedule_length(schedule)
    columns = {}
    for f in fields(schedule):
        x = getattr(schedule, f.name)
        if getattr(x, "ndim", 0) >= 1:
            x = torch.as_tensor(x, device=device)
        columns[f.name] = x
    return columns, n_steps


def _row(columns, i) -> R.BoundaryConditions:
    return R.BoundaryConditions(**{
        name: (x[i] if isinstance(x, torch.Tensor) and x.ndim else x)
        for name, x in columns.items()})


def plant_rollout_scheduled(params: PlantParams, plant: PlantState,
                            schedule: R.BoundaryConditions, dt: float,
                            substeps: int, record: bool = True,
                            stages=None, generator=None):
    """Loop ``plant_step`` over a time-varying boundary schedule (see
    ``core.reactor.rollout_scheduled``): physics + every instrument
    under scripted forcing."""
    columns, n_steps = _normalize_schedule(schedule,
                                           plant.reactor.pH.device)
    records = []
    for i in range(n_steps):
        plant, readings = plant_step(params, plant, _row(columns, i), dt,
                                     substeps, stages=stages,
                                     generator=generator)
        if record:
            records.append({k: v.value for k, v in readings.items()})
    return plant, (_stack_values(records) if record else None)


def plant_rollout_serve(params: PlantParams, plant: PlantState,
                        schedule: R.BoundaryConditions, dt: float,
                        substeps: int, stages=None, generator=None):
    """One hardware-in-the-loop serving chunk: advance the plant under a
    per-step boundary schedule, recording the full ``SensorOutput`` every
    step. Returns ``(final_plant, per_step_readings)`` where every field of
    ``per_step_readings[name]`` is ``[n_steps, ...]``."""
    columns, n_steps = _normalize_schedule(schedule,
                                           plant.reactor.pH.device)
    records = []
    for i in range(n_steps):
        plant, readings = plant_step(params, plant, _row(columns, i), dt,
                                     substeps, stages=stages,
                                     generator=generator)
        records.append(readings)
    per_step = {
        name: SB.SensorOutput(**{
            f.name: torch.stack([getattr(r[name], f.name) for r in records])
            for f in fields(SB.SensorOutput)})
        for name in records[0]}
    return plant, per_step


@dataclass
class ServeChunk:
    """What a serving chunk gives the serving loop (``plant_serve_chunk``):
    the final plant; the record's sensor columns (``names``), their measured
    values and fault codes at every ``record_every``-th step, ``[n_steps //
    record_every, len(names)(, B)]``; and the last step's ``(value, status,
    fault)`` of every instrument (``last``), status and fault int32
    codes."""

    plant: PlantState
    names: Tuple[str, ...]
    values: torch.Tensor
    faults: torch.Tensor
    last: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


_POWER_FAULTS = (SB._F[SensorFault.POWER_LOW], SB._F[SensorFault.POWER_HIGH])


def _last_codes(params, plant: PlantState, fault, attr: str):
    """The last reading's status of instrument ``attr``, from its returned
    carry and the reading's fault code, by the gates of
    ``sensors.base.base_read``: a power fault on either path reads
    POWER_FAULT; otherwise a sensor still warming up reads WARMING_UP (its
    carry keeps the status from before); otherwise the carry holds the
    reading's status."""
    carry = getattr(plant, attr).base
    warmup = getattr(params, attr).base.warmup_time_s
    t = plant.reactor.time.to(carry.power_on_time.dtype)
    warming = (t - carry.power_on_time) < warmup
    power = (fault == _POWER_FAULTS[0]) | (fault == _POWER_FAULTS[1])
    status = torch.where(
        power, SB._S[SensorStatus.POWER_FAULT],
        torch.where(warming, SB._S[SensorStatus.WARMING_UP], carry.status))
    return status.to(torch.int32)


@spanned("wt.serve.chunk")
def plant_serve_chunk(params: PlantParams, plant: PlantState,
                      schedule: R.BoundaryConditions, *, dt: float,
                      substeps: int, stages=None, record_every: int = 1,
                      seed: int = 0, step0: int = 0, plant0: int = 0,
                      rng: str = "philox", bits=None) -> ServeChunk:
    """One serving chunk: advance the plant under a per-step boundary
    schedule (``[n_steps]`` fields, or ``[n_steps, B]`` fields of a
    schedule per plant: a fleet's) and return what the serving loop reads
    (``ServeChunk``): the last step's readings for the register snapshot,
    values and fault codes at every ``record_every``-th step for the
    history (the record starts with step ``record_every - 1``; a chunk
    shorter than ``record_every`` records nothing), and the final plant.

    Routing, decided before any launch from what the plant shows: a plant
    on the CUDA card that the fused plant kernel supports
    (``ops.fused_plant.unsupported_reason`` is None) runs in one launch of
    that kernel, a CPU one in its plain version; a plant with an extension
    axis takes the ``plant_step`` loop on its own device. A failed launch
    raises; nothing reroutes.

    Randomness: the kernel's Philox stream of ``seed`` from global step
    ``step0`` (pass the serving loop's step count and the same seed every
    chunk: a run's noise then does not depend on how it is chunked) and
    plant ``plant0`` (the first lane of this batch in a fleet split over
    cards: the noise then does not depend on the split), or the injected
    ``bits`` ``[n_steps, 76, B]`` with ``rng="bits"``. The
    ``plant_step`` loop draws from a ``torch.Generator`` seeded with
    ``seed`` and ``step0`` (different noise every chunk, not
    chunk-invariant).

    Sample lines: the chunk consumes the incoming rings and hands on rings
    joined with them (``ops.fused_plant._join_rings``), so that chunks
    shorter than a line's delay chain as one longer chunk would; a chunk
    from a plant whose rings the ``plant_step`` loop filled keeps the fused
    kernel's documented differences (``ops/fused_plant.py``).

    The kernel records every ``gcd(n_steps, record_every)``-th step, so
    that its last row is the last step; the record returned is every
    ``record_every``-th of those. The last step's value is the carried last
    value, its fault code the kernel's, its status the carry's as
    ``_last_codes`` resolves it."""
    if record_every < 1:
        raise ValueError(f"record_every must be >= 1, got {record_every}")
    if rng not in ("philox", "bits") or (rng == "bits") != (bits is not None):
        raise ValueError("rng must be 'philox', or 'bits' with bits=")
    n_steps = R.schedule_length(schedule)
    if FP.unsupported_reason(params) is None:
        every = math.gcd(n_steps, record_every)
        new_plant, values, faults = FP._rollout_with(
            FP.table_runner(params, plant), params, plant, schedule, dt=dt,
            substeps=substeps, n_steps=n_steps, stages=stages,
            record_every=every, bits=bits, seed=seed,
            consume_line=True, step0=step0, plant0=plant0, served=True)
        with span("wt.serve.codes"):
            last = {}
            for k, (name, attr, _) in enumerate(FP.SENSORS):
                fault = faults[-1, k]
                last[name] = (getattr(new_plant, attr).base.last_value,
                              _last_codes(params, new_plant, fault, attr),
                              fault)
        k = record_every // every
        return ServeChunk(new_plant, tuple(last), values[k - 1::k],
                          faults[k - 1::k], last)

    if bits is not None:
        raise ValueError("injected words need the fused plant kernel's "
                         "configuration (no extension axis)")
    device = plant.reactor.pH.device
    generator = torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + int(step0)) & 0x7FFFFFFFFFFFFFFF)
    columns, _ = _normalize_schedule(schedule, device)
    rows, fault_rows = [], []
    for i in range(n_steps):
        plant, readings = plant_step(params, plant, _row(columns, i), dt,
                                     substeps, stages=stages,
                                     generator=generator)
        if (i + 1) % record_every == 0:
            rows.append(torch.stack([r.value for r in readings.values()]))
            fault_rows.append(torch.stack([r.fault for r in
                                           readings.values()]))
    names = tuple(readings)
    shape = (0, len(names)) + tuple(plant.reactor.time.shape)
    values = torch.stack(rows) if rows else torch.empty(
        shape, dtype=plant.reactor.pH.dtype, device=device)
    faults = torch.stack(fault_rows) if fault_rows else torch.empty(
        shape, dtype=torch.int32, device=device)
    last = {name: (r.value, r.status, r.fault)
            for name, r in readings.items()}
    return ServeChunk(plant, names, values, faults, last)


def make_plant_batch(config: R.ReactorConfiguration, n_plants: int,
                     seed: int = 0, dtype=DEFAULT_DTYPE,
                     randomize: bool = True, warmed_up: bool = True,
                     t0: float = 0.0, device=None):
    """Batched integrated plants: physics params randomized per plant from
    ``seed`` (``models/monte_carlo.py`` ranges) when ``randomize``, the
    same sensor configuration for every plant. Returns (params, state) with
    leading ``[n_plants]`` axes."""
    from ics_wt_physicsengine_torch.models.monte_carlo import (
        make_monte_carlo_batch)

    if n_plants < 1:
        raise ValueError(f"n_plants must be >= 1, got {n_plants}")
    dev = resolve_device(device)
    template_p, template_s = make_plant(config, dtype=dtype,
                                        warmed_up=warmed_up, t0=t0,
                                        device=dev)

    def bcast(x):
        return x.expand((n_plants,) + tuple(x.shape)).clone()

    params = map_tensors(bcast, template_p)
    state = map_tensors(bcast, template_s)
    if randomize:
        reactor_params, reactor_states = make_monte_carlo_batch(
            config, n_plants, seed=seed, dtype=dtype, device=dev)
        params = replace(params, reactor=reactor_params)
        state = replace(state, reactor=reactor_states)
    return params, state


def plant_step_batched(params: PlantParams, plant: PlantState,
                       boundary: R.BoundaryConditions, dt: float,
                       substeps: int, stages=None, rand=None,
                       boundary_axes=None, generator=None):
    """``plant_step`` over the leading plant axis (the step is natively
    batched). ``rand``: optional externally drawn randomness,
    ``{sensor: (normals[n, k], uniforms[n, k])}``, see
    ``draw_packed_rand``. ``boundary_axes=0`` takes a BoundaryConditions
    whose fields carry a leading ``[n_plants]`` axis (fleet mode: one
    independently controlled boundary per plant); None broadcasts one
    boundary."""
    if boundary_axes not in (None, 0):
        raise ValueError(f"boundary_axes must be None or 0, got "
                         f"{boundary_axes!r}")
    n_plants = plant.reactor.pH.shape[0]
    for f in fields(boundary):
        x = getattr(boundary, f.name)
        if x is None:               # an unset per-class inlet vector
            continue
        ndim = getattr(x, "ndim", 0)
        if boundary_axes is None and ndim:
            raise ValueError(f"boundary.{f.name} has a leading axis; pass "
                             "boundary_axes=0 for per-plant boundaries")
        if boundary_axes == 0 and (ndim != 1 or x.shape[0] != n_plants):
            raise ValueError(f"boundary.{f.name} must be [{n_plants}] with "
                             "boundary_axes=0")
    return plant_step(params, plant, boundary, dt, substeps, stages=stages,
                      rand=rand, generator=generator)


# Canonical order + per-sensor randomness widths (base layout first, then
# each overlay's extra draws).
_RAND_LAYOUT = (
    ("pH_inlet", SP.N_NORMALS, SP.N_UNIFORMS),
    ("pH_outlet", SP.N_NORMALS, SP.N_UNIFORMS),
    ("chlorine_inlet", SC.N_NORMALS, SC.N_UNIFORMS),
    ("chlorine_outlet", SC.N_NORMALS, SC.N_UNIFORMS),
    ("flow_main", SF.N_NORMALS, SF.N_UNIFORMS),
    ("temp_inlet", ST.N_NORMALS, ST.N_UNIFORMS),
    ("temp_outlet", ST.N_NORMALS, ST.N_UNIFORMS),
)
_TOT_N = sum(n for _, n, _ in _RAND_LAYOUT)
_TOT_U = sum(u for _, _, u in _RAND_LAYOUT)


def draw_packed_rand(generator, batch_shape, dtype, device):
    """The seven base instruments' per-read randomness in two generates
    from one generator; every element is an independent standard draw (the
    extension instruments draw from the step's ``generator``). Returns the
    ``rand=`` dict consumed by ``plant_step``/``_read_all``."""
    batch_shape = tuple(batch_shape)
    normals = torch.randn(batch_shape + (_TOT_N,), generator=generator,
                          dtype=dtype, device=device)
    uniforms = torch.rand(batch_shape + (_TOT_U,), generator=generator,
                          dtype=dtype, device=device)
    rand, i, j = {}, 0, 0
    for name, nn, nu in _RAND_LAYOUT:
        rand[name] = (normals[..., i:i + nn], uniforms[..., j:j + nu])
        i, j = i + nn, j + nu
    return rand


# Sensors whose reads accept an externally resolved sample tap (reading
# name, PlantParams/PlantState attribute)
_LINE_SENSORS = (("pH_inlet", "ph_inlet"), ("pH_outlet", "ph_outlet"),
                 ("temp_inlet", "temp_inlet"), ("temp_outlet", "temp_outlet"))


def _static_line_taps(params: PlantParams, dt: float) -> Dict[str, int]:
    """``{reading_name: tap_steps}`` for the line sensors whose delay is the
    same for every plant of the batch, the condition of the fixed-dt tap
    path; a sensor whose delays differ keeps the exact ring. The tap is
    clamped to ``capacity - 1``: the oldest sample a full ring can reach,
    so both schemes resolve the same sample."""
    taps = {}
    for rname, fname in _LINE_SENSORS:
        base = getattr(params, fname).base
        if base.line_capacity <= 0:
            continue
        delay = base.line_delay_s.detach().reshape(-1).cpu()
        if delay.numel() > 1 and not bool(torch.all(delay == delay[0])):
            continue
        k = max(0, int(round(float(delay[0]) / dt)))
        taps[rname] = min(k, base.line_capacity - 1)
    return taps


def _disable_lines(params: PlantParams, taps) -> PlantParams:
    """``params`` with ``line_capacity=0`` on the tap-resolved sensors, so
    their reads skip the carried ring (which passes through untouched)."""
    out = {}
    for rname, fname in _LINE_SENSORS:
        if rname in taps:
            sp = getattr(params, fname)
            out[fname] = replace(sp, base=replace(sp.base, line_capacity=0))
    return replace(params, **out)


def _line_true_values(params: PlantParams, state: R.ReactorState, taps):
    """The pre-line sample of each tap sensor, computed as its read would:
    the Nernst-compensated pH (``ph.ph_read``) or the zone's temperature."""
    out = {}
    for rname, fname in _LINE_SENSORS:
        if rname not in taps:
            continue
        sp = getattr(params, fname)
        if fname.startswith("ph"):
            out[rname] = SP.nernst_compensated_ph(
                sp, _zone(state.pH, sp.zone_index),
                _zone(state.temperature, sp.zone_index))
        else:
            out[rname] = _zone(state.temperature, sp.zone_index)
    return out


def _tap_update(bufs, taps, trues, j: int):
    """Advance the fixed-dt delay buffers: write step ``j``'s sample at row
    ``j mod (k+1)`` and read the sample of step ``max(j-k, 0)`` (the oldest
    there is until the buffer spans the delay, as the exact ring's
    nearest-timestamp rule resolves under a uniform dt)."""
    delayed = {}
    for name, buf in bufs.items():
        k = taps[name]
        buf[j % (k + 1)] = trues[name]
        delayed[name] = buf[max(j - k, 0) % (k + 1)].clone()
    return delayed


def plant_rollout_batched(params: PlantParams, plant: PlantState,
                          boundary: R.BoundaryConditions, dt: float,
                          substeps: int, n_steps: int, record: bool = True,
                          stages=None, line_mode: str = "auto",
                          rng_mode: str = "packed", line_taps=None,
                          schedule: R.BoundaryConditions = None,
                          generator=None, rand=None):
    """Loop the batched integrated step over ``n_steps``: the measured-value
    trajectories of a whole Monte-Carlo ensemble (what the instruments
    would report, not the true state). Plain PyTorch on the plants' device.

    ``line_mode`` picks the sample line:
    - ``"exact"``: the carried nearest-timestamp ring, step for step what
      ``plant_step_batched`` does;
    - ``"tap"``: fixed-dt circular taps resolved outside the sensor carries
      (the fused plant kernel's scheme). The readings equal ``"exact"``'s
      wherever every step is recorded; they differ at noise level: samples
      are recorded while a sensor warms up or is power-faulted (the ring
      skips those), the line starts from the rollout's first sample
      (the carried ring is not read), and a delay halfway between steps
      rounds to even. It needs a line delay that is the same for every
      plant (``ValueError`` when no sensor has one);
    - ``"auto"``: ``"tap"`` for each sensor it applies to, ``"exact"`` for
      the rest.
    ``line_taps={reading_name: tap_steps}`` sets the taps instead.

    ``rng_mode`` picks the instruments' randomness: ``"packed"`` draws the
    seven base instruments' noise in two generates a step
    (``draw_packed_rand``), ``"per-sensor"`` lets each read draw its own
    (``plant_step``). Both draw from ``generator`` (a ``torch.Generator``;
    None: the device's default); ``rand``, a sequence of ``n_steps``
    per-step ``{sensor: (normals, uniforms)}`` dicts, replaces the draws.

    ``schedule``: a ``BoundaryConditions`` with ``[n_steps]`` fields
    (scalars hold for every step) applied one row a step to every plant; it
    replaces ``boundary``.

    Returns ``(plant, readings)``: each sensor's ``[n_steps, ...batch]``
    values, or None when ``record=False``."""
    if line_mode not in ("auto", "tap", "exact"):
        raise ValueError(f"unknown line_mode: {line_mode!r}")
    if rng_mode not in ("packed", "per-sensor"):
        raise ValueError(f"unknown rng_mode: {rng_mode!r}")
    if rand is not None and len(rand) != n_steps:
        raise ValueError(f"rand holds {len(rand)} steps of draws, not "
                         f"n_steps={n_steps}")
    if line_mode == "exact":
        taps = {}
    elif line_taps is not None:
        valid = {r for r, _ in _LINE_SENSORS}
        if not set(line_taps) <= valid:
            raise ValueError(f"unknown line_taps names: "
                             f"{sorted(set(line_taps) - valid)}")
        taps = {r: int(k) for r, k in line_taps.items()}
    else:
        taps = _static_line_taps(params, dt)
    if line_mode == "tap" and not taps:
        raise ValueError("line_mode='tap' needs a line delay that is the "
                         "same for every plant (none found)")

    device = plant.reactor.pH.device
    if schedule is not None:
        columns, length = _normalize_schedule(schedule, device)
        if length != n_steps:
            raise ValueError(f"schedule fields of length {length} disagree "
                             f"with n_steps={n_steps}")

        def bc_at(j):
            return _row(columns, j)
    else:
        def bc_at(j):
            return boundary

    batch_shape = tuple(plant.reactor.pH.shape[:-1])
    dtype = plant.reactor.pH.dtype

    def draws(j):
        if rand is not None:
            return rand[j]
        if rng_mode == "packed":
            return draw_packed_rand(generator, batch_shape, dtype, device)
        return None

    records = []
    if not taps:
        for j in range(n_steps):
            plant, readings = plant_step_batched(
                params, plant, bc_at(j), dt, substeps, stages=stages,
                rand=draws(j), generator=generator)
            if record:
                records.append({k: v.value for k, v in readings.items()})
    else:
        params_nl = _disable_lines(params, taps)
        bufs = {name: torch.zeros((k + 1,) + batch_shape, dtype=dtype,
                                  device=device)
                for name, k in taps.items()}
        for j in range(n_steps):
            state = R.step(params.reactor, plant.reactor, bc_at(j), dt=dt,
                           substeps=substeps, stages=stages)
            delayed = _tap_update(bufs, taps,
                                  _line_true_values(params, state, taps), j)
            plant, readings = _read_all(params_nl, state, plant,
                                        rand=draws(j), delayed=delayed,
                                        generator=generator)
            if record:
                records.append({k: v.value for k, v in readings.items()})
    return plant, (_stack_values(records) if record and records else None)


def _is_schedule(boundary) -> bool:
    return any(getattr(getattr(boundary, f.name), "ndim", 0) >= 1
               for f in fields(boundary))


def plant_rollout_auto(params: PlantParams, plant: PlantState,
                       boundary: R.BoundaryConditions, dt: float,
                       substeps: int, n_steps: int, record: bool = True,
                       stages=None, seed: int = 0):
    """Integrated-plant rollout that picks its path from what it can
    observe: a plant on the CUDA card whose configuration the fused plant
    kernel supports (``ops.fused_plant.unsupported_reason`` is None) runs in
    one launch of that kernel, at any batch size; every other plant takes
    the ``plant_step`` loop on its own device. A failed launch raises;
    nothing reroutes after the check.

    ``boundary`` may be constant or a schedule with ``[n_steps]`` fields.
    Returns ``(new_plant, readings)`` where readings maps each sensor name
    to its per-step measured values ``[n_steps, ...batch]`` (None when
    ``record=False``). Randomness comes from ``seed``: the kernel's Philox
    stream, or a ``torch.Generator`` seeded with it on the loop path; the
    two are statistically, not bit-, identical."""
    ph = plant.reactor.pH
    if ph.is_cuda and FP.unsupported_reason(params) is None:
        new_plant, readings = FP.plant_rollout_fused(
            params, plant, boundary, dt=dt, substeps=substeps,
            n_steps=n_steps, stages=stages,
            record_every=1 if record else n_steps, seed=seed)
        return new_plant, (readings if record else None)
    generator = torch.Generator(device=ph.device).manual_seed(seed)
    if _is_schedule(boundary):
        if R.schedule_length(boundary) != n_steps:
            raise ValueError(
                f"schedule fields have length {R.schedule_length(boundary)};"
                f" expected n_steps={n_steps}")
        return plant_rollout_scheduled(params, plant, boundary, dt,
                                       substeps, record=record,
                                       stages=stages, generator=generator)
    return plant_rollout(params, plant, boundary, dt, substeps, n_steps,
                         record=record, stages=stages, generator=generator)


# ---------------------------------------------------------------------------
# Named baseline configurations
# ---------------------------------------------------------------------------

def config1_two_zone() -> R.ReactorConfiguration:
    """Config 1: single 2-zone CSTR, fixed dt, ideal sensors."""
    diameter = 2 * math.sqrt(1.0 / (math.pi * 2.0))
    return R.ReactorConfiguration(volume=1000, height=2.0, diameter=diameter,
                                  n_zones=2)


def config2_stratified_20_zone() -> R.ReactorConfiguration:
    """Config 2: 20-zone stratified CSTR, Richardson + Corrsin +
    temperature-dependent kinetics."""
    return R.ReactorConfiguration(n_zones=20,
                                  enable_thermal_stratification=True)


def full_chemistry_config(n_zones: int = 20) -> R.ReactorConfiguration:
    """All six extension axes at once, as the JAX package's
    ``bench.py::bench_full_chemistry`` runs them: 22 fields per zone (3
    core, 4 nitrogen, 2 gas, 3 particle classes + sludge, 3 pathogen
    classes + CT/age/TOC/THM, bacteria/BDOC/wall film), the phase axis
    riding the temperature."""
    return R.ReactorConfiguration(
        n_zones=n_zones, enable_nitrogen=True, enable_gas=True,
        enable_particles=True, initial_ammonia=1.0, initial_tss=20.0,
        enable_disinfection=True, initial_pathogens=1e4,
        enable_biofilm=True, initial_bacteria=1e-3, initial_bdoc=0.5,
        enable_phase=True)


def full_chemistry_boundary() -> R.BoundaryConditions:
    """``bench_full_chemistry``'s forcing: the UV bank lit, coagulant and
    filtration on, aeration, and a cold windy sky driving evaporation."""
    return R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.5, inlet_chlorine=0.3,
        inlet_ammonia=1.0, aeration_kla=1e-3, inlet_tss=20.0,
        coagulant_dose=20.0, filter_flow_rate=10.0,
        inlet_pathogens=1e4, uv_intensity=10.0,
        inlet_bacteria=1e-3, inlet_bdoc=0.5,
        ambient_temperature=2.0, ambient_humidity=0.4, wind_speed=3.0,
        heat_loss_coefficient=100.0)


def config3_full_sensors(dtype=DEFAULT_DTYPE, device=None):
    """Config 3: full sensor suite on a 5-zone plant (params and state)."""
    return make_plant(R.ReactorConfiguration(), dtype=dtype, device=device)


def config4_monte_carlo(n_plants: int = 4096, seed: int = 0,
                        dtype=DEFAULT_DTYPE, device=None):
    """Config 4: parameter-randomized Monte-Carlo batch."""
    from ics_wt_physicsengine_torch.models.monte_carlo import (
        make_monte_carlo_batch)

    return make_monte_carlo_batch(R.ReactorConfiguration(n_zones=20),
                                  n_plants, seed=seed, dtype=dtype,
                                  device=device)


def config5_hil_cli_args(port: int = 5020) -> list:
    """Config 5: closed-loop HIL: argv for the serving command line
    (``python -m ics_wt_physicsengine_torch``)."""
    return ["--port", str(port), "--dt", "1.0"]
