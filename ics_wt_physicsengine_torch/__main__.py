"""
Main simulation orchestrator (HIL serving loop) of the PyTorch port:
``python -m ics_wt_physicsengine_torch``, the counterpart of ``python -m
ics_wt_physicsengine_tpu`` with the same flags except ``--device
{cuda,cpu}`` (default ``cuda``) in place of ``--backend``.

The device: ``--device cuda`` proves the card in a deadline-bounded
subprocess first (``utils/backend_select.py``) and raises when there is
none; nothing falls back to the CPU. The reactor, the instrumented plant and
the serving chunk's schedule live on that device. With ``--fused-sensors
--serve-chunk N`` each chunk is ONE launch of the fused plant kernel on the
card (``models.plant.plant_serve_chunk``), its plain version on the CPU;
``--fused-sensors`` alone steps ``plant_step`` once a tick.

``--fleet N`` (N in 2..254) and ``--network FILE`` serve a batched fleet
behind one endpoint, one Modbus unit per plant (``fleet.py``): a masked
batched step a tick, or one launch of the fused plant kernel a
``--serve-chunk`` chunk for the whole fleet.

Structure-for-structure parity with the reference __main__ (reference
__main__.py:274-480): 5-phase startup (physics, boundary, sensors, Modbus
with graceful degradation, loop), zero-trust validation of Modbus commands,
graceful NaN readings on sensor failure, Modbus error budget, periodic
logging with warm-up awareness, real-time pacing, signal-based shutdown.

Gap-fixes over the reference (SURVEY.md 2.2 — wired here, not replicated):
- the ``pH_middle`` input register is actually updated (mid-zone value);
- the dosing-concentration and ``simulation_timestep`` holding registers are
  read back into the boundary/loop;
- pump-enable coils gate the dosing flows (initialized ON so reference
  controllers work unchanged) and ``simulation_running`` pauses the physics;
- the sensor-failure fallback reading uses real enum members (the
  reference's ``SensorStatus.FAULT`` / ``SensorFault.SENSOR_ERROR`` don't
  exist and would crash that path, __main__.py:154-156).

New flags beyond the reference: ``--zones``, ``--seed``, ``--rtf`` (pacing
factor; 0 = free-run as fast as the engine goes).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import time
from contextlib import suppress
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import (
    BoundaryConditions,
    IntegratedCSTR,
    ReactorConfiguration,
)
from ics_wt_physicsengine_torch.device import resolve_device
from ics_wt_physicsengine_torch.modbus import (
    ModbusRegisterMap,
    ModbusServerConfig,
    ModbusSlave,
)
from ics_wt_physicsengine_torch.sensors import (
    SensorFault,
    SensorReading,
    SensorStatus,
    create_realistic_sensor_suite,
)

logger = logging.getLogger(__name__)

running = True


def _signal_handler(sig, frame):
    global running
    logger.info("Shutdown signal received. Stopping simulation...")
    running = False


# --------------------------------------------------------------------------
# Zero-trust validators (reference __main__.py:57-81)
# --------------------------------------------------------------------------

def _hpc_to_mgC(cfu_per_ml: float) -> float:
    """Operator-facing HPC [CFU/mL] -> dynamics units [mg C/L]
    (core/biofilm.py CELLS_PER_MG_C)."""
    from ics_wt_physicsengine_torch.core.biofilm import CELLS_PER_MG_C
    return float(cfu_per_ml) * 1000.0 / CELLS_PER_MG_C


def validate_flow_rate(value, max_value: float = 20.0) -> float:
    if not isinstance(value, (int, float)):
        return 0.0
    if value != value:  # NaN
        return 0.0
    return max(0.0, min(float(value), max_value))


def validate_concentration(value, max_value: float = 1.0) -> float:
    if not isinstance(value, (int, float)):
        return 0.0
    if value != value:
        return 0.0
    return max(0.0, min(float(value), max_value))


def validate_ambient_temperature(value, lo: float = -60.0,
                                 hi: float = 60.0) -> float:
    """Signed-range zero-trust clamp for the weather input (phase-change
    extension); NaN/garbage falls back to a mild 20 C."""
    if not isinstance(value, (int, float)):
        return 20.0
    if value != value:
        return 20.0
    return max(lo, min(float(value), hi))


def validate_ph(value) -> float:
    if not isinstance(value, (int, float)):
        return 7.0
    if value != value:
        return 7.0
    return max(0.0, min(float(value), 14.0))


# --------------------------------------------------------------------------
# Phase helpers (reference __main__.py:84-271)
# --------------------------------------------------------------------------

def initialize_sensors(config, sim_start_time: float, verbose: bool = False,
                       seed: Optional[int] = None, device=None):
    """Create + calibrate the suite with a failure quorum
    (reference __main__.py:84-118). ``device`` ``None`` is the CUDA
    card."""
    logger.info("Initializing sensor suite...")
    try:
        sensors = create_realistic_sensor_suite(config, seed=seed,
                                                device=device)
    except Exception as e:  # noqa: BLE001
        logger.error("Failed to create sensor suite: %s", type(e).__name__)
        raise RuntimeError("Sensor initialization failed") from e

    calibration_errors = 0
    for name, sensor in sensors.items():
        try:
            if "pH" in name:
                sensor.calibrate(7.0, sim_start_time, "system_init")
            elif "chlorine" in name:
                sensor.calibrate(config.initial_chlorine, sim_start_time,
                                 "system_init")
            elif "temp" in name:
                sensor.calibrate(config.temperature, sim_start_time,
                                 "system_init")
            elif "flow" in name:
                sensor.calibrate(config.flow_rate, sim_start_time,
                                 "system_init")
            elif "ammonia" in name:
                sensor.calibrate(getattr(config, "initial_ammonia", 0.0),
                                 sim_start_time, "system_init")
            elif "turbidity" in name:
                sensor.calibrate(0.0, sim_start_time, "system_init")
            elif "oxygen" in name:
                from ics_wt_physicsengine_torch.core.gas import (
                    oxygen_saturation)
                o2_ref = getattr(config, "initial_oxygen", None)
                if o2_ref is None:
                    o2_ref = float(oxygen_saturation(
                        np.float64(config.temperature)))
                sensor.calibrate(o2_ref, sim_start_time, "system_init")
            if verbose:
                logger.info("  calibrated %s", name)
        except Exception:  # noqa: BLE001
            calibration_errors += 1
            logger.warning("  could not calibrate %s", name)

    if calibration_errors > len(sensors) // 2:
        raise RuntimeError("Too many sensor calibration failures")
    logger.info("Initialized %d sensors (%d errors)", len(sensors),
                calibration_errors)
    return sensors


def read_all_sensors(sensors: Dict, state, sim_time: float,
                     verbose: bool = False) -> Dict[str, SensorReading]:
    """Read every sensor; synthesize a NaN FAULT reading on failure
    (reference __main__.py:121-163)."""
    readings = {}
    error_count = 0
    for name, sensor in sensors.items():
        try:
            reading = sensor.read(state, current_time=sim_time)
            readings[name] = reading
            if reading.status != SensorStatus.NORMAL:
                if verbose or reading.status not in (
                        SensorStatus.WARMING_UP, SensorStatus.CALIBRATING):
                    logger.warning("%s: %s", name, reading.status.value)
            if reading.fault != SensorFault.NONE:
                logger.error("%s: FAULT - %s", name, reading.fault.value)
                error_count += 1
        except Exception:  # noqa: BLE001
            error_count += 1
            readings[name] = SensorReading(
                timestamp=sim_time, value=float("nan"),
                raw_value=float("nan"), noise=0.0, drift=0.0,
                status=SensorStatus.FAILED, uncertainty=float("inf"),
                fault=SensorFault.OPEN_CIRCUIT)
    if error_count > len(sensors) // 2:
        logger.error("CRITICAL: %d/%d sensors in fault state", error_count,
                     len(sensors))
    return readings


def update_modbus_inputs(slave: Optional[ModbusSlave],
                         readings: Dict[str, SensorReading],
                         state, sim_time: float,
                         unit: Optional[int] = None) -> bool:
    """Push sensor values + fault bits to the register map
    (reference __main__.py:166-224; pH_middle gap-fixed). ``unit`` selects
    a fleet unit's register space (fleet.py); None = the primary unit."""
    if slave is None or not slave.is_running:
        return False

    def safe_value(key: str) -> float:
        reading = readings.get(key)
        if reading is None:
            return 0.0
        val = reading.value
        if val != val or val in (float("inf"), float("-inf")):
            return 0.0
        return val

    def has_fault(key: str) -> bool:
        reading = readings.get(key)
        return reading is not None and reading.fault != SensorFault.NONE

    host = {}

    def arr(x):
        """A state field as host NumPy values (one copy per field)."""
        key = id(x)
        if key not in host:
            host[key] = x.detach().cpu().numpy() \
                if isinstance(x, torch.Tensor) else np.asarray(x)
        return host[key]

    try:
        slave.update_input_register("pH_inlet", safe_value("pH_inlet"),
                                    unit=unit)
        slave.update_input_register("pH_outlet", safe_value("pH_outlet"),
                                    unit=unit)
        # pH_middle: the register exists in the map but the reference never
        # writes it (__main__.py:195-207); publish the true mid-zone value.
        ph = arr(state.pH)
        mid = int(ph.shape[-1] // 2)
        slave.update_input_register("pH_middle", float(ph[mid]), unit=unit)
        slave.update_input_register("chlorine_inlet",
                                    safe_value("chlorine_inlet"), unit=unit)
        slave.update_input_register("chlorine_outlet",
                                    safe_value("chlorine_outlet"), unit=unit)
        slave.update_input_register("flow_rate", safe_value("flow_main"),
                                    unit=unit)
        slave.update_input_register("temperature_inlet",
                                    safe_value("temp_inlet"), unit=unit)
        slave.update_input_register("temperature_outlet",
                                    safe_value("temp_outlet"), unit=unit)
        slave.update_input_register("simulation_time", sim_time, unit=unit)

        # nitrogen-chemistry extension registers (present only when the
        # map was built with extended_nitrogen=True)
        ammonia = getattr(state, "ammonia", None)
        if ammonia is not None:
            def outlet(x):
                return float(arr(x)[..., -1])
            # prefer the MEASURED value when the ammonia instrument is in
            # the suite (sensors/ammonia.py); fall back to the true state
            am_val = (safe_value("ammonia_outlet")
                      if "ammonia_outlet" in readings
                      else outlet(ammonia))
            slave.update_input_register("ammonia_outlet", am_val,
                                        unit=unit)
            slave.update_input_register("nitrite_outlet",
                                        outlet(state.nitrite), unit=unit)
            slave.update_input_register("nitrate_outlet",
                                        outlet(state.nitrate), unit=unit)
            slave.update_input_register("chloramine_outlet",
                                        outlet(state.chloramine),
                                        unit=unit)

        # gas-exchange extension registers (extended_gas=True maps)
        oxygen = getattr(state, "oxygen", None)
        if oxygen is not None:
            def outlet_g(x):
                return float(arr(x)[..., -1])
            # prefer the MEASURED value from the DO instrument
            # (sensors/oxygen.py); fall back to the true state
            o2_val = (safe_value("oxygen_outlet")
                      if "oxygen_outlet" in readings
                      else outlet_g(oxygen))
            slave.update_input_register("oxygen_outlet", o2_val, unit=unit)
            slave.update_input_register("carbonate_outlet",
                                        outlet_g(state.carbonate),
                                        unit=unit)

        # particle-dynamics extension registers (extended_particles maps)
        tss = getattr(state, "tss", None)
        if tss is not None:
            tss_np = arr(tss)              # [..., C, Z]
            # prefer the MEASURED turbidity from the nephelometer
            # (sensors/turbidity.py); fall back to the true class-weighted
            # value with the canonical weights
            if "turbidity_outlet" in readings:
                ntu_val = safe_value("turbidity_outlet")
            else:
                from ics_wt_physicsengine_torch.core.particles import (
                    DEFAULT_NTU_PER_MGL)
                ntu_val = float(np.sum(
                    np.asarray(DEFAULT_NTU_PER_MGL) * tss_np[..., -1]))
            slave.update_input_register("turbidity_outlet", ntu_val,
                                        unit=unit)
            slave.update_input_register(
                "tss_outlet", float(tss_np[..., -1].sum()), unit=unit)
            slave.update_input_register(
                "sludge_level",
                float(arr(state.sludge).sum()), unit=unit)

        # disinfection extension registers (extended_disinfection maps):
        # per-class log-removal credit ACROSS the tank (inlet zone ->
        # outlet zone), accumulated CT / water age at the outlet, THMs,
        # and the UVT a 254 nm analyzer would report on the outlet water
        pathogens = getattr(state, "pathogens", None)
        if pathogens is not None:
            from ics_wt_physicsengine_torch.core import disinfection as dz
            pa = arr(pathogens)            # [..., P, Z]

            def logr(i: int) -> float:
                n0 = max(float(pa[..., i, 0]), 1e-30)
                n1 = max(float(pa[..., i, -1]), 1e-30 * n0)
                return float(np.log10(n0 / n1))
            slave.update_input_register("virus_log_removal", logr(0),
                                        unit=unit)
            slave.update_input_register("giardia_log_removal", logr(1),
                                        unit=unit)
            slave.update_input_register("crypto_log_removal", logr(2),
                                        unit=unit)
            slave.update_input_register(
                "ct_outlet", float(arr(state.ct)[..., -1]),
                unit=unit)
            slave.update_input_register(
                "water_age_outlet",
                float(arr(state.age)[..., -1]) / 60.0, unit=unit)
            slave.update_input_register(
                "thm_outlet", float(arr(state.thm)[..., -1]),
                unit=unit)
            toc_out = float(arr(state.toc)[..., -1])
            tss_state = getattr(state, "tss", None)
            tss_out = (float(arr(tss_state)[..., -1].sum())
                       if tss_state is not None else 0.0)
            # default optical coefficients (the analyzer's own cal), not
            # the reactor's possibly-overridden kinetics
            dp = dz.make_disinfection_params(device="cpu")
            uvt = float(dz.uvt_percent(dz.absorbance_254(
                torch.tensor(toc_out), torch.tensor(tss_out), dp)))
            slave.update_input_register("uvt_outlet", uvt, unit=unit)

        # biofilm/regrowth extension registers (extended_biofilm maps):
        # HPC plate-count proxy and BDOC at the outlet, plus the WORST
        # wall-film density across zones (the fouling figure an
        # inspection crew would report)
        bacteria = getattr(state, "bacteria", None)
        if bacteria is not None:
            from ics_wt_physicsengine_torch.core import biofilm as bf
            slave.update_input_register(
                "hpc_outlet",
                float(arr(bf.hpc_cfu_per_ml(bacteria))[..., -1]),
                unit=unit)
            slave.update_input_register(
                "bdoc_outlet", float(arr(state.bdoc)[..., -1]),
                unit=unit)
            slave.update_input_register(
                "biofilm_peak", float(arr(state.biofilm).max()),
                unit=unit)

        # phase-change extension registers (extended_phase maps): ice
        # fraction at the surface zone and the worst across zones. The
        # state carries no phase leaves (ice fraction is diagnostic in
        # temperature, core/phase.py), so the register reports the
        # canonical 0 C / 0.5 K band — the ice-detection instrument's own
        # convention, like the UVT analyzer's default calibration above.
        if slave.register_map.get_register_by_name("ice_fraction_top") \
                is not None:
            t_np = arr(state.temperature)
            phi = np.clip(-t_np / 0.5, 0.0, 1.0)
            slave.update_input_register("ice_fraction_top",
                                        float(phi[..., -1]), unit=unit)
            slave.update_input_register("ice_fraction_max",
                                        float(phi.max()), unit=unit)

        any_fault = any(r.fault != SensorFault.NONE
                        for r in readings.values())
        slave.update_input_register("system_status", 1 if any_fault else 0,
                                    unit=unit)

        slave.update_discrete_input("sensor_fault_pH_inlet",
                                    has_fault("pH_inlet"), unit=unit)
        slave.update_discrete_input("sensor_fault_pH_outlet",
                                    has_fault("pH_outlet"), unit=unit)
        slave.update_discrete_input(
            "sensor_fault_chlorine",
            has_fault("chlorine_inlet") or has_fault("chlorine_outlet"),
            unit=unit)
        return True
    except Exception as e:  # noqa: BLE001
        logger.error("Modbus update failed: %s", type(e).__name__)
        return False


def read_modbus_commands(slave: Optional[ModbusSlave],
                         unit: Optional[int] = None
                         ) -> Tuple[float, float, float, float, float, bool,
                                    bool, bool]:
    """Read + validate actuator commands, dosing concentrations, and coils
    (reference __main__.py:227-252, extended to the full register map).
    ``unit`` selects a fleet unit's register space; None = primary."""
    if slave is None or not slave.is_running:
        return (0.0, 0.0, 5.0, 0.1, 50.0, True, True, True, None, None,
                None, None, None)
    try:
        acid_rate = validate_flow_rate(
            slave.read_holding_register("acid_flow_rate", unit=unit),
            max_value=2.0)
        chlorine_rate = validate_flow_rate(
            slave.read_holding_register("chlorine_flow_rate", unit=unit),
            max_value=1.0)
        inlet_rate = validate_flow_rate(
            slave.read_holding_register("inlet_flow_rate", unit=unit),
            max_value=20.0)
        acid_conc = validate_concentration(
            slave.read_holding_register("acid_concentration", unit=unit),
            max_value=1.0)
        cl_conc = validate_concentration(
            slave.read_holding_register("chlorine_concentration", unit=unit),
            max_value=1000.0)
        acid_enable = slave.read_coil("acid_pump_enable", unit=unit)
        cl_enable = slave.read_coil("chlorine_pump_enable", unit=unit)
        sim_running = slave.read_coil("simulation_running", unit=unit)
        try:    # nitrogen extension register (extended maps only)
            inlet_ammonia = validate_concentration(
                slave.read_holding_register("inlet_ammonia", unit=unit),
                max_value=50.0)
        except Exception:  # noqa: BLE001 — base map: register absent
            inlet_ammonia = None
        try:    # gas extension register (extended maps only)
            aeration_kla = validate_concentration(
                slave.read_holding_register("aeration_kla", unit=unit),
                max_value=0.1)
        except Exception:  # noqa: BLE001 — base map: register absent
            aeration_kla = None
        try:    # particle extension registers (extended maps only)
            particle_cmds = (
                validate_concentration(
                    slave.read_holding_register("coagulant_dose",
                                                unit=unit),
                    max_value=100.0),
                validate_flow_rate(
                    slave.read_holding_register("filter_flow_rate",
                                                unit=unit),
                    max_value=60.0),
                validate_concentration(
                    slave.read_holding_register("sludge_blowdown",
                                                unit=unit),
                    max_value=0.01),
            )
        except Exception:  # noqa: BLE001 — base map: registers absent
            particle_cmds = None
        try:    # disinfection extension registers (extended maps only)
            disinfect_cmds = (
                validate_concentration(
                    slave.read_holding_register("uv_intensity", unit=unit),
                    max_value=50.0),
                validate_concentration(
                    slave.read_holding_register("inlet_toc", unit=unit),
                    max_value=20.0),
            )
        except Exception:  # noqa: BLE001 — base map: registers absent
            disinfect_cmds = None
        try:    # biofilm extension registers (extended maps only)
            biofilm_cmds = (
                validate_concentration(
                    slave.read_holding_register("inlet_bdoc", unit=unit),
                    max_value=10.0),
                validate_concentration(
                    slave.read_holding_register("inlet_hpc", unit=unit),
                    max_value=1.0e7),
            )
        except Exception:  # noqa: BLE001 — base map: registers absent
            biofilm_cmds = None
        try:    # phase-change extension registers (extended maps only)
            phase_cmds = (
                validate_concentration(
                    slave.read_holding_register("ambient_humidity",
                                                unit=unit),
                    max_value=1.0),
                validate_concentration(
                    slave.read_holding_register("wind_speed", unit=unit),
                    max_value=30.0),
                validate_ambient_temperature(
                    slave.read_holding_register("ambient_temperature",
                                                unit=unit)),
            )
        except Exception:  # noqa: BLE001 — base map: registers absent
            phase_cmds = None
        return (acid_rate, chlorine_rate, inlet_rate, acid_conc, cl_conc,
                acid_enable, cl_enable, sim_running, inlet_ammonia,
                aeration_kla, particle_cmds, disinfect_cmds, biofilm_cmds,
                phase_cmds)
    except Exception as e:  # noqa: BLE001
        logger.error("Modbus read failed: %s", type(e).__name__)
        return (0.0, 0.0, 5.0, 0.1, 50.0, True, True, True, None, None,
                None, None, None, None)


def apply_boundary_conditions(boundary: BoundaryConditions, commands
                              ) -> BoundaryConditions:
    """Apply validated commands to the boundary; pump-enable coils gate the
    dosing flows (reference __main__.py:255-271, coils gap-fixed).

    Returns a new BoundaryConditions (the pytree is frozen)."""
    (acid_rate, chlorine_rate, inlet_rate, acid_conc, cl_conc,
     acid_enable, cl_enable, _), extra = commands[:8], commands[8:]
    inlet_ammonia = extra[0] if extra else None
    aeration_kla = extra[1] if len(extra) > 1 else None
    particle_cmds = extra[2] if len(extra) > 2 else None
    disinfect_cmds = extra[3] if len(extra) > 3 else None
    biofilm_cmds = extra[4] if len(extra) > 4 else None
    phase_cmds = extra[5] if len(extra) > 5 else None
    from dataclasses import replace
    new_inlet = boundary.inlet_flow_rate
    if inlet_rate > 0.1:
        new_inlet = validate_flow_rate(inlet_rate, max_value=20.0)
    updates = {}
    if inlet_ammonia is not None:   # nitrogen extension register present
        updates["inlet_ammonia"] = inlet_ammonia
    if aeration_kla is not None:    # gas extension register present
        updates["aeration_kla"] = aeration_kla
    if particle_cmds is not None:   # particle extension registers present
        updates["coagulant_dose"] = particle_cmds[0]
        updates["filter_flow_rate"] = particle_cmds[1]
        updates["sludge_blowdown"] = particle_cmds[2]
    if disinfect_cmds is not None:  # disinfection extension registers present
        updates["uv_intensity"] = disinfect_cmds[0]
        updates["inlet_toc"] = disinfect_cmds[1]
    if biofilm_cmds is not None:    # biofilm extension registers present
        from ics_wt_physicsengine_torch.core.biofilm import CELLS_PER_MG_C
        updates["inlet_bdoc"] = biofilm_cmds[0]
        # operators command in CFU/mL; the dynamics run in mg C/L
        updates["inlet_bacteria"] = biofilm_cmds[1] * 1000.0 / CELLS_PER_MG_C
    if phase_cmds is not None:      # phase extension registers present
        updates["ambient_humidity"] = phase_cmds[0]
        updates["wind_speed"] = phase_cmds[1]
        updates["ambient_temperature"] = phase_cmds[2]
    return replace(
        boundary,
        acid_flow_rate=(validate_flow_rate(acid_rate, max_value=2.0)
                        if acid_enable else 0.0),
        chlorine_flow_rate=(validate_flow_rate(chlorine_rate, max_value=1.0)
                            if cl_enable else 0.0),
        acid_concentration=acid_conc,
        chlorine_concentration=cl_conc,
        inlet_flow_rate=new_inlet,
        **updates,
    )


_ACTUATOR_FIELDS = ("acid_flow_rate", "chlorine_flow_rate",
                    "inlet_flow_rate")


def _slew_decay(n_steps: int, dt: float, tau: float):
    """Closed-form first-order actuator-lag decay shared by the
    single-plant and fleet chunk schedules: step j's applied value is
    cmd + (applied_0 - cmd)·decay[j], and ``end_decay`` is the position
    after the full chunk. tau <= 0 = instant actuation (decay 0)."""
    if tau > 0.0:
        return (np.exp(-dt * np.arange(n_steps) / tau),
                float(np.exp(-dt * n_steps / tau)))
    return np.zeros(n_steps), 0.0


def build_chunk_schedule(applied: BoundaryConditions,
                         commanded: BoundaryConditions,
                         n_steps: int, dt: float, tau: float, device=None
                         ) -> Tuple[BoundaryConditions, BoundaryConditions]:
    """Per-step boundary schedule for one fast-time serving chunk
    (--serve-chunk): commands are zero-order-held across the chunk, and the
    actuator flow fields follow exactly the first-order-lag trajectory the
    per-tick loop integrates (apply_actuator_dynamics), evaluated in closed
    form — step j uses applied_j = cmd + (applied_0 - cmd)·exp(-j·dt/τ),
    matching the per-tick recursion applied_{j+1} = applied_j + α·(cmd -
    applied_j) with α = 1 - exp(-dt/τ).

    Returns ``(schedule, end_boundary)`` where every actuator field of
    ``schedule`` is a float32 ``[n_steps]`` tensor on ``device`` (``None``:
    the CUDA card), computed in float64 NumPy and rounded once, and
    ``end_boundary`` carries the actuator positions after the chunk (the
    next chunk's slew start)."""
    from dataclasses import replace

    from ics_wt_physicsengine_torch.device import resolve_device

    dev = resolve_device(device)
    decay, end_decay = _slew_decay(n_steps, dt, tau)
    sched, end = {}, {}
    for f in _ACTUATOR_FIELDS:
        a0 = float(getattr(applied, f))
        cmd = float(getattr(commanded, f))
        sched[f] = (cmd + (a0 - cmd) * decay).astype(np.float32)
        end[f] = cmd + (a0 - cmd) * end_decay
    columns = torch.from_numpy(np.stack([sched[f] for f in _ACTUATOR_FIELDS]))
    columns = columns.to(dev)          # one copy to the device
    sched = {f: columns[i] for i, f in enumerate(_ACTUATOR_FIELDS)}
    return replace(commanded, **sched), replace(commanded, **end)


def apply_actuator_dynamics(applied: BoundaryConditions,
                            commanded: BoundaryConditions,
                            dt: float, tau: float) -> BoundaryConditions:
    """First-order actuator lag: dosing pumps and the inlet valve approach
    the commanded flow with time constant ``tau`` [s] instead of jumping
    (an item on the reference's own roadmap — reference README.md:437
    'Actuator dynamics (valves, pumps)' — opt-in via ``--actuator-tau``;
    tau <= 0 keeps the reference's instant actuation).

    Applied to the actuator FLOW fields only: concentrations are tank
    properties, not actuator positions."""
    if tau <= 0.0:
        return commanded
    import math
    alpha = 1.0 - math.exp(-dt / tau)
    from dataclasses import replace
    updates = {f: getattr(applied, f)
               + alpha * (getattr(commanded, f) - getattr(applied, f))
               for f in _ACTUATOR_FIELDS}
    return replace(commanded, **updates)


_FLOAT_OUTPUT_FIELDS = ("timestamp", "value", "raw_value", "noise", "drift",
                        "uncertainty")


def _readings_from_outputs(outputs, lane: Optional[int] = None
                           ) -> Dict[str, SensorReading]:
    """Convert the fused plant's SensorOutput pytrees into SensorReading
    objects for the Modbus/logging plumbing. ``lane`` selects one plant of
    a batched output; None = unbatched. The fields come to the host in two
    copies (floats, codes), not one per field."""
    from ics_wt_physicsengine_torch.sensors.types import (
        FAULT_FROM_CODE, STATUS_FROM_CODE)

    names = list(outputs)
    if not names:
        return {}
    floats = torch.stack([
        getattr(outputs[n], f).to(torch.float64)
        for n in names for f in _FLOAT_OUTPUT_FIELDS]).cpu().numpy()
    codes = torch.stack([
        getattr(outputs[n], f).to(torch.int64)
        for n in names for f in ("status", "fault")]).cpu().numpy()
    if lane is not None:
        floats, codes = floats[:, lane], codes[:, lane]
    k = len(_FLOAT_OUTPUT_FIELDS)
    readings = {}
    for i, name in enumerate(names):
        f = dict(zip(_FLOAT_OUTPUT_FIELDS, map(float, floats[i * k:
                                                             (i + 1) * k])))
        readings[name] = SensorReading(
            **f, status=STATUS_FROM_CODE[int(codes[2 * i])],
            fault=FAULT_FROM_CODE[int(codes[2 * i + 1])])
    return readings


def _readings_from_chunk(chunk, t: float) -> Dict[str, SensorReading]:
    """The last step of a serving chunk (``models.plant.ServeChunk``) as
    SensorReading objects: value, status and fault; the chunk keeps no raw
    value, noise, drift or uncertainty (NaN here)."""
    from ics_wt_physicsengine_torch.sensors.types import (
        FAULT_FROM_CODE, STATUS_FROM_CODE)

    names = list(chunk.last)
    values = torch.stack([chunk.last[n][0].to(torch.float64)
                          for n in names]).cpu().numpy()
    codes = torch.stack([chunk.last[n][k].to(torch.int64)
                         for n in names for k in (1, 2)]).cpu().numpy()
    nan = float("nan")
    return {name: SensorReading(
        timestamp=t, value=float(values[i]), raw_value=nan, noise=nan,
        drift=nan, status=STATUS_FROM_CODE[int(codes[2 * i])],
        uncertainty=nan, fault=FAULT_FROM_CODE[int(codes[2 * i + 1])])
        for i, name in enumerate(names)}


def _recorded_readings(names, values, faults, row: int, t: float
                       ) -> Dict[str, SensorReading]:
    """Row ``row`` of a serving chunk's record (host NumPy ``values`` and
    ``faults``, ``[n_rec, len(names)]``) as SensorReading objects for the
    history: value and fault; the record keeps no status (NORMAL here) and
    nothing else (NaN)."""
    from ics_wt_physicsengine_torch.sensors.types import FAULT_FROM_CODE

    nan = float("nan")
    return {name: SensorReading(
        timestamp=t, value=float(values[row, i]), raw_value=nan, noise=nan,
        drift=nan, status=SensorStatus.NORMAL, uncertainty=nan,
        fault=FAULT_FROM_CODE[int(faults[row, i])])
        for i, name in enumerate(names)}


# --------------------------------------------------------------------------
# Main (reference __main__.py:274-480)
# --------------------------------------------------------------------------

def main(argv=None):
    # a no-op where the process has configured logging already
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    try:
        signal.signal(signal.SIGINT, _signal_handler)
        signal.signal(signal.SIGTERM, _signal_handler)
    except ValueError:
        pass   # not the main thread (embedded/test usage) — no signal hooks

    parser = argparse.ArgumentParser(
        description="Water Treatment Reactor Simulation (PyTorch/CUDA "
                    "engine)")
    parser.add_argument("--port", type=int, default=5020,
                        help="Modbus TCP port")
    parser.add_argument("--host", type=str, default="127.0.0.1",
                        help="Modbus bind address")
    parser.add_argument("--dt", type=float, default=1.0,
                        help="Simulation timestep [seconds]")
    parser.add_argument("--duration", type=float, default=float("inf"),
                        help="Total simulation duration [seconds]")
    parser.add_argument("--verbose", action="store_true",
                        help="Enable verbose sensor warnings")
    parser.add_argument("--no-modbus", action="store_true",
                        help="Run without Modbus server (testing mode)")
    parser.add_argument("--zones", type=int, default=5,
                        help="Number of reactor zones")
    parser.add_argument("--seed", type=int, default=None,
                        help="Deterministic sensor RNG seed")
    parser.add_argument("--rtf", type=float, default=1.0,
                        help="Real-time factor for pacing "
                             "(1.0 = real time, 0 = free-run)")
    parser.add_argument("--checkpoint-file", type=str, default=None,
                        help="Checkpoint the simulation state here "
                             "periodically and resume from it at startup "
                             "if it exists (pytree serialization — the "
                             "reference loses all state on stop, "
                             "README.md:151)")
    parser.add_argument("--checkpoint-hours", type=float, default=1.0,
                        help="Simulated hours between checkpoints")
    parser.add_argument("--checkpoint-resize", action="store_true",
                        help="Allow resuming a fleet checkpoint into a "
                             "DIFFERENT --fleet size: saved lanes restore "
                             "exactly, extra lanes start as fresh plants "
                             "(without this flag a size mismatch aborts "
                             "with an error)")
    parser.add_argument("--log-csv", type=str, default=None,
                        help="Append per-step sensor readings + commands to "
                             "this CSV file (historical logging — listed as "
                             "future work in the reference, README.md:441)")
    parser.add_argument("--log-parquet", type=str, default=None,
                        help="Stream per-step history to this Parquet file "
                             "(columnar row groups via pyarrow — the "
                             "reference roadmap's Phase 3 'historical data "
                             "logging (Parquet format)', README.md:443)")
    parser.add_argument("--log-parquet-rotate", type=int, default=0,
                        help="Finalize the Parquet file every N row groups "
                             "and continue in the next .partNNNNN file, so "
                             "a crash loses at most the open part (0 = one "
                             "file, valid only after clean shutdown; "
                             "--log-csv is always crash-safe)")
    parser.add_argument("--recal-hours", type=float, default=24.0,
                        help="Recalibrate (and revive latched) sensors every "
                             "N simulated hours — the maintenance the "
                             "reference's 24 h calibration validity implies "
                             "but its loop never performs. 0 disables.")
    parser.add_argument("--actuator-tau", type=float, default=0.0,
                        help="First-order actuator time constant [s]: dosing "
                             "pumps/inlet valve approach commanded flows "
                             "exponentially instead of jumping (reference "
                             "roadmap 'Actuator dynamics'; 0 = instant, "
                             "reference parity)")
    parser.add_argument("--enable-nitrogen", action="store_true",
                        help="Enable the nitrogen chemistry extension "
                             "(core/nitrogen.py): ammonia/nitrite/nitrate/"
                             "chloramine species, extended input registers "
                             "(20-27) and the inlet_ammonia holding "
                             "register (14)")
    parser.add_argument("--initial-ammonia", type=float, default=1.0,
                        help="Initial/source total ammonia nitrogen "
                             "[mg N/L] when --enable-nitrogen is set")
    parser.add_argument("--enable-gas", action="store_true",
                        help="Enable the gas-exchange extension "
                             "(core/gas.py): dissolved O2/CO2 species with "
                             "carbonate-pH coupling, a DO instrument, "
                             "extended input registers (28-31) and the "
                             "aeration_kla holding register (16)")
    parser.add_argument("--enable-particles", action="store_true",
                        help="Enable the particle-dynamics extension "
                             "(core/particles.py): suspended-solids size "
                             "classes with settling/coagulation/filtration,"
                             " a turbidity instrument, extended input "
                             "registers (32-37) and the coagulant/filter/"
                             "blowdown holding registers (18-23)")
    parser.add_argument("--initial-tss", type=float, default=10.0,
                        help="Initial/source total suspended solids "
                             "[mg/L] when --enable-particles is set")
    parser.add_argument("--enable-disinfection", action="store_true",
                        help="Enable the disinfection extension "
                             "(core/disinfection.py): pathogen "
                             "inactivation (Chick-Watson + UV), CT "
                             "credit, water age, and THM formation; "
                             "extended input registers (38-51) and the "
                             "uv_intensity/inlet_toc holding registers "
                             "(24-27)")
    parser.add_argument("--initial-pathogens", type=float, default=1.0e4,
                        help="Initial/source pathogen concentration "
                             "[org/L, every class] when "
                             "--enable-disinfection is set")
    parser.add_argument("--initial-toc", type=float, default=2.0,
                        help="Initial/source total organic carbon "
                             "[mg/L] when --enable-disinfection is set")
    parser.add_argument("--enable-biofilm", action="store_true",
                        help="Enable the biofilm/regrowth extension "
                             "(core/biofilm.py): planktonic HPC biomass, "
                             "BDOC substrate and wall-attached biofilm "
                             "with chlorine-inhibited Monod kinetics; "
                             "extended input registers (52-57) and the "
                             "inlet_bdoc/inlet_hpc holding registers "
                             "(28-31)")
    parser.add_argument("--initial-bdoc", type=float, default=0.3,
                        help="Initial/source biodegradable dissolved "
                             "organic carbon [mg/L] when --enable-biofilm "
                             "is set")
    parser.add_argument("--initial-hpc", type=float, default=500.0,
                        help="Initial/source heterotrophic plate count "
                             "[CFU/mL] when --enable-biofilm is set")
    parser.add_argument("--enable-phase", action="store_true",
                        help="Enable the phase-change extension "
                             "(core/phase.py): freezing/ice and the "
                             "boiling cap via the apparent-heat-capacity "
                             "method plus Dalton surface evaporation; "
                             "extended input registers (58-61, ice "
                             "fractions) and the ambient_humidity/"
                             "wind_speed/ambient_temperature holding "
                             "registers (32-37)")
    parser.add_argument("--ambient-temperature", type=float, default=20.0,
                        help="Initial ambient air temperature [C] "
                             "(writable at runtime via holding register "
                             "36 when --enable-phase is set)")
    parser.add_argument("--ambient-humidity", type=float, default=0.5,
                        help="Initial ambient relative humidity (0-1) "
                             "for the evaporation model when "
                             "--enable-phase is set")
    parser.add_argument("--wind-speed", type=float, default=0.0,
                        help="Initial wind speed over the free surface "
                             "[m/s] when --enable-phase is set")
    parser.add_argument("--heat-loss-coefficient", type=float, default=0.0,
                        help="Ambient heat-loss coefficient U [W/K] "
                             "(BoundaryConditions.heat_loss_coefficient; "
                             "0 = adiabatic, reference parity default)")
    parser.add_argument("--fleet", type=int, default=1,
                        help="Serve N independently controlled plants from "
                             "one Modbus endpoint: unit id u = plant lane "
                             "u-1 of a batched device ensemble, one "
                             "batched step per tick (fleet.py). No "
                             "reference counterpart (its physics cannot "
                             "batch); 1 = classic single-plant serving.")
    parser.add_argument("--network", type=str, default=None,
                        help="Serve a CONNECTED reactor network "
                             "(core/network.py): JSON file with 'routing' "
                             "([P][P] flow fractions, entry [j][i] = share "
                             "of plant i's outflow piped to plant j), "
                             "optional 'delay_steps' ([P][P] whole-tick "
                             "pipe delays) and 'external_inlet_flow' ([P] "
                             "L/min initial source flows). Each stage is "
                             "Modbus unit id stage+1; each unit's "
                             "inlet_flow_rate register commands its "
                             "EXTERNAL source only — routed inter-plant "
                             "flow is added by the hydraulics solve.")
    parser.add_argument("--fleet-no-shard", action="store_true",
                        help="Keep the whole fleet on one device even when "
                             "a multi-chip mesh is visible (default: shard "
                             "the lane axis across devices; trajectories "
                             "are bit-exact either way)")
    parser.add_argument("--fused-sensors", action="store_true",
                        help="Run physics + all 7 instruments as ONE jitted "
                             "step per tick (models/plant.py) instead of "
                             "per-sensor dispatches — higher loop ceiling; "
                             "sensors start warmed-up")
    parser.add_argument("--native-modbus", action="store_true",
                        help="Serve Modbus/TCP from the C++ data plane "
                             "(native/modbus_server.cpp) instead of the "
                             "Python asyncio server")
    parser.add_argument("--opcua", type=int, default=None, metavar="PORT",
                        help="Also serve the plant over OPC UA binary TCP "
                             "on this port (0 = ephemeral). The OPC UA "
                             "address space bridges onto the Modbus "
                             "register store (opcua/server.py), so both "
                             "protocol planes see identical values and "
                             "writes from either land in the same "
                             "validated holding registers/coils. Requires "
                             "the Modbus server (not --no-modbus).")
    parser.add_argument("--integrator", type=str, default="rk4",
                        choices=["rk4", "rkc-strict", "rkc-fast"],
                        help="physics integrator (core/reactor.py): rk4 = "
                             "1e-6 Radau-parity default; rkc-strict/rkc-fast "
                             "= Chebyshev-stabilized, fewer sequential "
                             "derivative evals per tick (tests/test_rkc.py "
                             "accuracy envelopes)")
    parser.add_argument("--serve-chunk", type=int, default=1, metavar="N",
                        help="fast-time HIL serving: advance N physics+"
                             "instrument steps per register exchange in ONE "
                             "device call (plant_rollout_serve). Commands "
                             "are zero-order-held across the chunk and the "
                             "--actuator-tau slew is precomputed into the "
                             "chunk's boundary schedule. Replaces the "
                             "reference's one-step-per-host-tick serving "
                             "pattern (reference __main__.py:453-457). "
                             "Requires --fused-sensors. 1 = per-tick loop.")
    parser.add_argument("--log-decimate", type=int, default=1, metavar="K",
                        help="with --serve-chunk: write every Kth in-chunk "
                             "step to --log-csv/--log-parquet (1 = every "
                             "step; raise for high-RTF free runs)")
    parser.add_argument("--rtu-serial", type=str, default=None,
                        metavar="DEVICE",
                        help="serve Modbus RTU on a serial device (or pty) "
                             "instead of Modbus/TCP — closes the "
                             "reference's 'No Modbus RTU/serial support' "
                             "limitation")
    parser.add_argument("--rtu-tcp", action="store_true",
                        help="serve RTU framing (CRC-16, no MBAP) on the "
                             "TCP port — the serial-device-server bridge "
                             "convention")
    parser.add_argument("--tls-cert", type=str, default=None,
                        help="Modbus/TCP Security (MB-TCP-Security-v21): "
                             "server certificate PEM. With --tls-key and "
                             "--tls-ca, the Python Modbus plane speaks TLS "
                             "with mandatory client certificates")
    parser.add_argument("--tls-key", type=str, default=None,
                        help="server private key PEM (with --tls-cert)")
    parser.add_argument("--tls-ca", type=str, default=None,
                        help="trust anchor PEM for client certificates "
                             "(with --tls-cert)")
    parser.add_argument("--tls-role", action="append", default=None,
                        metavar="ROLE=PERM",
                        help="map a client-certificate RoleOID value to a "
                             "permission (ro|rw|deny); repeatable. Clients "
                             "without a mapped role get --tls-default-"
                             "permission")
    parser.add_argument("--tls-default-permission", type=str, default="ro",
                        choices=["deny", "ro", "rw"],
                        help="permission for authenticated clients with no "
                             "or unmapped role (default: read-only)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the plant lives: the CUDA card "
                             "(default; proven in a deadline-bounded "
                             "subprocess first, an error when there is "
                             "none) or the CPU (plain PyTorch, asked for "
                             "explicitly; never a fallback)")
    args = parser.parse_args(argv)

    if args.opcua is not None and args.no_modbus:
        parser.error("--opcua bridges onto the Modbus register store and "
                     "cannot be combined with --no-modbus")
    if args.serve_chunk < 1:
        parser.error(f"--serve-chunk must be >= 1, got {args.serve_chunk}")
    if (args.serve_chunk > 1 and args.fleet == 1 and not args.network
            and not args.fused_sensors):
        # The fleet/network paths always run the in-graph batched
        # instrument pipeline, so only the single-plant loop needs the
        # explicit opt-in.
        parser.error("--serve-chunk needs the in-graph instrument pipeline: "
                     "add --fused-sensors (host-object sensors cannot run "
                     "inside a device rollout)")
    if args.log_decimate < 1:
        parser.error(f"--log-decimate must be >= 1, got {args.log_decimate}")
    if args.rtu_serial and args.rtu_tcp:
        parser.error("--rtu-serial and --rtu-tcp are mutually exclusive")
    if (args.rtu_serial or args.rtu_tcp) and args.native_modbus:
        parser.error("RTU framing is served by the Python plane "
                     "(drop --native-modbus)")
    if (args.rtu_serial or args.rtu_tcp) and (args.tls_cert or args.tls_key
                                              or args.tls_ca):
        parser.error("RTU framing has no TLS profile; use the Modbus/TCP "
                     "Security plane (--tls-cert without --rtu-*)")
    tls_config = None
    if args.tls_cert or args.tls_key or args.tls_ca:
        if not (args.tls_cert and args.tls_key and args.tls_ca):
            parser.error("Modbus TLS needs all three of --tls-cert, "
                         "--tls-key, --tls-ca (mutual authentication is "
                         "mandatory in the Modbus security spec)")
        if args.native_modbus:
            parser.error("--tls-cert requires the Python Modbus plane "
                         "(the C++ data plane is plaintext-only; terminate "
                         "TLS at a front proxy instead)")
        roles = {}
        for item in args.tls_role or ():
            role, sep, perm = item.partition("=")
            if not sep or perm not in ("deny", "ro", "rw"):
                parser.error(f"--tls-role must be ROLE=ro|rw|deny, "
                             f"got {item!r}")
            roles[role] = perm
        from ics_wt_physicsengine_torch.modbus import ModbusTLSConfig
        tls_config = ModbusTLSConfig(
            certfile=args.tls_cert, keyfile=args.tls_key,
            cafile=args.tls_ca, role_permissions=roles,
            default_permission=args.tls_default_permission)
    # carried on args so the fleet/network entry points (fleet.py) see it
    args.tls_config = tls_config
    if args.serve_chunk > 1 and args.log_decimate > args.serve_chunk:
        # range(dec-1, chunk, dec) would be empty: every chunk would
        # silently log zero history rows
        parser.error(f"--log-decimate ({args.log_decimate}) cannot exceed "
                     f"--serve-chunk ({args.serve_chunk}): at most one row "
                     "per K in-chunk steps is written, so K > chunk would "
                     "log nothing at all")

    if args.network:
        import json
        with open(args.network) as f:
            spec = json.load(f)
        n_net = len(spec["routing"])
        if args.fleet not in (1, n_net):
            parser.error(f"--fleet {args.fleet} conflicts with the "
                         f"{n_net}-plant network topology in {args.network}")
        args.fleet = n_net
        args.network_spec = spec
    elif args.fleet > 254:
        parser.error(f"--fleet is capped at 254 (the Modbus unit-id "
                     f"space, ids 1..254), got {args.fleet}")
    if args.fleet < 1:
        parser.error(f"--fleet must be >= 1, got {args.fleet}")

    if args.device == "cuda" and not torch.cuda.is_initialized():
        # Prove the card alive under a subprocess deadline before this
        # process touches it (a wedged driver hangs the first touch with no
        # exception to catch). No fallback: a failed probe raises.
        from ics_wt_physicsengine_torch.utils.backend_select import (
            select_devices)
        deadline = float(os.environ.get("WT_BACKEND_PROBE_DEADLINE", "60"))
        select_devices(1, probe_deadline=deadline, log=logger.info)
    device = resolve_device(args.device)

    if args.fleet > 1 or args.network:
        from ics_wt_physicsengine_torch.fleet import main_fleet
        # this module object, whose ``running`` the signal handler clears
        # (under ``python -m`` it is ``__main__``, not the package module)
        return main_fleet(args, device, orchestrator=sys.modules[__name__])

    logger.info("=" * 70)
    logger.info("WATER TREATMENT REACTOR SIMULATION (PYTORCH, %s)",
                device.type.upper())
    logger.info("=" * 70)

    # PHASE 1: physics
    logger.info("[PHASE 1] Initializing physics engine...")
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
            initial_bacteria=_hpc_to_mgC(args.initial_hpc)
            if args.enable_biofilm else 0.0,
            initial_bdoc=args.initial_bdoc if args.enable_biofilm else 0.0,
            enable_phase=args.enable_phase)
        reactor = IntegratedCSTR(config, integrator=args.integrator,
                                 device=device)
        _m, _s = reactor._plan_for(args.dt)
        logger.info("Physics engine initialized (%d zones, %s: substeps=%d%s)",
                    args.zones, args.integrator, _m,
                    "" if _s is None else f" x {_s} stages")
    except Exception as e:  # noqa: BLE001
        logger.error("Physics engine initialization failed: %s",
                     type(e).__name__)
        sys.exit(1)

    # PHASE 2: boundary conditions
    boundary = BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.5, inlet_chlorine=0.0,
        inlet_temperature=20.0, acid_flow_rate=0.0, acid_concentration=0.1,
        chlorine_flow_rate=0.0,
        inlet_ammonia=args.initial_ammonia if args.enable_nitrogen else 0.0,
        inlet_tss=args.initial_tss if args.enable_particles else 0.0,
        inlet_pathogens=args.initial_pathogens
        if args.enable_disinfection else 0.0,
        inlet_toc=args.initial_toc if args.enable_disinfection else 0.0,
        inlet_bacteria=_hpc_to_mgC(args.initial_hpc)
        if args.enable_biofilm else 0.0,
        inlet_bdoc=args.initial_bdoc if args.enable_biofilm else 0.0,
        ambient_temperature=args.ambient_temperature,
        ambient_humidity=args.ambient_humidity,
        wind_speed=args.wind_speed,
        heat_loss_coefficient=args.heat_loss_coefficient)

    # PHASE 3: sensors
    sim_start_time = time.monotonic()
    fused_plant = None
    serve_chunk = False
    if args.fused_sensors:
        try:
            from ics_wt_physicsengine_torch.models.plant import (
                make_plant, plant_serve_chunk, plant_step)

            plant_params, fused_plant = make_plant(config, warmed_up=True,
                                                   device=device)
            _m, _s = reactor._plan_for(args.dt)
            # the per-tick step's instruments draw from this generator; the
            # serving chunk's from the fused kernel's Philox stream of the
            # same seed
            generator = torch.Generator(device=device).manual_seed(
                args.seed or 0)

            def fused_step(params, plant, bc):
                return plant_step(params, plant, bc, args.dt, _m, stages=_s,
                                  generator=generator)

            if args.serve_chunk > 1:
                serve_chunk = True

                def serve_roll(params, plant, schedule, step0):
                    return plant_serve_chunk(
                        params, plant, schedule, dt=args.dt, substeps=_m,
                        stages=_s, record_every=args.log_decimate,
                        seed=args.seed or 0, step0=step0)

                logger.info("Fast-time serving enabled: %d steps per "
                            "register exchange in one device call",
                            args.serve_chunk)
            sensors = {}
            logger.info("Fused sensor path enabled (single "
                        "physics+instruments step per tick)")
        except Exception as e:  # noqa: BLE001
            logger.error("Fused plant initialization failed: %s",
                         type(e).__name__)
            sys.exit(1)
    else:
        try:
            sensors = initialize_sensors(config, sim_start_time,
                                         args.verbose, seed=args.seed,
                                         device=device)
        except Exception as e:  # noqa: BLE001
            logger.error("Sensor initialization failed: %s",
                         type(e).__name__)
            sys.exit(1)

    # PHASE 4: Modbus (graceful degradation to no-Modbus)
    slave = None
    if not args.no_modbus:
        logger.info("[PHASE 4] Initializing Modbus server...")
        try:
            server_config = ModbusServerConfig(
                host=args.host, port=args.port, unit_id=1,
                tls=getattr(args, "tls_config", None))
            if args.native_modbus:
                from ics_wt_physicsengine_torch.modbus import NativeModbusSlave
                slave = NativeModbusSlave(
                    ModbusRegisterMap(
                        extended_nitrogen=args.enable_nitrogen,
                        extended_gas=args.enable_gas,
                        extended_particles=args.enable_particles,
                        extended_disinfection=args.enable_disinfection,
                        extended_biofilm=args.enable_biofilm,
                        extended_phase=args.enable_phase),
                    server_config)
            elif args.rtu_serial or args.rtu_tcp:
                from ics_wt_physicsengine_torch.modbus import ModbusRtuSlave
                slave = ModbusRtuSlave(
                    ModbusRegisterMap(
                        extended_nitrogen=args.enable_nitrogen,
                        extended_gas=args.enable_gas,
                        extended_particles=args.enable_particles,
                        extended_disinfection=args.enable_disinfection,
                        extended_biofilm=args.enable_biofilm,
                        extended_phase=args.enable_phase),
                    server_config, serial_device=args.rtu_serial)
            else:
                slave = ModbusSlave(
                    ModbusRegisterMap(
                        extended_nitrogen=args.enable_nitrogen,
                        extended_gas=args.enable_gas,
                        extended_particles=args.enable_particles,
                        extended_disinfection=args.enable_disinfection,
                        extended_biofilm=args.enable_biofilm,
                        extended_phase=args.enable_phase),
                    server_config)
            slave.start(blocking=False)
            # Initialize writable registers/coils so reference-compatible
            # controllers see sane defaults.
            slave.write_holding_register("inlet_flow_rate", 5.0)
            slave.write_holding_register("acid_concentration", 0.1)
            slave.write_holding_register("chlorine_concentration", 50.0)
            slave.write_holding_register("simulation_timestep", args.dt)
            if args.enable_nitrogen:
                slave.write_holding_register("inlet_ammonia",
                                             args.initial_ammonia)
            if args.enable_gas:
                slave.write_holding_register("aeration_kla", 0.0)
            if args.enable_particles:
                slave.write_holding_register("coagulant_dose", 0.0)
                slave.write_holding_register("filter_flow_rate", 0.0)
                slave.write_holding_register("sludge_blowdown", 0.0)
            if args.enable_disinfection:
                slave.write_holding_register("uv_intensity", 0.0)
                slave.write_holding_register("inlet_toc", args.initial_toc)
            if args.enable_biofilm:
                slave.write_holding_register("inlet_bdoc",
                                             args.initial_bdoc)
                slave.write_holding_register("inlet_hpc", args.initial_hpc)
            if args.enable_phase:
                slave.write_holding_register("ambient_humidity",
                                             args.ambient_humidity)
                slave.write_holding_register("wind_speed", args.wind_speed)
                slave.write_holding_register("ambient_temperature",
                                             args.ambient_temperature)
            slave.write_coil("acid_pump_enable", True)
            slave.write_coil("chlorine_pump_enable", True)
            slave.write_coil("simulation_running", True)
            if args.rtu_serial:
                logger.info("Modbus RTU server started on serial %s",
                            args.rtu_serial)
            else:
                logger.info("Modbus server started on %s:%d", args.host,
                            slave.port)
        except Exception as e:  # noqa: BLE001
            logger.error("Modbus server startup failed: %s",
                         type(e).__name__)
            logger.warning("Continuing in no-Modbus mode")
            slave = None
    else:
        logger.info("[PHASE 4] Skipping Modbus (--no-modbus)")

    opcua_server = None
    if args.opcua is not None and slave is not None:
        try:
            from ics_wt_physicsengine_torch.opcua import OPCUAServer
            opcua_server = OPCUAServer(slave, host=args.host,
                                       port=args.opcua)
            opcua_server.start(blocking=False)
            logger.info("OPC UA server started on opc.tcp://%s:%d/plant",
                        args.host, opcua_server.actual_port)
        except Exception as e:  # noqa: BLE001
            logger.error("OPC UA server startup failed: %s",
                         type(e).__name__)
            logger.warning("Continuing without OPC UA")
            opcua_server = None

    # PHASE 5: main loop
    logger.info("[PHASE 5] Starting simulation loop...")
    sim_time = 0.0
    step_count = 0
    log_interval = 60
    warmup_steps = int(10.0 / args.dt)
    modbus_error_count = 0
    max_modbus_errors = 10
    recal_interval_s = args.recal_hours * 3600.0 if args.recal_hours > 0 \
        else float("inf")
    next_recal = recal_interval_s

    # 0 disables periodic checkpoints (same zero convention as
    # --recal-hours); the shutdown checkpoint still writes.
    checkpoint_interval_s = args.checkpoint_hours * 3600.0 \
        if args.checkpoint_hours > 0 else float("inf")
    next_checkpoint = checkpoint_interval_s
    if args.checkpoint_file and os.path.exists(args.checkpoint_file):
        try:
            from ics_wt_physicsengine_torch.utils import (load_metadata,
                                                        load_simulation)
            meta = load_metadata(args.checkpoint_file)
            if fused_plant is not None:
                logger.warning("Checkpoint resume with --fused-sensors "
                               "restores physics state only")
            load_simulation(args.checkpoint_file, reactor,
                            sensors=sensors or None)
            sim_time = float(meta.get("sim_time", float(reactor.state.time)))
            next_checkpoint = sim_time + checkpoint_interval_s
            if fused_plant is not None:
                from dataclasses import replace as dc_replace
                fused_plant = dc_replace(fused_plant, reactor=reactor.state)
            logger.info("Resumed from checkpoint %s at t=%.0fs",
                        args.checkpoint_file, sim_time)
        except Exception as e:  # noqa: BLE001
            logger.error("Checkpoint resume failed: %s — starting fresh",
                         type(e).__name__)

    def write_checkpoint():
        if not args.checkpoint_file:
            return
        try:
            from ics_wt_physicsengine_torch.utils import save_simulation
            if fused_plant is not None:
                reactor.state = fused_plant.reactor
            save_simulation(args.checkpoint_file, reactor,
                            sensors=sensors or None,
                            metadata={"sim_time": sim_time})
            logger.info("t=%.0fs | checkpoint written", sim_time)
        except Exception as e:  # noqa: BLE001
            logger.error("Checkpoint write failed: %s", type(e).__name__)

    csv_file = None
    if args.log_csv:
        csv_file = open(args.log_csv, "a", buffering=1)
        if csv_file.tell() == 0:
            csv_file.write("sim_time,pH_inlet,pH_outlet,chlorine_inlet,"
                           "chlorine_outlet,flow_main,temp_inlet,"
                           "temp_outlet,acid_cmd,chlorine_cmd,"
                           "inlet_flow_cmd,any_fault\n")

    _HISTORY_FIELDS = ["sim_time", "pH_inlet", "pH_outlet",
                       "chlorine_inlet", "chlorine_outlet", "flow_main",
                       "temp_inlet", "temp_outlet", "acid_cmd",
                       "chlorine_cmd", "inlet_flow_cmd", "any_fault"]
    parquet_log = None
    if args.log_parquet:
        try:
            from ics_wt_physicsengine_torch.utils import ParquetHistoryLogger
            parquet_log = ParquetHistoryLogger(
                args.log_parquet, _HISTORY_FIELDS, int_fields=["any_fault"],
                rotate_groups=args.log_parquet_rotate or None)
        except Exception as e:  # noqa: BLE001
            logger.error("Parquet logging unavailable: %s — continuing "
                         "without it", type(e).__name__)

    def log_csv_row(readings, t=None, bc=None):
        """One history row. ``t``/``bc`` override the loop's current
        sim_time/boundary for in-chunk rows (--serve-chunk decimated
        history)."""
        if csv_file is None and parquet_log is None:
            return
        t = sim_time if t is None else t
        bc = boundary if bc is None else bc
        def v(key):
            r = readings.get(key)
            return f"{r.value:.6g}" if r else ""
        any_fault = int(any(r.fault != SensorFault.NONE
                            for r in readings.values()))
        if csv_file is not None:
            csv_file.write(
                f"{t:.3f},{v('pH_inlet')},{v('pH_outlet')},"
                f"{v('chlorine_inlet')},{v('chlorine_outlet')},"
                f"{v('flow_main')},{v('temp_inlet')},{v('temp_outlet')},"
                f"{bc.acid_flow_rate:.6g},"
                f"{bc.chlorine_flow_rate:.6g},"
                f"{bc.inlet_flow_rate:.6g},{any_fault}\n")
        if parquet_log is not None:
            def fv(key):
                r = readings.get(key)
                return float(r.value) if r else float("nan")
            parquet_log.log({
                "sim_time": float(t),
                "pH_inlet": fv("pH_inlet"), "pH_outlet": fv("pH_outlet"),
                "chlorine_inlet": fv("chlorine_inlet"),
                "chlorine_outlet": fv("chlorine_outlet"),
                "flow_main": fv("flow_main"),
                "temp_inlet": fv("temp_inlet"),
                "temp_outlet": fv("temp_outlet"),
                "acid_cmd": float(bc.acid_flow_rate),
                "chlorine_cmd": float(bc.chlorine_flow_rate),
                "inlet_flow_cmd": float(bc.inlet_flow_rate),
                "any_fault": any_fault})

    def maintain_sensors():
        """Periodic maintenance: revive latched sensors and recalibrate
        (gap-fix — reference calibrations expire after 24 h,
        base_sensor.py:116, but its loop never recalibrates)."""
        nonlocal fused_plant
        refs = {"pH": 7.0, "ch": config.initial_chlorine,
                "te": config.temperature, "fl": config.flow_rate}
        if fused_plant is not None:
            from ics_wt_physicsengine_torch.models.plant import make_plant
            from dataclasses import replace as dc_replace
            # t0= anchors calibration age / warm-up at the maintenance
            # instant — without it the fresh carries read as
            # calibration-expired again the moment sim_time > 24 h.
            _, fresh = make_plant(config, warmed_up=True, t0=sim_time,
                                  device=device)
            fused_plant = dc_replace(fresh, reactor=fused_plant.reactor)
            # the per-tick instruments' generator is re-seeded as the JAX
            # package re-keys its fresh carries; the serving chunk's Philox
            # stream is indexed by the global step and needs nothing
            generator.manual_seed((args.seed or 0) + step_count)
        else:
            import math as _math
            for name, sensor in sensors.items():
                if not _math.isfinite(sensor.current_value):
                    sensor.reset(seed=(args.seed or 0) * 7919 + step_count)
                # the extension instruments have no entry in refs: they are
                # revived above but keep their commissioning calibration
                if name[:2] in refs:
                    sensor.calibrate(refs[name[:2]],
                                     sim_start_time + sim_time,
                                     "maintenance")
        logger.info("t=%.0fs | sensor maintenance/recalibration done",
                    sim_time)

    commanded = boundary   # last commanded target (actuator slew endpoint)
    failure = None
    try:
        while running and sim_time < args.duration:
            step_start = time.monotonic()

            paused = False
            if slave:
                with suppress(Exception):
                    paused = not slave.read_coil("simulation_running")

            if not paused and serve_chunk:
                # Fast-time serving (--serve-chunk): N steps per register
                # exchange in ONE device call — the reference's serving
                # ceiling is 1 step per host tick (__main__.py:453-457);
                # here the card free-runs one launch of the fused plant
                # kernel between exchanges (SURVEY §7 hard-part 4).
                from dataclasses import replace as _dc_replace
                # Final chunk clamps to the remaining horizon so the run
                # cannot overshoot --duration by up to chunk-1 steps (an
                # endless run, the default --duration, is never clamped).
                remaining = (args.duration - sim_time) / args.dt
                chunk = args.serve_chunk if remaining == float("inf") \
                    else min(args.serve_chunk, max(1, int(round(remaining))))
                try:
                    schedule, end_boundary = build_chunk_schedule(
                        boundary, commanded, chunk, args.dt,
                        args.actuator_tau, device=device)
                    # step0: the global step count, so that the Philox
                    # noise does not depend on how the run is chunked
                    result = serve_roll(plant_params, fused_plant, schedule,
                                        step_count)
                    fused_plant = result.plant
                    state = fused_plant.reactor
                    readings = _readings_from_chunk(
                        result, sim_time + chunk * args.dt)
                except Exception as e:  # noqa: BLE001
                    logger.error("Physics chunk failed: %s: %s",
                                 type(e).__name__, e)
                    raise

                if slave:
                    if not update_modbus_inputs(
                            slave, readings, state,
                            sim_time + chunk * args.dt):
                        modbus_error_count += 1
                        if modbus_error_count >= max_modbus_errors:
                            logger.error(
                                "Too many Modbus errors, disabling interface")
                            slave = None
                if slave:
                    commands = read_modbus_commands(slave)
                    commanded = apply_boundary_conditions(end_boundary,
                                                          commands)
                # Next chunk slews from the end-of-chunk actuator positions
                # toward the freshly validated commands (instant when no
                # actuator lag is configured) — same composition as the
                # per-tick apply_actuator_dynamics.
                if args.actuator_tau > 0:
                    boundary = _dc_replace(commanded, **{
                        f: getattr(end_boundary, f)
                        for f in _ACTUATOR_FIELDS})
                else:
                    boundary = commanded

                # Decimated in-chunk history: every Kth recorded step, with
                # its own sim_time and scheduled actuator values.
                if csv_file is not None or parquet_log is not None:
                    values = result.values.cpu().numpy()
                    faults = result.faults.cpu().numpy()
                    sched_host = {f: getattr(schedule, f).cpu().numpy()
                                  for f in _ACTUATOR_FIELDS}
                    for row, j in enumerate(range(args.log_decimate - 1,
                                                  chunk, args.log_decimate)):
                        row_bc = _dc_replace(end_boundary, **{
                            f: float(sched_host[f][j])
                            for f in _ACTUATOR_FIELDS})
                        log_csv_row(_recorded_readings(
                            result.names, values, faults, row,
                            sim_time + (j + 1) * args.dt),
                            t=sim_time + (j + 1) * args.dt, bc=row_bc)

                prev_intervals = step_count // log_interval
                step_count += chunk
                sim_time += chunk * args.dt
                if step_count // log_interval != prev_intervals:
                    ph_out = readings.get("pH_outlet")
                    cl_out = readings.get("chlorine_outlet")
                    logger.info(
                        "t=%.0fs | pH_out=%.2f | Cl_out=%.2f | AcidCmd=%.2f"
                        " | chunk=%d",
                        sim_time,
                        ph_out.value if ph_out else 0.0,
                        cl_out.value if cl_out else 0.0,
                        boundary.acid_flow_rate, chunk)
                if sim_time >= next_recal:
                    maintain_sensors()
                    next_recal += recal_interval_s
                if args.checkpoint_file and sim_time >= next_checkpoint:
                    write_checkpoint()
                    next_checkpoint += checkpoint_interval_s
            elif not paused:
                try:
                    if fused_plant is not None:
                        fused_plant, outputs = fused_step(
                            plant_params, fused_plant, boundary)
                        state = fused_plant.reactor
                        readings = _readings_from_outputs(outputs)
                    else:
                        state = reactor.step(args.dt, boundary=boundary)
                except Exception as e:  # noqa: BLE001
                    logger.error("Physics step failed: %s: %s",
                                 type(e).__name__, e)
                    raise

                current_sim_time = sim_start_time + sim_time
                if fused_plant is None:
                    readings = read_all_sensors(sensors, state,
                                                current_sim_time,
                                                args.verbose)

                if slave:
                    if not update_modbus_inputs(slave, readings, state,
                                                sim_time):
                        modbus_error_count += 1
                        if modbus_error_count >= max_modbus_errors:
                            logger.error(
                                "Too many Modbus errors, disabling interface")
                            slave = None

                if slave:
                    commands = read_modbus_commands(slave)
                    commanded = apply_boundary_conditions(boundary, commands)
                # Actuators keep slewing toward the LAST command even if the
                # Modbus interface dies mid-transient — a physical valve
                # completes its travel; freezing at a partial flow would be
                # an artifact of the error budget, not the plant.
                boundary = apply_actuator_dynamics(
                    boundary, commanded, args.dt, args.actuator_tau)

                if step_count % log_interval == 0:
                    sensors_ready = all(
                        r.status not in (SensorStatus.WARMING_UP,
                                         SensorStatus.CALIBRATING)
                        for r in readings.values())
                    if sensors_ready or step_count >= warmup_steps:
                        ph_in = readings.get("pH_inlet")
                        ph_out = readings.get("pH_outlet")
                        cl_out = readings.get("chlorine_outlet")
                        flow = readings.get("flow_main")
                        logger.info(
                            "t=%.0fs | pH_in=%.2f | pH_out=%.2f | "
                            "Cl_out=%.2f | Flow=%.1f | AcidCmd=%.2f",
                            sim_time,
                            ph_in.value if ph_in else 0.0,
                            ph_out.value if ph_out else 0.0,
                            cl_out.value if cl_out else 0.0,
                            flow.value if flow else 0.0,
                            boundary.acid_flow_rate)
                    else:
                        logger.info("t=%.0fs | Sensors warming up...",
                                    sim_time)

                log_csv_row(readings)
                step_count += 1
                sim_time += args.dt
                if sim_time >= next_recal:
                    maintain_sensors()
                    next_recal += recal_interval_s
                if args.checkpoint_file and sim_time >= next_checkpoint:
                    write_checkpoint()
                    next_checkpoint += checkpoint_interval_s

            # real-time pacing (reference __main__.py:453-457); a serving
            # chunk paces against its whole simulated span
            if args.rtf > 0:
                elapsed = time.monotonic() - step_start
                span = args.dt * (args.serve_chunk if serve_chunk else 1)
                sleep_time = max(0.0, span / args.rtf - elapsed)
                if sleep_time > 0:
                    time.sleep(sleep_time)

    except KeyboardInterrupt:
        logger.info("Keyboard interrupt received")
    except Exception as e:  # noqa: BLE001
        # a failed step, chunk or launch ends the run with an error, after
        # the checkpoint and the servers' shutdown below
        logger.error("Simulation error: %s: %s", type(e).__name__, e)
        failure = e
    finally:
        logger.info("Shutting down...")
        write_checkpoint()
        if csv_file is not None:
            with suppress(Exception):
                csv_file.close()
        if parquet_log is not None:
            with suppress(Exception):
                parquet_log.close()
        if opcua_server:
            logger.info("Stopping OPC UA server...")
            with suppress(Exception):
                opcua_server.stop()
        if slave:
            logger.info("Stopping Modbus server...")
            with suppress(Exception):
                slave.stop()
        if failure is None:
            logger.info("Simulation stopped cleanly (t=%.0fs, %d steps)",
                        sim_time, step_count)
    if failure is not None:
        raise SystemExit(1) from failure
    return 0


if __name__ == "__main__":
    sys.exit(main())
