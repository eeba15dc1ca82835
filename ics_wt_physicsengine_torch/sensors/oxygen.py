"""
Dissolved-oxygen sensor (optical / membrane-amperometric) as a pure
transform, the instrument of the gas exchange (port of
``ics_wt_physicsengine_tpu/sensors/oxygen.py``).

- Optical / luminescent ("optical"): the lumiphore photo-degrades with
  every excitation flash (~0.03%/day), losing sensitivity; its phase noise
  grows as the dye fades; ``replace_cap`` restores it.
- Clark cell ("clark"): the cathode consumes O2, so stagnant water
  under-reads (v/(v + K) in plant-flow units); the membrane fouls (up to
  60% signal loss) and the electrolyte depletes with the measured charge.

Both sense O2 partial pressure; the pO2 -> mg/L conversion carries a
temperature-compensation residual per degree from the calibration
temperature.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ics_wt_physicsengine_torch.core import gas as GC
from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, resolve_device,
                                               tensor_from_numpy)
from ics_wt_physicsengine_torch.sensors import base as B
from ics_wt_physicsengine_torch.utils.dispatch import ieee_div

OPTICAL = "optical"
CLARK = "clark"


@dataclass(frozen=True)
class OxygenSensorParams:
    zone_index: int
    sensor_type: str
    base: B.SensorParams = None
    cal_temperature: torch.Tensor = None      # [C]
    temp_comp_residual: torch.Tensor = None   # fraction error per degC
    photo_decay_pct_per_day: torch.Tensor = None   # optical cap aging
    fouling_rate_per_day: torch.Tensor = None      # clark membrane
    max_fouling: torch.Tensor = None               # clark signal-loss cap
    electrolyte_days: torch.Tensor = None          # clark KCl lifetime
    flow_K_m3h: torch.Tensor = None                # clark flow half-sat


@dataclass
class OxygenSensorCarry:
    base: B.SensorCarry
    cap_age_days: torch.Tensor        # optical lumiphore exposure
    slope_percentage: torch.Tensor    # optical sensitivity health
    membrane_fouling: torch.Tensor    # clark fractional signal loss
    electrolyte: torch.Tensor         # clark fill remaining [0..1]


def make_oxygen_params(zone_index=0, sensor_type=OPTICAL, precision=None,
                       response_time=None, drift_rate=0.01 / 24.0,
                       cal_temperature=20.0,
                       photo_decay_pct_per_day=0.03,
                       fouling_rate_per_day=0.004, max_fouling=0.6,
                       electrolyte_days=180.0, flow_K_m3h=0.05,
                       sample_line=None, installation=None,
                       dtype=DEFAULT_DTYPE,
                       device=None) -> OxygenSensorParams:
    dev = resolve_device(device)
    if sensor_type == OPTICAL:
        # slower response (dye diffusion), fine precision, quick warm-up
        default_precision, default_response, warmup = 0.05, 40.0, 60.0
    elif sensor_type == CLARK:
        # faster cell, needs polarization time after power-up
        default_precision, default_response, warmup = 0.1, 20.0, 900.0
    else:
        raise ValueError(f"unknown oxygen sensor type {sensor_type!r}")
    base = B.make_sensor_params(
        measurement_range=(0.0, 20.0),
        precision=precision or default_precision,
        response_time=response_time or default_response,
        drift_rate=drift_rate, warmup_time_s=warmup,
        hysteresis_magnitude=0.01, max_rate_of_change=2.0,
        installation=installation, sample_line=sample_line, dtype=dtype,
        device=dev)
    arr = lambda x: tensor_from_numpy(x, dtype, dev)  # noqa: E731
    return OxygenSensorParams(
        zone_index=zone_index, sensor_type=sensor_type, base=base,
        cal_temperature=arr(cal_temperature),
        temp_comp_residual=arr(0.002),
        photo_decay_pct_per_day=arr(photo_decay_pct_per_day),
        fouling_rate_per_day=arr(fouling_rate_per_day),
        max_fouling=arr(max_fouling),
        electrolyte_days=arr(electrolyte_days),
        flow_K_m3h=arr(flow_K_m3h))


def make_oxygen_carry(params: OxygenSensorParams, t0=0.0,
                      dtype=DEFAULT_DTYPE,
                      device=None) -> OxygenSensorCarry:
    dev = resolve_device(device)
    base = B.make_sensor_carry(params.base, t0=t0, initial_value=8.0,
                               dtype=dtype, device=dev)
    arr = lambda x: tensor_from_numpy(x, dtype, dev)  # noqa: E731
    return OxygenSensorCarry(base=base, cap_age_days=arr(0.0),
                             slope_percentage=arr(100.0),
                             membrane_fouling=arr(0.0),
                             electrolyte=arr(1.0))


N_NORMALS = B.BASE_NORMALS + 2     # + luminescence/polarization, electronics
N_UNIFORMS = B.BASE_UNIFORMS


def oxygen_read(params: OxygenSensorParams, carry: OxygenSensorCarry,
                o2_zone, temperature_zone, flow_rate, t, rand=None,
                generator=None):
    """One dissolved-O2 reading [mg/L]: base pipeline + principle overlay.
    ``rand``: optional pre-drawn ``(normals[..., N_NORMALS],
    uniforms[..., N_UNIFORMS])``; None draws from ``generator``. Returns
    ``(carry', SensorOutput)``."""
    cv = carry.base.current_value
    prev_ts = carry.base.last_timestamp
    had_prev = carry.base.has_history

    o2 = B._as(o2_zone, cv)
    T = B._as(temperature_zone, cv)
    q = B._as(flow_rate, cv)

    normals, uniforms = B.read_rand(rand, generator, carry.base,
                                    extra_normals=2)
    base_carry, out = B.base_read(
        params.base, carry.base, o2, t,
        rand=(normals[..., :B.BASE_NORMALS],
              uniforms[..., :B.BASE_UNIFORMS]))
    finite = torch.isfinite(out.value)
    n1 = normals[..., B.BASE_NORMALS]
    n2 = normals[..., B.BASE_NORMALS + 1]

    dt = torch.clamp(out.timestamp - prev_ts, min=0.0)
    update = had_prev & finite
    dt_days = ieee_div(dt, 86400.0)

    if params.sensor_type == OPTICAL:
        # lumiphore photo-degradation: the slope decays with exposure
        age = torch.where(update, carry.cap_age_days + dt_days,
                          carry.cap_age_days)
        slope = torch.where(
            update,
            torch.clamp(carry.slope_percentage
                        - params.photo_decay_pct_per_day * dt_days,
                        min=70.0),
            carry.slope_percentage)
        measured = out.value * ieee_div(slope, 100.0)
        # phase-detection noise grows as the dye fades
        measured = measured + n1 * params.base.precision * (100.0 / slope)
        fouling, elec = carry.membrane_fouling, carry.electrolyte
    else:
        age, slope = carry.cap_age_days, carry.slope_percentage
        # boundary-layer depletion: stagnant water under-reads
        flow_factor = q / (q + params.flow_K_m3h)
        fouling = torch.where(
            update,
            torch.minimum(carry.membrane_fouling
                          + params.fouling_rate_per_day * dt_days,
                          params.max_fouling),
            carry.membrane_fouling)
        # electrolyte consumption scales with the measured signal
        elec = torch.where(
            update,
            torch.clamp(carry.electrolyte
                        - dt_days / params.electrolyte_days
                        * ieee_div(out.value, 9.0), min=0.1),
            carry.electrolyte)
        response = flow_factor * (1.0 - fouling) \
            * (0.7 + 0.3 * torch.clamp(ieee_div(elec, 0.3), max=1.0))
        measured = out.value * response
        # polarization noise grows as the electrolyte depletes
        measured = measured + n1 * params.base.precision \
            / torch.clamp(elec, min=0.2)

    # electronics noise (both principles)
    measured = measured + n2 * params.base.precision * 0.5

    # pO2 -> mg/L conversion: temperature-compensation residual
    dT = T - params.cal_temperature
    measured = measured * (1.0 + params.temp_comp_residual * dT)

    final = torch.clamp(measured, min=params.base.min_value,
                        max=params.base.max_value)
    value = torch.where(finite, final, out.value)

    output = B.SensorOutput(
        timestamp=out.timestamp, value=value, raw_value=out.raw_value,
        noise=out.noise, drift=out.drift, status=out.status,
        uncertainty=torch.where(
            finite, params.base.precision * 2.0
            * (1.0 + carry.membrane_fouling), out.uncertainty),
        fault=out.fault)

    base_carry = replace(
        base_carry,
        current_value=torch.where(finite, value, base_carry.current_value),
        last_value=value)
    return OxygenSensorCarry(base=base_carry, cap_age_days=age,
                             slope_percentage=slope,
                             membrane_fouling=fouling,
                             electrolyte=elec), output


def replace_cap(carry: OxygenSensorCarry) -> OxygenSensorCarry:
    """Replace the optical sensing cap / Clark membrane and electrolyte:
    all consumable aging resets."""
    zeros = torch.zeros_like(carry.cap_age_days)
    return replace(carry, cap_age_days=zeros,
                   slope_percentage=zeros + 100.0,
                   membrane_fouling=zeros, electrolyte=zeros + 1.0)


def percent_saturation(o2_mgL, T_C):
    """A concentration reading as % air saturation."""
    return 100.0 * o2_mgL / GC.oxygen_saturation(T_C)


def validate_oxygen_sensor(verbose: bool = True, device=None) -> bool:
    """Principle physics against hand calculations, in float64 on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    f64 = torch.float64
    checks = []

    def check(name, ok):
        checks.append((name, bool(ok)))
        if verbose:
            print(f"  {'PASS' if ok else 'FAIL'}: {name}")

    def scalar(x):
        return torch.tensor(x, dtype=f64, device=dev)

    def read_once(sensor_type, o2, T=20.0, flow=2.0, fouling=0.0,
                  elec=1.0):
        p = make_oxygen_params(sensor_type=sensor_type, dtype=f64,
                               device=dev)
        c = make_oxygen_carry(p, dtype=f64, device=dev)
        c = replace(c, base=replace(
            c.base, power_on_time=scalar(-4000.0),
            last_calibration_time=scalar(0.0),
            has_calibration=torch.ones_like(c.base.has_calibration),
            current_value=scalar(o2)),   # lag-converged
            membrane_fouling=scalar(fouling), electrolyte=scalar(elec))
        n = torch.zeros((N_NORMALS,), dtype=f64, device=dev)
        u = torch.full((N_UNIFORMS,), 0.5, dtype=f64, device=dev)
        _, out = oxygen_read(p, c, o2, T, flow, 10.0, rand=(n, u))
        return float(out.value)

    v = read_once(OPTICAL, 8.0)
    check("optical reads true DO at cal point", abs(v - 8.0) < 1e-3)

    v = read_once(OPTICAL, 8.0, T=30.0)
    check("temp-comp residual = 0.2%/degC",
          abs(v - 8.0 * (1.0 + 0.002 * 10.0)) < 1e-3)

    v_flow = read_once(CLARK, 8.0, flow=2.0)
    v_stag = read_once(CLARK, 8.0, flow=0.01)
    check("Clark under-reads in stagnant water", v_stag < 0.25 * v_flow)
    check("Clark at high flow ~ true value", abs(v_flow - 8.0) < 0.25)

    v_foul = read_once(CLARK, 8.0, fouling=0.3)
    check("Clark fouling scales the signal",
          abs(v_foul / v_flow - 0.7) < 0.02)

    v_dep = read_once(CLARK, 8.0, elec=0.15)
    check("electrolyte depletion reduces response", v_dep < 0.95 * v_flow)

    sat20 = GC.oxygen_saturation(scalar(20.0))
    check("percent_saturation(sat, 20C) = 100%",
          abs(float(percent_saturation(sat20, scalar(20.0))) - 100.0)
          < 1e-9)

    ok = all(s for _, s in checks)
    if verbose:
        print(f"Oxygen sensor validation: "
              f"{'ALL PASS' if ok else 'FAILURES PRESENT'}")
    return ok
