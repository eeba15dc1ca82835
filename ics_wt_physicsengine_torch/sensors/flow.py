"""
Flow sensor (turbine / magnetic) as a pure transform (port of
``ics_wt_physicsengine_tpu/sensors/flow.py``).

- turbine: bearing-friction dead band growing with wear x vibration
- magnetic: electrode fouling + conductivity cutoff (<5 uS/cm reads 0)
- air-bubble dropouts read 0 (not NaN), 1% full-scale zero cutoff
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, resolve_device,
                                               tensor_from_numpy)
from ics_wt_physicsengine_torch.sensors import base as B
from ics_wt_physicsengine_torch.utils.dispatch import ieee_div

TURBINE = "turbine"
MAGNETIC = "magnetic"


@dataclass(frozen=True)
class FlowSensorParams:
    sensor_type: str
    base: B.SensorParams = None
    full_scale: torch.Tensor = None


@dataclass
class FlowSensorCarry:
    base: B.SensorCarry
    bearing_friction: torch.Tensor     # turbine
    bearing_wear_days: torch.Tensor
    electrode_fouling: torch.Tensor    # magnetic
    fluid_conductivity: torch.Tensor   # [uS/cm]


def make_flow_params(sensor_type=MAGNETIC, full_scale=100.0, precision=None,
                     response_time=0.5, drift_rate=0.0, sample_line=None,
                     installation=None, dtype=DEFAULT_DTYPE,
                     device=None) -> FlowSensorParams:
    dev = resolve_device(device)
    default_precision = (0.01 if sensor_type == TURBINE else 0.005) \
        * full_scale
    base = B.make_sensor_params(
        measurement_range=(0.0, full_scale),
        precision=precision or default_precision,
        response_time=response_time, drift_rate=drift_rate,
        warmup_time_s=10.0, hysteresis_magnitude=0.005 * full_scale,
        max_rate_of_change=full_scale, installation=installation,
        sample_line=sample_line, dtype=dtype, device=dev)
    return FlowSensorParams(sensor_type=sensor_type, base=base,
                            full_scale=tensor_from_numpy(full_scale, dtype,
                                                         dev))


def make_flow_carry(params: FlowSensorParams, t0=0.0, dtype=DEFAULT_DTYPE,
                    device=None) -> FlowSensorCarry:
    dev = resolve_device(device)
    base = B.make_sensor_carry(params.base, t0=t0, initial_value=0.0,
                               dtype=dtype, device=dev)
    arr = lambda x: tensor_from_numpy(x, dtype, dev)  # noqa: E731
    return FlowSensorCarry(base=base, bearing_friction=arr(0.01),
                           bearing_wear_days=arr(0.0),
                           electrode_fouling=arr(0.0),
                           fluid_conductivity=arr(100.0))


N_NORMALS = B.BASE_NORMALS + 1     # + vibration/electrical noise
N_UNIFORMS = B.BASE_UNIFORMS + 1   # + air-bubble roll


def flow_read(params: FlowSensorParams, carry: FlowSensorCarry,
              flow_rate, t, rand=None, generator=None):
    cv = carry.base.current_value
    prev_ts = carry.base.last_timestamp
    had_prev = carry.base.has_history

    normals, uniforms = B.read_rand(rand, generator, carry.base,
                                    extra_normals=1, extra_uniforms=1)
    base_carry, out = B.base_read(
        params.base, carry.base, B._as(flow_rate, cv), t,
        rand=(normals[..., :B.BASE_NORMALS],
              uniforms[..., :B.BASE_UNIFORMS]))
    finite = torch.isfinite(out.value)
    n1 = normals[..., B.BASE_NORMALS]
    u2 = uniforms[..., B.BASE_UNIFORMS]

    dt = torch.clamp(out.timestamp - prev_ts, min=0.0)
    update = had_prev & finite

    if params.sensor_type == TURBINE:
        wear_factor = 1.0 + params.base.pipe_vibration_g * 5.0
        wear = torch.where(update,
                           carry.bearing_wear_days
                           + ieee_div(dt, 86400.0) * wear_factor,
                           carry.bearing_wear_days)
        friction_threshold = carry.bearing_friction \
            * (1.0 + 0.01 * ieee_div(wear, 365.0))
        friction_loss = friction_threshold * params.full_scale
        effective = torch.where(out.value < friction_loss, 0.0,
                                out.value - friction_loss)
        vib_noise = n1 * params.base.pipe_vibration_g * 0.01 \
            * params.full_scale
        final = effective + vib_noise
        fouling = carry.electrode_fouling
    else:
        fouling = torch.where(update,
                              carry.electrode_fouling
                              + ieee_div(0.001 * dt, 86400.0),
                              carry.electrode_fouling)
        fouling_factor = torch.clamp(1.0 - 0.005 * fouling, min=0.9)
        cond = carry.fluid_conductivity
        conductivity_factor = torch.where(
            cond < 5.0, 0.0, torch.where(cond < 20.0,
                                         ieee_div(cond, 20.0), 1.0))
        electrical_noise = n1 * 0.001 * params.full_scale
        final = out.value * fouling_factor * conductivity_factor \
            + electrical_noise
        wear = carry.bearing_wear_days

    # air bubbles read zero
    bubble = (params.base.air_bubble_frequency > 0) & (
        u2 < ieee_div(params.base.air_bubble_frequency, 60.0))
    final = torch.where(bubble, 0.0, final)

    # zero cutoff + clip
    final = torch.where(final < 0.01 * params.full_scale, 0.0, final)
    final = torch.clamp(final, min=torch.zeros_like(params.base.max_value),
                        max=params.base.max_value)
    value = torch.where(finite, final, out.value)

    output = B.SensorOutput(
        timestamp=out.timestamp, value=value, raw_value=out.raw_value,
        noise=out.noise, drift=out.drift, status=out.status,
        uncertainty=torch.where(finite, params.base.precision * 2.0,
                                out.uncertainty),
        fault=out.fault)

    base_carry = replace(
        base_carry,
        current_value=torch.where(finite, value, base_carry.current_value),
        last_value=value)
    return FlowSensorCarry(base=base_carry,
                           bearing_friction=carry.bearing_friction,
                           bearing_wear_days=wear,
                           electrode_fouling=fouling,
                           fluid_conductivity=carry.fluid_conductivity), output
