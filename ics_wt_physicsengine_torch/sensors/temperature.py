"""
Temperature sensor (RTD / thermocouple) as a pure transform (port of
``ics_wt_physicsengine_tpu/sensors/temperature.py``).

- RTD (Pt100/Pt1000): resistance model, 2-wire lead resistance error, I^2 R
  self-heating, ADC noise
- thermocouple (K/J): Seebeck conversion, cold-junction random-walk drift
  (a true random walk carried across reads), EMF noise
- stem conduction error 1% of (T - ambient) for all types
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, resolve_device,
                                               tensor_from_numpy)
from ics_wt_physicsengine_torch.sensors import base as B
from ics_wt_physicsengine_torch.utils.dispatch import ieee_div

RTD_PT100 = "rtd_pt100"
RTD_PT1000 = "rtd_pt1000"
THERMOCOUPLE_K = "thermocouple_k"
THERMOCOUPLE_J = "thermocouple_j"


@dataclass(frozen=True)
class TemperatureSensorParams:
    zone_index: int
    sensor_type: str
    base: B.SensorParams = None
    nominal_resistance: torch.Tensor = None   # RTD
    rtd_alpha: torch.Tensor = None
    lead_resistance: torch.Tensor = None
    excitation_current_mA: torch.Tensor = None
    self_heating_C_per_mW: torch.Tensor = None
    seebeck_coefficient: torch.Tensor = None  # thermocouple


@dataclass
class TemperatureSensorCarry:
    base: B.SensorCarry
    cold_junction_temp: torch.Tensor
    cold_junction_drift: torch.Tensor   # random walk


def make_temperature_params(zone_index=0, sensor_type=RTD_PT100,
                            precision=None, response_time=15.0,
                            drift_rate=0.0, sample_line=None,
                            installation=None, dtype=DEFAULT_DTYPE,
                            device=None) -> TemperatureSensorParams:
    dev = resolve_device(device)
    is_rtd = "rtd" in sensor_type
    default_precision = 0.1 if is_rtd else 0.5
    base = B.make_sensor_params(
        measurement_range=(-10.0, 110.0),
        precision=precision or default_precision,
        response_time=response_time, drift_rate=drift_rate,
        warmup_time_s=30.0, hysteresis_magnitude=0.05,
        max_rate_of_change=10.0, installation=installation,
        sample_line=sample_line, dtype=dtype, device=dev)
    arr = lambda x: tensor_from_numpy(x, dtype, dev)  # noqa: E731
    return TemperatureSensorParams(
        zone_index=zone_index, sensor_type=sensor_type, base=base,
        nominal_resistance=arr(100.0 if sensor_type == RTD_PT100 else 1000.0),
        rtd_alpha=arr(0.00385), lead_resistance=arr(0.5),
        excitation_current_mA=arr(1.0), self_heating_C_per_mW=arr(0.001),
        seebeck_coefficient=arr(40.0))


def make_temperature_carry(params: TemperatureSensorParams, t0=0.0,
                           dtype=DEFAULT_DTYPE,
                           device=None) -> TemperatureSensorCarry:
    dev = resolve_device(device)
    base = B.make_sensor_carry(params.base, t0=t0, initial_value=20.0,
                               dtype=dtype, device=dev)
    return TemperatureSensorCarry(
        base=base, cold_junction_temp=tensor_from_numpy(25.0, dtype, dev),
        cold_junction_drift=tensor_from_numpy(0.0, dtype, dev))


N_NORMALS = B.BASE_NORMALS + 2     # + adc/cold-junction, emf noise
N_UNIFORMS = B.BASE_UNIFORMS


def temperature_read(params: TemperatureSensorParams,
                     carry: TemperatureSensorCarry, temperature_zone, t,
                     rand=None, delayed_true=None, generator=None):
    """``delayed_true``: optional already-delayed sample (the fused plant
    resolves the sample line outside; see ``ph.ph_read``)."""
    cv = carry.base.current_value
    if delayed_true is not None:
        temperature_zone = delayed_true

    normals, uniforms = B.read_rand(rand, generator, carry.base,
                                    extra_normals=2)
    # the uniforms go to the base read unsliced, as in the JAX package
    base_carry, out = B.base_read(
        params.base, carry.base, B._as(temperature_zone, cv), t,
        rand=(normals[..., :B.BASE_NORMALS], uniforms))
    finite = torch.isfinite(out.value)
    n1 = normals[..., B.BASE_NORMALS]
    n2 = normals[..., B.BASE_NORMALS + 1]

    if "rtd" in params.sensor_type:
        r_true = params.nominal_resistance \
            * (1.0 + params.rtd_alpha * out.value)
        r_measured = r_true + 2.0 * params.lead_resistance
        i_a = ieee_div(params.excitation_current_mA, 1000.0)
        power_mw = (i_a * i_a) * r_measured * 1000.0
        self_heating = params.self_heating_C_per_mW * power_mw
        t_measured = (r_measured / params.nominal_resistance - 1.0) \
            / params.rtd_alpha
        adc_noise = n1 * 0.001
        final = t_measured + self_heating + adc_noise
        cj_drift = carry.cold_junction_drift
    else:
        v_seebeck = params.seebeck_coefficient \
            * (out.value - carry.cold_junction_temp)
        cj_drift = torch.where(
            finite,
            carry.cold_junction_drift + n1 * 0.01,
            carry.cold_junction_drift)
        emf_noise = n2 * 0.5
        final = (v_seebeck + emf_noise) / params.seebeck_coefficient \
            + carry.cold_junction_temp + cj_drift

    # stem conduction error
    stem_error = 0.01 * (out.value - params.base.ambient_temperature)
    final = torch.clamp(final + stem_error, min=params.base.min_value,
                        max=params.base.max_value)
    value = torch.where(finite, final, out.value)

    output = B.SensorOutput(
        timestamp=out.timestamp, value=value, raw_value=out.raw_value,
        noise=out.noise,
        drift=torch.where(finite, out.drift + stem_error, out.drift),
        status=out.status,
        uncertainty=torch.where(finite, params.base.precision * 2.0,
                                out.uncertainty),
        fault=out.fault)

    base_carry = replace(
        base_carry,
        current_value=torch.where(finite, value, base_carry.current_value),
        last_value=value)
    return TemperatureSensorCarry(base=base_carry,
                                  cold_junction_temp=carry.cold_junction_temp,
                                  cold_junction_drift=cj_drift), output
