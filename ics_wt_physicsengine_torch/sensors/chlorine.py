"""
Chlorine sensor (amperometric / DPD colorimetric) as a pure transform (port
of ``ics_wt_physicsengine_tpu/sensors/chlorine.py``).

- HOCl-fraction-weighted response 0.5 + 0.5*alpha_HOCl at the sensor's own
  fixed pKa 7.5 (not the temperature-corrected chemistry value)
- amperometric path: cross-sensitivity interference (O3 x1.2, H2O2 x0.3,
  ClO2 x0.5), membrane fouling up to 80% signal loss, polarization noise
  growing with membrane age, diffusion noise
- DPD path: reagent potency with Arrhenius + photodegradation, 95% reaction
  completeness, optical noise

The sensor type is a Python value on the params, uniform over a batch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, resolve_device,
                                               tensor_from_numpy)
from ics_wt_physicsengine_torch.sensors import base as B
from ics_wt_physicsengine_torch.utils.dispatch import ieee_div

AMPEROMETRIC = "amperometric"
DPD = "dpd_colorimetric"

CHLORINE_PKA = 7.5   # sensor-local constant


@dataclass(frozen=True)
class ChlorineSensorParams:
    zone_index: int
    sensor_type: str
    # "free" (HOCl + OCl-) or "total" (free + combined chloramines)
    measurement_type: str = "free"
    base: B.SensorParams = None
    # amperometric cross-sensitivities
    ozone_sensitivity: torch.Tensor = None
    h2o2_sensitivity: torch.Tensor = None
    clo2_sensitivity: torch.Tensor = None


@dataclass
class ChlorineSensorCarry:
    base: B.SensorCarry
    # amperometric state
    membrane_fouling: torch.Tensor
    membrane_age_days: torch.Tensor
    electrode_polarization: torch.Tensor
    # DPD state
    reagent_potency: torch.Tensor
    reagent_age_days: torch.Tensor
    light_exposure_hours: torch.Tensor
    storage_temperature: torch.Tensor


def make_chlorine_params(zone_index=0, sensor_type=AMPEROMETRIC,
                         measurement_type="free",
                         precision=None, response_time=None,
                         drift_rate=0.02 / 24.0, sample_line=None,
                         installation=None, dtype=DEFAULT_DTYPE,
                         device=None) -> ChlorineSensorParams:
    dev = resolve_device(device)
    if sensor_type == AMPEROMETRIC:
        default_precision, default_response, warmup = 0.01, 30.0, 300.0
    else:
        default_precision, default_response, warmup = 0.02, 90.0, 60.0
    base = B.make_sensor_params(
        measurement_range=(0.0, 10.0),
        precision=precision or default_precision,
        response_time=response_time or default_response,
        drift_rate=drift_rate, warmup_time_s=warmup,
        hysteresis_magnitude=0.01, max_rate_of_change=1.0,
        installation=installation, sample_line=sample_line, dtype=dtype,
        device=dev)
    arr = lambda x: tensor_from_numpy(x, dtype, dev)  # noqa: E731
    if hasattr(measurement_type, "value"):   # an enum of the same names
        measurement_type = measurement_type.value
    if measurement_type not in ("free", "total"):
        raise ValueError(f"measurement_type must be 'free' or 'total', "
                         f"got {measurement_type!r}")
    return ChlorineSensorParams(
        zone_index=zone_index, sensor_type=sensor_type,
        measurement_type=measurement_type, base=base,
        ozone_sensitivity=arr(1.2), h2o2_sensitivity=arr(0.3),
        clo2_sensitivity=arr(0.5))


def make_chlorine_carry(params: ChlorineSensorParams, t0=0.0,
                        dtype=DEFAULT_DTYPE,
                        device=None) -> ChlorineSensorCarry:
    dev = resolve_device(device)
    base = B.make_sensor_carry(params.base, t0=t0, initial_value=0.0,
                               dtype=dtype, device=dev)
    arr = lambda x: tensor_from_numpy(x, dtype, dev)  # noqa: E731
    return ChlorineSensorCarry(
        base=base, membrane_fouling=arr(0.0), membrane_age_days=arr(0.0),
        electrode_polarization=arr(0.0), reagent_potency=arr(1.0),
        reagent_age_days=arr(0.0), light_exposure_hours=arr(0.0),
        storage_temperature=arr(20.0))


def chlorine_true_value(chlorine_zone, pH_zone):
    """HOCl-fraction-weighted effective chlorine."""
    ratio = 10.0 ** (CHLORINE_PKA - pH_zone)
    fraction_hocl = ratio / (1.0 + ratio)
    return chlorine_zone * (0.5 + 0.5 * fraction_hocl)


N_NORMALS = B.BASE_NORMALS + 2     # + polarization/optical, diffusion
N_UNIFORMS = B.BASE_UNIFORMS


def chlorine_read(params: ChlorineSensorParams, carry: ChlorineSensorCarry,
                  chlorine_zone, pH_zone, t,
                  ozone=0.0, hydrogen_peroxide=0.0, chlorine_dioxide=0.0,
                  combined_zone=None, rand=None, generator=None):
    """One chlorine reading: base pipeline + principle-specific overlay.

    ``ozone``/``hydrogen_peroxide``/``chlorine_dioxide`` are optional zone
    concentrations [mg/L]. ``combined_zone`` [mg/L as Cl2]: a
    ``measurement_type="total"`` sensor responds to free + combined; a
    "free" sensor ignores it. No ported state carries a combined species
    yet, so the plant passes None."""
    cv = carry.base.current_value
    prev_ts = carry.base.last_timestamp
    had_prev = carry.base.has_history

    true_value = chlorine_true_value(B._as(chlorine_zone, cv),
                                     B._as(pH_zone, cv))
    if params.measurement_type == "total" and combined_zone is not None:
        true_value = true_value + B._as(combined_zone, cv)
    normals, uniforms = B.read_rand(rand, generator, carry.base,
                                    extra_normals=2)
    base_carry, out = B.base_read(
        params.base, carry.base, true_value, t,
        rand=(normals[..., :B.BASE_NORMALS],
              uniforms[..., :B.BASE_UNIFORMS]))
    finite = torch.isfinite(out.value)
    n1 = normals[..., B.BASE_NORMALS]
    n2 = normals[..., B.BASE_NORMALS + 1]

    dt = torch.clamp(out.timestamp - prev_ts, min=0.0)
    update = had_prev & finite

    fouling, age = carry.membrane_fouling, carry.membrane_age_days
    potency, reagent_age = carry.reagent_potency, carry.reagent_age_days
    light = carry.light_exposure_hours
    if params.sensor_type == AMPEROMETRIC:
        interference = (B._as(ozone, cv) * params.ozone_sensitivity
                        + B._as(hydrogen_peroxide, cv)
                        * params.h2o2_sensitivity
                        + B._as(chlorine_dioxide, cv)
                        * params.clo2_sensitivity)
        # membrane fouling update
        fouling_rate = torch.where(params.base.flow_velocity < 0.1,
                                   B._as(0.05, cv), B._as(0.01, cv))
        fouling = torch.where(
            update,
            torch.clamp(carry.membrane_fouling
                        + ieee_div(fouling_rate * dt, 86400.0), max=1.0),
            carry.membrane_fouling)
        age = torch.where(update,
                          carry.membrane_age_days + ieee_div(dt, 86400.0),
                          carry.membrane_age_days)
        # amperometric effects
        fouling_factor = 1.0 - 0.8 * fouling
        polarization_noise = n1 * 0.005 * (1.0 + ieee_div(age, 365.0))
        diffusion_noise = n2 * 0.003
        final = (out.value + interference) * fouling_factor \
            + polarization_noise + diffusion_noise
    else:
        # reagent degradation
        t_storage_k = carry.storage_temperature + 273.15
        thermal = torch.exp((50000.0 / 8.314)
                            * (1.0 / 293.15 - 1.0 / t_storage_k))
        light = torch.where(update,
                            carry.light_exposure_hours
                            + ieee_div(dt, 3600.0),
                            carry.light_exposure_hours)
        photo = 1.0 + 0.1 * ieee_div(light, 100.0)
        degradation = thermal * photo * 0.01
        potency = torch.where(
            update,
            torch.clamp(carry.reagent_potency
                        - ieee_div(degradation * dt, 86400.0), min=0.0),
            carry.reagent_potency)
        reagent_age = torch.where(
            update, carry.reagent_age_days + ieee_div(dt, 86400.0),
            carry.reagent_age_days)
        # DPD effects
        optical_noise = n1 * 0.005
        final = out.value * potency * 0.95 + optical_noise

    final = torch.clamp(final, min=params.base.min_value,
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
    new_carry = ChlorineSensorCarry(
        base=base_carry, membrane_fouling=fouling, membrane_age_days=age,
        electrode_polarization=carry.electrode_polarization,
        reagent_potency=potency, reagent_age_days=reagent_age,
        light_exposure_hours=light,
        storage_temperature=carry.storage_temperature)
    return new_carry, output


def replace_membrane(carry: ChlorineSensorCarry, t):
    """Membrane replacement; the caller must recalibrate."""
    z = torch.zeros_like(carry.membrane_fouling)
    base = replace(carry.base, power_on_time=B._as(t, z) + z)
    return replace(carry, base=base, membrane_fouling=z,
                   membrane_age_days=z, electrode_polarization=z)


def replace_reagent(carry: ChlorineSensorCarry, t, storage_temp=20.0):
    """Reagent replacement."""
    z = torch.zeros_like(carry.reagent_potency)
    return replace(carry, reagent_potency=torch.ones_like(z),
                   reagent_age_days=z, light_exposure_hours=z,
                   storage_temperature=torch.full_like(z, storage_temp))
