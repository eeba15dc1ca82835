"""
Glass-electrode pH sensor as a pure transform (port of
``ics_wt_physicsengine_tpu/sensors/ph.py``).

- Nernst temperature compensation in the true value
- non-linear biofilm/scaling fouling state
- five pH-specific noise/offset overlays on top of the base pipeline:
  impedance noise growing with |pH-7|, junction noise scaled by
  reference-electrode contamination, slope degradation outside the
  calibration window, fouling offset/noise, contamination offset
- kept quirk: the overlay value becomes the carry's ``last_value``, so the
  next read's rate-of-change check sees post-overlay values one step late.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, resolve_device,
                                               tensor_from_numpy)
from ics_wt_physicsengine_torch.sensors import base as B
from ics_wt_physicsengine_torch.utils.dispatch import ieee_div


@dataclass(frozen=True)
class PHSensorParams:
    zone_index: int
    base: B.SensorParams = None
    temperature_coefficient: torch.Tensor = None   # [pH/C]


@dataclass
class PHSensorCarry:
    base: B.SensorCarry
    membrane_fouling: torch.Tensor        # 0-1
    glass_etching: torch.Tensor           # permanent damage
    days_since_cleaning: torch.Tensor
    water_hardness: torch.Tensor          # [mg/L CaCO3]
    reference_contamination: torch.Tensor  # 0-1
    slope_percentage: torch.Tensor        # % of Nernst slope
    cal_point_1: torch.Tensor             # buffer pH
    cal_point_2: torch.Tensor


def make_ph_params(zone_index=0, precision=0.01, response_time=15.0,
                   drift_rate=0.01 / 24.0, temperature_coefficient=0.003,
                   sample_line=None, installation=None,
                   dtype=DEFAULT_DTYPE, device=None) -> PHSensorParams:
    base = B.make_sensor_params(
        measurement_range=(0.0, 14.0), precision=precision,
        response_time=response_time, drift_rate=drift_rate,
        warmup_time_s=1800.0, hysteresis_magnitude=0.02,
        max_rate_of_change=0.5, installation=installation,
        sample_line=sample_line, dtype=dtype, device=device)
    return PHSensorParams(
        zone_index=zone_index, base=base,
        temperature_coefficient=tensor_from_numpy(
            temperature_coefficient, dtype, resolve_device(device)))


def make_ph_carry(params: PHSensorParams, t0=0.0, dtype=DEFAULT_DTYPE,
                  device=None) -> PHSensorCarry:
    dev = resolve_device(device)
    base = B.make_sensor_carry(params.base, t0=t0, initial_value=7.0,
                               dtype=dtype, device=dev)
    arr = lambda x: tensor_from_numpy(x, dtype, dev)  # noqa: E731
    return PHSensorCarry(
        base=base, membrane_fouling=arr(0.0), glass_etching=arr(0.0),
        days_since_cleaning=arr(0.0), water_hardness=arr(100.0),
        reference_contamination=arr(0.0), slope_percentage=arr(100.0),
        cal_point_1=arr(4.0), cal_point_2=arr(7.0))


N_NORMALS = B.BASE_NORMALS + 3     # + electrical, junction, fouling noise
N_UNIFORMS = B.BASE_UNIFORMS


def nernst_compensated_ph(params: PHSensorParams, reactor_pH_zone,
                          reactor_T_zone):
    """The electrode's pre-line 'true' sample: Nernst temperature
    compensation around the 25 C calibration point. Shared by ``ph_read``
    and the fused plant's sample-line histories, so the two cannot drift
    apart."""
    return reactor_pH_zone + params.temperature_coefficient * (
        reactor_T_zone - 25.0)


def ph_read(params: PHSensorParams, carry: PHSensorCarry,
            reactor_pH_zone, reactor_T_zone, t, rand=None,
            delayed_true=None, generator=None):
    """One pH reading: base pipeline + glass-electrode overlay.

    ``reactor_pH_zone`` / ``reactor_T_zone`` are the already-selected zone
    values. ``rand``: optional pre-drawn ``(normals[..., N_NORMALS],
    uniforms[..., N_UNIFORMS])`` (base layout first); None draws from
    ``generator``. ``delayed_true``: optional already-delayed
    Nernst-compensated sample: the fused plant resolves the sample line
    outside (params with ``line_capacity=0``) and passes the delayed value
    here.
    """
    cv = carry.base.current_value
    prev_ts = carry.base.last_timestamp
    had_prev = carry.base.has_history
    reactor_pH_zone = B._as(reactor_pH_zone, cv)
    temp = B._as(reactor_T_zone, cv)

    true_value = nernst_compensated_ph(params, reactor_pH_zone, temp)
    if delayed_true is not None:
        true_value = B._as(delayed_true, cv)

    normals, uniforms = B.read_rand(rand, generator, carry.base,
                                    extra_normals=3)
    base_carry, out = B.base_read(
        params.base, carry.base, true_value, t,
        rand=(normals[..., :B.BASE_NORMALS],
              uniforms[..., :B.BASE_UNIFORMS]))
    finite = torch.isfinite(out.value)
    n_elec = normals[..., B.BASE_NORMALS]
    n_junc = normals[..., B.BASE_NORMALS + 1]
    n_foul = normals[..., B.BASE_NORMALS + 2]

    # --- fouling state update, gated like the reference simulator ---
    dt = torch.clamp(out.timestamp - prev_ts, min=0.0)
    update = had_prev & finite
    bio_rate = torch.where(carry.membrane_fouling > 0.05,
                           0.1 * torch.exp(0.05 * (temp - 25.0)), 0.001)
    scaling_rate = torch.where(params.base.flow_velocity < 0.1,
                               carry.water_hardness * 1e-4,
                               carry.water_hardness * 1e-5)
    fouling = torch.where(
        update,
        torch.clamp(carry.membrane_fouling
                    + ieee_div((bio_rate + scaling_rate) * dt, 86400.0),
                    max=1.0),
        carry.membrane_fouling)
    days_clean = torch.where(update,
                             carry.days_since_cleaning
                             + ieee_div(dt, 86400.0),
                             carry.days_since_cleaning)

    # --- pH-specific overlay terms, gated on finite ---
    ph_dev = (out.value - 7.0).abs()
    electrical = n_elec * 0.002 * (1.0 + 0.1 * ph_dev)
    junction = n_junc * 0.005 * (1.0 + carry.reference_contamination)

    days_since_cal = torch.where(
        base_carry.has_calibration,
        ieee_div(out.timestamp - base_carry.last_calibration_time, 86400.0),
        0.0)
    slope_pct = torch.where(
        base_carry.has_calibration & finite,
        torch.clamp(100.0 - 0.001 * days_since_cal, min=90.0),
        carry.slope_percentage)

    in_cal_window = (carry.cal_point_1 < out.value) \
        & (out.value < carry.cal_point_2)
    distance = torch.minimum((out.value - carry.cal_point_1).abs(),
                             (out.value - carry.cal_point_2).abs())
    slope_error = torch.where(
        in_cal_window, 0.0,
        ieee_div(distance * (100.0 - slope_pct), 100.0))

    fouling_offset = fouling * 0.2
    fouling_noise = n_foul * (fouling * 0.05)

    contamination = torch.where(
        finite,
        torch.clamp(carry.reference_contamination
                    + 0.0001 * ieee_div(days_since_cal, 30.0), max=0.5),
        carry.reference_contamination)
    reference_offset = contamination * 0.1

    final_value = torch.clamp(
        out.value + electrical + junction + slope_error + fouling_offset
        + fouling_noise + reference_offset,
        min=params.base.min_value, max=params.base.max_value)

    value = torch.where(finite, final_value, out.value)
    noise = torch.where(finite,
                        out.noise + electrical + junction + fouling_noise,
                        out.noise)
    drift = torch.where(finite,
                        out.drift + slope_error + fouling_offset
                        + reference_offset,
                        out.drift)
    uncert = torch.where(finite, params.base.precision * 3.0,
                         out.uncertainty)

    output = B.SensorOutput(
        timestamp=out.timestamp, value=value, raw_value=out.raw_value,
        noise=noise, drift=drift, status=out.status, uncertainty=uncert,
        fault=out.fault)

    base_carry = replace(
        base_carry,
        current_value=torch.where(finite, value, base_carry.current_value),
        last_value=value,      # the overlay value replaces the history tail
    )
    new_carry = PHSensorCarry(
        base=base_carry, membrane_fouling=fouling,
        glass_etching=carry.glass_etching, days_since_cleaning=days_clean,
        water_hardness=carry.water_hardness,
        reference_contamination=contamination,
        slope_percentage=slope_pct, cal_point_1=carry.cal_point_1,
        cal_point_2=carry.cal_point_2)
    return new_carry, output


def clean_electrode(carry: PHSensorCarry, cleaning_method: str, t):
    """Electrode cleaning."""
    if cleaning_method == "water_rinse":
        fouling = carry.membrane_fouling * 0.5
        etching = carry.glass_etching
        slope = carry.slope_percentage
    elif cleaning_method == "acid_clean":
        fouling = carry.membrane_fouling * 0.1
        etching = carry.glass_etching + 0.001
        slope = carry.slope_percentage - etching * 10.0
    elif cleaning_method == "pepsin_clean":
        fouling = carry.membrane_fouling * 0.2
        etching = carry.glass_etching
        slope = carry.slope_percentage
    else:
        raise ValueError(f"Unknown cleaning method: {cleaning_method}")
    mf = carry.membrane_fouling
    base = replace(carry.base,
                   power_on_time=B._as(t, mf) + torch.zeros_like(mf))
    return replace(carry, base=base, membrane_fouling=fouling,
                   glass_etching=etching, slope_percentage=slope,
                   days_since_cleaning=torch.zeros_like(mf))
