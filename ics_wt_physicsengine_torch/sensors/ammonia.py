"""
Ammonia sensor (ion-selective electrode / gas-sensing membrane) as a pure
transform, the instrument of the nitrogen chemistry (port of
``ics_wt_physicsengine_tpu/sensors/ammonia.py``).

- ISE ("ise"): measures NH4+ activity, so it under-reads total ammonia as
  pH rises (relative to its pH-7 calibration); potassium interference adds
  k_sel [K+] (14/39.1) of apparent nitrogen; electrode noise grows with
  membrane age.
- Gas-sensing membrane ("gsm"): pH-independent (alkalized sample), but the
  conditioning reagent decays ~1%/day and scales the response.

Both: the membrane slope degrades with age (the reading is slope% of the
span from the zero point), and a Nernstian temperature-compensation
residual scales the reading per degree from the calibration temperature.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ics_wt_physicsengine_torch.core import nitrogen as NC
from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, resolve_device,
                                               tensor_from_numpy)
from ics_wt_physicsengine_torch.sensors import base as B
from ics_wt_physicsengine_torch.utils.dispatch import ieee_div

ISE = "ise"
GAS_MEMBRANE = "gsm"

MW_RATIO_N_K = 14.0067 / 39.0983     # apparent mg N per mg K+ interfering


@dataclass(frozen=True)
class AmmoniaSensorParams:
    zone_index: int
    sensor_type: str
    base: B.SensorParams = None
    selectivity_potassium: torch.Tensor = None   # k_sel (ISE)
    potassium_mgL: torch.Tensor = None           # background [K+]
    slope_drift_pct_per_day: torch.Tensor = None
    cal_pH: torch.Tensor = None                  # ISE calibration pH
    cal_temperature: torch.Tensor = None         # [C]
    temp_comp_residual: torch.Tensor = None      # fraction error per degC


@dataclass
class AmmoniaSensorCarry:
    base: B.SensorCarry
    membrane_age_days: torch.Tensor
    slope_percentage: torch.Tensor
    reagent_potency: torch.Tensor     # gas-membrane conditioning reagent


def make_ammonia_params(zone_index=0, sensor_type=ISE, precision=None,
                        response_time=None, drift_rate=0.02 / 24.0,
                        selectivity_potassium=0.1, potassium_mgL=2.0,
                        slope_drift_pct_per_day=0.05,
                        cal_pH=7.0, cal_temperature=25.0,
                        sample_line=None, installation=None,
                        dtype=DEFAULT_DTYPE,
                        device=None) -> AmmoniaSensorParams:
    dev = resolve_device(device)
    if sensor_type == ISE:
        default_precision, default_response, warmup = 0.05, 60.0, 600.0
    elif sensor_type == GAS_MEMBRANE:
        default_precision, default_response, warmup = 0.02, 120.0, 300.0
    else:
        raise ValueError(f"unknown ammonia sensor type {sensor_type!r}")
    base = B.make_sensor_params(
        measurement_range=(0.0, 100.0),
        precision=precision or default_precision,
        response_time=response_time or default_response,
        drift_rate=drift_rate, warmup_time_s=warmup,
        hysteresis_magnitude=0.02, max_rate_of_change=10.0,
        installation=installation, sample_line=sample_line, dtype=dtype,
        device=dev)
    arr = lambda x: tensor_from_numpy(x, dtype, dev)  # noqa: E731
    return AmmoniaSensorParams(
        zone_index=zone_index, sensor_type=sensor_type, base=base,
        selectivity_potassium=arr(selectivity_potassium),
        potassium_mgL=arr(potassium_mgL),
        slope_drift_pct_per_day=arr(slope_drift_pct_per_day),
        cal_pH=arr(cal_pH), cal_temperature=arr(cal_temperature),
        temp_comp_residual=arr(0.002))


def make_ammonia_carry(params: AmmoniaSensorParams, t0=0.0,
                       dtype=DEFAULT_DTYPE,
                       device=None) -> AmmoniaSensorCarry:
    dev = resolve_device(device)
    base = B.make_sensor_carry(params.base, t0=t0, initial_value=0.0,
                               dtype=dtype, device=dev)
    arr = lambda x: tensor_from_numpy(x, dtype, dev)  # noqa: E731
    return AmmoniaSensorCarry(base=base, membrane_age_days=arr(0.0),
                              slope_percentage=arr(100.0),
                              reagent_potency=arr(1.0))


N_NORMALS = B.BASE_NORMALS + 2     # + electrode noise, junction
N_UNIFORMS = B.BASE_UNIFORMS


def _nh4_fraction(pH, T_C):
    return 1.0 - NC.ammonia_fraction_nh3(pH, T_C)


def ammonia_read(params: AmmoniaSensorParams, carry: AmmoniaSensorCarry,
                 tan_zone, pH_zone, temperature_zone, t, rand=None,
                 generator=None):
    """One total-ammonia-nitrogen reading [mg N/L]: base pipeline +
    principle overlay. ``rand``: optional pre-drawn ``(normals[...,
    N_NORMALS], uniforms[..., N_UNIFORMS])``; None draws from
    ``generator``. Returns ``(carry', SensorOutput)``."""
    cv = carry.base.current_value
    prev_ts = carry.base.last_timestamp
    had_prev = carry.base.has_history

    tan = B._as(tan_zone, cv)
    pH = B._as(pH_zone, cv)
    T = B._as(temperature_zone, cv)

    normals, uniforms = B.read_rand(rand, generator, carry.base,
                                    extra_normals=2)
    base_carry, out = B.base_read(
        params.base, carry.base, tan, t,
        rand=(normals[..., :B.BASE_NORMALS],
              uniforms[..., :B.BASE_UNIFORMS]))
    finite = torch.isfinite(out.value)
    n1 = normals[..., B.BASE_NORMALS]
    n2 = normals[..., B.BASE_NORMALS + 1]

    dt = torch.clamp(out.timestamp - prev_ts, min=0.0)
    update = had_prev & finite
    age = torch.where(update,
                      carry.membrane_age_days + ieee_div(dt, 86400.0),
                      carry.membrane_age_days)
    slope = torch.where(
        update,
        torch.clamp(carry.slope_percentage
                    - ieee_div(params.slope_drift_pct_per_day * dt, 86400.0),
                    min=80.0),
        carry.slope_percentage)

    if params.sensor_type == ISE:
        # the electrode sees NH4+ activity relative to the calibration pH
        frac = _nh4_fraction(pH, T) / _nh4_fraction(params.cal_pH, T)
        measured = out.value * frac
        # potassium interference (apparent nitrogen)
        measured = measured + params.selectivity_potassium \
            * params.potassium_mgL * MW_RATIO_N_K
        # electrode noise grows with membrane age
        measured = measured + n1 * params.base.precision \
            * (1.0 + 0.05 * age)
        reagent = carry.reagent_potency
    else:
        # alkalized gas membrane: pH-free, scaled by a decaying reagent
        reagent = torch.where(
            update,
            torch.clamp(carry.reagent_potency
                        - ieee_div(0.01 * dt, 86400.0), min=0.5),
            carry.reagent_potency)
        measured = out.value * reagent + n1 * params.base.precision
    # junction / electronics noise
    measured = measured + n2 * params.base.precision * 0.5

    # an aged membrane under-responds: slope% of the span from zero
    measured = measured * ieee_div(slope, 100.0)
    # Nernstian temperature-compensation residual
    measured = measured * (1.0 + params.temp_comp_residual
                           * (T - params.cal_temperature))

    final = torch.clamp(measured, min=params.base.min_value,
                        max=params.base.max_value)
    value = torch.where(finite, final, out.value)

    output = B.SensorOutput(
        timestamp=out.timestamp, value=value, raw_value=out.raw_value,
        noise=out.noise, drift=out.drift, status=out.status,
        uncertainty=torch.where(finite, params.base.precision * 2.0
                                * (1.0 + 0.1 * age), out.uncertainty),
        fault=out.fault)

    base_carry = replace(
        base_carry,
        current_value=torch.where(finite, value, base_carry.current_value),
        last_value=value)
    return AmmoniaSensorCarry(base=base_carry, membrane_age_days=age,
                              slope_percentage=slope,
                              reagent_potency=reagent), output


def validate_ammonia_sensor(verbose: bool = True, device=None) -> bool:
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

    def read_once(sensor_type, tan, pH, T, k_sel=0.0):
        p = make_ammonia_params(sensor_type=sensor_type,
                                selectivity_potassium=k_sel, dtype=f64,
                                device=dev)
        c = make_ammonia_carry(p, dtype=f64, device=dev)
        c = replace(c, base=replace(
            c.base, power_on_time=scalar(-4000.0),
            last_calibration_time=scalar(0.0),
            has_calibration=torch.ones_like(c.base.has_calibration),
            current_value=scalar(tan)))   # lag-converged
        n = torch.zeros((N_NORMALS,), dtype=f64, device=dev)
        u = torch.full((N_UNIFORMS,), 0.5, dtype=f64, device=dev)
        _, out = ammonia_read(p, c, tan, pH, T, 10.0, rand=(n, u))
        return float(out.value)

    v = read_once(ISE, 2.0, 7.0, 25.0)
    check("ISE reads TAN at cal point (pH 7, 25C)", abs(v - 2.0) < 1e-4)

    # at pH = pKa (9.245 @ 25C) only the NH4+ half is visible
    v = read_once(ISE, 2.0, 9.245, 25.0)
    expect = 2.0 * 0.5 / float(_nh4_fraction(scalar(7.0), scalar(25.0)))
    check("ISE under-reads at pH = pKa (NH4+ fraction)",
          abs(v - expect) < 0.01)

    v0 = read_once(ISE, 2.0, 7.0, 25.0, k_sel=0.0)
    v1 = read_once(ISE, 2.0, 7.0, 25.0, k_sel=0.1)
    check("K+ interference adds k_sel*[K]*(14/39.1)",
          abs((v1 - v0) - 0.1 * 2.0 * MW_RATIO_N_K) < 1e-6)

    va = read_once(GAS_MEMBRANE, 2.0, 7.0, 25.0)
    vb = read_once(GAS_MEMBRANE, 2.0, 9.5, 25.0)
    check("gas-membrane reading is pH-independent", abs(va - vb) < 1e-9)
    check("gas-membrane reads TAN with fresh reagent", abs(va - 2.0) < 0.01)

    ok = all(s for _, s in checks)
    if verbose:
        print(f"Ammonia sensor validation: "
              f"{'ALL PASS' if ok else 'FAILURES PRESENT'}")
    return ok
