"""
Base sensor pipeline as a pure transform on batched tensors (port of
``ics_wt_physicsengine_tpu/sensors/base.py``).

``base_read(params, carry, true_value, t) -> (carry', SensorOutput)`` is the
reference simulator's 14-step stateful ``BaseSensor.read``:

- every mutable member (current value, drift clock, supply voltage, delay
  ring) lives in one ``SensorCarry``; every leaf carries the leading batch
  axes of the plants it belongs to, and the delay ring is
  ``[..., capacity]``, so one call reads a whole batch;
- the early returns (power fault, warm-up) are ``where`` selections over
  both the output and the carry updates;
- the sample line is a fixed-capacity ring with a nearest-timestamp argmin
  lookup, exact for any dt;
- random open/short faults at 1e-4 per read are draws the caller supplies
  (``rand=``) or that come from a ``torch.Generator``.

Randomness is explicit: the carry holds no generator state. Draws happen
unconditionally and are masked in.

Kept from the JAX package on purpose: hysteresis is configured but never
applied (dead code in the reference simulator), every sensor owns its own
ring, and a NaN value latches through the first-order lag.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, numpy_dtype,
                                               resolve_device,
                                               tensor_from_numpy)
from ics_wt_physicsengine_torch.sensors.types import (
    FAULT_CODE,
    STATUS_CODE,
    InstallationQuality,
    SensorFault,
    SensorStatus,
)
from ics_wt_physicsengine_torch.utils.dispatch import ieee_div

_F = {f: FAULT_CODE[f] for f in SensorFault}
_S = {s: STATUS_CODE[s] for s in SensorStatus}

RESPONSE_ALPHA = 0.5          # first-order lag
RANDOM_FAULT_PROB = 1e-4      # open/short per read
VOLTAGE_NOMINAL = 24.0        # [VDC]
VOLTAGE_LO, VOLTAGE_HI = 20.0, 28.0


@dataclass(frozen=True)
class SensorParams:
    """Per-sensor configuration: 0-d tensors for one plant, ``[B]`` for a
    batch. ``line_capacity`` is a Python int (0 = no sample line)."""

    line_capacity: int

    min_value: torch.Tensor = None
    max_value: torch.Tensor = None
    precision: torch.Tensor = None
    response_time: torch.Tensor = None
    drift_rate: torch.Tensor = None            # [units/hour]
    warmup_time_s: torch.Tensor = None
    hysteresis_magnitude: torch.Tensor = None  # retained; never applied
    max_rate_of_change: torch.Tensor = None    # inf = unchecked

    # installation
    flow_velocity: torch.Tensor = None
    air_bubble_frequency: torch.Tensor = None
    grounding_quality: torch.Tensor = None
    pipe_vibration_g: torch.Tensor = None
    ambient_temperature: torch.Tensor = None

    # sample line: only the transport delay enters the pipeline
    line_delay_s: torch.Tensor = None


@dataclass
class SensorCarry:
    """All mutable sensor state."""

    current_value: torch.Tensor
    supply_voltage: torch.Tensor
    power_on_time: torch.Tensor
    calibration_offset: torch.Tensor
    last_calibration_time: torch.Tensor
    calibration_validity_hours: torch.Tensor
    has_calibration: torch.Tensor     # bool
    status: torch.Tensor              # int32 code
    fault: torch.Tensor               # int32 code
    last_value: torch.Tensor          # previous reading value (post-overlay)
    last_timestamp: torch.Tensor
    has_history: torch.Tensor         # bool

    # sample-line ring ([..., capacity]; size-1 dummies without a line)
    line_values: torch.Tensor = None
    line_times: torch.Tensor = None
    line_count: torch.Tensor = None   # int32
    line_ptr: torch.Tensor = None     # int32


@dataclass
class SensorOutput:
    """One reading (``SensorReading``'s fields with coded enums)."""

    timestamp: torch.Tensor
    value: torch.Tensor
    raw_value: torch.Tensor
    noise: torch.Tensor
    drift: torch.Tensor
    status: torch.Tensor       # int32
    uncertainty: torch.Tensor
    fault: torch.Tensor        # int32


def make_sensor_params(measurement_range: Tuple[float, float],
                       precision: float,
                       response_time: float = 15.0,
                       drift_rate: float = 0.0,
                       warmup_time_s: float = 1800.0,
                       hysteresis_magnitude: float = 0.0,
                       max_rate_of_change: Optional[float] = None,
                       installation=None,
                       sample_line=None,
                       dtype=DEFAULT_DTYPE, device=None) -> SensorParams:
    installation = installation or InstallationQuality()
    installation.validate()
    dev = resolve_device(device)

    def arr(x):
        return tensor_from_numpy(x, dtype, dev)

    return SensorParams(
        line_capacity=(sample_line.buffer_capacity if sample_line else 0),
        min_value=arr(measurement_range[0]),
        max_value=arr(measurement_range[1]),
        precision=arr(precision),
        response_time=arr(response_time),
        drift_rate=arr(drift_rate),
        warmup_time_s=arr(warmup_time_s),
        hysteresis_magnitude=arr(hysteresis_magnitude),
        max_rate_of_change=arr(max_rate_of_change
                               if max_rate_of_change is not None
                               else math.inf),
        flow_velocity=arr(installation.flow_velocity),
        air_bubble_frequency=arr(installation.air_bubble_frequency),
        grounding_quality=arr(installation.grounding_quality),
        pipe_vibration_g=arr(installation.pipe_vibration_g),
        ambient_temperature=arr(installation.ambient_temperature),
        line_delay_s=arr(sample_line.transport_delay_s if sample_line
                         else 0.0),
    )


def make_sensor_carry(params: SensorParams, t0=0.0,
                      initial_value: Optional[float] = None,
                      dtype=DEFAULT_DTYPE, device=None) -> SensorCarry:
    """Fresh carry of a single sensor (``BaseSensor.__init__`` state)."""
    dev = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    cap = max(1, params.line_capacity)
    if initial_value is None:
        initial_value = float(params.min_value.cpu().numpy()
                              + params.max_value.cpu().numpy()) / 2.0

    def arr(x):
        return tensor_from_numpy(x, dtype, dev)

    def other(x, torch_dtype):
        return torch.as_tensor(x, dtype=torch_dtype, device=dev)

    return SensorCarry(
        current_value=arr(initial_value),
        supply_voltage=arr(VOLTAGE_NOMINAL),
        power_on_time=arr(t0),
        calibration_offset=arr(0.0),
        last_calibration_time=arr(t0),
        calibration_validity_hours=arr(24.0),
        has_calibration=other(False, torch.bool),
        status=other(_S[SensorStatus.NORMAL], torch.int32),
        fault=other(_F[SensorFault.NONE], torch.int32),
        last_value=arr(np.nan),
        last_timestamp=arr(-1.0),
        has_history=other(False, torch.bool),
        line_values=arr(np.zeros(cap, np_dtype)),
        line_times=arr(np.full(cap, -np.inf, np_dtype)),
        line_count=other(0, torch.int32),
        line_ptr=other(0, torch.int32),
    )


def _ring_append_and_lookup(params: SensorParams, carry: SensorCarry,
                            value, t, do_append):
    """Append (t, value) to the delay ring (masked) and fetch the sample
    nearest to ``t - delay``. ``torch.argmin`` returns the first minimum,
    so ties resolve by ring slot order, as in the JAX package."""
    cap = max(1, params.line_capacity)
    idx = torch.arange(cap, device=value.device)

    append_mask = do_append[..., None] & (idx == carry.line_ptr[..., None])
    line_values = torch.where(append_mask, value[..., None],
                              carry.line_values)
    line_times = torch.where(append_mask, t[..., None], carry.line_times)
    line_ptr = torch.where(do_append, (carry.line_ptr + 1) % cap,
                           carry.line_ptr)
    line_count = torch.where(do_append,
                             torch.clamp(carry.line_count + 1, max=cap),
                             carry.line_count)

    target = t - params.line_delay_s
    valid = idx < line_count[..., None]
    diffs = torch.where(valid, (line_times - target[..., None]).abs(),
                        math.inf)
    best = torch.argmin(diffs, dim=-1)
    picked = torch.gather(line_values, -1, best[..., None])[..., 0]
    delayed_value = torch.where(line_count > 0, picked, value)

    new_carry = replace(carry, line_values=line_values,
                        line_times=line_times, line_ptr=line_ptr,
                        line_count=line_count)
    return new_carry, delayed_value


# Randomness layout of one base read.
BASE_NORMALS = 5     # supply voltage, noise, stagnation, grounding, vibration
BASE_UNIFORMS = 3    # air bubble, random-fault roll, fault-type pick


def draw_read_rand(generator, shape, dtype, device, extra_normals: int = 0,
                   extra_uniforms: int = 0):
    """``(normals, uniforms)`` for one read of ``shape`` plants: base layout
    first, then the overlay's ``extra_*`` values. ``generator`` is a
    ``torch.Generator`` on ``device`` (``None``: the global one)."""
    shape = tuple(shape)
    normals = torch.randn(shape + (BASE_NORMALS + extra_normals,),
                          generator=generator, dtype=dtype, device=device)
    uniforms = torch.rand(shape + (BASE_UNIFORMS + extra_uniforms,),
                          generator=generator, dtype=dtype, device=device)
    return normals, uniforms


def read_rand(rand, generator, carry: SensorCarry, extra_normals: int = 0,
              extra_uniforms: int = 0):
    """The caller's pre-drawn ``rand`` or fresh draws for ``carry``'s
    plants."""
    if rand is not None:
        return rand
    cv = carry.current_value
    return draw_read_rand(generator, cv.shape, cv.dtype, cv.device,
                          extra_normals, extra_uniforms)


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def base_read(params: SensorParams, carry: SensorCarry, true_value, t,
              rand=None, generator=None):
    """One reading through the full base pipeline.

    Returns ``(carry', SensorOutput)``. ``true_value`` is the physical value
    the sensor-specific overlay extracted. ``rand``: optional
    ``(normals[..., 5], uniforms[..., 3])`` pre-drawn by the caller; when
    None the read draws from ``generator``.
    """
    cv = carry.current_value
    t = _as(t, cv)
    true_value = _as(true_value, cv)
    nan = math.nan

    normals, uniforms = read_rand(rand, generator, carry)
    n_volt, n_noise, n_stag, n_gnd, n_vib = (
        normals[..., i] for i in range(BASE_NORMALS))
    u_bub, u_fault_roll, u_fault_type = (
        uniforms[..., i] for i in range(BASE_UNIFORMS))

    # --- pre-existing power fault (early return #1) ---
    v0 = carry.supply_voltage
    power_bad = ~((VOLTAGE_LO < v0) & (v0 < VOLTAGE_HI))
    power_fault_code = torch.where(v0 <= VOLTAGE_LO,
                                   _F[SensorFault.POWER_LOW],
                                   _F[SensorFault.POWER_HIGH])

    # voltage fluctuation for the next read, skipped on the fault path
    new_voltage = VOLTAGE_NOMINAL + n_volt
    supply_voltage = torch.where(power_bad, v0, new_voltage)

    # --- warm-up gate (early return #2) ---
    warming = (t - carry.power_on_time) < params.warmup_time_s

    normal_path = ~power_bad & ~warming

    # --- calibration expiry ---
    cal_age_h = ieee_div(t - carry.last_calibration_time, 3600.0)
    cal_expired = ~carry.has_calibration | \
        (cal_age_h > carry.calibration_validity_hours)

    # --- sample line ---
    if params.line_capacity > 0:
        carry, delayed = _ring_append_and_lookup(
            params, carry, true_value + torch.zeros_like(cv),
            t + torch.zeros_like(cv), normal_path)
        raw_value = delayed
    else:
        raw_value = true_value

    # --- drift + noise + lag ---
    drift = params.drift_rate * cal_age_h + carry.calibration_offset
    noise = n_noise * params.precision
    lagged = RESPONSE_ALPHA * (raw_value + noise + drift) \
        + (1.0 - RESPONSE_ALPHA) * cv

    # (hysteresis is never applied: see the module docstring)

    # --- installation effects ---
    value = lagged
    value = value + torch.where(
        params.flow_velocity < 0.1,
        n_stag * params.precision * 2.0, 0.0)
    bubble = (params.air_bubble_frequency > 0) & (
        u_bub < ieee_div(params.air_bubble_frequency, 60.0))
    value = value + torch.where(
        params.grounding_quality < 0.8,
        n_gnd * params.precision * (2.0 - params.grounding_quality), 0.0)
    value = value + torch.where(
        params.pipe_vibration_g > 0.2,
        n_vib * params.pipe_vibration_g * params.precision, 0.0)
    value = torch.where(bubble, nan, value)

    # --- rate of change ---
    dt_hist = t - carry.last_timestamp
    rate = torch.where(
        carry.has_history & (dt_hist > 0) & torch.isfinite(carry.last_value),
        (value - carry.last_value) / torch.clamp(dt_hist, min=1e-30), 0.0)

    # --- fault lattice ---
    span = params.max_value - params.min_value
    post_power_bad = ~((VOLTAGE_LO < supply_voltage)
                       & (supply_voltage < VOLTAGE_HI))
    post_power_code = torch.where(
        supply_voltage <= VOLTAGE_LO, _F[SensorFault.POWER_LOW],
        _F[SensorFault.POWER_HIGH])
    out_of_range = (value < params.min_value - 0.1 * span) | \
        (value > params.max_value + 0.1 * span)
    rate_fault = rate.abs() > params.max_rate_of_change
    random_fault = u_fault_roll < RANDOM_FAULT_PROB
    random_code = torch.where(u_fault_type < 0.5,
                              _F[SensorFault.OPEN_CIRCUIT],
                              _F[SensorFault.SHORT_CIRCUIT])

    none_code = _F[SensorFault.NONE]
    fault = torch.where(
        post_power_bad, post_power_code,
        torch.where(out_of_range, _F[SensorFault.OUT_OF_RANGE],
                    torch.where(rate_fault, _F[SensorFault.RATE_FAULT],
                                torch.where(random_fault, random_code,
                                            none_code))))

    is_open_short = (fault == _F[SensorFault.OPEN_CIRCUIT]) | \
        (fault == _F[SensorFault.SHORT_CIRCUIT])
    has_fault = fault != none_code

    # --- status resolution + saturation ---
    # torch.clamp, like jnp.clip, lets a NaN value through
    bounded = torch.clamp(value, min=params.min_value, max=params.max_value)
    saturated = ~torch.isnan(value) & (bounded != value)
    drift_warn = drift.abs() > 0.1 * span

    status_fault = torch.where(
        is_open_short, _S[SensorStatus.FAILED],
        torch.where(fault == _F[SensorFault.OUT_OF_RANGE],
                    _S[SensorStatus.OUT_OF_RANGE],
                    torch.where((fault == _F[SensorFault.POWER_LOW])
                                | (fault == _F[SensorFault.POWER_HIGH]),
                                _S[SensorStatus.POWER_FAULT],
                                _S[SensorStatus.RATE_OF_CHANGE_FAULT])))

    prior_status = torch.where(cal_expired,
                               _S[SensorStatus.CALIBRATION_EXPIRED],
                               carry.status)
    status_ok = torch.where(
        torch.isnan(value), prior_status,
        torch.where(saturated, _S[SensorStatus.SATURATED],
                    torch.where(cal_expired,
                                _S[SensorStatus.CALIBRATION_EXPIRED],
                                _S[SensorStatus.NORMAL])))
    status_ok = torch.where(
        drift_warn & (status_ok != _S[SensorStatus.CALIBRATION_EXPIRED]),
        _S[SensorStatus.DRIFT_WARNING], status_ok)

    status_norm = torch.where(has_fault, status_fault, status_ok)
    value_norm = torch.where(is_open_short, nan,
                             torch.where(has_fault, value, bounded))

    # --- merge the three paths ---
    early = power_bad | warming
    out_value = torch.where(early, nan, value_norm)
    out_raw = torch.where(early, nan, raw_value)
    out_noise = torch.where(early, 0.0, noise)
    out_drift = torch.where(early, 0.0, drift)
    out_status = torch.where(
        power_bad, _S[SensorStatus.POWER_FAULT],
        torch.where(warming, _S[SensorStatus.WARMING_UP],
                    status_norm)).to(torch.int32)
    out_fault = torch.where(
        power_bad, power_fault_code,
        torch.where(warming, none_code, fault)).to(torch.int32)
    out_uncert = torch.where(early, 0.0, params.precision * 2.0)

    output = SensorOutput(
        timestamp=t + torch.zeros_like(out_value), value=out_value,
        raw_value=out_raw, noise=out_noise, drift=out_drift,
        status=out_status, uncertainty=out_uncert, fault=out_fault)

    # --- carry updates (the early-return paths freeze most fields) ---
    new_current = torch.where(normal_path, value_norm, cv)
    new_status = torch.where(normal_path, status_norm, carry.status) \
        .to(torch.int32)
    new_fault = torch.where(normal_path, out_fault, carry.fault) \
        .to(torch.int32)

    new_carry = replace(
        carry,
        current_value=new_current,
        supply_voltage=supply_voltage,
        status=new_status,
        fault=new_fault,
        last_value=out_value,
        last_timestamp=output.timestamp,
        has_history=torch.ones_like(normal_path),
    )
    return new_carry, output


def inject_power_fault(carry, kind: str = "power_low"):
    """Scripted fault injection: force the carried supply voltage outside
    the [20, 28] VDC window so the next read takes the power-fault path
    (NaN reading, POWER_FAULT status) and latches, like a real supply
    failure. Works on single and batched carries. Undo with
    ``clear_power_fault``."""
    if kind not in ("power_low", "power_high"):
        raise ValueError(f"unknown fault kind: {kind!r} "
                         "(power_low | power_high)")
    v = VOLTAGE_LO - 2.0 if kind == "power_low" else VOLTAGE_HI + 2.0
    return replace(carry,
                   supply_voltage=torch.full_like(carry.supply_voltage, v))


def clear_power_fault(carry):
    """Restore the nominal supply voltage and clear the fault and status
    codes: the repair that ends a power fault."""
    return replace(
        carry,
        supply_voltage=torch.full_like(carry.supply_voltage,
                                       VOLTAGE_NOMINAL),
        fault=torch.full_like(carry.fault, _F[SensorFault.NONE]),
        status=torch.full_like(carry.status, _S[SensorStatus.NORMAL]))


def calibrate(carry: SensorCarry, reference_value, t,
              validity_hours: float = 24.0):
    """Calibration as a pure carry transform. Returns ``(carry', offset)``."""
    cv = carry.current_value
    offset = _as(reference_value, cv) - cv
    new_carry = replace(
        carry,
        calibration_offset=offset,
        last_calibration_time=_as(t, cv) + torch.zeros_like(cv),
        calibration_validity_hours=torch.full_like(cv, validity_hours),
        has_calibration=torch.ones_like(carry.has_calibration),
        status=torch.full_like(carry.status, _S[SensorStatus.NORMAL]),
        fault=torch.full_like(carry.fault, _F[SensorFault.NONE]),
        power_on_time=_as(t, cv) + torch.zeros_like(cv),  # warm-up restarts
    )
    return new_carry, offset
