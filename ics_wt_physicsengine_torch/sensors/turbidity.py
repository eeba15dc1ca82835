"""
Turbidity sensor (nephelometer) as a pure transform, the instrument of the
particle dynamics (port of ``ics_wt_physicsengine_tpu/sensors/turbidity.py``).

- 90-degree nephelometry (ISO 7027): the true value is the class-weighted
  NTU from core/particles.py, which the caller computes from the state's
  tss classes; the instrument itself is size-blind.
- Optical-window fouling: a positive bias growing with immersion time;
  ``wipe_window`` resets it (the mechanical wiper).
- Stray-light floor: a fixed additive error near zero NTU.
- Bubble spikes: entrained air reads high (a positive spike), not NaN.
- Detector shot noise ~ sqrt(signal), plus 2% of the reading.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, resolve_device,
                                               tensor_from_numpy)
from ics_wt_physicsengine_torch.sensors import base as B
from ics_wt_physicsengine_torch.utils.dispatch import ieee_div


@dataclass(frozen=True)
class TurbiditySensorParams:
    zone_index: int
    base: B.SensorParams = None
    stray_light_ntu: torch.Tensor = None      # additive zero floor
    fouling_ntu_per_day: torch.Tensor = None  # window-fouling bias growth
    max_fouling_ntu: torch.Tensor = None
    bubble_spike_ntu: torch.Tensor = None     # magnitude of an air spike
    bubble_rate: torch.Tensor = None          # spikes per read


@dataclass
class TurbiditySensorCarry:
    base: B.SensorCarry
    window_fouling_ntu: torch.Tensor          # accumulated stray-light bias


def make_turbidity_params(zone_index=0, precision=None, response_time=None,
                          drift_rate=0.005 / 24.0,
                          stray_light_ntu=0.02,
                          fouling_ntu_per_day=0.05, max_fouling_ntu=5.0,
                          bubble_spike_ntu=10.0, bubble_rate=0.0,
                          sample_line=None, installation=None,
                          dtype=DEFAULT_DTYPE,
                          device=None) -> TurbiditySensorParams:
    dev = resolve_device(device)
    base = B.make_sensor_params(
        measurement_range=(0.0, 1000.0),
        precision=precision or 0.02,       # NTU (2% of reading added below)
        response_time=response_time or 15.0,
        drift_rate=drift_rate, warmup_time_s=30.0,
        hysteresis_magnitude=0.0, max_rate_of_change=100.0,
        installation=installation, sample_line=sample_line, dtype=dtype,
        device=dev)
    arr = lambda x: tensor_from_numpy(x, dtype, dev)  # noqa: E731
    if bubble_rate == 0.0 and installation is not None:
        bubble_rate = float(getattr(installation, "air_bubble_frequency",
                                    0.0))
    return TurbiditySensorParams(
        zone_index=zone_index, base=base,
        stray_light_ntu=arr(stray_light_ntu),
        fouling_ntu_per_day=arr(fouling_ntu_per_day),
        max_fouling_ntu=arr(max_fouling_ntu),
        bubble_spike_ntu=arr(bubble_spike_ntu),
        bubble_rate=arr(bubble_rate))


def make_turbidity_carry(params: TurbiditySensorParams, t0=0.0,
                         dtype=DEFAULT_DTYPE,
                         device=None) -> TurbiditySensorCarry:
    dev = resolve_device(device)
    base = B.make_sensor_carry(params.base, t0=t0, initial_value=1.0,
                               dtype=dtype, device=dev)
    return TurbiditySensorCarry(
        base=base, window_fouling_ntu=tensor_from_numpy(0.0, dtype, dev))


N_NORMALS = B.BASE_NORMALS + 1     # + shot noise
N_UNIFORMS = B.BASE_UNIFORMS + 1   # + bubble-spike draw


def turbidity_read(params: TurbiditySensorParams,
                   carry: TurbiditySensorCarry, true_ntu, t, rand=None,
                   generator=None):
    """One turbidity reading [NTU]: base pipeline + nephelometer overlay.
    ``true_ntu`` is the class-weighted turbidity at the sensor's zone
    (``core.particles.turbidity_ntu_tap``). ``rand``: optional pre-drawn
    ``(normals[..., N_NORMALS], uniforms[..., N_UNIFORMS])``; None draws
    from ``generator``. Returns ``(carry', SensorOutput)``."""
    cv = carry.base.current_value
    prev_ts = carry.base.last_timestamp
    had_prev = carry.base.has_history

    ntu = B._as(true_ntu, cv)

    normals, uniforms = B.read_rand(rand, generator, carry.base,
                                    extra_normals=1, extra_uniforms=1)
    base_carry, out = B.base_read(
        params.base, carry.base, ntu, t,
        rand=(normals[..., :B.BASE_NORMALS],
              uniforms[..., :B.BASE_UNIFORMS]))
    finite = torch.isfinite(out.value)
    n1 = normals[..., B.BASE_NORMALS]
    u1 = uniforms[..., B.BASE_UNIFORMS]

    dt = torch.clamp(out.timestamp - prev_ts, min=0.0)
    update = had_prev & finite
    fouling = torch.where(
        update,
        torch.minimum(carry.window_fouling_ntu
                      + ieee_div(params.fouling_ntu_per_day * dt, 86400.0),
                      params.max_fouling_ntu),
        carry.window_fouling_ntu)

    measured = out.value
    # positive biases: window fouling + stray-light floor
    measured = measured + fouling + params.stray_light_ntu
    # detector shot noise ~ sqrt(signal), plus 2% of reading
    measured = measured + n1 * (params.base.precision
                                * torch.sqrt(torch.clamp(measured, min=0.0))
                                + 0.02 * torch.clamp(measured, min=0.0))
    # entrained-air spike (positive, unlike the immersed probes' NaN)
    measured = measured + torch.where(u1 < params.bubble_rate,
                                      params.bubble_spike_ntu, 0.0)

    final = torch.clamp(measured, min=params.base.min_value,
                        max=params.base.max_value)
    value = torch.where(finite, final, out.value)

    output = B.SensorOutput(
        timestamp=out.timestamp, value=value, raw_value=out.raw_value,
        noise=out.noise, drift=out.drift, status=out.status,
        uncertainty=torch.where(finite,
                                params.base.precision * 2.0 + fouling,
                                out.uncertainty),
        fault=out.fault)

    base_carry = replace(
        base_carry,
        current_value=torch.where(finite, value, base_carry.current_value),
        last_value=value)
    return TurbiditySensorCarry(base=base_carry,
                                window_fouling_ntu=fouling), output


def wipe_window(carry: TurbiditySensorCarry) -> TurbiditySensorCarry:
    """Run the mechanical wiper: clears the window-fouling bias."""
    return replace(carry, window_fouling_ntu=torch.zeros_like(
        carry.window_fouling_ntu))


def validate_turbidity_sensor(verbose: bool = True, device=None) -> bool:
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

    def read_once(ntu, fouling=0.0, bubble=False):
        p = make_turbidity_params(bubble_rate=1.0 if bubble else 0.0,
                                  dtype=f64, device=dev)
        c = make_turbidity_carry(p, dtype=f64, device=dev)
        c = replace(c, base=replace(
            c.base, power_on_time=scalar(-4000.0),
            last_calibration_time=scalar(0.0),
            has_calibration=torch.ones_like(c.base.has_calibration),
            current_value=scalar(ntu)),
            window_fouling_ntu=scalar(fouling))
        n = torch.zeros((N_NORMALS,), dtype=f64, device=dev)
        u = torch.full((N_UNIFORMS,), 0.5, dtype=f64, device=dev)
        if bubble:
            u[-1] = 0.0      # force the spike draw
        _, out = turbidity_read(p, c, ntu, 10.0, rand=(n, u))
        return float(out.value)

    v = read_once(5.0)
    check("clean read = true + stray-light floor (0.02 NTU)",
          abs(v - 5.02) < 1e-3)
    check("stray light sets a nonzero floor at 0 NTU",
          read_once(0.0) >= 0.02 - 1e-9)
    check("window fouling reads high (+2 NTU)",
          abs(read_once(5.0, fouling=2.0) - 7.02) < 1e-3)
    check("air bubble spikes +10 NTU",
          abs(read_once(5.0, bubble=True) - 15.02) < 1e-3)

    p = make_turbidity_params(dtype=f64, device=dev)
    c = replace(make_turbidity_carry(p, dtype=f64, device=dev),
                window_fouling_ntu=scalar(3.0))
    check("wipe_window clears the fouling bias",
          float(wipe_window(c).window_fouling_ntu) == 0.0)

    ok = all(s for _, s in checks)
    if verbose:
        print(f"Turbidity sensor validation: "
              f"{'ALL PASS' if ok else 'FAILURES PRESENT'}")
    return ok
