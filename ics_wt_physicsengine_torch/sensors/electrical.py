"""
Electrical-environment model: EMI, cable capacitance, ground loops (port of
``ics_wt_physicsengine_tpu/sensors/electrical.py``).

These effects live on the analog transmission path between the transmitter
and the DAQ, so the model is a post-transform on any sensor's reading value
(NaN fault paths propagate unchanged):

    ecarry, out_value = electrical_transform(ep, ecarry, out.value, t)

- **Mains EMI pickup**: additive ``A sin(2 pi f t + phi)`` hum plus
  Poisson-gated impulse bursts: per-read burst probability
  ``rate dt / 3600``, amplitude ``burst_amplitude x N(0, 1)``.
- **Cable capacitance**: an RC low-pass with the source impedance
  (tau = R_src C_per_m length), one first-order pole with the exact discrete
  update ``y' = y + (1 - e^(-dt/tau)) (x - y)``.
- **Ground loop**: an Ornstein-Uhlenbeck potential walk plus mains hum, both
  scaled by ``1 - grounding_quality``.

All parameters default to "effect off", so attaching the stage with defaults
leaves the signal bit for bit. Randomness is explicit, as everywhere in the
port: the carry holds no generator state; a transform takes pre-drawn
``rand=`` or draws from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, resolve_device,
                                               tensor_from_numpy)

ELECTRICAL_NORMALS = 2    # burst amplitude, ground-walk innovation
ELECTRICAL_UNIFORMS = 1   # burst gate


@dataclass(frozen=True)
class ElectricalParams:
    """Static electrical-environment configuration (per sensor; a leading
    axis batches over plants)."""

    # mains EMI pickup
    mains_frequency_hz: torch.Tensor = None      # 50.0 or 60.0
    emi_pickup_amplitude: torch.Tensor = None    # [reading units] 0 = off
    emi_phase_rad: torch.Tensor = None           # per-installation phase
    emi_burst_rate_per_hour: torch.Tensor = None  # Poisson rate, 0 = off
    emi_burst_amplitude: torch.Tensor = None     # [reading units]

    # cable RC low-pass
    cable_length_m: torch.Tensor = None
    cable_capacitance_pf_per_m: torch.Tensor = None   # ~100 pF/m typical
    source_impedance_ohm: torch.Tensor = None    # glass pH ~1e8, RTD ~1e2

    # ground loop
    grounding_quality: torch.Tensor = None       # 1.0 = perfect, 0 = floating
    ground_loop_amplitude: torch.Tensor = None   # [reading units] at q=0
    ground_walk_tau_s: torch.Tensor = None       # OU relaxation time
    ground_walk_sigma: torch.Tensor = None       # OU innovation scale


@dataclass
class ElectricalCarry:
    """Mutable electrical state."""

    cable_filtered: torch.Tensor     # RC pole state
    cable_initialized: torch.Tensor  # bool: the pole seeds on first sample
    ground_potential: torch.Tensor   # OU state (dimensionless)
    last_t: torch.Tensor


def make_electrical_params(mains_frequency_hz=50.0,
                           emi_pickup_amplitude=0.0,
                           emi_phase_rad=0.0,
                           emi_burst_rate_per_hour=0.0,
                           emi_burst_amplitude=0.0,
                           cable_length_m=0.0,
                           cable_capacitance_pf_per_m=100.0,
                           source_impedance_ohm=0.0,
                           grounding_quality=1.0,
                           ground_loop_amplitude=0.0,
                           ground_walk_tau_s=60.0,
                           ground_walk_sigma=1.0,
                           dtype=DEFAULT_DTYPE,
                           device=None) -> ElectricalParams:
    dev = resolve_device(device)

    def arr(x):
        return tensor_from_numpy(x, dtype, dev)

    return ElectricalParams(
        mains_frequency_hz=arr(mains_frequency_hz),
        emi_pickup_amplitude=arr(emi_pickup_amplitude),
        emi_phase_rad=arr(emi_phase_rad),
        emi_burst_rate_per_hour=arr(emi_burst_rate_per_hour),
        emi_burst_amplitude=arr(emi_burst_amplitude),
        cable_length_m=arr(cable_length_m),
        cable_capacitance_pf_per_m=arr(cable_capacitance_pf_per_m),
        source_impedance_ohm=arr(source_impedance_ohm),
        grounding_quality=arr(grounding_quality),
        ground_loop_amplitude=arr(ground_loop_amplitude),
        ground_walk_tau_s=arr(ground_walk_tau_s),
        ground_walk_sigma=arr(ground_walk_sigma))


def make_electrical_carry(params: ElectricalParams,
                          t0=0.0) -> ElectricalCarry:
    """A fresh carry in the parameters' shape, dtype and device."""
    zero = torch.zeros_like(params.grounding_quality)
    return ElectricalCarry(
        cable_filtered=zero,
        cable_initialized=torch.zeros_like(zero, dtype=torch.bool),
        ground_potential=zero,
        last_t=torch.full_like(zero, t0))


def cable_time_constant(params: ElectricalParams):
    """tau = R_source x C_cable x length (pF/m -> F)."""
    c_total = (params.cable_capacitance_pf_per_m * 1e-12
               * params.cable_length_m)
    return params.source_impedance_ohm * c_total


def electrical_transform(params: ElectricalParams, carry: ElectricalCarry,
                         value, t, rand=None, generator=None):
    """Corrupt one transmitted sample; returns ``(carry', value')``.

    ``rand``: optional ``(normals[..., 2], uniforms[..., 1])`` pre-drawn by
    the caller; when None the transform draws from ``generator`` (a
    ``torch.Generator`` on the carry's device; ``None``: the global one).
    """
    like = carry.cable_filtered
    t = torch.as_tensor(t, dtype=like.dtype, device=like.device)
    value = torch.as_tensor(value, dtype=like.dtype, device=like.device)

    if rand is None:
        normals = torch.randn(like.shape + (ELECTRICAL_NORMALS,),
                              generator=generator, dtype=like.dtype,
                              device=like.device)
        uniforms = torch.rand(like.shape + (ELECTRICAL_UNIFORMS,),
                              generator=generator, dtype=like.dtype,
                              device=like.device)
    else:
        normals, uniforms = rand
    n_burst, n_walk = normals[..., 0], normals[..., 1]
    u_burst = uniforms[..., 0]

    dt = torch.clamp(t - carry.last_t, min=0.0)

    # --- cable RC low-pass (exact zero-order-hold discretization) ---
    tau = cable_time_constant(params)
    alpha = 1.0 - torch.exp(-dt / torch.clamp(tau, min=1e-30))
    seeded = torch.where(carry.cable_initialized, carry.cable_filtered,
                         value)
    # tau = 0 (no cable modeled) passes the sample through bit for bit:
    # seeded + 1 * (value - seeded) would round
    filtered = torch.where(tau > 0.0, seeded + alpha * (value - seeded),
                           value)
    # a NaN sample (sensor fault path) goes out as NaN but freezes the pole
    # state, so recovery does not replay the fault
    good = torch.isfinite(value)
    new_filtered = torch.where(good, filtered, carry.cable_filtered)
    new_initialized = carry.cable_initialized | good
    out = torch.where(good, filtered, value)

    # --- mains EMI pickup + impulse bursts ---
    omega_t = 2.0 * math.pi * params.mains_frequency_hz * t
    hum = params.emi_pickup_amplitude * torch.sin(omega_t
                                                  + params.emi_phase_rad)
    p_burst = torch.clamp(params.emi_burst_rate_per_hour * dt / 3600.0,
                          min=0.0, max=1.0)
    burst = torch.where(u_burst < p_burst,
                        params.emi_burst_amplitude * n_burst,
                        torch.zeros_like(n_burst))

    # --- ground loop: OU potential walk + mains hum, scaled by (1 - q) ---
    tau_g = torch.clamp(params.ground_walk_tau_s, min=1e-30)
    decay = torch.exp(-dt / tau_g)
    g = carry.ground_potential * decay \
        + params.ground_walk_sigma * torch.sqrt(
            torch.clamp(dt, min=0.0)) * n_walk
    badness = torch.clamp(1.0 - params.grounding_quality, min=0.0, max=1.0)
    ground = params.ground_loop_amplitude * badness * (
        g + torch.sin(omega_t))

    out = out + hum + burst + ground

    new_carry = replace(carry, cable_filtered=new_filtered,
                        cable_initialized=new_initialized,
                        ground_potential=g, last_t=t + torch.zeros_like(g))
    return new_carry, out
