"""
Transport phenomena (port of
``ics_wt_physicsengine_tpu/core/transport.py``).

The inter-zone exchange operator is represented by its ``n_zones - 1``
interface coefficients and applied as a shift/add stencil
(``apply_exchange``), vectorized over batched plants on the leading axes.
``transport_coefficients`` is host-side NumPy, as in the JAX package.
``exchange_matrix`` materializes the dense operator for diagnostics and
invariant checks, and ``TransportModel`` is the reference simulator's class
over these functions (host-side; its tracer curves are tensors).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.core import thermodynamics as thermo
from ics_wt_physicsengine_torch.device import resolve_device
from ics_wt_physicsengine_torch.utils.dispatch import align_trailing


@dataclass
class GeometryParameters:
    """Tank geometry."""

    volume: float            # [L]
    height: float            # [m]
    diameter: float          # [m]
    n_zones: int = 5

    def validate(self) -> None:
        calculated_volume = (
            math.pi * (self.diameter / 2.0) ** 2 * self.height * 1000.0
        )
        volume_error = abs(calculated_volume - self.volume) / self.volume
        if volume_error > 0.1:
            raise ValueError(
                f"Volume inconsistency: specified {self.volume}L, "
                f"calculated {calculated_volume:.1f}L from geometry"
            )
        if self.n_zones < 2:
            raise ValueError(f"Need at least 2 zones, got {self.n_zones}")

    @property
    def zone_height(self) -> float:
        return self.height / self.n_zones

    @property
    def zone_volume(self) -> float:
        return self.volume / self.n_zones

    @property
    def cross_sectional_area(self) -> float:
        return math.pi * (self.diameter / 2.0) ** 2


@dataclass
class FlowParameters:
    """Flow characteristics."""

    flow_rate: float                    # [L/min]
    turbulent_intensity: float = 0.15
    recirculation_ratio: float = 5.0
    impeller_speed: float = 60.0        # [rpm]
    impeller_diameter: float = 0.3      # [m]
    power_number: float = 5.0

    def validate(self) -> None:
        if self.flow_rate < 0:
            raise ValueError(f"Flow rate cannot be negative: {self.flow_rate}")
        if not 0 <= self.turbulent_intensity <= 1:
            raise ValueError(
                "Turbulent intensity must be in [0,1]: "
                f"{self.turbulent_intensity}"
            )
        if self.recirculation_ratio < 0:
            raise ValueError(
                "Recirculation ratio cannot be negative: "
                f"{self.recirculation_ratio}"
            )
        if self.impeller_speed < 0:
            raise ValueError(
                f"Impeller speed cannot be negative: {self.impeller_speed}"
            )
        if self.impeller_diameter <= 0:
            raise ValueError(
                f"Impeller diameter must be positive: {self.impeller_diameter}"
            )


def transport_coefficients(geometry: GeometryParameters, flow: FlowParameters,
                           temperature: float = 20.0) -> dict:
    """Derive all transport scalars from geometry + flow (host-side: Python
    floats, or ``[B]`` NumPy arrays for a batch of configurations)."""
    q_m3_s = flow.flow_rate / 60000.0
    superficial_velocity = q_m3_s / geometry.cross_sectional_area

    n_rps = flow.impeller_speed / 60.0
    d_imp = flow.impeller_diameter
    impeller_tip_speed = math.pi * d_imp * n_rps

    re = n_rps * d_imp ** 2 / c.WATER_KINEMATIC_VISCOSITY

    d_turbulent = c.D_TURB_COEFF * n_rps * d_imp ** 2
    d_molecular = np.asarray(thermo.diffusion_coefficient(temperature))
    d_effective = d_turbulent + d_molecular

    mixing_time_s = (
        c.C_MIXING * (geometry.height / d_imp)
        / (n_rps * flow.power_number ** (1.0 / 3.0))
    )

    pe = geometry.height * superficial_velocity / d_effective

    # Interface exchange rate [1/s]: K = D_eff * A / dz / V_zone
    k_exchange = (
        d_effective * geometry.cross_sectional_area / geometry.zone_height
    ) / (geometry.zone_volume / 1000.0)

    if np.ndim(flow.flow_rate) == 0:
        residence_time = (
            geometry.volume / flow.flow_rate if flow.flow_rate > 0 else None
        )
    else:  # batched configs: inf marks batch mode instead of None
        q = np.asarray(flow.flow_rate)
        residence_time = np.where(q > 0, np.asarray(geometry.volume)
                                  / np.where(q > 0, q, 1.0), np.inf)

    return {
        "residence_time": residence_time,               # [min] or None (batch)
        "superficial_velocity": superficial_velocity,   # [m/s]
        "impeller_tip_speed": impeller_tip_speed,       # [m/s]
        "Re": re,
        "D_turbulent": d_turbulent,
        "D_molecular": d_molecular,
        "D_effective": d_effective,
        "mixing_time_seconds": mixing_time_s,
        "Pe": pe,
        "k_exchange": k_exchange,                        # [1/s]
        "q_per_v": (flow.flow_rate / 60.0) / geometry.volume,  # [1/s]
    }


def apply_exchange(x, k_iface, q_per_v):
    """Apply the conservative inter-zone exchange operator to ``x``:

        (L x)[i] = k_iface[i]   * (x[i+1] - x[i])     (i < n-1)
                 + k_iface[i-1] * (x[i-1] - x[i])     (i > 0)
        (L x)[n-1] -= q_per_v * x[n-1]

    Shapes: ``x[..., Z]``, ``k_iface[..., Z-1]``, ``q_per_v[...]``.
    """
    up_flux = k_iface * (x[..., 1:] - x[..., :-1])       # flux into i from i+1
    zeros = torch.zeros_like(x[..., :1])
    out = (
        torch.cat([up_flux, zeros], dim=-1)               # from zone above
        - torch.cat([zeros, up_flux], dim=-1)             # from zone below
    )
    outlet = align_trailing(q_per_v, x) * x[..., -1:]
    return out - torch.cat([torch.zeros_like(x[..., :-1]), outlet], dim=-1)


def exchange_matrix(n_zones: int, k_exchange: float, q_per_v: float,
                    suppression=None) -> np.ndarray:
    """The dense exchange matrix, for tests and diagnostics. Row sums are
    exactly zero except the outlet row (= -q_per_v)."""
    k_iface = np.full(n_zones - 1, k_exchange, dtype=np.float64)
    if suppression is not None:
        k_iface = k_iface * np.asarray(suppression, dtype=np.float64)
    K = np.zeros((n_zones, n_zones))
    for i in range(n_zones - 1):
        K[i, i + 1] = k_iface[i]
        K[i + 1, i] = k_iface[i]
    for i in range(n_zones):
        K[i, i] = -(K[i].sum() - K[i, i])
    K[n_zones - 1, n_zones - 1] -= q_per_v
    return K


def mixing_quality(concentrations):
    """(CV, segregation index) over the zone axis; tensors in, tensors out,
    anything else is computed in NumPy."""
    if isinstance(concentrations, torch.Tensor):
        x, xp = concentrations, torch
        mean, std = x.mean(dim=-1), x.std(dim=-1, unbiased=False)
    else:
        x, xp = np.asarray(concentrations), np
        mean, std = x.mean(axis=-1), x.std(axis=-1)
    zero, one = xp.zeros_like(mean), xp.ones_like(mean)
    cv = xp.where(mean > 0, std / xp.where(mean > 0, mean, one), zero)
    var = std * std
    var_seg = mean * mean
    s = xp.where(var_seg > 0,
                 xp.clip(var / xp.where(var_seg > 0, var_seg, one), 0.0, 1.0),
                 zero)
    return cv, s


def _time_tensor(time_points) -> torch.Tensor:
    if isinstance(time_points, torch.Tensor):
        return time_points
    return torch.from_numpy(np.asarray(time_points, dtype=np.float64))


def tracer_response_pulse(time_points, tau_s, n_tanks: int):
    """Tanks-in-series E(t) for a pulse input (a tensor on the device of
    ``time_points``; NumPy values are taken as float64 on the CPU)."""
    t = _time_tensor(time_points)
    log_fact = math.lgamma(n_tanks)  # log((n-1)!)
    valid = t > 0
    safe_t = torch.where(valid, t, torch.ones_like(t))
    log_e = (
        n_tanks * math.log(n_tanks / tau_s)
        + (n_tanks - 1) * torch.log(safe_t)
        - log_fact
        - n_tanks * safe_t / tau_s
    )
    return torch.where(valid, torch.exp(log_e), torch.zeros_like(t))


def tracer_response_step(time_points, tau_s, n_tanks: int):
    """Tanks-in-series F(t) for a step input: F(t) = P(n, n t / tau), the
    regularized lower incomplete gamma function."""
    t = _time_tensor(time_points)
    return torch.special.gammainc(torch.full_like(t, float(n_tanks)),
                                  n_tanks * t / tau_s)


class TransportModel:
    """The reference simulator's transport class over the functions above.
    As in the JAX package, ``dispersion_number`` and ``print_diagnostics``
    use ``superficial_velocity``, and ``tracer_response`` raises a clear
    error in batch mode."""

    WATER_VISCOSITY = c.WATER_KINEMATIC_VISCOSITY
    C_MIXING = c.C_MIXING

    def __init__(self, geometry: GeometryParameters, flow: FlowParameters,
                 temperature: float = 20.0):
        geometry.validate()
        flow.validate()
        self.geometry = geometry
        self.flow = flow
        self.temperature = temperature
        self.is_batch_mode = flow.flow_rate == 0.0
        self.thermo = thermo.TemperatureDependentKinetics()

        coeffs = transport_coefficients(geometry, flow, temperature)
        self.residence_time = coeffs["residence_time"]
        self.superficial_velocity = coeffs["superficial_velocity"]
        self.impeller_tip_speed = coeffs["impeller_tip_speed"]
        self.Re = coeffs["Re"]
        self.D_turbulent = coeffs["D_turbulent"]
        self.D_molecular = coeffs["D_molecular"]
        self.D_effective = coeffs["D_effective"]
        self.mixing_time_seconds = coeffs["mixing_time_seconds"]
        self.mixing_time = coeffs["mixing_time_seconds"] / 60.0
        self.Pe = coeffs["Pe"]
        self.k_exchange = coeffs["k_exchange"]
        self.q_per_v = coeffs["q_per_v"]

        self.K_matrix = self._build_exchange_matrix()

    def _build_exchange_matrix(self) -> np.ndarray:
        K = exchange_matrix(self.geometry.n_zones, self.k_exchange,
                            self.q_per_v)
        # conservation audit
        row_sums = K.sum(axis=1)
        for i in range(self.geometry.n_zones - 1):
            if abs(row_sums[i]) > 1e-12:
                raise ValueError(
                    f"Mass conservation violated in zone {i}: "
                    f"row sum = {row_sums[i]:.2e} (should be < 1e-12)"
                )
        if abs(row_sums[-1] + self.q_per_v) > 1e-12:
            raise ValueError(
                f"Outlet mass balance wrong: got {row_sums[-1]:.2e}, "
                f"expected {-self.q_per_v:.2e}"
            )
        return K

    def calculate_mixing_quality(self, concentrations):
        cv, s = mixing_quality(concentrations)
        return float(cv), float(s)

    def tracer_response(self, time_points, tracer_input_mode: str = "pulse"):
        if self.residence_time is None:
            raise ValueError(
                "Tracer response undefined in batch mode (flow_rate = 0)"
            )
        tau_s = self.residence_time * 60.0
        n = self.geometry.n_zones
        if tracer_input_mode == "pulse":
            return tracer_response_pulse(time_points, tau_s, n)
        if tracer_input_mode == "step":
            return tracer_response_step(time_points, tau_s, n)
        raise ValueError(f"Unknown tracer input mode: {tracer_input_mode}")

    def dispersion_number(self) -> float:
        if self.superficial_velocity <= 0:
            return float("inf")
        return self.D_effective / (self.superficial_velocity
                                   * self.geometry.height)

    def tanks_in_series_equivalent(self) -> float:
        d_over_ul = self.dispersion_number()
        return 1.0 / (2.0 * d_over_ul) if d_over_ul > 0 else float("inf")

    def print_diagnostics(self) -> None:
        regime = ("Turbulent" if self.Re > 4000
                  else "Transitional" if self.Re > 2000 else "Laminar")
        print("Transport Model Diagnostics")
        print("=" * 60)
        print(f"Reynolds number: {self.Re:.0f} ({regime})")
        rt = (f"{self.residence_time:.1f} min"
              if self.residence_time is not None else "n/a (batch mode)")
        print(f"Residence time: {rt}")
        print(f"Mixing time (95%): {self.mixing_time_seconds:.1f} s")
        print(f"Superficial velocity: {self.superficial_velocity:.4f} m/s")
        print(f"Molecular diffusivity: {self.D_molecular:.2e} m2/s")
        print(f"Turbulent diffusivity: {self.D_turbulent:.2e} m2/s")
        print(f"Effective diffusivity: {self.D_effective:.2e} m2/s")
        print(f"Peclet number: {self.Pe:.1f}")
        print(f"Dispersion number: {self.dispersion_number():.4f}")
        print("Tanks-in-series equivalent: "
              f"{self.tanks_in_series_equivalent():.1f}")
        print("=" * 60)


def validate_transport(device=None) -> None:
    """Structural-invariant suite. The stencil operator runs in float64 on
    ``device`` (``None``: the CUDA card) against the dense matrix."""
    dev = resolve_device(device)
    volume_l = 1000
    height_m = 2.0
    diameter = 2 * math.sqrt((volume_l / 1000) / (math.pi * height_m))

    geom = GeometryParameters(volume=volume_l, height=height_m,
                              diameter=diameter, n_zones=5)
    flow = FlowParameters(flow_rate=5.0, impeller_speed=60.0,
                          impeller_diameter=0.3)
    transport = TransportModel(geom, flow, temperature=20.0)

    geom.validate()

    K = transport.K_matrix
    eigenvalues = np.linalg.eigvals(K)
    assert np.all(eigenvalues.real <= 1e-10), \
        "Exchange matrix should be negative semi-definite"

    row_sums = K.sum(axis=1)
    for i in range(geom.n_zones - 1):
        assert abs(row_sums[i]) < 1e-12, f"Conservation violated in zone {i}"
    q_per_v = (flow.flow_rate / 60.0) / geom.volume
    assert abs(row_sums[-1] + q_per_v) < 1e-12, "Outlet mass balance wrong"

    x = np.linspace(1.0, 2.0, geom.n_zones)
    dense = K @ x
    stencil = apply_exchange(
        torch.from_numpy(x).to(dev),
        torch.full((geom.n_zones - 1,), float(transport.k_exchange),
                   dtype=torch.float64, device=dev),
        torch.tensor(q_per_v, dtype=torch.float64, device=dev)).cpu().numpy()
    assert np.allclose(dense, stencil, rtol=0, atol=1e-12), \
        f"Stencil != dense matrix: {dense} vs {stencil}"

    cv, s = transport.calculate_mixing_quality(np.ones(5) * 2.0)
    assert cv < 1e-10 and s < 1e-10, \
        "Uniform concentration should have CV ~ 0"

    assert transport.Re > 1000, f"Re = {transport.Re} should be turbulent"
    assert 30 < transport.mixing_time_seconds < 300, \
        f"Mixing time {transport.mixing_time_seconds:.1f}s outside [30, 300]s"

    print("All transport validations passed")
