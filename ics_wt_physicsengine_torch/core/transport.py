"""
Transport phenomena (port of ``ics_wt_physicsengine_tpu/core/transport.py``
:41-197).

The inter-zone exchange operator is represented by its ``n_zones - 1``
interface coefficients and applied as a shift/add stencil
(``apply_exchange``), vectorized over batched plants on the leading axes.
``transport_coefficients`` is host-side NumPy, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.core import thermodynamics as thermo
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
