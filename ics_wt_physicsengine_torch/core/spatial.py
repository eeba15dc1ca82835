"""
Spatial stratification (port of
``ics_wt_physicsengine_tpu/core/spatial.py``).

Branch-free elementwise math over zone/interface arrays: density from
temperature, Richardson numbers per interface, and mixing-suppression
factors as a select. Batched plant axes broadcast on the left of the zone
axis. Every function runs on torch tensors (the hot path) and on NumPy
values (host-side state construction and the ``SpatialModel`` class, which
computes in NumPy as the JAX package's does).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.utils.dispatch import absolute, clip


@dataclass
class StratificationParameters:
    """Stratification controls."""

    enable_thermal_stratification: bool = True
    enable_density_stratification: bool = True
    critical_richardson: float = 0.25
    mixing_suppression_factor: float = 0.5


def _namespace(x):
    return torch if isinstance(x, torch.Tensor) else np


def _trail(x, like):
    """Expand a per-plant scalar ([B] or ()) for broadcasting against a
    trailing interface/zone axis ([B, Z-1])."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)       # a Python float stays float64
        if isinstance(like, torch.Tensor):
            x = torch.from_numpy(x).to(like.device)
    return x[..., None] if x.ndim else x


def water_density(temperature, salinity_g_L=0.0):
    """rho(T, S): parabolic 4 C-anomaly fit for T <= 8 C, linear thermal
    expansion above, + 0.7 kg/m^3 per g/L TDS."""
    xp = _namespace(temperature)
    t = temperature if xp is torch else np.asarray(temperature)
    rho_cold = c.RHO_MAX_4C - c.DENSITY_ANOMALY_COEFF * (t - 4.0) ** 2
    rho_warm = c.WATER_DENSITY_20C * (
        1.0 - c.THERMAL_EXPANSION_COEFF * (t - 20.0)
    )
    rho = xp.where(t <= 8.0, rho_cold, rho_warm)
    return rho + c.SALINITY_DENSITY_COEFF * salinity_g_L


def richardson_number(densities, zone_height, velocity_scale):
    """Ri per interface: Ri_i = g * (rho[i+1]-rho[i]) * dz / (rho_avg * u^2)
    for interfaces i = 0..Z-2; ``velocity_scale <= 1e-6`` maps to +inf (the
    no-flow branch)."""
    xp = _namespace(densities)
    drho = densities[..., 1:] - densities[..., :-1]
    rho_avg = 0.5 * (densities[..., 1:] + densities[..., :-1])
    u = _trail(velocity_scale, densities)
    dz = _trail(zone_height, densities)
    safe_u2 = (clip(u, 1e-6) if xp is torch
               else np.maximum(u, 1e-6)) ** 2
    ri = c.G_GRAVITY * drho * dz / (rho_avg * safe_u2)
    return xp.where(u > 1e-6, ri, xp.inf)


def mixing_suppression(densities, zone_height, velocity_scale,
                       critical_richardson=0.25,
                       suppression_factor=0.5,
                       enabled=True):
    """Per-interface suppression factors: ``suppression_factor`` where the
    interface is stably stratified (Ri > Ri_crit), else 1.0. ``enabled``
    may be a 0/1 or boolean array (per plant) or a Python bool."""
    ri = richardson_number(densities, zone_height, velocity_scale)
    stratified = ri > _trail(critical_richardson, densities)
    factor = _trail(suppression_factor, densities)
    enabled = _trail(enabled, densities)
    if isinstance(densities, torch.Tensor):
        supp = torch.where(stratified, factor.to(ri.dtype), 1.0)
        return torch.where(enabled.to(torch.bool), supp,
                           torch.ones_like(supp))
    supp = np.where(stratified, factor.astype(ri.dtype), 1.0)
    return np.where(enabled.astype(bool), supp, np.ones_like(supp))


def brunt_vaisala_squared(densities, zone_height):
    """N^2 per interface = -(g / rho_avg) * drho/dz."""
    drho_dz = (densities[..., 1:] - densities[..., :-1]) \
        / _trail(zone_height, densities)
    rho_avg = 0.5 * (densities[..., 1:] + densities[..., :-1])
    return -(c.G_GRAVITY / rho_avg) * drho_dz


def jet_penetration(inlet_velocity, inlet_diameter, tank_height):
    """z_jet = min(6.2 * d * Fr, H)."""
    if any(isinstance(x, torch.Tensor)
           for x in (inlet_velocity, inlet_diameter)):
        like = inlet_velocity if isinstance(inlet_velocity, torch.Tensor) \
            else inlet_diameter
        fr = inlet_velocity / torch.sqrt(torch.as_tensor(
            c.G_GRAVITY * inlet_diameter, dtype=like.dtype,
            device=like.device))
        return clip(c.JET_PENETRATION_COEFF * inlet_diameter * fr,
                    hi=tank_height)
    fr = inlet_velocity / np.sqrt(np.asarray(c.G_GRAVITY * inlet_diameter))
    return np.minimum(c.JET_PENETRATION_COEFF * inlet_diameter * fr,
                      tank_height)


def spatial_gradients(parameter, zone_height) -> Dict[str, object]:
    """Gradient statistics of a zone profile."""
    if isinstance(parameter, torch.Tensor):
        p = parameter
        grads = absolute((p[..., 1:] - p[..., :-1]) / zone_height)
        stats = dict(mean=p.mean(dim=-1), std=p.std(dim=-1, unbiased=False),
                     max=p.amax(dim=-1), min=p.amin(dim=-1),
                     gmax=grads.amax(dim=-1), gmean=grads.mean(dim=-1),
                     gloc=grads.argmax(dim=-1))
    else:
        p = np.asarray(parameter)
        grads = np.abs((p[..., 1:] - p[..., :-1]) / zone_height)
        stats = dict(mean=p.mean(axis=-1), std=p.std(axis=-1),
                     max=p.max(axis=-1), min=p.min(axis=-1),
                     gmax=grads.max(axis=-1), gmean=grads.mean(axis=-1),
                     gloc=grads.argmax(axis=-1))
    return {
        "mean_value": stats["mean"],
        "std_value": stats["std"],
        "max_value": stats["max"],
        "min_value": stats["min"],
        "range": stats["max"] - stats["min"],
        "max_gradient": stats["gmax"],
        "mean_gradient": stats["gmean"],
        "gradient_location": stats["gloc"],
    }


def interpolate_to_elevation(parameter, zone_centers, elevation):
    """Linear interpolation of a zone profile at an elevation, with linear
    extrapolation beyond the end zones."""
    if isinstance(parameter, torch.Tensor):
        p = parameter
        zc = torch.as_tensor(zone_centers, dtype=p.dtype, device=p.device)
        at = torch.as_tensor(elevation, dtype=p.dtype, device=p.device)
        n = zc.shape[-1]
        # clamp so extrapolation reuses the end segments
        idx = clip(torch.searchsorted(zc, at) - 1, 0, n - 2)
        elevation = at
    else:
        p, zc = np.asarray(parameter), np.asarray(zone_centers)
        n = zc.shape[-1]
        idx = np.clip(np.searchsorted(zc, elevation) - 1, 0, n - 2)
    x0, x1 = zc[idx], zc[idx + 1]
    y0, y1 = p[..., idx], p[..., idx + 1]
    w = (elevation - x0) / (x1 - x0)
    return y0 + w * (y1 - y0)


# ---------------------------------------------------------------------------
# Object API (host NumPy, as in the JAX package)
# ---------------------------------------------------------------------------


class SpatialModel:
    """The reference simulator's spatial class over the functions above."""

    G_GRAVITY = c.G_GRAVITY
    WATER_DENSITY_20C = c.WATER_DENSITY_20C
    THERMAL_EXPANSION_COEFF = c.THERMAL_EXPANSION_COEFF
    DENSITY_ANOMALY_COEFF = c.DENSITY_ANOMALY_COEFF
    SOLUTAL_EXPANSION = dict(c.SOLUTAL_EXPANSION)

    def __init__(self, n_zones: int, height: float,
                 stratification_params: Optional[
                     StratificationParameters] = None):
        if n_zones < 2:
            raise ValueError(f"Need at least 2 zones, got {n_zones}")
        self.n_zones = n_zones
        self.height = height
        self.zone_height = height / n_zones
        self.strat_params = stratification_params \
            or StratificationParameters()
        self.zone_centers = np.array(
            [(i + 0.5) * self.zone_height for i in range(n_zones)]
        )
        self.temperatures = np.zeros(n_zones)
        self.densities = np.zeros(n_zones)
        self.mixing_suppression = np.ones(n_zones - 1)

    def calculate_water_density(self, temperature,
                                salinity_g_L: float = 0.0):
        return float(water_density(temperature, salinity_g_L))

    def update_density_profile(self, temperatures,
                               concentrations: Optional[Dict] = None):
        temperatures = np.asarray(temperatures)
        if temperatures.shape[-1] != self.n_zones:
            raise ValueError(
                f"Expected {self.n_zones} temperatures, got "
                f"{temperatures.shape[-1]}"
            )
        self.temperatures = temperatures.copy()
        tds = np.zeros(self.n_zones)
        if concentrations:
            for species in concentrations:
                tds = tds + np.asarray(concentrations[species])
        self.densities = np.asarray(water_density(temperatures, tds))
        return self.densities

    def calculate_richardson_number(self, zone_idx: int,
                                    velocity_scale: float):
        if zone_idx < 0 or zone_idx >= self.n_zones - 1:
            raise ValueError(f"Invalid zone index for interface: {zone_idx}")
        ri = richardson_number(np.asarray(self.densities), self.zone_height,
                               velocity_scale)
        return float(ri[zone_idx])

    def is_stratification_stable(self, zone_idx: int, velocity_scale: float):
        return (self.calculate_richardson_number(zone_idx, velocity_scale)
                > self.strat_params.critical_richardson)

    def calculate_mixing_suppression(self, velocity_scale: float):
        supp = mixing_suppression(
            np.asarray(self.densities), self.zone_height, velocity_scale,
            critical_richardson=self.strat_params.critical_richardson,
            suppression_factor=self.strat_params.mixing_suppression_factor,
            enabled=self.strat_params.enable_thermal_stratification,
        )
        self.mixing_suppression = np.asarray(supp)
        return self.mixing_suppression

    def calculate_brunt_vaisala_frequency(self, zone_idx: int) -> float:
        if zone_idx < 0 or zone_idx >= self.n_zones - 1:
            return 0.0
        n_sq = brunt_vaisala_squared(np.asarray(self.densities),
                                     self.zone_height)
        return float(n_sq[zone_idx])

    def identify_thermocline(self) -> Optional[float]:
        if not self.strat_params.enable_thermal_stratification:
            return None
        grads = np.abs(np.diff(self.temperatures)) / self.zone_height
        idx = int(np.argmax(grads))
        if grads[idx] > 0.5:
            return self.height - self.zone_centers[idx]
        return None

    def calculate_inlet_jet_penetration(self, inlet_velocity: float,
                                        inlet_diameter: float,
                                        inlet_zone: int = 0) -> float:
        return float(jet_penetration(inlet_velocity, inlet_diameter,
                                     self.height))

    def estimate_dead_zones(self, velocity_field=None,
                            threshold_velocity: float = 0.001) -> List[int]:
        if velocity_field is None:
            return []
        return [i for i, v in enumerate(velocity_field)
                if v < threshold_velocity]

    def _profile(self, parameter) -> np.ndarray:
        parameter = np.asarray(parameter)
        if parameter.shape[-1] != self.n_zones:
            raise ValueError(
                f"Expected {self.n_zones} values, got {parameter.shape[-1]}"
            )
        return parameter

    def calculate_spatial_gradients(self, parameter,
                                    parameter_name: str = "parameter"):
        stats = spatial_gradients(self._profile(parameter), self.zone_height)
        return {key: (int(v) if key == "gradient_location" else float(v))
                for key, v in stats.items()}

    def interpolate_to_depth(self, parameter, depth_from_top: float) -> float:
        parameter = self._profile(parameter)
        if depth_from_top < 0 or depth_from_top > self.height:
            raise ValueError(
                f"Depth {depth_from_top}m outside tank [0, {self.height}]"
            )
        elevation = self.height - depth_from_top
        return float(interpolate_to_elevation(
            parameter, np.asarray(self.zone_centers), elevation))

    def print_spatial_diagnostics(self) -> None:
        print("Spatial Model Diagnostics")
        print("=" * 60)
        print(f"Number of zones: {self.n_zones}")
        print(f"Tank height: {self.height:.2f} m")
        print(f"Zone height: {self.zone_height:.3f} m")
        print("Temperature profile:")
        for i in range(self.n_zones):
            print(f"  zone {i}: z={self.zone_centers[i]:.3f} m, "
                  f"T={self.temperatures[i]:.2f} C, "
                  f"rho={self.densities[i]:.2f} kg/m3")
        thermocline = self.identify_thermocline()
        print(f"Thermocline: "
              f"{'%.2f m from top' % thermocline if thermocline else 'none'}")
        for i in range(self.n_zones - 1):
            n_sq = self.calculate_brunt_vaisala_frequency(i)
            print(f"  interface {i}-{i+1}: N2={n_sq:.6f} 1/s2, "
                  f"mixing factor={self.mixing_suppression[i]:.3f}")
        print("=" * 60)


def validate_spatial() -> None:
    """Oracle suite of the spatial class (host-side)."""
    spatial = SpatialModel(n_zones=5, height=2.0)

    rho_4 = spatial.calculate_water_density(4.0)
    assert abs(rho_4 - 999.97) < 0.5, \
        f"Density at 4C should be ~999.97, got {rho_4}"

    assert spatial.calculate_water_density(5.0) \
        > spatial.calculate_water_density(20.0)
    assert spatial.calculate_water_density(3.0) \
        < spatial.calculate_water_density(4.0)

    spatial.update_density_profile(np.array([25, 23, 21, 19, 17]))
    assert spatial.calculate_richardson_number(0, 0.01) > 0, \
        "Hot water on top should give positive Ri"

    spatial.update_density_profile(np.array([17, 19, 21, 23, 25]))
    assert spatial.calculate_richardson_number(0, 0.01) < 0, \
        "Cold water on top should give negative Ri"

    param = np.array([7.0, 7.1, 7.2, 7.1, 7.0])
    stats = spatial.calculate_spatial_gradients(param, "pH")
    assert abs(stats["mean_value"] - 7.08) < 0.01, "Mean calculation error"

    value_at_mid = spatial.interpolate_to_depth(param, 1.0)
    assert 7.0 - 1e-9 <= value_at_mid <= 7.2 + 1e-9, \
        "Interpolated value should be in range"

    print("All spatial validations passed")
