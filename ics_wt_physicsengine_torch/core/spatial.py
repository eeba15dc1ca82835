"""
Spatial stratification (port of ``ics_wt_physicsengine_tpu/core/spatial.py``
:48-110).

Branch-free elementwise math over zone/interface tensors: density from
temperature, Richardson numbers per interface, and mixing-suppression
factors as a select. Batched plant axes broadcast on the left of the zone
axis. ``water_density`` also runs on NumPy values for host-side state
construction.
"""

from __future__ import annotations

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import constants as c


def _trail(x, like):
    """Expand a per-plant scalar ([B] or ()) for broadcasting against a
    trailing interface/zone axis ([B, Z-1])."""
    x = torch.as_tensor(x, device=like.device)
    return x[..., None] if x.ndim else x


def water_density(temperature, salinity_g_L=0.0):
    """rho(T, S): parabolic 4 C-anomaly fit for T <= 8 C, linear thermal
    expansion above, + 0.7 kg/m^3 per g/L TDS."""
    xp = torch if isinstance(temperature, torch.Tensor) else np
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
    drho = densities[..., 1:] - densities[..., :-1]
    rho_avg = 0.5 * (densities[..., 1:] + densities[..., :-1])
    u = _trail(velocity_scale, densities)
    dz = _trail(zone_height, densities)
    safe_u2 = torch.clamp(u, min=1e-6) ** 2
    ri = c.G_GRAVITY * drho * dz / (rho_avg * safe_u2)
    return torch.where(u > 1e-6, ri, torch.inf)


def mixing_suppression(densities, zone_height, velocity_scale,
                       critical_richardson=0.25,
                       suppression_factor=0.5,
                       enabled=True):
    """Per-interface suppression factors: ``suppression_factor`` where the
    interface is stably stratified (Ri > Ri_crit), else 1.0. ``enabled``
    may be a 0/1 or boolean tensor (per plant) or a Python bool."""
    ri = richardson_number(densities, zone_height, velocity_scale)
    stratified = ri > _trail(critical_richardson, densities)
    supp = torch.where(
        stratified, _trail(suppression_factor, densities).to(ri.dtype), 1.0)
    enabled_mask = _trail(enabled, densities).to(torch.bool)
    return torch.where(enabled_mask, supp, torch.ones_like(supp))
