"""
Phase change: freezing / ice and the boiling cap by the apparent heat
capacity method, plus Dalton surface evaporation (port of
``ics_wt_physicsengine_tpu/core/phase.py``).

The axis adds no state: the ice fraction is a function of temperature.

- Freezing: across a mushy band ``[t_freeze - delta_freeze, t_freeze]`` the
  apparent heat capacity carries the latent heat of fusion, so temperatures
  pin at the front; below it the water is ice (cp_ice). Ice floats (the
  stratification sees the mixture density), throttles the inter-zone
  exchange, insulates the ambient loss and lids the free surface.
- Evaporation: m'' = k_e (1 + c_w W) max(e_s(T_w) - RH e_s(T_a), 0) with
  the WMO/Penman wind function and Magnus saturation pressure, cooling the
  top zone by lambda(T) m''.
- Boiling cap: a second latent band ``[t_boil, t_boil + delta_boil]``
  carries the latent heat of vaporization.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.core import spatial as spatial_mod
from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE,
                                               dataclass_from_numpy,
                                               numpy_dtype, resolve_device)
from ics_wt_physicsengine_torch.utils.dispatch import clip, nonneg

# --- literature constants ---
LATENT_FUSION = 333550.0        # [J/kg] ice <-> water at 0 C (CRC)
LATENT_VAP_100C = 2256400.0     # [J/kg] water <-> steam at 100 C
LATENT_VAP_0C = 2500900.0       # [J/kg] at 0 C
CP_ICE = 2108.0                 # [J/(kg K)] ice near 0 C
RHO_ICE = 916.7                 # [kg/m^3] ice at 0 C
K_CRYOSCOPIC = 1.86             # [K kg/mol] water cryoscopic constant
# WMO/Penman open-water wind function 0.26 (1 + 0.54 u) mm/day per hPa
K_EVAP = 3.0e-5                 # [kg/(m^2 s kPa)] at u = 0
C_WIND = 0.54                   # [s/m]


@dataclass(frozen=True)
class PhaseParams:
    """Phase-change parameters: 0-d tensors, or ``[B]`` for a batch."""

    t_freeze: torch.Tensor = None       # [C] liquidus (after depression)
    delta_freeze: torch.Tensor = None   # [K] mushy band width (freeze)
    t_boil: torch.Tensor = None         # [C] boil point
    delta_boil: torch.Tensor = None     # [K] mushy band width (boil)
    t_min: torch.Tensor = None          # [C] hard lower clip
    latent_fusion: torch.Tensor = None  # [J/kg]
    cp_ice: torch.Tensor = None         # [J/(kg K)]
    rho_ice: torch.Tensor = None        # [kg/m^3]
    ice_insulation: torch.Tensor = None  # in [0, 1]: heat-loss throttle
    k_evap: torch.Tensor = None         # [kg/(m^2 s kPa)]
    c_wind: torch.Tensor = None         # [s/m] wind-function slope


def freezing_point_depression(molality):
    """Colligative liquidus depression dT_f = K_f m [K] (K_f = 1.86)."""
    return K_CRYOSCOPIC * molality


def phase_params_numpy(np_dtype=np.float64, t_freeze=0.0,
                       solute_molality=0.0, delta_freeze=0.5, t_boil=100.0,
                       delta_boil=0.5, t_min=-60.0,
                       latent_fusion=LATENT_FUSION, cp_ice=CP_ICE,
                       rho_ice=RHO_ICE, ice_insulation=0.7, k_evap=K_EVAP,
                       c_wind=C_WIND) -> dict:
    """The parameter fields as NumPy values of ``np_dtype``."""
    a = lambda x: np.asarray(x, np_dtype)  # noqa: E731
    return dict(
        t_freeze=a(t_freeze
                   - freezing_point_depression(float(solute_molality))),
        delta_freeze=a(delta_freeze), t_boil=a(t_boil),
        delta_boil=a(delta_boil), t_min=a(t_min),
        latent_fusion=a(latent_fusion), cp_ice=a(cp_ice), rho_ice=a(rho_ice),
        ice_insulation=a(ice_insulation), k_evap=a(k_evap), c_wind=a(c_wind))


def make_phase_params(dtype=DEFAULT_DTYPE, device=None, **overrides
                      ) -> PhaseParams:
    """``PhaseParams`` on ``device`` (``None``: the CUDA card);
    ``overrides`` replace the defaults of ``phase_params_numpy``."""
    return dataclass_from_numpy(
        PhaseParams, phase_params_numpy(numpy_dtype(dtype), **overrides),
        dtype, device)


# ---------------------------------------------------------------------------
# Thermodynamic property fits
# ---------------------------------------------------------------------------

def latent_heat_vaporization(T_C):
    """lambda(T) [J/kg]: linear through (0 C, 2500.9) and (100 C, 2256.4)
    kJ/kg."""
    return LATENT_VAP_0C + (LATENT_VAP_100C - LATENT_VAP_0C) / 100.0 * T_C


def saturation_vapor_pressure(T_C):
    """Saturation vapor pressure over liquid water [kPa], Magnus form
    (Alduchov & Eskridge 1996): 0.611 kPa at 0 C, 2.339 at 20 C. A tensor
    or a Python float (an ambient temperature stays on the host)."""
    exponent = 17.625 * T_C / (T_C + 243.04)
    if isinstance(exponent, torch.Tensor):
        return 0.61094 * torch.exp(exponent)
    return 0.61094 * math.exp(exponent)


# ---------------------------------------------------------------------------
# Apparent heat capacity / enthalpy (the fixed-grid Stefan formulation)
# ---------------------------------------------------------------------------

def ice_fraction(T_C, p: PhaseParams):
    """Diagnostic ice fraction phi(T): linear ramp across the mushy band,
    0 above ``t_freeze``, 1 below ``t_freeze - delta_freeze``."""
    return clip((p.t_freeze - T_C) / p.delta_freeze, 0.0, 1.0)


def heat_capacity_ratio(T_C, p: PhaseParams):
    """c_eff(T) / cp_water, the factor every temperature tendency is
    divided by: cp_ice/cp_w below the freeze band, (c_m + L_f/delta_f)/cp_w
    inside it (c_m the phase-average cp), 1 in the liquid range, and
    (cp_w + lambda(t_b)/delta_b)/cp_w from the boil point up. The integral
    of c_eff across each band is the latent heat."""
    cpw = c.WATER_CP
    c_mushy = (0.5 * (cpw + p.cp_ice) + p.latent_fusion / p.delta_freeze)
    c_boil = cpw + latent_heat_vaporization(p.t_boil) / p.delta_boil
    r = torch.where(T_C < p.t_freeze - p.delta_freeze, p.cp_ice / cpw,
                    torch.ones_like(T_C))
    r = torch.where((T_C >= p.t_freeze - p.delta_freeze)
                    & (T_C < p.t_freeze), c_mushy / cpw, r)
    return torch.where(T_C >= p.t_boil, c_boil / cpw, r)


def enthalpy(T_C, p: PhaseParams):
    """Specific enthalpy h(T) [J/kg], the exact integral of ``c_eff`` with
    ``h(t_freeze) = 0``."""
    cpw = c.WATER_CP
    c_mushy = 0.5 * (cpw + p.cp_ice) + p.latent_fusion / p.delta_freeze
    lam_b = latent_heat_vaporization(p.t_boil)
    zero = torch.zeros_like(T_C)
    h = cpw * torch.maximum(T_C - p.t_freeze, zero)
    h = h + (lam_b / p.delta_boil) * torch.minimum(
        torch.maximum(T_C - p.t_boil, zero), p.delta_boil)
    h = h - c_mushy * torch.minimum(torch.maximum(p.t_freeze - T_C, zero),
                                    p.delta_freeze)
    return h - p.cp_ice * torch.maximum((p.t_freeze - p.delta_freeze) - T_C,
                                        zero)


def effective_density(T_C, p: PhaseParams):
    """Mixture density the stratification sees:
    ``(1 - phi) rho_w(T) + phi rho_ice`` -- ice floats."""
    phi = ice_fraction(T_C, p)
    return (1.0 - phi) * spatial_mod.water_density(T_C) + phi * p.rho_ice


def interface_mobility(phi):
    """Per-interface transport mobility from zone ice fractions ``[..., Z]``:
    ``(1 - phi_i)(1 - phi_{i+1})`` -- exchange needs liquid on both
    sides."""
    liq = 1.0 - phi
    return liq[..., :-1] * liq[..., 1:]


# ---------------------------------------------------------------------------
# Evaporation (Dalton mass transfer, Penman wind function)
# ---------------------------------------------------------------------------

def evaporation_flux(T_water, T_ambient, humidity, wind_speed,
                     p: PhaseParams):
    """Evaporative mass flux m'' [kg/(m^2 s)] from the free surface:
    k_e (1 + c_w W) max(e_s(T_w) - RH e_s(T_a), 0). Condensation is
    clipped."""
    deficit = nonneg(
        saturation_vapor_pressure(T_water)
        - humidity * saturation_vapor_pressure(T_ambient))
    return p.k_evap * (1.0 + p.c_wind * wind_speed) * deficit


def evaporative_cooling_flux(T_water, T_ambient, humidity, wind_speed,
                             p: PhaseParams):
    """Latent cooling flux q'' = lambda(T) m'' [W/m^2]."""
    return latent_heat_vaporization(T_water) * evaporation_flux(
        T_water, T_ambient, humidity, wind_speed, p)


# ---------------------------------------------------------------------------
# Validation (literature oracles + structural invariants)
# ---------------------------------------------------------------------------

def validate_phase(verbose: bool = True, device=None) -> bool:
    """Literature oracles and structural invariants, in float64 on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    p = make_phase_params(dtype=torch.float64, device=dev)
    checks = []

    def f64(x):
        return torch.tensor(x, dtype=torch.float64, device=dev)

    def check(name, ok):
        checks.append((name, bool(ok)))
        if verbose:
            print(f"  {'PASS' if ok else 'FAIL'}: {name}")

    check("latent heat of fusion = 333.55 kJ/kg",
          abs(float(p.latent_fusion) - 333550.0) < 1.0)
    check("latent heat of vaporization at 100 C = 2256.4 kJ/kg",
          abs(float(latent_heat_vaporization(f64(100.0))) - 2256400.0)
          < 1.0)
    check("latent heat of vaporization at 20 C ~ 2453.5 kJ/kg",
          abs(float(latent_heat_vaporization(f64(20.0))) - 2453500.0)
          < 3000.0)

    check("e_s(0 C) = 0.611 kPa",
          abs(float(saturation_vapor_pressure(f64(0.0))) - 0.611) < 0.002)
    check("e_s(20 C) = 2.339 kPa",
          abs(float(saturation_vapor_pressure(f64(20.0))) - 2.339) < 0.01)
    check("e_s(25 C) = 3.168 kPa",
          abs(float(saturation_vapor_pressure(f64(25.0))) - 3.168) < 0.02)
    es = saturation_vapor_pressure(
        torch.linspace(0.0, 50.0, 51, dtype=torch.float64, device=dev))
    check("e_s monotonically increasing", bool((torch.diff(es) > 0).all()))

    check("freezing-point depression K_f = 1.86 K kg/mol",
          abs(freezing_point_depression(1.0) - 1.86) < 1e-12)
    check("ice density = 916.7 kg/m^3 (ice floats)",
          float(p.rho_ice) < 999.0 and abs(float(p.rho_ice) - 916.7) < 0.1)
    check("ice heat capacity = 2108 J/(kg K)",
          abs(float(p.cp_ice) - 2108.0) < 1.0)

    # the c_eff integral across each mushy band is the latent heat
    dT = float(p.delta_freeze)
    c_band = c.WATER_CP * float(heat_capacity_ratio(
        f64(float(p.t_freeze) - 0.5 * dT), p))
    sensible = 0.5 * (c.WATER_CP + float(p.cp_ice))
    check("integral of c_eff over freeze band == L_f (exact)",
          abs(c_band * dT - (sensible * dT + float(p.latent_fusion)))
          < 1e-6)
    db = float(p.delta_boil)
    c_bb = c.WATER_CP * float(heat_capacity_ratio(
        f64(float(p.t_boil) + 0.5 * db), p))
    check("integral of c_eff over boil band == lambda(t_boil) (exact)",
          abs(c_bb * db - (c.WATER_CP * db + latent_heat_vaporization(
              float(p.t_boil)))) < 1e-3)

    # enthalpy is the exact antiderivative of c_eff away from the kinks
    for t0 in (-10.0, -0.25, 10.0, 100.25):
        eps = 1e-4
        dh = (float(enthalpy(f64(t0 + eps), p))
              - float(enthalpy(f64(t0 - eps), p))) / (2 * eps)
        ceff = c.WATER_CP * float(heat_capacity_ratio(f64(t0), p))
        check(f"dh/dT == c_eff at T = {t0} C",
              abs(dh - ceff) / ceff < 1e-6)
    check("enthalpy drop across the freeze band >= L_f",
          float(enthalpy(f64(0.0), p)) - float(enthalpy(f64(-0.5), p))
          >= float(p.latent_fusion))

    check("phi = 0 above freezing", float(ice_fraction(f64(5.0), p)) == 0.0)
    check("phi = 1 below the band", float(ice_fraction(f64(-5.0), p)) == 1.0)
    phis = ice_fraction(
        torch.linspace(-2.0, 2.0, 101, dtype=torch.float64, device=dev), p)
    check("phi monotone non-increasing in T",
          bool((torch.diff(phis) <= 0).all()))

    check("effective density of frozen zone = rho_ice",
          abs(float(effective_density(f64(-5.0), p))
              - float(p.rho_ice)) < 1e-9)
    check("effective density of liquid zone = rho_w(T)",
          abs(float(effective_density(f64(20.0), p))
              - float(spatial_mod.water_density(f64(20.0)))) < 1e-9)

    mob = interface_mobility(f64([0.0, 1.0, 0.0]))
    check("interface mobility zero against a frozen zone",
          float(mob[0]) == 0.0 and float(mob[1]) == 0.0)

    m = float(evaporation_flux(f64(20.0), f64(20.0), f64(0.5), f64(2.0), p))
    mm_day = m / 1000.0 * 86400.0 * 1000.0
    check("evaporation 20 C / 50% RH / 2 m/s in 2-8 mm/day",
          2.0 < mm_day < 8.0)
    q = float(evaporative_cooling_flux(f64(20.0), f64(20.0), f64(0.5),
                                       f64(2.0), p))
    check("evaporative cooling ~ 100-250 W/m^2", 80.0 < q < 250.0)
    check("no evaporation at 100% RH, T_w = T_a",
          float(evaporation_flux(f64(20.0), f64(20.0), f64(1.0), f64(0.0),
                                 p)) == 0.0)

    ok = all(s for _, s in checks)
    if verbose:
        print(f"Phase-change validation: "
              f"{'ALL PASS' if ok else 'FAILURES PRESENT'}")
    return ok
