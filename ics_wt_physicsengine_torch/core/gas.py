"""
Gas exchange: dissolved oxygen and CO2 <-> atmosphere (port of
``ics_wt_physicsengine_tpu/core/gas.py``).

Vectorized rate laws over ``[..., Z]`` zone tensors. Gas transfer is slow
(kLa ~ 1e-5..1e-3 1/s), so it rides the reactor's integrators directly.

- Surface O2/CO2 transfer (two-film theory) at rate k_L / h_zone on the top
  zone (Z-1); CO2's film coefficient is scaled by sqrt(D_CO2 / D_O2).
- Diffused aeration: a volumetric ``aeration_kla`` boundary input acting on
  every zone, which strips CO2 and so raises pH.
- O2 saturation: Benson & Krause (1984) as in APHA Standard Methods 4500-O.
- CO2 solubility: Henry's law with a van't Hoff correction (Sander 2015).
- Carbonate <-> pH: CO2 changes total carbonate at constant alkalinity,
  dpH/dC_T = -(alpha1 + 2 alpha2) / beta.
- With the nitrogen axis on: nitrification consumes 3.43 + 1.14 g O2 / g N
  and is Monod-limited in O2; denitrification is O2-inhibited.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import chemistry as chem
from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE,
                                               dataclass_from_numpy,
                                               numpy_dtype, resolve_device)
from ics_wt_physicsengine_torch.utils.dispatch import align_trailing, nonneg

# molar masses [g/mol]
MW_O2 = 31.9988
MW_CO2 = 44.0095

# mg/L per mol/L
_O2_MGL_PER_MOL = MW_O2 * 1000.0
_CO2_MGL_PER_MOL = MW_CO2 * 1000.0

# molecular diffusivities in water at 25 C [m^2/s]: the film-coefficient
# ratio k_L,CO2 / k_L,O2 = sqrt(D_CO2 / D_O2) (penetration theory)
D_O2_25C = 2.10e-9
D_CO2_25C = 1.92e-9
CO2_FILM_RATIO = float(np.sqrt(D_CO2_25C / D_O2_25C))   # ~0.956

# nitrification oxygen stoichiometry [g O2 / g N] (Metcalf & Eddy)
O2_PER_N_AOB = 3.43
O2_PER_N_NOB = 1.14


@dataclass(frozen=True)
class GasParams:
    """Gas-exchange parameters: 0-d tensors, or ``[B]`` for a batch."""

    kl_surface: torch.Tensor = None     # [m/s] surface film coefficient (O2)
    theta_kla: torch.Tensor = None      # kLa temperature model (ASCE 1.024)
    p_o2_atm: torch.Tensor = None       # [atm] O2 partial pressure
    p_co2_atm: torch.Tensor = None      # [atm] CO2 partial pressure
    K_o2_nitrif: torch.Tensor = None    # [mg/L] Monod half-sat, nitrification
    K_o2_denit: torch.Tensor = None     # [mg/L] O2 inhibition, denitrification


def gas_params_numpy(np_dtype=np.float64, kl_surface=2.0e-5, theta_kla=1.024,
                     p_o2_atm=0.2095, p_co2_atm=420e-6, K_o2_nitrif=0.5,
                     K_o2_denit=0.2) -> dict:
    """The parameter fields as NumPy values of ``np_dtype``."""
    a = lambda x: np.asarray(x, np_dtype)  # noqa: E731
    return dict(kl_surface=a(kl_surface), theta_kla=a(theta_kla),
                p_o2_atm=a(p_o2_atm), p_co2_atm=a(p_co2_atm),
                K_o2_nitrif=a(K_o2_nitrif), K_o2_denit=a(K_o2_denit))


def make_gas_params(dtype=DEFAULT_DTYPE, device=None, **overrides
                    ) -> GasParams:
    """``GasParams`` on ``device`` (``None``: the CUDA card);
    ``overrides`` replace the defaults of ``gas_params_numpy``."""
    return dataclass_from_numpy(
        GasParams, gas_params_numpy(numpy_dtype(dtype), **overrides), dtype,
        device)


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


# ---------------------------------------------------------------------------
# Saturation / solubility (tensors, or NumPy values on the host path)
# ---------------------------------------------------------------------------

def oxygen_saturation(T_C):
    """Dissolved-O2 saturation [mg/L] in freshwater at 1 atm (Benson &
    Krause 1984): 14.62 at 0 C, 9.09 at 20 C, 8.26 at 25 C."""
    T = T_C + 273.15
    lnC = (-139.34411 + 1.575701e5 / T - 6.642308e7 / T ** 2
           + 1.2438e10 / T ** 3 - 8.621949e11 / T ** 4)
    return _exp(lnC)


def co2_henry_constant(T_C):
    """Henry solubility K_H(T) [mol/(L atm)] for CO2 in water:
    0.034 exp(2400 (1/T - 1/298.15)) (Sander 2015)."""
    T = T_C + 273.15
    return 0.034 * _exp(2400.0 * (1.0 / T - 1.0 / 298.15))


def co2_saturation_mol(T_C, p_co2_atm):
    """Equilibrium dissolved CO2 (as H2CO3*) [mol/L] under partial pressure
    ``p_co2_atm``: ~1.4e-5 M (0.63 mg/L) at 25 C, 420 ppm."""
    return co2_henry_constant(T_C) * p_co2_atm


def kla_temperature(kla_20, T_C, theta):
    """kLa(T) = kLa(20C) * theta^(T-20) (ASCE standard, theta = 1.024)."""
    return kla_20 * theta ** (T_C - 20.0)


# ---------------------------------------------------------------------------
# Carbonate <-> pH coupling
# ---------------------------------------------------------------------------

def ph_per_carbonate(pH, k: chem.ChemistryConstants):
    """dpH/dC_T at constant alkalinity [pH per (mol/L)]:
    -(alpha1 + 2 alpha2) / beta(pH). ``k.C_T_mol`` must carry the dynamic
    per-zone carbonate."""
    _, a1, a2 = chem.alpha_carbonate(pH, k.Ka1, k.Ka2)
    beta = chem.buffering_capacity(pH, k)
    return -(a1 + 2.0 * a2) / beta


# ---------------------------------------------------------------------------
# Biology coupling factors
# ---------------------------------------------------------------------------

def o2_monod(o2, K):
    """Monod O2 limitation factor for aerobic processes."""
    o2 = nonneg(o2)
    return o2 / (align_trailing(K, o2) + o2)


def o2_inhibition(o2, K_I):
    """O2 inhibition factor for anoxic processes (denitrification)."""
    o2 = nonneg(o2)
    K_I = align_trailing(K_I, o2)
    return K_I / (K_I + o2)


# ---------------------------------------------------------------------------
# Validation (literature oracles + structural invariants)
# ---------------------------------------------------------------------------

def validate_gas(verbose: bool = True, device=None) -> bool:
    """Literature oracles and structural invariants, in float64 on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    p = make_gas_params(dtype=torch.float64, device=dev)
    checks = []

    def f64(x):
        return torch.tensor(x, dtype=torch.float64, device=dev)

    def check(name, ok):
        checks.append((name, bool(ok)))
        if verbose:
            print(f"  {'PASS' if ok else 'FAIL'}: {name}")

    # Benson-Krause table values (APHA 4500-O, freshwater, 1 atm)
    check("O2 saturation at 0 C = 14.62 mg/L",
          abs(float(oxygen_saturation(f64(0.0))) - 14.62) < 0.05)
    check("O2 saturation at 20 C = 9.09 mg/L",
          abs(float(oxygen_saturation(f64(20.0))) - 9.09) < 0.05)
    check("O2 saturation at 25 C = 8.26 mg/L",
          abs(float(oxygen_saturation(f64(25.0))) - 8.26) < 0.05)
    sat = oxygen_saturation(torch.linspace(0.0, 40.0, 41,
                                           dtype=torch.float64, device=dev))
    check("O2 saturation monotonically decreasing in T",
          bool((torch.diff(sat) < 0).all()))

    kh25 = float(co2_henry_constant(f64(25.0)))
    check("CO2 Henry K_H(25C) = 0.034 mol/(L atm)",
          abs(kh25 - 0.034) < 1e-4)
    co2_eq = float(co2_saturation_mol(f64(25.0), 420e-6)) * _CO2_MGL_PER_MOL
    check("dissolved CO2 at 420 ppm, 25C ~ 0.63 mg/L",
          abs(co2_eq - 0.628) < 0.02)

    r = float(kla_temperature(f64(1.0), f64(30.0), f64(1.024))
              / kla_temperature(f64(1.0), f64(20.0), f64(1.024)))
    check("kLa theta ratio r(30C)/r(20C) = 1.024^10",
          abs(r - 1.024 ** 10) < 1e-9)

    check("CO2/O2 film ratio = sqrt(D ratio) ~ 0.956",
          abs(CO2_FILM_RATIO - 0.956) < 0.002)

    # coupling sign: adding CO2 lowers pH, with magnitude -(a1+2a2)/beta
    k = chem.make_chemistry_constants(
        f64(100.0), f64(2.0), f64(25.0))
    dpH_dCT = float(ph_per_carbonate(f64(7.0), k))
    check("dpH/dC_T < 0 (CO2 acidifies)", dpH_dCT < 0.0)
    a0, a1, a2 = chem.alpha_carbonate(f64(7.0), k.Ka1, k.Ka2)
    beta = chem.buffering_capacity(f64(7.0), k)
    expected = -float((a1 + 2.0 * a2) / beta)
    check("dpH/dC_T matches -(a1+2a2)/beta analytically",
          abs(dpH_dCT - expected) < 1e-12)

    check("O2 Monod -> 0 at O2 = 0",
          float(o2_monod(f64(0.0), p.K_o2_nitrif)) == 0.0)
    check("O2 Monod -> 1 at O2 >> K",
          abs(float(o2_monod(f64(1e3), p.K_o2_nitrif)) - 1.0) < 1e-3)
    check("denitrification inhibition -> 1 at O2 = 0",
          abs(float(o2_inhibition(f64(0.0), p.K_o2_denit)) - 1.0) < 1e-12)
    check("denitrification inhibition -> 0 at O2 >> K_I",
          float(o2_inhibition(f64(1e3), p.K_o2_denit)) < 1e-3)

    ok = all(s for _, s in checks)
    if verbose:
        print(f"Gas exchange validation: "
              f"{'ALL PASS' if ok else 'FAILURES PRESENT'}")
    return ok
