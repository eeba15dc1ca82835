"""
Biofilm / bacterial regrowth: wall-attached biomass, planktonic bacteria and
biodegradable organic carbon (port of
``ics_wt_physicsengine_tpu/core/biofilm.py``).

State, each ``[..., Z]``: bacteria X [mg C/L] (planktonic, mixed and
advected), bdoc S [mg/L] (the growth substrate) and biofilm B [mg C/m2]
(wall-attached, zone-local). Processes: Monod growth on BDOC with a theta
temperature model and chlorine inhibition (the film with a larger,
matrix-protected constant and a logistic cap), Chick-Watson kill with lysis
recycling a fraction to BDOC, first-order attachment and (shear-driven)
detachment, and the film's wall chlorine demand. Wall quantities convert
through the zone's area-to-volume ratio a_v [m2/L].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE,
                                               dataclass_from_numpy,
                                               numpy_dtype, resolve_device)
from ics_wt_physicsengine_torch.utils.dispatch import nonneg

LN10 = float(np.log(10.0))
SECONDS_PER_DAY = 86400.0
SECONDS_PER_MIN = 60.0

# HPC conversion: ~5e9 cells per mg biomass C (0.2 pg C/cell) -- used only
# for reporting, never in the dynamics.
CELLS_PER_MG_C = 5.0e9


@dataclass(frozen=True)
class BiofilmParams:
    """Kinetic parameters: 0-d tensors, or ``[B]`` for a batch."""

    # Monod growth on BDOC
    mu_max: torch.Tensor = None       # [1/day] max specific growth at 20 C
    K_s: torch.Tensor = None          # [mg/L] BDOC half-saturation
    yield_c: torch.Tensor = None      # [mg biomass C / mg BDOC consumed]
    theta_mu: torch.Tensor = None     # temperature theta model

    # chlorine inhibition of growth (bulk vs matrix-protected film)
    K_I_bulk: torch.Tensor = None     # [mg/L]
    K_I_film: torch.Tensor = None     # [mg/L]

    # Chick-Watson chlorine kill (bulk), film protected by `protection`
    k_kill: torch.Tensor = None       # [L/mg/s]
    protection: torch.Tensor = None   # film kill = k_kill / protection
    f_lysis: torch.Tensor = None      # killed-biomass fraction -> BDOC

    # attachment / detachment
    k_att: torch.Tensor = None        # [1/s] bulk -> wall
    k_det: torch.Tensor = None        # [1/s] wall -> bulk (quiescent)
    k_det_shear: torch.Tensor = None  # [1/m] x velocity [m/s] -> [1/s]

    # film carrying capacity and wall chlorine demand
    B_max: torch.Tensor = None        # [mg C/m2]
    k_cl_film: torch.Tensor = None    # [L/mg/s] on the B*a_v equivalent


def biofilm_params_numpy(np_dtype=np.float64, mu_max=2.0, K_s=0.2,
                         yield_c=0.4, theta_mu=1.07, K_I_bulk=0.05,
                         K_I_film=0.5, ct_3log_hpc=10.0, protection=150.0,
                         f_lysis=0.5, k_att=1e-5, k_det=2e-6,
                         k_det_shear=0.0, B_max=1000.0,
                         k_cl_film=1e-5) -> dict:
    """The parameter fields as NumPy values of ``np_dtype``. ``k_kill`` is
    derived from ``ct_3log_hpc``, the 3-log chlorine CT [mg min/L] of the
    bulk flora."""
    a = lambda x: np.asarray(x, np_dtype)  # noqa: E731
    k_kill = 3.0 * LN10 / (SECONDS_PER_MIN * float(ct_3log_hpc))
    return dict(
        mu_max=a(mu_max), K_s=a(K_s), yield_c=a(yield_c),
        theta_mu=a(theta_mu), K_I_bulk=a(K_I_bulk), K_I_film=a(K_I_film),
        k_kill=a(k_kill), protection=a(protection), f_lysis=a(f_lysis),
        k_att=a(k_att), k_det=a(k_det), k_det_shear=a(k_det_shear),
        B_max=a(B_max), k_cl_film=a(k_cl_film))


def make_biofilm_params(dtype=DEFAULT_DTYPE, device=None, **overrides
                        ) -> BiofilmParams:
    """``BiofilmParams`` on ``device`` (``None``: the CUDA card);
    ``overrides`` replace the defaults of ``biofilm_params_numpy``."""
    return dataclass_from_numpy(
        BiofilmParams, biofilm_params_numpy(numpy_dtype(dtype), **overrides),
        dtype, device)


# ---------------------------------------------------------------------------
# Rate laws
# ---------------------------------------------------------------------------

def _pos(x):
    return nonneg(x)


def monod(s, K_s):
    """Substrate saturation S/(K_s + S), floored at 0."""
    s = _pos(s)
    return s / (K_s + s)


def chlorine_inhibition(Cl, K_I):
    """Non-competitive chlorine inhibition of growth: 1 at Cl=0, 1/2 at
    Cl=K_I."""
    return K_I / (K_I + _pos(Cl))


def specific_growth_bulk(s, Cl, T_C, p: BiofilmParams):
    """Bulk specific growth rate mu [1/s]: Monod x theta x inhibition."""
    return (p.mu_max / SECONDS_PER_DAY) * p.theta_mu ** (T_C - 20.0) \
        * monod(s, p.K_s) * chlorine_inhibition(Cl, p.K_I_bulk)


def specific_growth_film(s, Cl, T_C, B, p: BiofilmParams):
    """Film specific growth rate [1/s]: matrix-protected inhibition and the
    logistic carrying-capacity factor (1 - B/B_max)."""
    room = nonneg(1.0 - _pos(B) / p.B_max)
    return (p.mu_max / SECONDS_PER_DAY) * p.theta_mu ** (T_C - 20.0) \
        * monod(s, p.K_s) * chlorine_inhibition(Cl, p.K_I_film) * room


def kill_rate_bulk(Cl, p: BiofilmParams):
    """Chick-Watson specific kill of planktonic biomass [1/s]."""
    return p.k_kill * _pos(Cl)


def kill_rate_film(Cl, p: BiofilmParams):
    """Matrix-protected specific kill of wall biomass [1/s]."""
    return (p.k_kill / p.protection) * _pos(Cl)


def detachment_rate(u, p: BiofilmParams):
    """Specific detachment [1/s]: quiescent base + shear term in the
    superficial velocity scale."""
    return p.k_det + p.k_det_shear * _pos(u)


def wall_demand_rate(Cl, B, a_v, p: BiofilmParams):
    """Chlorine demand the film exerts [mg Cl/L/s]: first order in both
    the residual and the bulk-equivalent film mass B*a_v [mg/L]."""
    return p.k_cl_film * _pos(Cl) * _pos(B) * a_v


def hpc_cfu_per_ml(x_mgC_L):
    """Report planktonic biomass as an HPC plate count [CFU/mL]."""
    return _pos(x_mgC_L) * CELLS_PER_MG_C / 1000.0


def total_biomass_carbon(x, s, b, a_v):
    """Closed organic-carbon pool per zone [mg C/L]: bulk biomass +
    substrate + wall film in bulk-equivalent units."""
    return x + s + b * a_v


# ---------------------------------------------------------------------------
# Validation (literature oracles + structural invariants)
# ---------------------------------------------------------------------------

def validate_biofilm(verbose: bool = True, device=None) -> bool:
    """Literature oracles and structural invariants, in float64 on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    p = make_biofilm_params(dtype=torch.float64, device=dev)
    checks = []

    def f64(x):
        return torch.tensor(x, dtype=torch.float64, device=dev)

    def check(name, ok):
        checks.append((name, bool(ok)))
        if verbose:
            print(f"  {'PASS' if ok else 'FAIL'}: {name}")

    zero, twenty = f64(0.0), f64(20.0)

    check("Monod saturation -> 1",
          abs(float(monod(f64(1e6), p.K_s)) - 1.0) < 1e-5)
    check("Monod dilute limit -> S/K_s",
          abs(float(monod(f64(2e-4), p.K_s)) - 1e-3) < 1e-6)

    m20 = specific_growth_bulk(f64(10.0), zero, twenty, p)
    m30 = specific_growth_bulk(f64(10.0), zero, f64(30.0), p)
    check("theta ratio mu(30C)/mu(20C) = 1.07^10",
          abs(float(m30 / m20) - 1.07 ** 10) < 1e-6)

    m_sat = specific_growth_bulk(f64(1e6), zero, twenty, p)
    check("mu_max reproduced at saturation",
          abs(float(m_sat) * SECONDS_PER_DAY - 2.0) < 1e-4)

    check("inhibition(0) = 1",
          abs(float(chlorine_inhibition(zero, p.K_I_bulk)) - 1.0) < 1e-12)
    check("inhibition(K_I) = 1/2",
          abs(float(chlorine_inhibition(p.K_I_bulk, p.K_I_bulk)) - 0.5)
          < 1e-12)
    check("bulk growth < 10% at 0.5 mg/L residual",
          float(chlorine_inhibition(f64(0.5), p.K_I_bulk)) < 0.1)
    check("film K_I is 10x the bulk (matrix protection)",
          abs(float(p.K_I_film / p.K_I_bulk) - 10.0) < 1e-9)

    lam = float(kill_rate_bulk(f64(1.0), p))
    t3_min = 3.0 * LN10 / lam / SECONDS_PER_MIN
    check("bulk kill CT(3-log) = 10 mg min/L", abs(t3_min - 10.0) < 1e-9)
    lam_f = float(kill_rate_film(f64(1.0), p))
    check("film kill = bulk / protection", abs(lam / lam_f - 150.0) < 1e-9)

    g_full = float(specific_growth_film(f64(10.0), zero, twenty, zero, p))
    g_half = float(specific_growth_film(f64(10.0), zero, twenty,
                                        p.B_max / 2.0, p))
    g_cap = float(specific_growth_film(f64(10.0), zero, twenty, p.B_max, p))
    check("film growth capped at B_max", abs(g_cap) < 1e-15)
    check("film growth halved at B_max/2",
          abs(g_half / g_full - 0.5) < 1e-9)

    # attachment/detachment equilibrium (growth and kill off)
    a_v = 0.01  # [m2/L] typical tank
    x = 0.001   # [mg/L]
    b_star = float(p.k_att) * x / (float(p.k_det) * a_v)
    flux_on = float(p.k_att) * x / a_v            # [mg/m2/s]
    flux_off = float(detachment_rate(zero, p)) * b_star
    check("attach/detach equilibrium closes",
          abs(flux_on - flux_off) < 1e-15 * flux_on)
    p_sh = make_biofilm_params(k_det_shear=1e-4, dtype=torch.float64,
                               device=dev)
    d0 = float(detachment_rate(zero, p_sh))
    d1 = float(detachment_rate(f64(0.02), p_sh))
    check("shear detachment linear in u", abs((d1 - d0) - 2e-6) < 1e-12)

    r = float(wall_demand_rate(f64(1.0), f64(100.0), f64(0.01), p))
    check("wall demand at B a_v = 1 mg/L ~ 0.5..1.5 1/day",
          0.5 < r * SECONDS_PER_DAY < 1.5)

    # carbon accounting in the conservative limit (yield 1, no loss)
    p1 = make_biofilm_params(yield_c=1.0, f_lysis=1.0, dtype=torch.float64,
                             device=dev)
    mu = specific_growth_bulk(f64(1.0), zero, twenty, p1)
    x0 = f64(0.5)
    dX = mu * x0
    dS = -mu * x0 / p1.yield_c
    check("conservative limit: dX + dS = 0", abs(float(dX + dS)) < 1e-18)

    check("HPC proxy: 1 ug C/L -> 5e3 CFU/mL",
          abs(float(hpc_cfu_per_ml(f64(1e-3))) - 5e3) < 1e-6)

    ok = all(s for _, s in checks)
    if verbose:
        print(f"Biofilm validation: "
              f"{'ALL PASS' if ok else 'FAILURES PRESENT'}")
    return ok


if __name__ == "__main__":
    # python -m ics_wt_physicsengine_torch.core.biofilm [--device cpu]:
    # exits 1 when a check fails
    from ics_wt_physicsengine_torch.device import module_device

    raise SystemExit(0 if validate_biofilm(device=module_device(
        description="The biofilm validation suite, on the CUDA card "
                    "unless --device names another device.")) else 1)
