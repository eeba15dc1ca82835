"""
Nitrogen / biological chemistry: nitrification, denitrification and the
chlorine-ammonia (chloramine) reaction (port of
``ics_wt_physicsengine_tpu/core/nitrogen.py``).

Vectorized rate laws over ``[..., Z]`` zone tensors that ride the reactor's
fixed-step integrators, plus an exact analytic operator split for the one
fast reaction (chloramine formation, pseudo-first-order ~60 1/s at 2 mg/L
free chlorine) so that the slow processes set the substep count.

- Nitrification (AOB): NH4+ -> NO2-, Monod in total ammonia nitrogen with a
  theta temperature model (theta = 1.072), releasing 2 H+ per N.
- Nitratation (NOB): NO2- -> NO3-, Monod, theta = 1.06.
- Denitrification: NO3- -> N2, Monod, consuming 1 H+ per N; zero by default.
- Chloramination: HOCl + NH3 -> NH2Cl (tracked in mg/L as Cl2), Morris and
  Isaac's k(T) = 6.6e8 exp(-1510/T_K) 1/(M s) on the reactive fractions
  alpha_HOCl and alpha_NH3 (Emerson et al. 1975 ammonium pKa).

Parameters are built in float64 NumPy (``nitrogen_params_numpy``) and cast,
as the JAX package builds them, so both packages start from the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE,
                                               dataclass_from_numpy,
                                               numpy_dtype, resolve_device)
from ics_wt_physicsengine_torch.utils.dispatch import clip, nonneg

# molar masses [g/mol]
MW_N = 14.0067
MW_CL2 = 70.906
# mg/L -> mol/L divisors
_N_MGL_PER_MOL = MW_N * 1000.0
_CL2_MGL_PER_MOL = MW_CL2 * 1000.0

SECONDS_PER_DAY = 86400.0


@dataclass(frozen=True)
class NitrogenParams:
    """Kinetic parameters: 0-d tensors, or ``[B]`` for a Monte-Carlo
    batch."""

    # AOB nitrification: zero-order max rate with Monod saturation
    k_nitrif: torch.Tensor = None        # [mg N/L/day] at 20 C
    K_nh: torch.Tensor = None            # [mg N/L] half saturation
    theta_aob: torch.Tensor = None       # temperature theta model

    # NOB nitratation
    k_nitrat: torch.Tensor = None        # [mg N/L/day] at 20 C
    K_no2: torch.Tensor = None           # [mg N/L]
    theta_nob: torch.Tensor = None

    # denitrification (0 = off; aerobic plant default)
    k_denit: torch.Tensor = None         # [mg N/L/day] at 20 C
    K_no3: torch.Tensor = None           # [mg N/L]
    theta_dn: torch.Tensor = None

    # chloramination (Morris & Isaac 1983: k = A exp(-B / T_K) [1/(M s)])
    k_cm_A: torch.Tensor = None
    k_cm_B: torch.Tensor = None
    # monochloramine auto-decomposition (slow, first order)
    k_cm_decay: torch.Tensor = None      # [1/day]


def nitrogen_params_numpy(np_dtype=np.float64, k_nitrif=2.0, K_nh=1.0,
                          theta_aob=1.072, k_nitrat=3.0, K_no2=0.5,
                          theta_nob=1.06, k_denit=0.0, K_no3=0.5,
                          theta_dn=1.07, k_cm_A=6.6e8, k_cm_B=1510.0,
                          k_cm_decay=0.02) -> dict:
    """The parameter fields as NumPy values of ``np_dtype``."""
    a = lambda x: np.asarray(x, np_dtype)  # noqa: E731
    return dict(
        k_nitrif=a(k_nitrif), K_nh=a(K_nh), theta_aob=a(theta_aob),
        k_nitrat=a(k_nitrat), K_no2=a(K_no2), theta_nob=a(theta_nob),
        k_denit=a(k_denit), K_no3=a(K_no3), theta_dn=a(theta_dn),
        k_cm_A=a(k_cm_A), k_cm_B=a(k_cm_B), k_cm_decay=a(k_cm_decay))


def make_nitrogen_params(dtype=DEFAULT_DTYPE, device=None,
                         **kinetics) -> NitrogenParams:
    """``NitrogenParams`` on ``device`` (``None``: the CUDA card);
    ``kinetics`` overrides the defaults of ``nitrogen_params_numpy``."""
    return dataclass_from_numpy(
        NitrogenParams, nitrogen_params_numpy(numpy_dtype(dtype), **kinetics),
        dtype, device)


# ---------------------------------------------------------------------------
# Rate laws
# ---------------------------------------------------------------------------

def ammonium_pKa(T_C):
    """NH4+ acid dissociation pKa(T) (Emerson et al. 1975):
    pKa = 0.09018 + 2729.92 / T_K. 9.245 at 25 C."""
    return 0.09018 + 2729.92 / (T_C + 273.15)


def ammonia_fraction_nh3(pH, T_C):
    """Fraction of total ammonia present as reactive NH3 (un-ionized)."""
    return 1.0 / (1.0 + 10.0 ** (ammonium_pKa(T_C) - pH))


def _theta(theta, T_C):
    return theta ** (T_C - 20.0)


def nitrification_rate(tan, T_C, p: NitrogenParams):
    """AOB: NH4+ -> NO2- [mg N/L/s], Monod in TAN, theta T-correction."""
    tan = nonneg(tan)
    return (p.k_nitrif / SECONDS_PER_DAY) * _theta(p.theta_aob, T_C) \
        * tan / (p.K_nh + tan)


def nitratation_rate(no2, T_C, p: NitrogenParams):
    """NOB: NO2- -> NO3- [mg N/L/s]."""
    no2 = nonneg(no2)
    return (p.k_nitrat / SECONDS_PER_DAY) * _theta(p.theta_nob, T_C) \
        * no2 / (p.K_no2 + no2)


def denitrification_rate(no3, T_C, p: NitrogenParams):
    """NO3- -> N2 (leaves the water) [mg N/L/s]."""
    no3 = nonneg(no3)
    return (p.k_denit / SECONDS_PER_DAY) * _theta(p.theta_dn, T_C) \
        * no3 / (p.K_no3 + no3)


def chloramination_rate_constant(T_C, p: NitrogenParams):
    """Morris & Isaac k(T) [1/(M s)] for HOCl + NH3 -> NH2Cl.
    ~3.1e6 at 25 C."""
    return p.k_cm_A * torch.exp(-p.k_cm_B / (T_C + 273.15))


def hocl_fraction(pH, Ka_HOCl):
    """alpha_HOCl of free chlorine."""
    H = 10.0 ** (-clip(pH, 0.0, 14.0))
    return H / (H + Ka_HOCl)


def chloramination_extent(cl_mgL, tan_mgNL, pH, T_C, Ka_HOCl,
                          p: NitrogenParams, dt: float):
    """Exact extent x [mol/L] of HOCl + NH3 -> NH2Cl over one step of
    ``dt`` seconds, with the effective bimolecular rate
    k_eff = k(T) * alpha_HOCl * alpha_NH3 frozen over the step:

      unequal pools:  x = A B (1 - E) / (A - B E),  E = exp(-k (A-B) dt)
      equal pools:    x = k B^2 dt / (1 + k B dt)

    with A >= B the larger and smaller pool (mol/L), so the exponential
    decays for any imbalance. Both branches are evaluated and one is
    picked; the guarded denominators keep the branch not taken finite, so
    no ``inf * 0`` NaN reaches the ``where``."""
    C = nonneg(cl_mgL) / _CL2_MGL_PER_MOL     # mol/L as Cl2
    N = nonneg(tan_mgNL) / _N_MGL_PER_MOL     # mol/L as N
    k_eff = chloramination_rate_constant(T_C, p) \
        * hocl_fraction(pH, Ka_HOCl) * ammonia_fraction_nh3(pH, T_C)
    kd = k_eff * dt
    A = torch.maximum(C, N)
    B = torch.minimum(C, N)
    D = A - B
    # relative threshold (absolute pools are ~1e-5 M); <= so exactly equal
    # pools, both-zero included, take the safe branch
    near = D <= 1e-6 * A
    E = torch.exp(-kd * torch.where(near, torch.zeros_like(D), D))
    x_neq = A * B * (1.0 - E) / torch.where(near, torch.ones_like(A),
                                            A - B * E)
    x_eq = A * B * kd / (1.0 + B * kd)
    x = torch.where(near, x_eq, x_neq)
    return clip(x, 0.0, B)


# mol H+ released per mol N by each process (net, at drinking-water pH
# where NH4+ dominates): nitrification +2, denitrification -1,
# chloramination +1 (NH4+ + HOCl -> NH2Cl + H2O + H+).
H_PER_N_NITRIF = 2.0
H_PER_N_DENIT = -1.0
H_PER_N_CHLORAMINE = 1.0


def total_nitrogen_mgN(nh, no2, no3, nhcl):
    """Total nitrogen per zone [mg N/L] incl. the N bound in
    monochloramine (tracked in mg/L as Cl2 -> x MW_N / MW_CL2)."""
    return nh + no2 + no3 + nhcl * (MW_N / MW_CL2)


# ---------------------------------------------------------------------------
# Validation (literature oracles + structural invariants)
# ---------------------------------------------------------------------------

def validate_nitrogen(verbose: bool = True, device=None) -> bool:
    """Literature oracles and structural invariants, in float64 on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    p = make_nitrogen_params(dtype=torch.float64, device=dev)
    checks = []

    def f64(x):
        return torch.tensor(x, dtype=torch.float64, device=dev)

    def check(name, ok):
        checks.append((name, bool(ok)))
        if verbose:
            print(f"  {'PASS' if ok else 'FAIL'}: {name}")

    # theta temperature model: r(30)/r(20) = theta^10
    r20 = nitrification_rate(f64(100.0), f64(20.0), p)
    r30 = nitrification_rate(f64(100.0), f64(30.0), p)
    check("AOB theta ratio r(30C)/r(20C) = 1.072^10",
          abs(float(r30 / r20) - 1.072 ** 10) < 1e-6)

    # Monod saturation: rate at TAN >> K approaches k_max
    r_sat = nitrification_rate(f64(1e6), f64(20.0), p)
    check("Monod saturation -> k_max",
          abs(float(r_sat) * SECONDS_PER_DAY - 2.0) < 1e-3)

    check("NH4+ pKa(25C) = 9.245",
          abs(float(ammonium_pKa(f64(25.0))) - 9.245) < 0.01)

    # NH3 fraction is exactly 1/2 at pH = pKa; ~0.5% at pH 7, 25 C
    pka = float(ammonium_pKa(f64(25.0)))
    check("alpha_NH3(pH=pKa) = 0.5",
          abs(float(ammonia_fraction_nh3(f64(pka), f64(25.0))) - 0.5)
          < 1e-9)
    check("alpha_NH3(pH 7, 25C) ~ 0.57%",
          abs(float(ammonia_fraction_nh3(f64(7.0), f64(25.0))) - 0.0057)
          < 5e-4)

    k25 = float(chloramination_rate_constant(f64(25.0), p))
    check("chloramination k(25C) in 2e6..6e6 1/(M s)", 2e6 < k25 < 6e6)

    check("Cl2:N mass stoichiometry = 5.06",
          abs(MW_CL2 / MW_N - 5.06) < 0.01)

    # extent: bounded by the limiting reagent, exact in the t->inf limit
    x = chloramination_extent(f64(2.0), f64(10.0), f64(8.0), f64(25.0),
                              f64(10 ** -7.5), p, dt=1e9)
    check("extent -> limiting reagent (Cl2-limited)",
          abs(float(x) * _CL2_MGL_PER_MOL - 2.0) < 1e-6)
    x2 = chloramination_extent(f64(20.0), f64(1.0), f64(8.0), f64(25.0),
                               f64(10 ** -7.5), p, dt=1e9)
    check("extent -> limiting reagent (N-limited)",
          abs(float(x2) * _N_MGL_PER_MOL - 1.0) < 1e-6)

    # the two formula branches agree across the near-equal switch point
    kwargs = dict(pH=f64(8.0), T_C=f64(25.0), Ka_HOCl=f64(10 ** -7.5), p=p,
                  dt=1.0)
    n_eq = 2.0 * MW_N / MW_CL2       # same mol/L as 2.0 mg/L Cl2
    xa = chloramination_extent(f64(2.0), f64(n_eq * (1 + 2e-6)), **kwargs)
    xb = chloramination_extent(f64(2.0), f64(n_eq * (1 + 0.5e-6)), **kwargs)
    check("branch switch continuous (rel diff < 1e-05)",
          abs(float(xa) - float(xb)) < 1e-5 * float(xb))

    ok = all(s for _, s in checks)
    if verbose:
        print(f"Nitrogen chemistry validation: "
              f"{'ALL PASS' if ok else 'FAILURES PRESENT'}")
    return ok


if __name__ == "__main__":
    # python -m ics_wt_physicsengine_torch.core.nitrogen [--device cpu]:
    # exits 1 when a check fails
    from ics_wt_physicsengine_torch.device import module_device

    raise SystemExit(0 if validate_nitrogen(device=module_device(
        description="The nitrogen chemistry validation suite, on the CUDA "
                    "card unless --device names another device.")) else 1)
