"""
Disinfection: pathogen inactivation, CT credit, UV dose and DBP formation
(port of ``ics_wt_physicsengine_tpu/core/disinfection.py``).

Vectorized rate laws over ``[..., Z]`` zone tensors, the pathogen classes on
a ``[..., P, Z]`` class axis (the layout of the particle classes).

- Chick-Watson chlorine kill of three classes (virus, Giardia,
  Cryptosporidium), dN/dt = -k_p theta^(T-20) phi(pH, T) Cl N, with k_p
  from the EPA CT tables at 20 C / pH 7 and phi the HOCl-weighted
  germicidal speciation normalized to 1 there.
- UV kill at the outlet zone, first order in the Beer-Lambert average
  fluence across the lamp gap; the water's own organics and particles
  shade the lamps. ``reactor.step`` applies it as an exact operator split.
- CT credit and water age as advected scalars (sources Cl/60 and 1).
- THM formation as a pH-enhanced yield on the organics' chlorine demand;
  TOC is consumed stoichiometrically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE,
                                               dataclass_from_numpy,
                                               numpy_dtype, resolve_device)
from ics_wt_physicsengine_torch.utils.dispatch import clip, nonneg

LN10 = float(np.log(10.0))
SECONDS_PER_MIN = 60.0

# pathogen class axis order (fixed, like particles.N_CLASSES)
PATHOGEN_NAMES = ("virus", "giardia", "cryptosporidium")
N_PATHOGENS = len(PATHOGEN_NAMES)

# EPA CT tables, 20 C / pH 7 free chlorine [mg min/L for 3-log]
CT_3LOG_20C_PH7 = (2.0, 56.0, 1.0e4)

# EPA UV disinfection guidance manual (2006) validated 3-log doses
# [mJ/cm2]: adenovirus 143, Giardia 11, Cryptosporidium 12.
UV_DOSE_3LOG = (143.0, 11.0, 12.0)


@dataclass(frozen=True)
class DisinfectionParams:
    """Kinetic parameters: 0-d tensors and ``[P]`` class vectors, with a
    leading ``[B]`` axis for a batch."""

    # Chick-Watson chlorine kill: [P] rates, pH-7/20C-calibrated [L/mg/s]
    k_cl: torch.Tensor = None
    theta_cl: torch.Tensor = None     # CT halves per 10 C -> 2^0.1
    r_ocl: torch.Tensor = None        # OCl- relative biocidal activity

    # UV kill: [P] fluence sensitivities [cm2/mJ]
    k_uv: torch.Tensor = None
    uv_path_cm: torch.Tensor = None   # lamp-to-wall water gap [cm]
    a_water: torch.Tensor = None      # background absorbance [1/cm]
    a_toc: torch.Tensor = None        # TOC specific absorbance [L/(mg cm)]
    a_tss: torch.Tensor = None        # TSS attenuation [L/(mg cm)]

    # organics chlorine demand + THM formation
    k_toc: torch.Tensor = None        # [L/(mg s)] demand rate constant
    theta_toc: torch.Tensor = None    # Arrhenius-ish theta model
    y_thm: torch.Tensor = None        # [ug THM / mg Cl demand] at pH 7.5
    b_ph_thm: torch.Tensor = None     # base-catalysis exponent [1/pH]
    s_toc: torch.Tensor = None        # [mg TOC consumed / mg Cl demand]


def _phi_ref(r_ocl: float) -> float:
    """Germicidal speciation weight at the 20 C / pH 7 calibration point
    (pKa_HOCl(20C) = 7.45)."""
    alpha = 1.0 / (1.0 + 10.0 ** (7.0 - 7.45))
    return alpha + r_ocl * (1.0 - alpha)


def disinfection_params_numpy(
        np_dtype=np.float64, ct_3log=CT_3LOG_20C_PH7,
        theta_cl=2.0 ** 0.1, r_ocl=0.05, uv_dose_3log=UV_DOSE_3LOG,
        uv_path_cm=5.0, a_water=0.02, a_toc=0.03, a_tss=0.01, k_toc=5e-6,
        theta_toc=1.04, y_thm=40.0, b_ph_thm=0.15, s_toc=0.05) -> dict:
    """The parameter fields as NumPy values of ``np_dtype``. ``ct_3log`` /
    ``uv_dose_3log`` are the per-class 3-log requirements; the rate
    constants are derived in float64 so the tables hold exactly at the
    calibration point."""
    a = lambda x: np.asarray(x, np_dtype)  # noqa: E731
    k_cl = 3.0 * LN10 / (SECONDS_PER_MIN * np.asarray(ct_3log, np.float64))
    k_uv = 3.0 * LN10 / np.asarray(uv_dose_3log, np.float64)
    return dict(
        k_cl=a(k_cl), theta_cl=a(theta_cl), r_ocl=a(r_ocl),
        k_uv=a(k_uv), uv_path_cm=a(uv_path_cm), a_water=a(a_water),
        a_toc=a(a_toc), a_tss=a(a_tss),
        k_toc=a(k_toc), theta_toc=a(theta_toc), y_thm=a(y_thm),
        b_ph_thm=a(b_ph_thm), s_toc=a(s_toc))


def make_disinfection_params(dtype=DEFAULT_DTYPE, device=None, **overrides
                             ) -> DisinfectionParams:
    """``DisinfectionParams`` on ``device`` (``None``: the CUDA card);
    ``overrides`` replace the defaults of ``disinfection_params_numpy``."""
    return dataclass_from_numpy(
        DisinfectionParams,
        disinfection_params_numpy(numpy_dtype(dtype), **overrides), dtype,
        device)


# ---------------------------------------------------------------------------
# Rate laws
# ---------------------------------------------------------------------------

def germicidal_weight(pH, T_C, Ka_HOCl, p: DisinfectionParams):
    """phi(pH, T): HOCl-weighted biocidal activity of the free-chlorine
    pool, normalized to 1 at 20 C / pH 7."""
    H = 10.0 ** (-clip(pH, 0.0, 14.0))
    alpha = H / (H + Ka_HOCl)
    phi = alpha + p.r_ocl * (1.0 - alpha)
    alpha_ref = 1.0 / (1.0 + 10.0 ** (7.0 - 7.45))
    return phi / (alpha_ref + p.r_ocl * (1.0 - alpha_ref))


def chlorine_lethality(Cl, pH, T_C, Ka_HOCl, p: DisinfectionParams):
    """Chick-Watson specific kill rate [1/s] per pathogen class:
    ``[..., P, Z]`` from ``[..., Z]`` chlorine/pH/temperature fields."""
    phi = germicidal_weight(pH, T_C, Ka_HOCl, p)
    base = p.theta_cl ** (T_C - 20.0) * phi * nonneg(Cl)
    return p.k_cl[..., :, None] * base[..., None, :]


def absorbance_254(toc, tss_total, p: DisinfectionParams):
    """UV254 absorbance [1/cm] the water carries: background + organics
    + particle shading."""
    return p.a_water + p.a_toc * nonneg(toc) \
        + p.a_tss * nonneg(tss_total)


def uvt_percent(a254):
    """UV transmittance over the standard 1 cm path [%]."""
    return 100.0 * 10.0 ** (-a254)


def average_fluence(e0, a254, p: DisinfectionParams):
    """Beer-Lambert average fluence rate across the ``uv_path_cm`` gap
    [mW/cm2] for wall intensity ``e0``:
    E_avg = E0 (1 - 10^(-a d)) / (a d ln 10), -> E0 as a d -> 0."""
    ad = nonneg(a254 * p.uv_path_cm)
    small = ad < 1e-6
    safe = torch.where(small, torch.ones_like(ad), ad)
    frac = torch.where(small, 1.0 - 0.5 * LN10 * ad,
                       (1.0 - 10.0 ** (-safe)) / (safe * LN10))
    if isinstance(e0, torch.Tensor):
        return nonneg(e0) * frac
    return max(e0, 0.0) * frac


def uv_survival(e_avg, dt, p: DisinfectionParams):
    """Exact per-class survival fraction over ``dt`` seconds at average
    fluence rate ``e_avg`` ``[..., Z]`` -> ``[..., P, Z]``."""
    return torch.exp(-p.k_uv[..., :, None] * e_avg[..., None, :] * dt)


def chlorine_demand_rate(toc, Cl, T_C, p: DisinfectionParams):
    """Organics-exerted chlorine demand [mg Cl/L/s], first order in both
    TOC and residual."""
    return p.k_toc * p.theta_toc ** (T_C - 20.0) \
        * nonneg(toc) * nonneg(Cl)


def thm_formation_rate(demand_rate, pH, p: DisinfectionParams):
    """THM formation [ug/L/s] as a pH-enhanced yield on the exerted
    demand."""
    return p.y_thm * 10.0 ** (p.b_ph_thm * (clip(pH, 0.0, 14.0)
                                            - 7.5)) * demand_rate


def log_inactivation(n, n0):
    """log10 removal relative to the reference (inlet) concentration,
    floored so a sterile zone reports a large finite credit."""
    n0 = clip(n0, 1e-30)
    return torch.log10(n0 / clip(n, 1e-30 * n0))


# ---------------------------------------------------------------------------
# Validation (literature oracles + structural invariants)
# ---------------------------------------------------------------------------

def validate_disinfection(verbose: bool = True, device=None) -> bool:
    """EPA table oracles and structural invariants, in float64 on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    p = make_disinfection_params(dtype=torch.float64, device=dev)
    checks = []

    def f64(x):
        return torch.tensor(x, dtype=torch.float64, device=dev)

    def check(name, ok):
        checks.append((name, bool(ok)))
        if verbose:
            print(f"  {'PASS' if ok else 'FAIL'}: {name}")

    ka20 = f64(10.0 ** -7.45)  # pKa_HOCl at 20 C
    one = torch.ones((1,), dtype=torch.float64, device=dev)

    # CT-table reconstruction: at 1 mg/L, pH 7, 20 C the kill integrates
    # to exactly 3 logs over CT_3log minutes, per class
    lam = chlorine_lethality(one, 7.0 * one, 20.0 * one, ka20, p)[..., 0]
    for i, name in enumerate(PATHOGEN_NAMES):
        t3 = 3.0 * LN10 / float(lam[i])
        check(f"CT table reproduced ({name}): "
              f"t(3-log) @1 mg/L = {CT_3LOG_20C_PH7[i]} min",
              abs(t3 / 60.0 - CT_3LOG_20C_PH7[i])
              < 1e-6 * CT_3LOG_20C_PH7[i])

    lam30 = chlorine_lethality(one, 7.0 * one, 30.0 * one, ka20, p)[..., 0]
    check("kill rate doubles per 10 C (theta = 2^0.1)",
          abs(float(lam30[1] / lam[1]) - 2.0) < 1e-9)

    phi7 = float(germicidal_weight(f64(7.0), f64(20.0), ka20, p))
    phi10 = float(germicidal_weight(f64(10.0), f64(20.0), ka20, p))
    phi4 = float(germicidal_weight(f64(4.0), f64(20.0), ka20, p))
    check("phi(pH 7, 20C) = 1 (calibration point)", abs(phi7 - 1.0) < 1e-6)
    check("phi(pH 10) -> r_ocl/phi_ref (OCl- dominated)",
          abs(phi10 - 0.05 / _phi_ref(0.05)) < 0.01)
    check("phi(pH 4) -> 1/phi_ref (pure HOCl)",
          abs(phi4 - 1.0 / _phi_ref(0.05)) < 0.01)

    surv = uv_survival(f64([1.0]), 12.0, p)[..., 2, 0]
    check("UV 12 mJ/cm2 -> 3-log Crypto", abs(float(surv) - 1e-3) < 1e-12)
    surv_g = uv_survival(f64([1.0]), 11.0, p)[..., 1, 0]
    check("UV 11 mJ/cm2 -> 3-log Giardia",
          abs(float(surv_g) - 1e-3) < 1e-12)

    e_clear = float(average_fluence(f64(10.0), f64(1e-9), p))
    check("fluence clear-water limit E_avg -> E0", abs(e_clear - 10.0) < 1e-6)
    e_opaque = float(average_fluence(f64(10.0), f64(2.0), p))
    check("fluence opaque limit E0/(a d ln10)",
          abs(e_opaque - 10.0 / (2.0 * 5.0 * LN10)) < 1e-6)

    a0 = absorbance_254(f64(0.0), f64(0.0), p)
    check("UVT(clean) ~ 95.5%", abs(float(uvt_percent(a0)) - 95.5) < 0.1)
    a1 = absorbance_254(f64(2.0), f64(10.0), p)
    check("UVT(TOC 2, TSS 10) < 70%", float(uvt_percent(a1)) < 70.0)

    r = chlorine_demand_rate(f64(2.0), f64(1.0), f64(20.0), p)
    f75 = float(thm_formation_rate(r, f64(7.5), p) / r)
    f85 = float(thm_formation_rate(r, f64(8.5), p) / r)
    check("THM yield @pH 7.5 = y_thm", abs(f75 - 40.0) < 1e-9)
    check("THM base catalysis = 10^b per pH",
          abs(f85 / f75 - 10 ** 0.15) < 1e-6)

    kday = float(r / 1.0) * 86400.0
    check("bulk demand at TOC 2 ~ 0.5..1.5 1/day", 0.5 < kday < 1.5)

    li = float(log_inactivation(f64(0.0), f64(1e4)))
    check("log_inactivation(0) finite", math.isfinite(li) and li > 20)

    ok = all(s for _, s in checks)
    if verbose:
        print(f"Disinfection validation: "
              f"{'ALL PASS' if ok else 'FAILURES PRESENT'}")
    return ok
