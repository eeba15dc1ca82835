"""
Aqueous carbonate/chlorine chemistry (port of
``ics_wt_physicsengine_tpu/core/chemistry.py`` :63-241).

All functions are elementwise in pH and explicitly parameterized by the
equilibrium constants, so one code path serves single plants and
Monte-Carlo batches whose constants are ``[B]`` tensors (``align_trailing``
pads them against ``[B, Z]`` zone tensors).

The Newton pH solve is a fixed-iteration, masked-update loop: every element
runs the same iterations, and an element stops moving once
``|delta pH| < tol``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.core import thermodynamics as thermo
from ics_wt_physicsengine_torch.device import resolve_device, tensor_from_numpy
from ics_wt_physicsengine_torch.utils.dispatch import align_trailing

LN10 = math.log(10.0)

PH_TOLERANCE = 1e-6
MAX_ITERATIONS = 100
# Newton step cap [pH units/iteration], decayed geometrically per iteration
# so that the solve cannot limit-cycle around a root (same policy as the
# JAX package).
MAX_NEWTON_STEP = 2.0
NEWTON_STEP_DECAY = 0.95


@dataclass(frozen=True)
class ChemistryConstants:
    """Equilibrium constants cached at the buffer temperature: scalars, or
    ``[B]`` tensors for a Monte-Carlo batch."""

    Kw: torch.Tensor
    Ka1: torch.Tensor
    Ka2: torch.Tensor
    Ka_HOCl: torch.Tensor
    C_T_mol: torch.Tensor   # total carbonate [mol/L]
    alk_eq: torch.Tensor    # alkalinity [eq/L]


def make_chemistry_constants(alkalinity, total_carbonate, temperature,
                             dtype=None, device=None) -> ChemistryConstants:
    """Derive the constant bundle from buffer parameters.

    Tensor inputs stay in torch. Python/NumPy inputs are computed in
    float64 NumPy, as the JAX package's host path does, and then become
    ``dtype`` tensors on ``device`` (``None``: the CUDA card)."""
    if any(isinstance(x, torch.Tensor)
           for x in (alkalinity, total_carbonate, temperature)):
        k = ChemistryConstants(
            Kw=thermo.water_ionization_constant(temperature),
            Ka1=10.0 ** (-thermo.carbonate_pKa1(temperature)),
            Ka2=10.0 ** (-thermo.carbonate_pKa2(temperature)),
            Ka_HOCl=10.0 ** (-thermo.pKa_HOCl(temperature)),
            C_T_mol=torch.as_tensor(total_carbonate) / 1000.0,
            alk_eq=torch.as_tensor(alkalinity) / c.ALK_MG_CACO3_PER_EQ,
        )
        if dtype is None:
            return k
        return ChemistryConstants(**{f.name: getattr(k, f.name).to(dtype)
                                     for f in fields(k)})
    values = chemistry_constants_numpy(alkalinity, total_carbonate,
                                       temperature)
    return constants_from_numpy(values, dtype=dtype, device=device)


def chemistry_constants_numpy(alkalinity, total_carbonate,
                              temperature) -> dict:
    """The constant bundle as float64 NumPy values (the host path)."""
    t = np.asarray(temperature, dtype=np.float64)
    return dict(
        Kw=thermo.water_ionization_constant(t),
        Ka1=10.0 ** (-thermo.carbonate_pKa1(t)),
        Ka2=10.0 ** (-thermo.carbonate_pKa2(t)),
        Ka_HOCl=10.0 ** (-thermo.pKa_HOCl(t)),
        C_T_mol=np.asarray(total_carbonate) / 1000.0,
        alk_eq=np.asarray(alkalinity) / c.ALK_MG_CACO3_PER_EQ,
    )


def constants_from_numpy(values, dtype=None,
                         device=None) -> ChemistryConstants:
    """A ``ChemistryConstants`` from a mapping of field name to NumPy
    values (``device.tensor_from_numpy``)."""
    dev = resolve_device(device)
    return ChemistryConstants(**{
        f.name: tensor_from_numpy(values[f.name], dtype, dev)
        for f in fields(ChemistryConstants)})


def H_from_pH(pH):
    return 10.0 ** (-pH)


def alpha_carbonate(pH, Ka1, Ka2):
    """Carbonate speciation fractions (alpha0, alpha1, alpha2)."""
    Ka1 = align_trailing(Ka1, pH)
    Ka2 = align_trailing(Ka2, pH)
    H = H_from_pH(pH)
    D = H * H + Ka1 * H + Ka1 * Ka2
    return H * H / D, Ka1 * H / D, Ka1 * Ka2 / D


def charge_balance_error(pH, k: ChemistryConstants):
    """f(pH) = [H+] - [OH-] + [HCO3-] + 2[CO3--] - alk  [eq/L]."""
    H = H_from_pH(pH)
    OH = align_trailing(k.Kw, pH) / H
    ct = align_trailing(k.C_T_mol, pH)
    _, a1, a2 = alpha_carbonate(pH, k.Ka1, k.Ka2)
    return H - OH + a1 * ct + 2.0 * a2 * ct - align_trailing(k.alk_eq, pH)


def charge_balance_derivative(pH, k: ChemistryConstants):
    """Analytic df/dpH of the charge balance."""
    Kw = align_trailing(k.Kw, pH)
    Ka1 = align_trailing(k.Ka1, pH)
    Ka2 = align_trailing(k.Ka2, pH)
    ct = align_trailing(k.C_T_mol, pH)
    H = H_from_pH(pH)
    dH_dpH = -LN10 * H
    dOH_dpH = -(Kw / (H * H)) * dH_dpH

    D = H * H + Ka1 * H + Ka1 * Ka2
    dD_dH = 2.0 * H + Ka1
    dalpha1_dH = Ka1 * (D - H * dD_dH) / (D * D)
    dalpha2_dH = -Ka1 * Ka2 * dD_dH / (D * D)

    dHCO3_dpH = ct * dalpha1_dH * dH_dpH
    dCO3_dpH = ct * dalpha2_dH * dH_dpH

    return dH_dpH - dOH_dpH + dHCO3_dpH + 2.0 * dCO3_dpH


def solve_pH(k: ChemistryConstants, initial_guess=7.0,
             tolerance: float = PH_TOLERANCE,
             max_iter: int = MAX_ITERATIONS):
    """Fixed-iteration masked Newton-Raphson on the charge balance,
    elementwise over the shape of ``initial_guess`` and the constants.
    Converged elements freeze; the step is capped at
    ``MAX_NEWTON_STEP * NEWTON_STEP_DECAY**i`` and pH is clipped to [0, 14].
    """
    pH = torch.as_tensor(initial_guess, dtype=k.Kw.dtype,
                         device=k.Kw.device)
    done = torch.zeros_like(pH, dtype=torch.bool)
    for i in range(max_iter):
        f = charge_balance_error(pH, k)
        df = charge_balance_derivative(pH, k)
        cap = MAX_NEWTON_STEP * NEWTON_STEP_DECAY ** i
        delta = torch.clip(-f / df, -cap, cap)
        pH_new = torch.clip(pH + delta, 0.0, 14.0)
        newly_done = torch.abs(delta) < tolerance
        pH = torch.where(done, pH, pH_new)
        done = done | newly_done
    return pH


def buffering_capacity(pH, k: ChemistryConstants):
    """beta(pH) = water + carbonate contributions."""
    H = H_from_pH(pH)
    beta_water = 2.303 * (H + align_trailing(k.Kw, pH) / H)
    a0, a1, a2 = alpha_carbonate(pH, k.Ka1, k.Ka2)
    beta_carb = 2.303 * align_trailing(k.C_T_mol, pH) \
        * (a0 * a1 + 4.0 * a1 * a2 + a0 * a2)
    return beta_water + beta_carb


def hocl_fraction(pH, Ka_HOCl):
    """alpha_HOCl = [H+] / ([H+] + Ka)."""
    H = H_from_pH(pH)
    return H / (H + align_trailing(Ka_HOCl, pH))


def pH_dependent_chlorine_decay_factor(pH, Ka_HOCl):
    """Weighted decay multiplier: HOCl at 1.0, OCl- at 0.02."""
    a_hocl = hocl_fraction(pH, Ka_HOCl)
    return a_hocl * 1.0 + (1.0 - a_hocl) * c.K_OCL_RELATIVE
