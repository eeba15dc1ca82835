"""
Aqueous carbonate/chlorine chemistry (port of
``ics_wt_physicsengine_tpu/core/chemistry.py``).

All functions are elementwise in pH and explicitly parameterized by the
equilibrium constants, so one code path serves single plants and
Monte-Carlo batches whose constants are ``[B]`` tensors (``align_trailing``
pads them against ``[B, Z]`` zone tensors).

The Newton pH solve is a fixed-iteration, masked-update loop: every element
runs the same iterations, and an element stops moving once
``|delta pH| < tol``. ``solve_pH`` is that loop step by step in PyTorch;
``ops/ph_solver.py`` holds the same solve as one CUDA kernel, which
``pH_after_alkalinity_shift`` reaches for CUDA tensors. ``solve_pH_host``
and the ``AqueousChemistry`` class compute on the host in float64 NumPy
(the formulas below take NumPy values as well as tensors).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.core import thermodynamics as thermo
from ics_wt_physicsengine_torch.device import resolve_device, tensor_from_numpy
from ics_wt_physicsengine_torch.utils.dispatch import (absolute,
                                                       align_trailing, clip)

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


def pH_from_H(H):
    if isinstance(H, torch.Tensor):
        return -torch.log10(H)
    return -np.log10(H)


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
        delta = clip(-f / df, -cap, cap)
        pH_new = clip(pH + delta, 0.0, 14.0)
        newly_done = absolute(delta) < tolerance
        pH = torch.where(done, pH, pH_new)
        done = done | newly_done
    return pH


def solve_pH_host(k: ChemistryConstants, initial_guess=7.0,
                  tolerance: float = PH_TOLERANCE,
                  max_iter: int = MAX_ITERATIONS) -> float:
    """Host-side (NumPy scalar) Newton-Raphson with an early exit and a
    RuntimeError on non-convergence or a vanishing derivative; ``k`` holds
    NumPy values. Used by ``AqueousChemistry``; ``solve_pH`` above is the
    device path."""
    pH = float(initial_guess)
    f = float("nan")
    for i in range(max_iter):
        f = float(charge_balance_error(np.float64(pH), k))
        df = float(charge_balance_derivative(np.float64(pH), k))
        if abs(df) < 1e-15:
            raise RuntimeError(
                f"Derivative too small at pH={pH:.3f}, cannot continue")
        cap = MAX_NEWTON_STEP * NEWTON_STEP_DECAY ** i
        delta = min(max(-f / df, -cap), cap)
        pH_new = min(max(pH + delta, 0.0), 14.0)
        if abs(delta) < tolerance:
            return pH_new
        pH = pH_new
    raise RuntimeError(
        f"pH calculation did not converge after {max_iter} iterations. "
        f"Final pH={pH:.3f}, error={f:.2e}")


def pH_after_alkalinity_shift(k: ChemistryConstants, delta_alk_eq,
                              current_pH):
    """Re-solve pH after shifting alkalinity by ``delta_alk_eq`` [eq/L],
    the primitive behind strong acid/base addition. CUDA tensors go through
    the fused Newton kernel (``ops.ph_solver.solve_pH_auto``), CPU tensors
    through ``solve_pH``."""
    # imported here: ops.ph_solver imports this module
    from ics_wt_physicsengine_torch.ops.ph_solver import solve_pH_auto

    return solve_pH_auto(replace(k, alk_eq=k.alk_eq + delta_alk_eq),
                         current_pH)


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


# ---------------------------------------------------------------------------
# Object API (host NumPy float64, as in the JAX package)
# ---------------------------------------------------------------------------


@dataclass
class BufferSystem:
    """Buffer parameters."""

    alkalinity: float              # [mg/L as CaCO3]
    total_carbonate: float         # [mmol/L]
    temperature: float = 20.0      # [C]

    def validate(self) -> None:
        if self.alkalinity < 0:
            raise ValueError(
                f"Alkalinity cannot be negative: {self.alkalinity}")
        if self.total_carbonate < 0:
            raise ValueError(
                f"Total carbonate cannot be negative: {self.total_carbonate}"
            )
        if self.temperature < 0 or self.temperature > 40:
            warnings.warn(
                f"Temperature {self.temperature}C outside typical range "
                "[0, 40]"
            )


class AqueousChemistry:
    """The reference simulator's chemistry class over the functions above.
    It computes on the host in NumPy float64 and touches no device;
    ``constants`` holds NumPy values."""

    CACO3_MW = c.CACO3_MW
    PH_TOLERANCE = PH_TOLERANCE
    MAX_ITERATIONS = MAX_ITERATIONS

    def __init__(self, buffer_system: BufferSystem):
        buffer_system.validate()
        self.buffer = buffer_system
        self.thermo = thermo.TemperatureDependentKinetics()
        self._update_temperature_constants()

    def _update_temperature_constants(self) -> None:
        self.constants = ChemistryConstants(**chemistry_constants_numpy(
            self.buffer.alkalinity, self.buffer.total_carbonate,
            self.buffer.temperature))
        self.Kw = float(self.constants.Kw)
        self.pKw = -math.log10(self.Kw)
        self.pKa1 = float(thermo.carbonate_pKa1(self.buffer.temperature))
        self.Ka1 = float(self.constants.Ka1)
        self.pKa2 = float(thermo.carbonate_pKa2(self.buffer.temperature))
        self.Ka2 = float(self.constants.Ka2)
        self.pKa_HOCl = float(thermo.pKa_HOCl(self.buffer.temperature))
        self.Ka_HOCl = float(self.constants.Ka_HOCl)

    def H_from_pH(self, pH):
        return H_from_pH(np.asarray(pH))

    def pH_from_H(self, H):
        return pH_from_H(np.asarray(H))

    def alpha_carbonate(self, pH):
        return alpha_carbonate(np.asarray(pH),
                               self.constants.Ka1, self.constants.Ka2)

    def charge_balance_error(self, pH):
        return charge_balance_error(np.asarray(pH), self.constants)

    def charge_balance_derivative(self, pH):
        return charge_balance_derivative(np.asarray(pH), self.constants)

    def calculate_pH(self, initial_guess: float = 7.0,
                     tolerance: float = PH_TOLERANCE,
                     max_iter: int = MAX_ITERATIONS):
        return solve_pH_host(self.constants, initial_guess,
                             tolerance=tolerance, max_iter=max_iter)

    def _shifted(self, delta_alk_eq: float) -> ChemistryConstants:
        return replace(self.constants,
                       alk_eq=self.constants.alk_eq + delta_alk_eq)

    def add_acid(self, volume_L: float, acid_mol: float, current_pH: float):
        """New pH after strong-acid addition."""
        return solve_pH_host(self._shifted(-(acid_mol / volume_L)),
                             initial_guess=current_pH)

    def add_base(self, volume_L: float, base_mol: float, current_pH: float):
        """New pH after strong-base addition."""
        return solve_pH_host(self._shifted(base_mol / volume_L),
                             initial_guess=current_pH)

    def buffering_capacity(self, pH):
        return buffering_capacity(np.asarray(pH), self.constants)

    def chlorine_speciation(self, total_chlorine_mg_L, pH):
        a_hocl = hocl_fraction(np.asarray(pH), self.constants.Ka_HOCl)
        a_ocl = 1.0 - a_hocl
        return {
            "HOCl": a_hocl * total_chlorine_mg_L,
            "OCl": a_ocl * total_chlorine_mg_L,
            "HOCl_fraction": a_hocl,
            "OCl_fraction": a_ocl,
            "effective_disinfection": a_hocl,
        }

    def pH_dependent_chlorine_decay_factor(self, pH):
        return pH_dependent_chlorine_decay_factor(
            np.asarray(pH), self.constants.Ka_HOCl)


def validate_chemistry() -> None:
    """Oracle suite of the chemistry class (host-side)."""
    buffer = BufferSystem(alkalinity=100, total_carbonate=2.0, temperature=20)
    chemistry = AqueousChemistry(buffer)

    pH = chemistry.calculate_pH()
    assert 6.0 < pH < 9.0, f"pH {pH} outside expected range"

    a0, a1, a2 = chemistry.alpha_carbonate(pH)
    assert abs(float(a0 + a1 + a2) - 1.0) < 1e-6, "Alphas don't sum to 1"

    pH_after_acid = chemistry.add_acid(1000, 0.001, pH)
    assert pH_after_acid < pH, "Acid should decrease pH"

    pH_after_base = chemistry.add_base(1000, 0.001, pH)
    assert pH_after_base > pH, "Base should increase pH"

    beta_635 = float(chemistry.buffering_capacity(6.35))
    beta_80 = float(chemistry.buffering_capacity(8.0))
    assert beta_635 > beta_80, "Buffering should be stronger near pKa"

    spec = chemistry.chlorine_speciation(2.0, 7.0)
    assert abs(float(spec["HOCl"] + spec["OCl"]) - 2.0) < 1e-6, \
        "Chlorine doesn't balance"

    print("All chemistry validations passed")
