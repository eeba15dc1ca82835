"""
Temperature-dependent kinetics and equilibria (port of
``ics_wt_physicsengine_tpu/core/thermodynamics.py``).

Every quantity is an elementwise function of temperature. The functions run
on torch tensors (the hot path) and on NumPy values (host-side parameter
construction, which must match the JAX package's float64 NumPy results bit
for bit). Temperatures are clamped into the liquid range [0, 100] C instead
of raising, as in the reference package; ``check_liquid_water_range`` is
the host-side gate, and the ``TemperatureDependentKinetics`` class raises
through it as the reference simulator's class does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.utils.dispatch import align_trailing, clip

# Module-level aliases of the reference simulator's names; the values live
# in core/constants.py.
R_GAS = c.R_GAS
T_REFERENCE_K = c.T_REFERENCE_K
T_REFERENCE_C = c.T_REFERENCE_C


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


def celsius_to_kelvin(temp_c):
    """C -> K, clamped to the liquid-water range [0, 100] C."""
    if isinstance(temp_c, torch.Tensor):
        return clip(temp_c, c.T_MIN_C, c.T_MAX_C) + 273.15
    return np.clip(temp_c, c.T_MIN_C, c.T_MAX_C) + 273.15


def arrhenius_rate(temp_c, k_ref=c.CL_DECAY_K_REF, e_a=c.CL_DECAY_EA,
                   t_ref_k=c.T_REFERENCE_K):
    """k(T) = k_ref * exp[-Ea/R * (1/T - 1/T_ref)]."""
    t_k = celsius_to_kelvin(temp_c)
    e_a = align_trailing(e_a, t_k)
    exponent = -(e_a / c.R_GAS) * (1.0 / t_k - 1.0 / t_ref_k)
    return align_trailing(k_ref, t_k) * _exp(exponent)


def chlorine_decay_rate(temp_c, k_ref=c.CL_DECAY_K_REF, e_a=c.CL_DECAY_EA):
    """First-order chlorine decay constant [1/s]."""
    return arrhenius_rate(temp_c, k_ref=k_ref, e_a=e_a)


def water_ionization_constant(temp_c):
    """Kw(T) via Van't Hoff."""
    t_k = celsius_to_kelvin(temp_c)
    exponent = (c.DELTA_H_WATER / c.R_GAS) * (1.0 / c.T_25C_K - 1.0 / t_k)
    return c.KW_25C * _exp(exponent)


def neutral_pH(temp_c):
    """Neutral pH = 0.5 * pKw(T)."""
    kw = water_ionization_constant(temp_c)
    if isinstance(kw, torch.Tensor):
        return -0.5 * torch.log10(kw)
    return -0.5 * np.log10(kw)


def carbonate_pKa1(temp_c):
    """pKa1(T) = 6.35 - 0.008*(T - 25)."""
    return c.PKA1_25C + c.DPKA_DT * (temp_c - 25.0)


def carbonate_pKa2(temp_c):
    """pKa2(T) = 10.33 - 0.008*(T - 25)."""
    return c.PKA2_25C + c.DPKA_DT * (temp_c - 25.0)


def pKa_HOCl(temp_c):
    """HOCl dissociation pKa(T) = 7.5 + 0.01*(T - 25)."""
    return c.PKA_HOCL_25C + c.DPKA_HOCL_DT * (temp_c - 25.0)


def diffusion_coefficient(temp_c, viscosity_ratio=None):
    """Stokes-Einstein D(T) with the water-viscosity model."""
    t_k = celsius_to_kelvin(temp_c)
    if viscosity_ratio is None:
        exponent = c.VISCOSITY_EXP_COEFF * (1.0 / t_k - 1.0 / c.T_REFERENCE_K)
        viscosity_ratio = _exp(-exponent)
    return c.D_MOLECULAR_REF * (t_k / c.T_REFERENCE_K) * viscosity_ratio


def temperature_compensation_factor(temp_c, ref_temp_c=c.T_REFERENCE_C):
    """k(T) / k(T_ref) ratio."""
    return chlorine_decay_rate(temp_c) / chlorine_decay_rate(ref_temp_c)


def check_liquid_water_range(temp_c) -> None:
    """The reference simulator's hard temperature gate, host-side: raises
    ValueError outside [0, 100] C."""
    t = temp_c.detach().cpu().numpy() if isinstance(temp_c, torch.Tensor) \
        else np.asarray(temp_c)
    if np.any(t < c.T_MIN_C) or np.any(t > c.T_MAX_C):
        raise ValueError(
            f"Temperature {t} C outside liquid water range "
            f"[{c.T_MIN_C}, {c.T_MAX_C}] C. This indicates invalid input "
            f"data or numerical instability in the integration."
        )


# ---------------------------------------------------------------------------
# Object API
# ---------------------------------------------------------------------------


@dataclass
class ArrheniusParameters:
    """Arrhenius parameter bundle."""

    k_ref: float
    E_a: float
    T_ref: float = c.T_REFERENCE_K

    def validate(self) -> None:
        if self.k_ref <= 0:
            raise ValueError(
                f"Rate constant must be positive: k_ref={self.k_ref}")
        if self.E_a < 0:
            raise ValueError(
                f"Activation energy must be non-negative: E_a={self.E_a}")
        if self.T_ref < 273.15 or self.T_ref > 373.15:
            raise ValueError(
                f"Reference temperature out of water range: "
                f"T_ref={self.T_ref}K"
            )


class TemperatureDependentKinetics:
    """The reference simulator's kinetics class: thin shims over the
    functions above that raise outside the liquid range. Methods take
    Python/NumPy values (host results) or tensors."""

    CHLORINE_DECAY = ArrheniusParameters(
        k_ref=c.CL_DECAY_K_REF, E_a=c.CL_DECAY_EA, T_ref=c.T_REFERENCE_K
    )
    DELTA_H_WATER = c.DELTA_H_WATER
    KW_25C = c.KW_25C
    PKA1_25C = c.PKA1_25C
    PKA2_25C = c.PKA2_25C
    DPKA_DT = c.DPKA_DT
    D_MOLECULAR_REF = c.D_MOLECULAR_REF
    T_MIN_C = c.T_MIN_C
    T_MAX_C = c.T_MAX_C
    TOLERANCE_KINETICS = 1e-10
    TOLERANCE_EQUILIBRIUM = 1e-6
    TOLERANCE_PH = 1e-4

    def __init__(self):
        self.CHLORINE_DECAY.validate()

    @staticmethod
    def celsius_to_kelvin(temp_c):
        check_liquid_water_range(temp_c)
        return celsius_to_kelvin(temp_c)

    def arrhenius_rate(self, temp_c,
                       params: Optional[ArrheniusParameters] = None):
        if params is None:
            params = self.CHLORINE_DECAY
        check_liquid_water_range(temp_c)
        return arrhenius_rate(temp_c, k_ref=params.k_ref, e_a=params.E_a,
                              t_ref_k=params.T_ref)

    def water_ionization_constant(self, temp_c):
        check_liquid_water_range(temp_c)
        return water_ionization_constant(temp_c)

    def neutral_pH(self, temp_c):
        check_liquid_water_range(temp_c)
        return neutral_pH(temp_c)

    def carbonate_pKa(self, temp_c, dissociation: int = 1):
        if dissociation not in (1, 2):
            raise ValueError(
                f"Dissociation must be 1 or 2, got {dissociation}")
        return carbonate_pKa1(temp_c) if dissociation == 1 \
            else carbonate_pKa2(temp_c)

    def diffusion_coefficient(self, temp_c, viscosity_ratio: float = 1.0):
        check_liquid_water_range(temp_c)
        vr = None if viscosity_ratio == 1.0 else viscosity_ratio
        return diffusion_coefficient(temp_c, viscosity_ratio=vr)

    def chlorine_decay_rate(self, temp_c):
        check_liquid_water_range(temp_c)
        return chlorine_decay_rate(temp_c)

    def temperature_compensation_factor(self, temp_c,
                                        ref_temp_c=c.T_REFERENCE_C):
        return temperature_compensation_factor(temp_c, ref_temp_c)


def validate_thermodynamics() -> None:
    """Literature-value oracle suite (host-side)."""
    kinetics = TemperatureDependentKinetics()

    k_ref = float(kinetics.chlorine_decay_rate(c.T_REFERENCE_C))
    assert abs(k_ref - 1e-4) < kinetics.TOLERANCE_KINETICS, \
        f"k_ref mismatch: {k_ref}"

    kw_25 = float(kinetics.water_ionization_constant(25.0))
    assert abs(kw_25 - 1e-14) < kinetics.TOLERANCE_EQUILIBRIUM * 1e-14, \
        f"Kw: {kw_25}"

    ph_n_25 = float(kinetics.neutral_pH(25.0))
    assert abs(ph_n_25 - 7.0) < kinetics.TOLERANCE_PH, f"pH(25C): {ph_n_25}"

    pka1_25 = float(kinetics.carbonate_pKa(25.0, 1))
    assert abs(pka1_25 - 6.35) < kinetics.TOLERANCE_PH, \
        f"pKa1(25C): {pka1_25}"

    k_values = [float(kinetics.chlorine_decay_rate(t))
                for t in (0, 10, 20, 30, 40)]
    assert all(a < b for a, b in zip(k_values, k_values[1:])), \
        "Decay rate should increase with temperature"

    q10 = float(kinetics.chlorine_decay_rate(30.0)
                / kinetics.chlorine_decay_rate(20.0))
    assert 1.5 < q10 < 2.5, f"Q10 = {q10:.3f} outside [1.5, 2.5]"

    for bad_t in (-10.0, 110.0):
        try:
            kinetics.celsius_to_kelvin(bad_t)
        except ValueError:
            pass
        else:
            raise AssertionError(f"Should have raised for T={bad_t}C")

    print("All thermodynamic validations passed")
