"""
Temperature-dependent kinetics and equilibria (port of
``ics_wt_physicsengine_tpu/core/thermodynamics.py`` :43-111).

Every quantity is an elementwise function of temperature. The functions run
on torch tensors (the hot path) and on NumPy values (host-side parameter
construction, which must match the JAX package's float64 NumPy results bit
for bit). Temperatures are clamped into the liquid range [0, 100] C instead
of raising, as in the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.utils.dispatch import align_trailing


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


def celsius_to_kelvin(temp_c):
    """C -> K, clamped to the liquid-water range [0, 100] C."""
    if isinstance(temp_c, torch.Tensor):
        return torch.clip(temp_c, c.T_MIN_C, c.T_MAX_C) + 273.15
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
