"""
Particle dynamics: suspended solids, settling, coagulation, filtration (port
of ``ics_wt_physicsengine_tpu/core/particles.py``).

A fixed number of particle size classes is carried as one ``[..., C, Z]``
tensor (class axis ahead of the zone axis), so the exchange stencil and the
settling stencil both vectorize over classes.

- Gravitational settling (Stokes law) toward zone 0, the tank bottom, which
  deposits into a per-class sludge inventory (mg/L of bottom-zone volume).
- Resuspension of sludge, and a ``sludge_blowdown`` boundary input [1/s].
- Coagulation: a ``coagulant_dose`` [mg/L] drives a mass-conserving
  aggregation chain fine -> medium -> coarse with a Monod dose response.
- Recirculating filtration: a ``filter_flow_rate`` [L/min] through a
  granular filter with per-class capture at the outlet zone.
- Turbidity: NTU = sum_c k_ntu[c] * tss[c] (fines scatter more per mass).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE,
                                               dataclass_from_numpy,
                                               numpy_dtype, resolve_device)
from ics_wt_physicsengine_torch.utils.dispatch import absolute, align_trailing

G_GRAVITY = 9.80665          # [m/s^2]

# canonical three size classes (diameters in meters): fine clay/silt,
# silt/small floc, large floc / grit
N_CLASSES = 3
DEFAULT_DIAMETERS_M = (2e-6, 10e-6, 50e-6)
DEFAULT_DENSITY = 2650.0     # [kg/m^3] silica
# NTU per mg/L per class: scattering efficiency per mass falls with size
DEFAULT_NTU_PER_MGL = (3.0, 1.0, 0.25)
# granular-media single-pass capture per class: fines pass, flocs caught
DEFAULT_FILTER_EFF = (0.35, 0.85, 0.99)


def water_viscosity(T_C):
    """Dynamic viscosity of water [Pa s], Vogel/VFT fit:
    1.0016 mPa s at 20 C, 0.890 at 25 C, 0.547 at 50 C."""
    T = T_C + 273.15
    return 1e-3 * torch.exp(-3.7188 + 578.919 / (T - 137.546))


def stokes_velocity(diameter_m, rho_p, T_C):
    """Stokes terminal settling velocity [m/s] (laminar regime)."""
    rho_w = 998.2   # the (rho_p - rho_w) contrast dwarfs rho_w(T)
    contrast = align_trailing(rho_p - rho_w, diameter_m)  # [B] vs [B, C]
    return G_GRAVITY * contrast * diameter_m ** 2 \
        / (18.0 * water_viscosity(T_C))


@dataclass(frozen=True)
class ParticleParams:
    """Particle-dynamics parameters: 0-d tensors and ``[C]`` class vectors,
    with a leading ``[B]`` axis for a batch."""

    diameters_m: torch.Tensor = None      # [C]
    density_kgm3: torch.Tensor = None     # particle density
    inlet_fractions: torch.Tensor = None  # [C] source-water class split
    ntu_per_mgl: torch.Tensor = None      # [C] turbidity weights
    filter_eff: torch.Tensor = None       # [C] single-pass capture
    k_coag: torch.Tensor = None           # [1/s] max aggregation rate
    K_dose: torch.Tensor = None           # [mg/L] coagulant half-sat
    k_resuspension: torch.Tensor = None   # [1/s] sludge re-entrainment


def particle_params_numpy(np_dtype=np.float64,
                          diameters_m=DEFAULT_DIAMETERS_M,
                          density_kgm3=DEFAULT_DENSITY,
                          inlet_fractions=(0.5, 0.35, 0.15),
                          ntu_per_mgl=DEFAULT_NTU_PER_MGL,
                          filter_eff=DEFAULT_FILTER_EFF,
                          k_coag=2e-3, K_dose=10.0,
                          k_resuspension=1e-6) -> dict:
    """The parameter fields as NumPy values of ``np_dtype``; the inlet
    fractions are normalized in that type, as in the JAX package."""
    a = lambda x: np.asarray(x, np_dtype)  # noqa: E731
    fr = a(inlet_fractions)
    return dict(
        diameters_m=a(diameters_m), density_kgm3=a(density_kgm3),
        inlet_fractions=fr / fr.sum(axis=-1, keepdims=True),
        ntu_per_mgl=a(ntu_per_mgl), filter_eff=a(filter_eff),
        k_coag=a(k_coag), K_dose=a(K_dose),
        k_resuspension=a(k_resuspension))


def make_particle_params(dtype=DEFAULT_DTYPE, device=None, **overrides
                         ) -> ParticleParams:
    """``ParticleParams`` on ``device`` (``None``: the CUDA card);
    ``overrides`` replace the defaults of ``particle_params_numpy``."""
    return dataclass_from_numpy(
        ParticleParams,
        particle_params_numpy(numpy_dtype(dtype), **overrides), dtype, device)


def settling_rates(p: ParticleParams, T_surface, zone_height):
    """Per-class settling rate w/h [1/s] at one representative
    temperature."""
    w = stokes_velocity(p.diameters_m, p.density_kgm3, T_surface)
    return w / align_trailing(zone_height, w)


def settling_rates_zonal(p: ParticleParams, T_zone, zone_height):
    """Per-class, per-zone settling rate w/h [1/s], each zone's Stokes
    velocity from its own temperature's viscosity
    (``[..., Z] -> [..., C, Z]``)."""
    contrast = align_trailing(p.density_kgm3 - 998.2, p.diameters_m)
    w_c = G_GRAVITY * contrast * p.diameters_m ** 2 / 18.0  # mu-free
    w_cz = w_c[..., :, None] / water_viscosity(T_zone)[..., None, :]
    return w_cz / align_trailing(zone_height, w_cz)


def settle(x, rate_cz, top_mask=None, bottom_mask=None):
    """Upwind settling stencil on ``x[..., C, Z]`` with per-class rates
    ``rate_cz`` (``[..., C, 1]`` or ``[..., C, Z]``; zone 0 = bottom).
    Returns ``(dx, deposit)``: the in-column tendency and the per-class
    bottom deposition flux [mg/L/s of bottom-zone volume].

    ``top_mask``/``bottom_mask`` (``[..., Z]`` one-hot floats) relocate
    the no-receive condition and the deposit extraction away from the
    array ends (a zone-sharded domain); None keeps the array ends."""
    fall = rate_cz * x                        # downward flux out of each zone
    zeros = torch.zeros_like(x[..., :1])
    # zone i receives zone i+1's fall; the top zone receives nothing
    recv = torch.cat([fall[..., 1:], zeros], dim=-1)
    if top_mask is not None:
        recv = recv * (1.0 - top_mask[..., None, :])
    if bottom_mask is None:
        deposit = fall[..., 0]                # bottom zone -> sludge
    else:
        deposit = torch.sum(fall * bottom_mask[..., None, :], dim=-1)
    return recv - fall, deposit


def coagulation_chain(x, dose, p: ParticleParams):
    """First-order aggregation chain fine -> ... -> coarse with Monod dose
    response; returns the per-class tendency (mass-conserving)."""
    rate = p.k_coag * dose / (dose + p.K_dose)
    up = align_trailing(rate, x) * x          # flux leaving each class
    # the coarsest class aggregates no further
    last = torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)[-1]
    up = up * (1.0 - last[..., :, None])
    zeros = torch.zeros_like(x[..., :1, :])
    recv = torch.cat([zeros, up[..., :-1, :]], dim=-2)
    return recv - up


def turbidity_ntu(tss_cz, p: ParticleParams):
    """Turbidity [NTU] per zone from the class concentrations
    ``[..., C, Z]`` -> ``[..., Z]``."""
    return torch.sum(p.ntu_per_mgl[..., :, None] * tss_cz, dim=-2)


def turbidity_ntu_tap(tss_c, p: ParticleParams):
    """Turbidity [NTU] at one zone tap: ``[..., C]`` -> ``[...]``."""
    return torch.sum(p.ntu_per_mgl * tss_c, dim=-1)


def total_solids_mgl(tss_cz):
    """Total suspended solids [mg/L] per zone."""
    return torch.sum(tss_cz, dim=-2)


# ---------------------------------------------------------------------------
# Validation (literature oracles + structural invariants)
# ---------------------------------------------------------------------------

def validate_particles(verbose: bool = True, device=None) -> bool:
    """Literature oracles and structural invariants, in float64 on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    checks = []

    def f64(x):
        return torch.tensor(x, dtype=torch.float64, device=dev)

    def check(name, ok):
        checks.append((name, bool(ok)))
        if verbose:
            print(f"  {'PASS' if ok else 'FAIL'}: {name}")

    # viscosity oracles (CRC): 1.0016 mPa s @ 20 C, 0.890 @ 25 C
    check("water viscosity at 20 C = 1.002 mPa s",
          abs(float(water_viscosity(f64(20.0))) * 1e3 - 1.0016) < 0.01)
    check("water viscosity at 25 C = 0.890 mPa s",
          abs(float(water_viscosity(f64(25.0))) * 1e3 - 0.890) < 0.01)

    # Stokes oracle: 10 um silica (2650 kg/m3) at 20 C ~ 0.090 mm/s
    v10 = float(stokes_velocity(f64(10e-6), f64(2650.0), f64(20.0)))
    check("Stokes velocity, 10 um silica at 20 C ~ 0.090 mm/s",
          abs(v10 * 1e3 - 0.0899) < 0.003)
    v20 = float(stokes_velocity(f64(20e-6), f64(2650.0), f64(20.0)))
    check("Stokes velocity scales as d^2", abs(v20 / v10 - 4.0) < 1e-9)
    v10w = float(stokes_velocity(f64(10e-6), f64(2650.0), f64(30.0)))
    check("settling faster in warm water", v10w > v10)

    p = make_particle_params(dtype=torch.float64, device=dev)

    # settling stencil conserves mass: column loss == bottom deposit
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        1.0, 5.0, (N_CLASSES, 6))).to(dev)
    rate = settling_rates(p, f64(20.0), f64(0.4))[..., None]
    dx, dep = settle(x, rate)
    col = float(torch.sum(dx))
    tol = 1e-6 * float(torch.sum(absolute(dx)))
    check("settling conserves mass (column loss = deposit)",
          abs(col + float(torch.sum(dep))) < tol)
    check("top zone receives nothing from above",
          bool((dx[..., -1] < 0.0).all()))

    # coagulation chain conserves total mass and moves it coarser
    dxc = coagulation_chain(x, f64(30.0), p)
    check("coagulation conserves mass across classes",
          abs(float(torch.sum(dxc)))
          < 1e-6 * float(torch.sum(absolute(dxc))))
    check("coagulation drains the finest class",
          bool((dxc[..., 0, :] < 0.0).all()))
    check("coagulation feeds the coarsest class",
          bool((dxc[..., -1, :] > 0.0).all()))
    check("no dose, no coagulation",
          float(torch.max(absolute(
              coagulation_chain(x, f64(0.0), p)))) == 0.0)

    # turbidity: fines dominate per unit mass
    fine = torch.zeros((N_CLASSES, 1), dtype=torch.float64, device=dev)
    fine[0, 0] = 1.0
    coarse = torch.zeros_like(fine)
    coarse[-1, 0] = 1.0
    ntu_fine = float(turbidity_ntu(fine, p)[0])
    ntu_coarse = float(turbidity_ntu(coarse, p)[0])
    check("fines scatter more per mg/L", ntu_fine > 2.0 * ntu_coarse)
    check("turbidity is linear in concentration",
          abs(float(turbidity_ntu(2.0 * fine, p)[0]) - 2.0 * ntu_fine)
          < 1e-12)

    ok = all(s for _, s in checks)
    if verbose:
        print(f"Particle dynamics validation: "
              f"{'ALL PASS' if ok else 'FAILURES PRESENT'}")
    return ok


if __name__ == "__main__":
    # python -m ics_wt_physicsengine_torch.core.particles [--device cpu]:
    # exits 1 when a check fails
    from ics_wt_physicsengine_torch.device import module_device

    raise SystemExit(0 if validate_particles(device=module_device(
        description="The particle dynamics validation suite, on the CUDA card "
                    "unless --device names another device.")) else 1)
