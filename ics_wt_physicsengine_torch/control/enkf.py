"""
Ensemble Kalman filter over the full plant state (port of
``ics_wt_physicsengine_tpu/control/enkf.py``).

The EKF (``control/ekf.py``) linearizes the plant and carries an explicit
[n, n] covariance. The EnKF replaces both with a Monte-Carlo ensemble: N
copies of the plant state step through the full nonlinear
``core.reactor.step`` as one batch (the step is natively batched: the
members are its leading axis, where the JAX package maps the step with
``jax.vmap``), and the update works on ensemble anomalies; memory is
O(N n) instead of O(n^2).

- Measurement updates run one channel at a time in scalar ensemble form;
  a NaN reading zeroes its channel's innovations.
- Perturbed observations (stochastic EnKF) with centered perturbations;
  every anomaly statistic divides by N - 1.
- Multiplicative inflation and Gaspari-Cohn zone localization (the taper
  is built on the host in float64 NumPy).
- Randomness: the carry holds a ``torch.Generator`` where the JAX package
  carries a PRNG key; a step may instead be given its draws (``w``,
  ``eps_all``, shaped as the JAX step draws them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ics_wt_physicsengine_torch.control.ekf import (
    _Cast, _axes, _flat_bounds_numpy, _measurement_noise, _process_noise,
    _tap_row, field_diag, flatten_state, state_fields, unflatten_state)
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.utils.dispatch import clip


@dataclass
class EnKFCarry:
    ensemble: torch.Tensor            # [N, n] member states
    generator: Optional[torch.Generator]   # drives the noise draws


def make_enkf_carry(state0: R.ReactorState, p0, n_zones: int,
                    n_ensemble: int, generator=None,
                    pert: Optional[torch.Tensor] = None) -> EnKFCarry:
    """Initial ensemble from a (possibly wrong) state guess, on the
    state's device.

    Members are drawn ~ N(flatten(state0), diag(p0)) (``p0`` as in
    :func:`ekf.make_ekf_carry`), then clipped to the physical bounds.
    ``generator`` (a ``torch.Generator`` on the state's device, or an int
    seed for a new one) rides the carry; ``pert``: optional ``[N, n]``
    standard normal draws to use instead of drawing."""
    if n_ensemble < 2:
        raise ValueError(f"n_ensemble must be >= 2 (anomaly statistics "
                         f"divide by N-1), got {n_ensemble}")
    nitrogen = state0.ammonia is not None
    gas = state0.oxygen is not None
    biofilm = state0.bacteria is not None
    tss = getattr(state0, "tss", None)
    n_cls = 0 if tss is None else tss.shape[-2]
    x0 = flatten_state(state0)
    n = x0.shape[-1]
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=x0.device).manual_seed(
            0 if generator is None else int(generator))
    diag = field_diag(p0, n_zones, nitrogen, gas, biofilm, n_cls,
                      x0.dtype, device=x0.device)
    if pert is None:
        pert = torch.randn((n_ensemble, n), generator=generator,
                           dtype=x0.dtype, device=x0.device)
    pert = torch.as_tensor(pert, dtype=x0.dtype, device=x0.device)
    pert = pert - torch.mean(pert, dim=0)        # centered: mean == x0
    lo, hi = _flat_bounds_numpy(n_zones, nitrogen, gas, biofilm, n_cls)
    lo, hi = _Cast(lo)(x0), _Cast(hi)(x0)
    ens = clip(x0[None, :] + pert * torch.sqrt(diag)[None, :], lo, hi)
    # Clipping a bound-adjacent guess with a wide p0 shifts the mean away
    # from x0 one-sidedly: pull it back and re-clip a few fixed times
    for _ in range(4):
        ens = clip(ens + (x0 - torch.mean(ens, dim=0))[None, :], lo, hi)
    return EnKFCarry(ensemble=ens, generator=generator)


def _gaspari_cohn(d: np.ndarray, c: float) -> np.ndarray:
    """Gaspari-Cohn (1999) 5th-order compact taper: 1 at distance 0, 0
    beyond 2c."""
    r = np.asarray(d, np.float64) / float(c)
    near = (-0.25 * r**5 + 0.5 * r**4 + 0.625 * r**3
            - (5.0 / 3.0) * r**2 + 1.0)
    rs = np.maximum(r, 1e-12)                  # guard the 1/r branch
    far = (r**5 / 12.0 - 0.5 * r**4 + 0.625 * r**3
           + (5.0 / 3.0) * r**2 - 5.0 * r + 4.0 - 2.0 / (3.0 * rs))
    out = np.where(r <= 1.0, near, np.where(r <= 2.0, far, 0.0))
    return np.maximum(out, 0.0)


def _entry_zones(n_zones: int, n_fields: int, n_cls: int) -> np.ndarray:
    """Zone index of every flat-state entry (-1: not zone-local, the
    per-class sludge inventories, left un-localized)."""
    z = np.tile(np.arange(n_zones), n_fields)
    if n_cls:
        z = np.concatenate([z, np.tile(np.arange(n_zones), n_cls),
                            np.full(n_cls, -1)])
    return z


def make_enkf(params: R.ReactorParams, n_zones: int,
              taps: Sequence[Tuple[str, int]], dt: float, substeps: int,
              process_noise: Sequence[float] = (1e-6, 1e-5, 1e-5),
              measurement_noise=0.01,
              particle_noise: Tuple[float, float] = (1e-4, 1e-8),
              inflation: float = 1.0,
              localization_radius: Optional[float] = None,
              stages=None, diagnostics: bool = False):
    """Build the stochastic-EnKF step for a plant and a set of taps (the
    conventions of :func:`ekf.make_ekf`), with ``inflation`` (multiplicative
    anomaly inflation after each analysis; 1.0 = off) and
    ``localization_radius`` (the Gaspari-Cohn half-width in zones; None =
    no localization).

    Returns ``enkf_step(carry, z, boundary, w=None, eps_all=None) ->
    (carry', x_hat)``, ``x_hat`` the posterior ensemble mean (the EKF's
    flat layout); with ``diagnostics=True`` a third element like the
    EKF's (the NIS at the pre-update mean). ``w`` (``[N, n]``) and
    ``eps_all`` (``[len(taps), N]``) are standard normal draws for the
    model noise and the perturbed observations; left out, they are drawn
    from the carry's generator."""
    nitrogen, gas, biofilm, n_cls = _axes(params)
    n_fields = len(state_fields(nitrogen, gas, biofilm))
    n = n_fields * n_zones + n_cls * n_zones + n_cls
    idxs = tuple(
        _tap_row(f, z, n_zones, nitrogen, gas, n_cls, n,
                 params.particles, biofilm=biofilm) for f, z in taps)
    q_diag = np.repeat(_process_noise(process_noise, n_fields, nitrogen,
                                      gas, biofilm), n_zones)
    if n_cls:
        q_tss, q_sl = particle_noise
        q_diag = np.concatenate([
            q_diag, np.full(n_cls * n_zones, q_tss, np.float32),
            np.full(n_cls, q_sl, np.float32)])
    q_std = _Cast(np.sqrt(q_diag * dt))          # float32, as in JAX
    r = _measurement_noise(measurement_noise, len(idxs))
    r_std = tuple(float(np.sqrt(np.float32(v))) for v in r)
    rows = {k: _Cast(idx) for k, idx in enumerate(idxs)
            if isinstance(idx, np.ndarray)}

    taper = None
    if localization_radius is not None:
        zone_of = _entry_zones(n_zones, n_fields, n_cls)
        tapers = []
        for field, zone in taps:
            d = np.abs(zone_of - (zone % n_zones)).astype(np.float64)
            rho = _gaspari_cohn(d, float(localization_radius))
            rho[zone_of < 0] = 1.0      # sludge: never localized
            tapers.append(rho)
        taper = _Cast(np.stack(tapers).astype(np.float32))   # [m, n]

    lo, hi = _flat_bounds_numpy(n_zones, nitrogen, gas, biofilm, n_cls)
    lo, hi = _Cast(lo), _Cast(hi)

    def forecast(ens, boundary):
        # A plain clip (the EnKF never differentiates the model), so an
        # out-of-bounds member is pulled back before it steps and step()'s
        # own clamps do not bias the forecast anomalies.
        ens = clip(ens, lo(ens), hi(ens))
        st = unflatten_state(ens, n_zones, nitrogen=nitrogen, gas=gas,
                             biofilm=biofilm, n_classes=n_cls)
        st2 = R.step(params, st, boundary, dt, substeps, stages=stages)
        return flatten_state(st2)

    def enkf_step(carry: EnKFCarry, z, boundary, w=None, eps_all=None):
        ens, gen = carry.ensemble, carry.generator
        n_ens = ens.shape[0]
        # -- forecast: the nonlinear plant on every member, plus additive
        #    model noise matching the EKF's Q
        ens = forecast(ens, boundary)
        if w is None:
            w = torch.randn(ens.shape, generator=gen, dtype=ens.dtype,
                            device=ens.device)
        w = torch.as_tensor(w, dtype=ens.dtype, device=ens.device)
        # centered draws leave the mean untouched; under the N-1
        # convention their sample covariance is already unbiased for Q
        w = w - torch.mean(w, dim=0)
        ens = ens + w * q_std(ens)[None, :]
        # -- analysis: sequential scalar updates, perturbed observations
        z = torch.as_tensor(z, dtype=ens.dtype, device=ens.device)
        if eps_all is None:
            eps_all = torch.randn((len(idxs), n_ens), generator=gen,
                                  dtype=ens.dtype, device=ens.device)
        eps_all = torch.as_tensor(eps_all, dtype=ens.dtype,
                                  device=ens.device)
        innovations, variances = [], []
        for k, idx in enumerate(idxs):
            if k in rows:
                hx = ens @ rows[k](ens)                  # [N] row tap
            else:
                hx = ens[:, idx]                         # [N] state tap
            hx_m = torch.mean(hx)
            a = hx - hx_m                                # obs anomalies
            s = torch.sum(a * a) / (n_ens - 1) + r[k]    # innovation var
            A = ens - torch.mean(ens, dim=0)             # state anomalies
            gain = (A.T @ a) / ((n_ens - 1) * s)         # [n]
            if taper is not None:
                gain = gain * taper(ens)[k]
            zk = z[..., k]
            finite = torch.isfinite(zk)
            zs = torch.where(finite, zk, 0.0)
            eps = eps_all[k] * r_std[k]
            eps = eps - torch.mean(eps)                  # centered
            innov = torch.where(finite, (zs + eps) - hx, 0.0)   # [N]
            ens = ens + innov[:, None] * gain[None, :]
            innovations.append(torch.where(finite, zs - hx_m,
                                           float("nan")))
            variances.append(s)
        if inflation != 1.0:
            mean = torch.mean(ens, dim=0)
            ens = mean[None, :] + inflation * (ens - mean[None, :])
        ens = clip(ens, lo(ens), hi(ens))
        new = EnKFCarry(ensemble=ens, generator=gen)
        x_hat = torch.mean(ens, dim=0)
        if diagnostics:
            nu = torch.stack(innovations, dim=-1)
            s_all = torch.stack(variances, dim=-1)
            return new, x_hat, {"innovation": nu,
                                "innovation_variance": s_all,
                                "nis": nu * nu / s_all}
        return new, x_hat

    return enkf_step


def ensemble_spread(carry: EnKFCarry) -> torch.Tensor:
    """Per-entry posterior standard deviation (the EnKF's sqrt(diag P)):
    healthy spread ~ actual RMSE."""
    return torch.std(carry.ensemble, dim=0, correction=1)
