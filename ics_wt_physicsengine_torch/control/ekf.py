"""
Extended Kalman filter over the full plant state (port of
``ics_wt_physicsengine_tpu/control/ekf.py``).

Reconstructs every zone's state, measured or not, from a few noisy
boundary-zone instruments. The process model is the simulator's own
``core.reactor.step`` and its transition Jacobian is
``torch.func.jacfwd`` of that step (``jax.jacfwd`` in the JAX package),
so the filter is exact to the discretization.

- Measurement updates run one channel at a time in scalar form (exact for
  a diagonal R); a NaN reading skips its channel's update.
- The covariance is re-symmetrized after each predict and update.
- ``ekf_step`` is natively batched: a carry with leading axes (a bank of
  filters) takes each filter's Jacobian through ``torch.func.vmap(
  torch.func.jacfwd(...))`` — the JAX package's ``jax.vmap(ekf_step)``.
  The step has no ``.item()`` and no Python branch on tensor values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ics_wt_physicsengine_torch.control.pid import ste_clip
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.core.biofilm import CELLS_PER_MG_C
from ics_wt_physicsengine_torch.device import numpy_dtype, resolve_device
from ics_wt_physicsengine_torch.utils.dispatch import constant

# Measurable fields, in state-vector order; the extension species follow
# the core when the plant carries them
_FIELDS = ("pH", "chlorine", "temperature")
_N_FIELDS = ("ammonia", "nitrite", "nitrate", "chloramine")
_G_FIELDS = ("oxygen", "carbonate")
_B_FIELDS = ("bacteria", "bdoc", "biofilm")


def state_fields(nitrogen: bool = False, gas: bool = False,
                 biofilm: bool = False) -> tuple:
    return _FIELDS + (_N_FIELDS if nitrogen else ()) \
        + (_G_FIELDS if gas else ()) + (_B_FIELDS if biofilm else ())


def _flat_bounds_numpy(n_zones: int, nitrogen: bool, gas: bool,
                       biofilm: bool, n_classes: int):
    """The flat state's physical bounds as float32 NumPy (the JAX
    package's float32 arrays): pH [0, 14], T [0, 100], every
    concentration-like species >= 0."""
    fields = state_fields(nitrogen, gas, biofilm)
    lo_f = {f: 0.0 for f in fields}
    hi_f = {f: np.inf for f in fields}
    hi_f["pH"] = 14.0
    hi_f["temperature"] = 100.0
    lo = [np.full(n_zones, lo_f[f], np.float32) for f in fields]
    hi = [np.full(n_zones, hi_f[f], np.float32) for f in fields]
    if n_classes:
        lo.append(np.zeros(n_classes * n_zones + n_classes, np.float32))
        hi.append(np.full(n_classes * n_zones + n_classes, np.inf,
                          np.float32))
    return np.concatenate(lo), np.concatenate(hi)


def _flat_bounds(n_zones: int, nitrogen: bool, gas: bool, biofilm: bool,
                 n_classes: int, dtype, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-entry physical bounds of the flat state vector, matching
    ``step``'s own clamps, as ``dtype`` tensors on ``device``."""
    lo, hi = _flat_bounds_numpy(n_zones, nitrogen, gas, biofilm, n_classes)
    dev = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    return (torch.from_numpy(lo.astype(np_dtype)).to(dev),
            torch.from_numpy(hi.astype(np_dtype)).to(dev))


class _Cast:
    """A float32 NumPy array as tensors of the dtypes and devices asked
    for, each made once (no copy from the host in a step after the
    first)."""

    def __init__(self, array):
        self.array = np.asarray(array)
        self._made = {}

    def __call__(self, like: torch.Tensor) -> torch.Tensor:
        key = (like.dtype, like.device)
        t = self._made.get(key)
        if t is None:
            t = self._made[key] = torch.from_numpy(
                self.array.astype(numpy_dtype(like.dtype))).to(like.device)
        return t


def _n_classes(state_or_none) -> int:
    """Particle class count carried by a state (0 when particles off)."""
    tss = getattr(state_or_none, "tss", None)
    return 0 if tss is None else tss.shape[-2]


@dataclass
class EKFCarry:
    x: torch.Tensor   # [..., n] state estimate
    P: torch.Tensor   # [..., n, n] covariance


def flatten_state(state: R.ReactorState) -> torch.Tensor:
    """ReactorState -> flat vector (pH | Cl | T [| NH3 | NO2 | NO3 |
    NH2Cl] [| O2 | C_T] [| bacteria | BDOC | film] [| TSS classes x zones
    | sludge classes]: the species the state carries)."""
    arrs = [state.pH, state.chlorine, state.temperature]
    if state.ammonia is not None:
        arrs += [state.ammonia, state.nitrite, state.nitrate,
                 state.chloramine]
    if state.oxygen is not None:
        arrs += [state.oxygen, state.carbonate]
    if state.bacteria is not None:
        arrs += [state.bacteria, state.bdoc, state.biofilm]
    if state.tss is not None:
        c, z = state.tss.shape[-2:]
        arrs += [state.tss.reshape(state.tss.shape[:-2] + (c * z,)),
                 state.sludge]
    return torch.cat(arrs, dim=-1)


def unflatten_state(x: torch.Tensor, n_zones: int,
                    time=0.0, flow_rate=0.0,
                    nitrogen: bool = False,
                    gas: bool = False,
                    biofilm: bool = False,
                    n_classes: int = 0) -> R.ReactorState:
    """Flat vector -> ReactorState (derived fields recomputed).

    ``n_classes > 0`` declares a particle plant: the trailing
    ``n_classes * n_zones + n_classes`` entries are the TSS class
    concentrations ([..., C, Z]) and the settled sludge inventory."""
    fields = state_fields(nitrogen, gas, biofilm)
    p_kw = {}
    if n_classes:
        n_p = n_classes * n_zones + n_classes
        xp, x = x[..., -n_p:], x[..., :-n_p]
        p_kw = dict(
            tss=xp[..., :n_classes * n_zones].reshape(
                xp.shape[:-1] + (n_classes, n_zones)),
            sludge=xp[..., n_classes * n_zones:])
    parts = {f: x[..., i * n_zones:(i + 1) * n_zones]
             for i, f in enumerate(fields)}
    st = R.ReactorState(
        time=constant(time, x), pH=parts["pH"], chlorine=parts["chlorine"],
        temperature=parts["temperature"], flow_rate=constant(flow_rate, x),
        **({k: parts[k] for k in _N_FIELDS} if nitrogen else {}),
        **({k: parts[k] for k in _G_FIELDS} if gas else {}),
        **({k: parts[k] for k in _B_FIELDS} if biofilm else {}),
        **p_kw)
    return R._update_derived(st)


def tap_index(field: str, zone: int, n_zones: int,
              nitrogen: bool = False, gas: bool = False,
              biofilm: bool = False) -> int:
    """State-vector index of ``field`` at ``zone`` (negative zones ok)."""
    fields = state_fields(nitrogen, gas, biofilm)
    if field not in fields:
        raise ValueError(f"field must be one of {fields}, got {field!r}")
    if not -n_zones <= zone < n_zones:
        raise ValueError(f"zone {zone} outside [{-n_zones}, {n_zones})")
    return fields.index(field) * n_zones + (zone % n_zones)


def tss_index(cls: int, zone: int, n_zones: int, n_classes: int,
              nitrogen: bool = False, gas: bool = False,
              biofilm: bool = False) -> int:
    """State-vector index of TSS class ``cls`` at ``zone`` on a particle
    plant (the particle block trails the zone fields)."""
    if not -n_classes <= cls < n_classes:
        raise ValueError(f"class {cls} outside [{-n_classes}, "
                         f"{n_classes})")
    if not -n_zones <= zone < n_zones:
        raise ValueError(f"zone {zone} outside [{-n_zones}, {n_zones})")
    base = len(state_fields(nitrogen, gas, biofilm)) * n_zones
    return base + (cls % n_classes) * n_zones + (zone % n_zones)


def field_diag(values, n_zones: int, nitrogen: bool, gas: bool,
               biofilm: bool, n_cls: int, dtype, what: str = "p0",
               device=None) -> torch.Tensor:
    """Per-field values -> flat-state diagonal on ``device`` (``None``: the
    card): a scalar broadcasts everywhere; a per-field vector (core fields
    + enabled species [+ (tss, sludge) with particles on]) repeats across
    each field's zones, the tss entry across every class x zone and the
    sludge entry across the per-class inventory."""
    n_fields = len(state_fields(nitrogen, gas, biofilm))
    n = n_fields * n_zones + n_cls * n_zones + n_cls
    np_dtype = numpy_dtype(dtype)
    arr = np.asarray(values.detach().cpu().numpy()
                     if isinstance(values, torch.Tensor) else values,
                     np_dtype)
    if arr.ndim == 0:
        diag = np.full(n, arr, np_dtype)
    else:
        want = n_fields + (2 if n_cls else 0)
        if arr.shape != (want,):
            raise ValueError(f"{what} needs {want} per-field entries "
                             f"(or a scalar), got {arr.shape}")
        diag = np.repeat(arr[:n_fields], n_zones)
        if n_cls:
            diag = np.concatenate([
                diag, np.full(n_cls * n_zones, arr[n_fields], np_dtype),
                np.full(n_cls, arr[n_fields + 1], np_dtype)])
    return torch.from_numpy(diag).to(resolve_device(device))


def make_ekf_carry(state0: R.ReactorState, p0, n_zones: int) -> EKFCarry:
    """Initial carry from a (possibly wrong) state guess, on the state's
    device.

    ``p0`` is the initial variance: a scalar, or one value per field (pH,
    chlorine, temperature[, ammonia, nitrite, nitrate, chloramine][,
    oxygen, carbonate][, bacteria, bdoc, biofilm][, tss, sludge]) repeated
    across that field's zones."""
    nitrogen = state0.ammonia is not None
    gas = state0.oxygen is not None
    biofilm = state0.bacteria is not None
    n_cls = _n_classes(state0)
    x0 = flatten_state(state0)
    n = x0.shape[-1]
    diag = field_diag(p0, n_zones, nitrogen, gas, biofilm, n_cls,
                      x0.dtype, device=x0.device)
    P0 = torch.zeros(x0.shape + (n,), dtype=x0.dtype, device=x0.device) \
        + torch.diag(diag)
    return EKFCarry(x=x0, P=P0)


def _axes(params: R.ReactorParams):
    """(nitrogen, gas, biofilm, n_classes) of a plant's parameters."""
    n_cls = (0 if params.particles is None
             else params.particles.ntu_per_mgl.shape[-1])
    return (params.nitrogen is not None, params.gas is not None,
            params.biofilm is not None, n_cls)


def _process_noise(process_noise, n_fields: int, nitrogen, gas, biofilm):
    """One float32 PSD per field (a 3-entry core value is extended with
    1e-6 for each extension species)."""
    q_field = np.asarray(process_noise, np.float32)
    if q_field.shape == (3,) and n_fields > 3:
        q_field = np.concatenate(
            [q_field, np.full(n_fields - 3, 1e-6, np.float32)])
    if q_field.shape != (n_fields,):
        raise ValueError(f"process_noise is one PSD per field "
                         f"{state_fields(nitrogen, gas, biofilm)}")
    return q_field


def _measurement_noise(measurement_noise, m: int) -> Tuple[float, ...]:
    """Per-channel variances, rounded to float32 as the JAX package keeps
    them, as Python floats."""
    r = np.broadcast_to(np.asarray(measurement_noise, np.float32), (m,))
    return tuple(float(v) for v in r)


def make_ekf(params: R.ReactorParams, n_zones: int,
             taps: Sequence[Tuple[str, int]], dt: float, substeps: int,
             process_noise: Sequence[float] = (1e-6, 1e-5, 1e-5),
             measurement_noise=0.01,
             particle_noise: Tuple[float, float] = (1e-4, 1e-8),
             stages=None, diagnostics: bool = False):
    """Build the EKF step for a plant and a set of instrument taps.

    ``taps`` lists the measured channels as ``(field, zone)`` pairs, e.g.
    ``[("pH", 0), ("pH", -1), ("chlorine", -1), ("temperature", -1)]``.
    ``process_noise`` is the per-field PSD (unit^2/s, repeated over zones);
    ``measurement_noise`` the per-channel variance (scalar or one per
    tap). Extension species extend the state and may be tapped
    (``("ammonia", -1)``, ``("oxygen", -1)``); ``("turbidity", z)``,
    ``("tss", z)`` and ``("hpc", z)`` taps are measurement rows (a
    class-weighted or scaled read), updated in general scalar form.
    ``particle_noise`` is the (tss, sludge) PSD pair.

    Returns ``ekf_step(carry, z, boundary) -> (carry', x_hat)`` where ``z``
    is the ``[..., len(taps)]`` measurement vector (NaN = dropped sample)
    and ``x_hat`` the posterior flat state; with ``diagnostics=True`` a
    third element ``{"innovation", "innovation_variance", "nis"}`` per
    channel (the NIS is ~chi-square(1) for a healthy channel:
    :func:`nis_fault_monitor`). The carry may carry leading axes: a bank
    of filters, each with its own boundary fields (``[...]``) or a shared
    one."""
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
    q_diag = q_diag * dt                          # float32, as in JAX
    r = _measurement_noise(measurement_noise, len(idxs))
    lo, hi = _flat_bounds_numpy(n_zones, nitrogen, gas, biofilm, n_cls)
    lo, hi = _Cast(lo), _Cast(hi)

    def f_flat(x, boundary):
        # Full straight-through clip to the physical bounds before the
        # plant model: step() clamps out-of-range species, and a hard
        # clamp's zero gradient would be an absorbing region for the
        # filter (an unmeasured field pushed below zero by one update
        # would lose its Jacobian row and its covariance). The tangent
        # passes unchanged (ste_clip, not st_clip's leak: a discount
        # shrinks P(i,i) by its square every predict).
        x = ste_clip(x, lo(x), hi(x))
        st = unflatten_state(x, n_zones, nitrogen=nitrogen, gas=gas,
                             biofilm=biofilm, n_classes=n_cls)
        st2 = R.step(params, st, boundary, dt, substeps, stages=stages)
        return flatten_state(st2)

    return _build_ekf_step(f_flat, idxs, _Cast(np.diag(q_diag)), r,
                           diagnostics=diagnostics)


def _tap_row(field: str, zone: int, n_zones: int, nitrogen: bool,
             gas: bool, n_classes: int, n: int, pp,
             biofilm: bool = False):
    """A tap -> a state index (a direct state measurement) or a float32
    measurement row h (a linear-combination measurand)."""
    if field == "hpc":
        # lab plate count [CFU/mL]: a scaled read of the bacteria state
        if not biofilm:
            raise ValueError("hpc taps need a biofilm plant "
                             "(params.biofilm)")
        h = np.zeros((n,), np.float32)
        i = tap_index("bacteria", zone, n_zones, nitrogen, gas, biofilm)
        h[i] = np.float32(CELLS_PER_MG_C / 1000.0)
        return h
    if field == "turbidity":
        if not n_classes:
            raise ValueError("turbidity taps need a particle plant "
                             "(params.particles)")
        if not -n_zones <= zone < n_zones:
            raise ValueError(f"zone {zone} outside "
                             f"[{-n_zones}, {n_zones})")
        h = np.zeros((n,), np.float32)
        base = len(state_fields(nitrogen, gas, biofilm)) * n_zones
        ntu = pp.ntu_per_mgl.detach().cpu().numpy()
        for c in range(n_classes):
            h[base + c * n_zones + (zone % n_zones)] = np.float32(ntu[c])
        return h
    if field == "tss" and n_classes:
        # total-solids tap (unweighted class sum) at one zone
        h = np.zeros((n,), np.float32)
        base = len(state_fields(nitrogen, gas, biofilm)) * n_zones
        for c in range(n_classes):
            h[base + c * n_zones + (zone % n_zones)] = 1.0
        return h
    return tap_index(field, zone, n_zones, nitrogen, gas, biofilm)


def _boundary_batch(boundary, batch):
    """A boundary split for ``torch.func.vmap`` over a filter bank's
    leading axis: the fields that carry it (``[B, ...]``) and the rest."""
    kw = {f.name: getattr(boundary, f.name)
          for f in dataclasses.fields(boundary)}
    mapped = {k: v for k, v in kw.items() if isinstance(v, torch.Tensor)
              and v.ndim and v.shape[0] == batch}
    rest = {k: v for k, v in kw.items() if k not in mapped}
    return mapped, rest


def _predict(f_flat, x, boundary):
    """(f(x), df/dx) at the prior mean: one ``jacfwd`` pass gives both. A
    bank of filters ([B, n]) maps it over B."""
    def f_and_aux(xx, bc):
        y = f_flat(xx, bc)
        return y, y

    if x.ndim == 1:
        F, x_pred = torch.func.jacfwd(f_and_aux, has_aux=True)(x, boundary)
        return x_pred, F
    lead = x.shape[:-1]
    xb = x.reshape((-1, x.shape[-1]))
    mapped, rest = _boundary_batch(boundary, xb.shape[0])

    def one(xx, bmap):
        return torch.func.jacfwd(f_and_aux, has_aux=True)(
            xx, R.BoundaryConditions(**rest, **bmap))

    F, x_pred = torch.func.vmap(one)(xb, mapped)
    return x_pred.reshape(x.shape), F.reshape(lead + F.shape[-2:])


def _sym(P):
    return 0.5 * (P + P.transpose(-1, -2))


def _build_ekf_step(f_flat, idxs, q_mat, r, diagnostics: bool = False):
    rows = {k: _Cast(idx) for k, idx in enumerate(idxs)
            if isinstance(idx, np.ndarray)}

    def ekf_step(carry: EKFCarry, z, boundary):
        # -- predict: nonlinear step + Jacobian at the prior mean
        x_pred, F = _predict(f_flat, carry.x, boundary)
        P = F @ carry.P @ F.transpose(-1, -2) + q_mat(carry.P)
        P = _sym(P)
        # -- update: sequential scalar updates (diagonal R), NaN-masked
        x, Pu = x_pred, P
        z = torch.as_tensor(z, dtype=x.dtype, device=x.device)
        innovations, variances = [], []
        for k, idx in enumerate(idxs):
            zk = z[..., k]
            finite = torch.isfinite(zk)
            zs = torch.where(finite, zk, 0.0)
            if k in rows:
                # general measurement row: y = h.x (turbidity, hpc, tss)
                h = rows[k](Pu)
                p_row = torch.einsum("...ij,j->...i", Pu, h)    # P h
                s = torch.einsum("...i,i->...", p_row, h) + r[k]
                gain = p_row / s[..., None]
                innov = zs - torch.einsum("...i,i->...", x, h)
            else:
                p_row = Pu[..., idx, :]           # P @ h (h = e_idx)
                s = p_row[..., idx] + r[k]        # innovation variance
                gain = p_row / s[..., None]       # K = P h / s
                innov = zs - x[..., idx]
            innovations.append(torch.where(finite, innov, float("nan")))
            variances.append(s)
            x_upd = x + gain * innov[..., None]
            Pu_upd = _sym(Pu - gain[..., :, None] * p_row[..., None, :])
            x = torch.where(finite[..., None], x_upd, x)
            Pu = torch.where(finite[..., None, None], Pu_upd, Pu)
        new = EKFCarry(x=x, P=Pu)
        if diagnostics:
            nu = torch.stack(innovations, dim=-1)
            s_all = torch.stack(variances, dim=-1)
            # per-channel normalized innovation squared: ~chi^2(1) for a
            # healthy channel and a consistent filter
            return new, x, {"innovation": nu,
                            "innovation_variance": s_all,
                            "nis": nu * nu / s_all}
        return new, x

    return ekf_step


def nis_fault_monitor(n_channels: int, alpha: float = 0.1,
                      threshold: float = 4.0, dtype=torch.float32,
                      device=None):
    """Innovation-based instrument fault detection on top of an EKF built
    with ``diagnostics=True``: an exponential moving average of each
    channel's NIS (healthy ~1), flagged once it exceeds ``threshold``. NaN
    NIS entries (dropouts) leave the average untouched.

    Returns ``(ema0, update)``, ``update(ema, diag) -> (ema', flags)``;
    ``ema0`` lies on ``device`` (``None``: the card)."""
    ema0 = torch.ones((n_channels,), dtype=dtype,
                      device=resolve_device(device))

    def update(ema, diag):
        nis = diag["nis"]
        fresh = torch.isfinite(nis)
        ema = torch.where(fresh, (1.0 - alpha) * ema + alpha * nis, ema)
        return ema, ema > threshold

    return ema0, update


def make_augmented_ekf(params: R.ReactorParams, n_zones: int,
                       taps: Sequence[Tuple[str, int]], dt: float,
                       substeps: int,
                       augment: Sequence[str] = ("inlet_chlorine",),
                       augment_noise=1e-6,
                       process_noise: Sequence[float] = (1e-6, 1e-5,
                                                         1e-5),
                       measurement_noise=0.01,
                       stages=None, diagnostics: bool = False):
    """EKF with online parameter estimation: the ``BoundaryConditions``
    fields named in ``augment`` (e.g. ``inlet_chlorine``, an upstream
    disturbance no instrument measures) ride the state vector as
    random-walk states with PSD ``augment_noise``; the provided boundary's
    values for them are ignored. The state vector is ``[core | len(augment)
    parameters]``. Same conventions as :func:`make_ekf`; build the carry
    with :func:`make_augmented_carry`."""
    nitrogen, gas, biofilm, n_cls = _axes(params)
    n_fields = len(state_fields(nitrogen, gas, biofilm))
    bc_fields = {f.name for f in dataclasses.fields(R.BoundaryConditions)}
    for name in augment:
        if name not in bc_fields:
            raise ValueError(f"{name!r} is not a BoundaryConditions "
                             f"field")
    n_aug = len(augment)
    n_core = n_fields * n_zones + n_cls * n_zones + n_cls
    idxs = tuple(
        _tap_row(f, z, n_zones, nitrogen, gas, n_cls,
                 n_core + n_aug, params.particles, biofilm=biofilm)
        for f, z in taps)
    q_field = _process_noise(process_noise, n_fields, nitrogen, gas,
                             biofilm)
    q_aug = np.broadcast_to(np.asarray(augment_noise, np.float32), (n_aug,))
    q_core = np.repeat(q_field, n_zones)
    if n_cls:
        q_core = np.concatenate([
            q_core, np.full(n_cls * n_zones, 1e-4, np.float32),
            np.full(n_cls, 1e-8, np.float32)])
    q_diag = np.concatenate([q_core, q_aug]) * dt
    r = _measurement_noise(measurement_noise, len(idxs))
    lo, hi = _flat_bounds_numpy(n_zones, nitrogen, gas, biofilm, n_cls)
    lo, hi = _Cast(lo), _Cast(hi)

    def f_flat(x, boundary):
        theta = x[..., n_core:]
        bc = dataclasses.replace(
            boundary, **{name: theta[..., i]
                         for i, name in enumerate(augment)})
        # the same straight-through pre-clip as make_ekf; theta stays
        # unclipped (parameters have no physical clamp in the plant)
        core = x[..., :n_core]
        st = unflatten_state(ste_clip(core, lo(core), hi(core)), n_zones,
                             nitrogen=nitrogen, gas=gas, biofilm=biofilm,
                             n_classes=n_cls)
        st2 = R.step(params, st, bc, dt, substeps, stages=stages)
        return torch.cat([flatten_state(st2), theta], dim=-1)

    return _build_ekf_step(f_flat, idxs, _Cast(np.diag(q_diag)), r,
                           diagnostics=diagnostics)


def make_augmented_carry(state0: R.ReactorState, theta0, p0, p0_theta,
                         n_zones: int) -> EKFCarry:
    """Carry for :func:`make_augmented_ekf`: the core guess and the
    parameter guesses ``theta0`` with their initial variances
    ``p0_theta``."""
    core = make_ekf_carry(state0, p0, n_zones)
    dtype, dev = core.x.dtype, core.x.device
    theta0 = torch.as_tensor(np.asarray(theta0), dtype=dtype, device=dev)
    n_aug = theta0.shape[-1]
    n_core = core.x.shape[-1]
    p0_t = torch.as_tensor(np.asarray(p0_theta), dtype=dtype,
                           device=dev).broadcast_to((n_aug,))
    n = n_core + n_aug
    P = torch.zeros((n, n), dtype=dtype, device=dev)
    P[:n_core, :n_core] = core.P
    P[torch.arange(n_core, n), torch.arange(n_core, n)] = p0_t
    return EKFCarry(x=torch.cat([core.x, theta0]), P=P)


def ekf_observer(controller, ekf_step, n_zones: int,
                 measured: Sequence[str], estimates: dict,
                 batched: bool = False,
                 nitrogen: bool = False, gas: bool = False,
                 biofilm: bool = False):
    """Wrap a controller so it acts on EKF state estimates instead of raw
    readings: observer-based output feedback.

    ``ekf_step`` comes from :func:`make_ekf` with taps matching
    ``measured`` (the observation names whose readings form the
    measurement vector, in tap order). ``estimates`` maps observation
    names to ``(field, zone)``: each is written into the controller's
    observations from the posterior, replacing a raw reading or adding a
    channel no instrument measures. The wrapped carry is ``(ctrl_carry,
    EKFCarry)``; the wrapper declares ``wants_boundary`` so
    ``rollout_closed_loop`` passes the boundary that drove the tick. The
    EKF's dt (from ``make_ekf``) must equal the rollout's. ``batched``:
    the filter carries the loop's leading lane axis (``ekf_step`` is
    natively batched; the flag is kept for the JAX package's signature)."""
    del batched
    idx_of = {name: tap_index(f, z, n_zones, nitrogen, gas, biofilm)
              for name, (f, z) in estimates.items()}

    def step(gains, carry, obs, dt, boundary):
        ctrl_carry, ekf_carry = carry
        z = torch.stack([obs[name] for name in measured], dim=-1)
        ekf_carry, x = ekf_step(ekf_carry, z, boundary)
        est_obs = dict(obs)
        for name, idx in idx_of.items():
            est_obs[name] = x[..., idx]
        ctrl_carry, commands = controller(gains, ctrl_carry, est_obs, dt)
        return (ctrl_carry, ekf_carry), commands

    step.wants_boundary = True
    return step
