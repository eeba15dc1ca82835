"""
Moving-horizon estimation: optimization-based state reconstruction (port
of ``ics_wt_physicsengine_tpu/control/mhe.py``).

At every tick MHE re-solves for the state at the start of an N-step window
by gradient descent on the measurement misfit of the nonlinear plant
rolled across the window, plus an arrival cost anchoring the window start
to the prior. It optimizes within the physical bounds (the MPC's leaky
straight-through clip), linearizes nothing, and re-interprets the past:
each new reading re-solves the whole window.

- The decision variable is the window-start state x0; the solve is
  ``iters`` Adam steps (``control/optim.py``) on the value and gradient of
  the cost through the N-step rollout.
- The measurement and boundary windows ride the carry and slide each tick;
  NaN measurements weight their residual to zero.
- Warm start: the previous solution propagated one step is both the first
  iterate and the arrival-cost anchor.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Sequence, Tuple

import numpy as np
import torch

from ics_wt_physicsengine_torch.control import optim
from ics_wt_physicsengine_torch.control.ekf import (
    _Cast, _axes, _flat_bounds_numpy, _tap_row, field_diag, flatten_state,
    state_fields, unflatten_state)
from ics_wt_physicsengine_torch.control.pid import st_clip
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.utils.dispatch import clip


@dataclass
class MHECarry:
    z_buf: torch.Tensor            # [N, m] measurement window (NaN: none)
    bc_buf: R.BoundaryConditions   # fields [N]
    x0: torch.Tensor               # estimate of the state at window start


def _slot(bc: R.BoundaryConditions, i: int) -> R.BoundaryConditions:
    return R.BoundaryConditions(**{
        f.name: (None if getattr(bc, f.name) is None
                 else getattr(bc, f.name)[i]) for f in fields(bc)})


def make_mhe_carry(state0: R.ReactorState, horizon: int, n_taps: int,
                   boundary: R.BoundaryConditions) -> MHECarry:
    """Initial carry from a (possibly wrong) state guess, on the state's
    device; the window starts full of NaN measurements and
    ``boundary``."""
    x0 = flatten_state(state0)
    z_buf = torch.full((horizon, n_taps), float("nan"), dtype=x0.dtype,
                       device=x0.device)
    bc_buf = R.BoundaryConditions(**{
        f.name: (None if getattr(boundary, f.name) is None else
                 torch.as_tensor(getattr(boundary, f.name), dtype=x0.dtype,
                                 device=x0.device)
                 .broadcast_to((horizon,)).clone())
        for f in fields(boundary)})
    return MHECarry(z_buf=z_buf, bc_buf=bc_buf, x0=x0)


def make_mhe(params: R.ReactorParams, n_zones: int,
             taps: Sequence[Tuple[str, int]], dt: float, substeps: int,
             horizon: int = 10, prior_variance=0.25,
             measurement_noise=0.01, iters: int = 20,
             learning_rate: float = 0.05, stages=None):
    """Build the MHE step for a plant and a set of instrument taps (the
    conventions of :func:`ekf.make_ekf`), with ``horizon`` (window length
    N), ``prior_variance`` (arrival-cost variance, scalar or per field) and
    ``iters`` / ``learning_rate`` (the Adam budget of each tick's
    warm-started solve).

    Returns ``mhe_step(carry, z, boundary) -> (carry', x_hat)``, ``x_hat``
    the estimate at the current tick (window end), the EKF's flat layout.
    A tick costs ``iters x horizon`` plant steps forward and backward."""
    nitrogen, gas, biofilm, n_cls = _axes(params)
    n_fields = len(state_fields(nitrogen, gas, biofilm))
    n = n_fields * n_zones + n_cls * n_zones + n_cls
    idxs = tuple(
        _tap_row(f, z, n_zones, nitrogen, gas, n_cls, n,
                 params.particles, biofilm=biofilm) for f, z in taps)
    m = len(idxs)
    r = _Cast(np.broadcast_to(np.asarray(measurement_noise, np.float32),
                              (m,)))
    p_diag = _Cast(field_diag(prior_variance, n_zones, nitrogen, gas,
                              biofilm, n_cls, torch.float32,
                              what="prior_variance", device="cpu").numpy())
    rows = {k: _Cast(idx) for k, idx in enumerate(idxs)
            if isinstance(idx, np.ndarray)}
    lo, hi = _flat_bounds_numpy(n_zones, nitrogen, gas, biofilm, n_cls)
    lo, hi = _Cast(lo), _Cast(hi)

    def step_flat(x, bc):
        # Leaky straight-through bounds (the MPC's st_clip: a full
        # straight-through tangent can grow over the recurrent window):
        # the plant always steps an in-domain state, an out-of-bounds
        # iterate keeps a leak-scaled escape gradient, and the arrival
        # cost supplies the restoring pull.
        x = st_clip(x, lo(x), hi(x))
        st = unflatten_state(x, n_zones, nitrogen=nitrogen, gas=gas,
                             biofilm=biofilm, n_classes=n_cls)
        st2 = R.step(params, st, bc, dt, substeps, stages=stages)
        return flatten_state(st2)

    def measure(xs):
        cols = [xs @ rows[k](xs) if k in rows else xs[..., idx]
                for k, idx in enumerate(idxs)]
        return torch.stack(cols, dim=-1)              # [..., m]

    def window_rollout(x0, bc_buf):
        xs = []
        x = x0
        for i in range(horizon):
            x = step_flat(x, _slot(bc_buf, i))
            xs.append(x)
        return x, torch.stack(xs)                     # (x_end, [N, n])

    def cost(x0, x_prior, z_buf, bc_buf):
        _, xs = window_rollout(x0, bc_buf)
        z_hat = measure(xs)                           # [N, m]
        finite = torch.isfinite(z_buf)
        resid = torch.where(finite, z_hat - torch.nan_to_num(z_buf), 0.0)
        # r and p_diag hold float32 values, as in the JAX package
        meas = torch.sum(resid * resid / r(resid))
        arrival = torch.sum((x0 - x_prior) ** 2 / p_diag(x0))
        return meas + arrival

    def mhe_step(carry: MHECarry, z, boundary):
        dev = carry.x0.device
        # -- slide the window: drop the oldest (z, bc), append the current
        bc_old = _slot(carry.bc_buf, 0)
        z = torch.as_tensor(z, dtype=carry.z_buf.dtype, device=dev)
        z_buf = torch.cat([carry.z_buf[1:], z[None]])
        bc_buf = R.BoundaryConditions(**{
            f.name: (None if getattr(carry.bc_buf, f.name) is None else
                     torch.cat([getattr(carry.bc_buf, f.name)[1:],
                                torch.as_tensor(
                                    getattr(boundary, f.name),
                                    dtype=getattr(carry.bc_buf,
                                                  f.name).dtype,
                                    device=dev)[None]]))
            for f in fields(carry.bc_buf)})
        with torch.no_grad():
            # -- warm start + arrival anchor: the previous window start
            #    propagated one step with the boundary that just left
            x_prior = clip(step_flat(carry.x0, bc_old), lo(carry.x0),
                           hi(carry.x0))
        x0 = x_prior
        opt_state = optim.adam_init([x0])
        for _ in range(iters):
            x0 = x0.detach().requires_grad_(True)
            val = cost(x0, x_prior, z_buf, bc_buf)
            (g,) = torch.autograd.grad(val, x0)
            g = torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
            (upd,), opt_state = optim.adam_update([g], opt_state,
                                                  learning_rate)
            x0 = x0.detach() + upd
        with torch.no_grad():
            x0 = clip(x0, lo(x0), hi(x0))
            x_end, _ = window_rollout(x0, bc_buf)
            x_hat = clip(x_end, lo(x_end), hi(x_end))
        return MHECarry(z_buf=z_buf, bc_buf=bc_buf, x0=x0), x_hat

    return mhe_step
