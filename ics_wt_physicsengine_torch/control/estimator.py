"""
Measurement filtering for closed-loop control on real instruments (port of
``ics_wt_physicsengine_tpu/control/estimator.py``).

A deployed controller sees the instrument suite: noise, NaN dropouts,
drift. Feeding raw readings to a PID turns noise into actuator churn and a
NaN into a frozen tick. This module is the standard fix as a pure transform
that composes with ``rollout_closed_loop``:

- ``kalman_step``: scalar Kalman filter with a random-walk process model
  (x_t = x_{t-1} + w, w ~ N(0, Q dt); z = x + v, v ~ N(0, R)). A NaN
  measurement is a missing sample: the time update runs (the variance
  grows) and the measurement update is skipped.
- ``filtered_controller``: wraps any controller so that named observations
  pass through per-lane Kalman filters before the control law.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ics_wt_physicsengine_torch.device import DEFAULT_DTYPE, resolve_device


@dataclass(frozen=True)
class KalmanParams:
    q: torch.Tensor          # process noise PSD [unit^2 / s]
    r: torch.Tensor          # measurement variance [unit^2]


@dataclass
class KalmanCarry:
    x: torch.Tensor          # state estimate
    p: torch.Tensor          # estimate variance
    initialized: torch.Tensor  # bool: the first finite measurement seeds x


def make_kalman_params(q: float, r: float, dtype=DEFAULT_DTYPE,
                       device=None) -> KalmanParams:
    """Filter parameters on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    return KalmanParams(q=torch.as_tensor(q, dtype=dtype, device=dev),
                        r=torch.as_tensor(r, dtype=dtype, device=dev))


def make_kalman_carry(batch_shape=(), x0: float = 0.0, p0: float = 1e6,
                      dtype=DEFAULT_DTYPE, device=None) -> KalmanCarry:
    """A fresh carry on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    shape = tuple(batch_shape)
    return KalmanCarry(
        x=torch.full(shape, x0, dtype=dtype, device=dev),
        p=torch.full(shape, p0, dtype=dtype, device=dev),
        initialized=torch.zeros(shape, dtype=torch.bool, device=dev))


def kalman_step(params: KalmanParams, carry: KalmanCarry, z, dt: float
                ) -> Tuple[KalmanCarry, torch.Tensor]:
    """One predict + update of the scalar random-walk Kalman filter.

    Returns ``(carry', x_hat)``. A non-finite ``z`` skips the measurement
    update (prediction only: the variance grows by Q dt). The first finite
    measurement initializes the state directly."""
    z = torch.as_tensor(z, dtype=carry.x.dtype, device=carry.x.device)
    finite = torch.isfinite(z)
    # time update (random walk)
    p_pred = carry.p + params.q * dt
    # measurement update, masked on finiteness
    k = p_pred / (p_pred + params.r)
    z_safe = torch.where(finite, z, 0.0)
    x_upd = carry.x + k * (z_safe - carry.x)
    p_upd = (1.0 - k) * p_pred
    # the first finite sample seeds the filter
    x_new = torch.where(finite,
                        torch.where(carry.initialized, x_upd, z_safe),
                        carry.x)
    p_new = torch.where(finite,
                        torch.where(carry.initialized, p_upd, params.r),
                        p_pred)
    init = carry.initialized | finite
    return KalmanCarry(x=x_new, p=p_new, initialized=init), x_new


def filtered_controller(controller: Callable,
                        filters: Dict[str, KalmanParams]):
    """Wrap ``controller(gains, carry, obs, dt)`` so that the observations
    named in ``filters`` are Kalman-filtered before the control law.

    The wrapped carry is ``(ctrl_carry, {name: KalmanCarry})``: build the
    filter carries with ``make_kalman_carry(batch_shape)`` for the loop's
    batch. Composes with ``rollout_closed_loop``."""

    def step(gains, carry, obs, dt):
        ctrl_carry, kf_carries = carry
        new_kf = {}
        filtered = dict(obs)
        for name, kp in filters.items():
            new_kf[name], filtered[name] = kalman_step(
                kp, kf_carries[name], obs[name], dt)
        ctrl_carry, commands = controller(gains, ctrl_carry, filtered, dt)
        return (ctrl_carry, new_kf), commands

    return step
