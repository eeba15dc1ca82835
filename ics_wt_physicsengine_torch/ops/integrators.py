"""
Fixed-step ODE integrators over tuples of tensors (port of
``ics_wt_physicsengine_tpu/ops/integrators.py``).

The reactor's stiffness is bounded and known before a run (the fastest
eigenvalue is set by the inter-zone exchange rate), so a fixed substep count
keeps every batched plant in lockstep: classical RK4, or the s-stage
Runge-Kutta-Chebyshev scheme RKC2 (Sommeijer, Shampine and Verwer, J. Comput.
Appl. Math. 88 (1997)), whose real stability interval grows ~0.65 s^2 and so
needs ~s-fold fewer sequential derivative evaluations per unit of stiffness.
``lax.scan`` over substeps becomes a Python loop.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

State = Tuple[torch.Tensor, ...]

# RK4's real-axis stability boundary is |lambda h| < 2.785; leave a 2x
# margin for the nonlinear chemistry terms.
RK4_STABILITY_LIMIT = 2.785
RK4_SAFETY = 0.5


def rk4_step(f: Callable[[State], State], y: State, h) -> State:
    """One classical RK4 step of dy/dt = f(y) over a tuple state."""
    k1 = f(y)
    k2 = f(tuple(a + 0.5 * h * b for a, b in zip(y, k1)))
    k3 = f(tuple(a + 0.5 * h * b for a, b in zip(y, k2)))
    k4 = f(tuple(a + h * b for a, b in zip(y, k3)))
    return tuple(
        a + (h / 6.0) * (b1 + 2.0 * b2 + 2.0 * b3 + b4)
        for a, b1, b2, b3, b4 in zip(y, k1, k2, k3, k4))


def integrate_fixed(f: Callable[[State], State], y0: State, dt: float,
                    substeps: int) -> State:
    """Advance y by dt using ``substeps`` equal RK4 steps."""
    if substeps < 1:
        raise ValueError(f"substeps must be >= 1, got {substeps}")
    h = dt / substeps
    y = y0
    for _ in range(substeps):
        y = rk4_step(f, y, h)
    return y


def stable_substeps(dt: float, lambda_max: float,
                    min_h: float | None = None) -> int:
    """RK4 substep count for step ``dt`` given the stiffest linear rate
    ``lambda_max`` [1/s]; ``min_h`` optionally caps the substep size."""
    h_stab = RK4_SAFETY * RK4_STABILITY_LIMIT / max(lambda_max, 1e-12)
    h = min(dt, h_stab)
    if min_h is not None:
        h = min(h, min_h)
    return max(1, math.ceil(dt / h - 1e-9))


RKC_DAMPING = 2.0 / 13.0
RKC_STABILITY_PER_S2 = 0.653   # real-axis stability ~= 0.653 * s^2 (damped)
RKC_SAFETY = 0.8


def _rkc2_coefficients(s: int):
    """RKC2 coefficient tables for ``s`` stages (float64 NumPy):
    ``(mu1_tilde, mu, nu, mu_tilde, gamma_tilde)``, the arrays indexed by
    stage ``j`` (entries 0 and 1 unused)."""
    if s < 2:
        raise ValueError(f"RKC2 needs s >= 2 stages, got {s}")
    w0 = 1.0 + RKC_DAMPING / s ** 2

    # Chebyshev T_j(w0), T_j'(w0), T_j''(w0) by recurrence.
    t = np.zeros(s + 1)
    dt_ = np.zeros(s + 1)
    d2t = np.zeros(s + 1)
    t[0], t[1] = 1.0, w0
    dt_[0], dt_[1] = 0.0, 1.0
    d2t[0], d2t[1] = 0.0, 0.0
    for j in range(2, s + 1):
        t[j] = 2.0 * w0 * t[j - 1] - t[j - 2]
        dt_[j] = 2.0 * t[j - 1] + 2.0 * w0 * dt_[j - 1] - dt_[j - 2]
        d2t[j] = 4.0 * dt_[j - 1] + 2.0 * w0 * d2t[j - 1] - d2t[j - 2]

    w1 = dt_[s] / d2t[s]
    b = np.zeros(s + 1)
    for j in range(2, s + 1):
        b[j] = d2t[j] / dt_[j] ** 2
    b[0] = b[2]
    b[1] = 1.0 / w0

    a = np.array([1.0 - b[j] * t[j] for j in range(s + 1)])

    mu1_tilde = b[1] * w1
    mu = np.zeros(s + 1)
    nu = np.zeros(s + 1)
    mu_tilde = np.zeros(s + 1)
    gamma_tilde = np.zeros(s + 1)
    for j in range(2, s + 1):
        mu[j] = 2.0 * b[j] * w0 / b[j - 1]
        nu[j] = -b[j] / b[j - 2]
        mu_tilde[j] = 2.0 * b[j] * w1 / b[j - 1]
        gamma_tilde[j] = -a[j - 1] * mu_tilde[j]
    return mu1_tilde, mu, nu, mu_tilde, gamma_tilde


def rkc2_step(f: Callable[[State], State], y: State, h, s: int) -> State:
    """One s-stage RKC2 step of dy/dt = f(y) over a tuple state."""
    mu1_tilde, mu, nu, mu_tilde, gamma_tilde = (
        x.tolist() for x in map(np.asarray, _rkc2_coefficients(s)))

    f0 = f(y)
    y_jm2 = y
    y_jm1 = tuple(a_ + mu1_tilde * h * b_ for a_, b_ in zip(y, f0))
    for j in range(2, s + 1):
        fj = f(y_jm1)
        c0 = 1.0 - mu[j] - nu[j]
        y_j = tuple(
            c0 * y0 + mu[j] * a1 + nu[j] * a2
            + mu_tilde[j] * h * fj_ + gamma_tilde[j] * h * f0_
            for y0, a1, a2, fj_, f0_ in zip(y, y_jm1, y_jm2, fj, f0))
        y_jm2, y_jm1 = y_jm1, y_j
    return y_jm1


def integrate_rkc(f: Callable[[State], State], y0: State, dt: float,
                  substeps: int, stages: int) -> State:
    """Advance y by dt using ``substeps`` equal RKC2(s=stages) steps."""
    if substeps < 1:
        raise ValueError(f"substeps must be >= 1, got {substeps}")
    h = dt / substeps
    y = y0
    for _ in range(substeps):
        y = rkc2_step(f, y, h, stages)
    return y


def rkc_plan(dt: float, lambda_max: float, max_stages: int = 8,
             accuracy_span: float | None = 1.5):
    """Pick (substeps, stages) minimizing total sequential evaluations
    (substeps * stages) subject to lambda*h <= min(0.8 * 0.653 * s^2,
    accuracy_span). ``accuracy_span=None`` is the stability-limited fast
    mode for Monte-Carlo ensembles."""
    best = None
    for s in range(2, max_stages + 1):
        span = RKC_SAFETY * RKC_STABILITY_PER_S2 * s ** 2
        if accuracy_span is not None:
            span = min(span, accuracy_span)
        m = max(1, math.ceil(dt * lambda_max / span - 1e-9))
        cost = m * s
        if best is None or cost < best[2]:
            best = (m, s, cost)
    return best[0], best[1]
