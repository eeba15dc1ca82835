"""
The 20-zone contact tank's ODE and its integrators (classical RK4, or
RKC2: Sommeijer, Shampine and Verwer's second-order Runge-Kutta-Chebyshev
method), plain NumPy.

State: pH, free chlorine and temperature in each of Z stacked zones
(``[B, Z]``, zone 0 at the inlet, zone Z-1 at the outlet). Zone k
exchanges with k+1 at ``k_exchange``, halved where the interface is stably
stratified (Richardson number above ``ri_crit``); the inlet and the dosing
enter zone 0, the outflow leaves zone Z-1. The pH moves through the
carbonate buffer's capacity, chlorine decays by Arrhenius kinetics scaled
by its HOCl fraction, and the tank loses heat to ambient. After every step
the state is clipped to pH [0, 14], chlorine >= 0, temperature [0, 100].

The three fields travel stacked (``[3, B, Z]``), so that one NumPy call
serves all three where the arithmetic is the same.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import params as P

FIELDS = ("pH", "chlorine", "temperature")
RKC_DAMPING = 2.0 / 13.0


def columns(params: dict, xp) -> dict:
    """``[B]`` parameter arrays as ``[B, 1]`` columns in ``xp``."""
    return {k: xp.asarray(v)[:, None] for k, v in params.items()}


def make_deriv(p: dict, xp):
    """The right-hand side ``deriv(y, b)`` for parameter columns ``p``:
    ``y`` the stacked state, ``b`` the source terms
    (``params.boundary_terms``)."""
    safe_u2 = xp.maximum(p["velocity_scale"], 1e-6) ** 2
    still = ~(np.asarray(p["velocity_scale"]) > 1e-6)
    strat_on = np.asarray(p["strat_enabled"]) > 0.5
    ka12 = p["Ka1"] * p["Ka2"]
    ea_r = -(p["cl_ea"] / P.R_GAS)
    one = xp.asarray(1.0)

    def exchange(x, k, q):
        """``[3, B, Z]`` exchange over the ``Z - 1`` interfaces of rate
        ``k`` ``[B, Z - 1]``, less the outflow ``q`` from the last zone."""
        flux = k * (x[..., 1:] - x[..., :-1])
        zero = xp.asarray(np.zeros(x.shape[:-1] + (1,)))
        ex = xp.cat([flux, zero]) - xp.cat([zero, flux])
        return xp.cat([ex[..., :-1], ex[..., -1:] - q * x[..., -1:]])

    def deriv(y, b):
        ph = xp.clip(y[0], 0.0, 14.0)
        cl = xp.maximum(y[1], 0.0)
        t = xp.clip(y[2], 0.0, 100.0)
        rho = P.WATER_DENSITY_20C * (1.0 - P.THERMAL_EXPANSION_COEFF
                                     * (t - 20.0))
        cold = t <= 8.0
        if cold.any():
            rho = xp.where(cold, P.RHO_MAX_4C - P.DENSITY_ANOMALY_COEFF
                           * (t - 4.0) ** 2, rho)
        lo, hi = rho[:, :-1], rho[:, 1:]
        ri = P.G_GRAVITY * (hi - lo) * p["zone_height"] \
            / (0.5 * (hi + lo) * safe_u2)
        k = p["k_exchange"] * xp.where(
            ((ri > p["ri_crit"]) | still) & strat_on, p["supp_factor"], one)

        h = xp.exp(-P.LN10 * ph)
        hh, k1h = h * h, p["Ka1"] * h
        d = hh + k1h + ka12
        a0, a1, a2 = hh / d, k1h / d, ka12 / d
        beta = 2.303 * (h + p["Kw"] / h) \
            + 2.303 * p["C_T_mol"] * (a0 * a1 + 4.0 * a1 * a2 + a0 * a2)
        inv = 1.0 / (beta * P.LN10)
        ex = exchange(xp.stack([h, cl, t]), k, b["q_per_v"])

        q = b["q_per_v"]
        dph = -ex[0] * inv
        dph = xp.cat([dph[:, :1] - (b["dh_dosing"] + q * (
            b["h_inlet"] - h[:, :1])) * inv[:, :1], dph[:, 1:]])
        dcl = xp.cat([ex[1][:, :1] + (b["dcl_dosing"] + q * (
            b["cl_inlet"] - cl[:, :1])), ex[1][:, 1:]])
        k_base = p["cl_k_ref"] * xp.exp(
            ea_r * (1.0 / (t + 273.15) - 1.0 / P.T_REFERENCE_K))
        a_hocl = h / (h + p["Ka_HOCl"])
        dcl = dcl - k_base * (a_hocl + (1.0 - a_hocl) * P.K_OCL_RELATIVE) \
            * cl
        dt_ = xp.cat([ex[2][:, :1] + q * (b["t_inlet"] - t[:, :1]),
                      ex[2][:, 1:]]) - b["heat_rate"] * (t - b["t_amb"])
        return xp.stack([dph, dcl, dt_])

    return deriv


def integrator(config: dict) -> dict:
    """The configuration's integrator: ``dt``, ``substeps`` and ``stages``
    (None for RK4, the Chebyshev stages for RKC2)."""
    integ = config["integrator"]
    if integ["method"] not in ("rk4", "rkc"):
        raise ValueError(f"unknown integrator {integ['method']!r}")
    rkc = integ["method"] == "rkc"
    return dict(dt=float(integ["dt_s"]), substeps=int(integ["substeps"]),
                stages=int(integ["stages_per_substep"]) if rkc else None)


def rkc2_coefficients(s: int) -> tuple:
    """``(mu1~, mu, nu, mu~, gamma~)`` of an ``s``-stage RKC2 step with
    damping ``eps`` (``RKC_DAMPING``, the method's usual 2/13):
    ``w0 = 1 + eps / s^2``, ``w1 = T_s'(w0) / T_s''(w0)``,
    ``b_j = T_j''(w0) / T_j'(w0)^2`` (``b_0 = b_2``, ``b_1 = 1 / w0``);
    the arrays are indexed by the stage ``j``."""
    if s < 2:
        raise ValueError(f"RKC2 needs at least 2 stages, got {s}")
    w0 = 1.0 + RKC_DAMPING / s ** 2
    t, d1, d2 = [1.0, w0], [0.0, 1.0], [0.0, 0.0]
    for j in range(2, s + 1):
        t.append(2.0 * w0 * t[j - 1] - t[j - 2])
        d1.append(2.0 * t[j - 1] + 2.0 * w0 * d1[j - 1] - d1[j - 2])
        d2.append(4.0 * d1[j - 1] + 2.0 * w0 * d2[j - 1] - d2[j - 2])
    w1 = d1[s] / d2[s]
    b = [0.0, 1.0 / w0] + [d2[j] / d1[j] ** 2 for j in range(2, s + 1)]
    b[0] = b[2]
    mu, nu, mut, gmt = ([0.0] * (s + 1) for _ in range(4))
    for j in range(2, s + 1):
        mu[j] = 2.0 * b[j] * w0 / b[j - 1]
        nu[j] = -b[j] / b[j - 2]
        mut[j] = 2.0 * b[j] * w1 / b[j - 1]
        gmt[j] = -(1.0 - b[j - 1] * t[j - 1]) * mut[j]
    return b[1] * w1, mu, nu, mut, gmt


def bounds(y, xp):
    """The physical bounds: pH [0, 14], chlorine >= 0, temperature
    [0, 100]."""
    return xp.stack([xp.clip(y[0], 0.0, 14.0), xp.maximum(y[1], 0.0),
                     xp.clip(y[2], 0.0, 100.0)])


def rk4_step(deriv, y, b, h: float, substeps: int, xp):
    """One step of the stacked state ``y``: ``substeps`` classical RK4
    substeps of ``h`` under source terms ``b``, then the physical
    bounds."""
    for _ in range(substeps):
        k1 = deriv(y, b)
        k2 = deriv(y + 0.5 * h * k1, b)
        k3 = deriv(y + 0.5 * h * k2, b)
        k4 = deriv(y + h * k3, b)
        y = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return bounds(y, xp)


def rkc_step(deriv, y, b, h: float, substeps: int, coeffs: tuple, xp):
    """One step: ``substeps`` RKC2 substeps of ``h`` with the stage
    coefficients ``coeffs`` (``rkc2_coefficients``), then the bounds."""
    mu1t, mu, nu, mut, gmt = coeffs
    for _ in range(substeps):
        f0 = deriv(y, b)
        prev2, prev = y, y + (mu1t * h) * f0
        for j in range(2, len(mu)):
            fj = deriv(prev, b)
            prev2, prev = prev, (
                (1.0 - mu[j] - nu[j]) * y + mu[j] * prev + nu[j] * prev2
                + (mut[j] * h) * fj + (gmt[j] * h) * f0)
        y = prev
    return bounds(y, xp)


def stepper(integ: dict, xp):
    """``step(deriv, y, b)``: one step of ``integ`` (``integrator``)."""
    h, m = integ["dt"] / integ["substeps"], integ["substeps"]
    if integ["stages"] is None:
        return lambda deriv, y, b: rk4_step(deriv, y, b, h, m, xp)
    coeffs = rkc2_coefficients(integ["stages"])
    return lambda deriv, y, b: rkc_step(deriv, y, b, h, m, coeffs, xp)


def forcing(p: dict, boundary: dict, xp) -> dict:
    """Source terms of one forcing (scalars, or ``[B]`` arrays)."""
    b = {k: (xp.asarray(v)[:, None] if np.ndim(v) else xp.asarray(v))
         for k, v in boundary.items()}
    return P.boundary_terms(p, b, xp)


def stack_state(state: dict, xp):
    return xp.stack([xp.asarray(state[k]) for k in FIELDS])


def rollout(params: dict, state: dict, boundary: dict, *, integ: dict,
            n_steps: int, xp) -> dict:
    """``n_steps`` steps of ``integ`` (``integrator``) of every plant under
    a constant ``boundary``; ``state`` holds ``pH``, ``chlorine``,
    ``temperature`` ``[B, Z]``. Returns the final state as float64
    arrays."""
    p = columns(params, xp)
    deriv, b = make_deriv(p, xp), forcing(p, boundary, xp)
    step = stepper(integ, xp)
    y = stack_state(state, xp)
    for _ in range(n_steps):
        y = step(deriv, y, b)
    return {k: np.asarray(v, np.float64) for k, v in zip(FIELDS, y)}
