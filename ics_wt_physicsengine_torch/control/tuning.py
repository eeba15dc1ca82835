"""
Batched PID tuning: thousands of gain candidates in one batched closed loop
(port of ``ics_wt_physicsengine_tpu/control/tuning.py``).

The physics is natively batched, ``pid_step`` broadcasts, and the closed
loop steps the whole batch at once, so a 4096-gain sweep is one loop over
``[n_gains, n_zones]`` tensors.

Two tuners:
  - ``gain_sweep``: every candidate on its own plant lane, scored and
    ranked (the PLC-commissioning workflow); ``robust_gain_sweep`` scores
    each candidate over a Monte-Carlo ensemble of plants.
  - ``tune_pid_gradient``: reverse mode through the closed-loop rollout,
    multi-start Adam (``control/optim.py``) on a smooth tracking loss.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch.control import optim
from ics_wt_physicsengine_torch.control.closed_loop import (
    DualPIDGains, dual_pid_controller, make_dual_pid_carry,
    rollout_closed_loop)
from ics_wt_physicsengine_torch.control.pid import PIDGains
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, numpy_dtype,
                                               resolve_device)
from ics_wt_physicsengine_torch.utils.dispatch import map_tensors


def make_gain_grid(kp_cl, ki_cl, kp_ph, ki_ph, cl_setpoint: float = 2.0,
                   ph_setpoint: float = 7.0, kd_cl=0.0, kd_ph=0.0,
                   dtype=DEFAULT_DTYPE, device=None) -> DualPIDGains:
    """Cartesian candidate grid over the two loops' (kp, ki). Scalars
    broadcast; the fields are flat ``[n_gains]`` tensors on ``device``
    (``None``: the card), n = len(kp_cl) * len(ki_cl) * len(kp_ph) *
    len(ki_ph), ``kp_cl`` varying slowest."""
    dev = resolve_device(device)
    axes = [np.atleast_1d(np.asarray(v, np.float64))
            for v in (kp_cl, ki_cl, kp_ph, ki_ph)]
    a, b, c, d = np.meshgrid(*axes, indexing="ij")
    np_dtype = numpy_dtype(dtype)

    def flat(x):
        return torch.from_numpy(x.reshape(-1).astype(np_dtype)).to(dev)
    n = a.size

    def full(v):
        return torch.full((n,), float(v), dtype=dtype, device=dev)
    return DualPIDGains(
        chlorine=PIDGains(kp=flat(a), ki=flat(b), kd=full(kd_cl),
                          setpoint=full(cl_setpoint), out_min=full(0.0),
                          out_max=full(1.0)),
        ph=PIDGains(kp=flat(c), ki=flat(d), kd=full(kd_ph),
                    setpoint=full(ph_setpoint), out_min=full(0.0),
                    out_max=full(2.0)))


def n_gains(gains: DualPIDGains) -> int:
    shape = tuple(gains.chlorine.kp.shape)
    return int(shape[0]) if shape else 1


def tracking_scores(traj: Dict[str, torch.Tensor], gains: DualPIDGains,
                    dt: float, effort_weight: float = 0.0) -> torch.Tensor:
    """Per-lane integrated squared error (lower is better) of the two
    controlled variables, plus an optional control-effort penalty:
    ISE_cl + ISE_pH + w * integral(cmd^2) dt. Time is the leading axis."""
    cl_err = traj["chlorine_outlet"] - gains.chlorine.setpoint
    ph_err = traj["pH_inlet"] - gains.ph.setpoint
    score = torch.sum(cl_err ** 2, dim=0) * dt \
        + torch.sum(ph_err ** 2, dim=0) * dt
    if effort_weight:
        score = score + effort_weight * dt * (
            torch.sum(traj["cmd:chlorine_flow_rate"] ** 2, dim=0)
            + torch.sum(traj["cmd:acid_flow_rate"] ** 2, dim=0))
    return score


def _batched_plant(config: R.ReactorConfiguration, n: int, dtype, device):
    """One reactor broadcast to [n] lanes (identical plants, different
    gains): the parameters stay scalar; only the state carries the lanes."""
    params = R.make_params(config, dtype=dtype, device=device)
    state = R.make_initial_state(config, dtype=dtype, device=device)
    state = map_tensors(lambda x: x.expand((n,) + tuple(x.shape)), state)
    return params, state


def _pick(gains, i: int):
    return map_tensors(lambda x: x[i] if x.ndim else x, gains)


def gain_sweep(config: R.ReactorConfiguration, gains: DualPIDGains,
               dt: float, n_steps: int,
               boundary: Optional[R.BoundaryConditions] = None,
               substeps: Optional[int] = None, stages=None,
               effort_weight: float = 0.0, feedforward: bool = False,
               dtype=DEFAULT_DTYPE, return_traj: bool = False,
               device=None) -> Dict:
    """Evaluate every candidate on its own closed-loop plant lane in one
    batched loop, on ``device`` (``None``: the card). Returns
    ``{"scores": [n], "best_index": int, "best": DualPIDGains (0-d
    fields), "traj": optional}``."""
    dev = resolve_device(device)
    n = n_gains(gains)
    params, state = _batched_plant(config, n, dtype, dev)
    if substeps is None:
        substeps = R.default_substeps(config, dt)
    if boundary is None:
        boundary = R.BoundaryConditions()
    carry = make_dual_pid_carry((n,), dtype, dev)
    # warmup_gate=False: true-state sweeps have no warm-up zeros, and the
    # > 0 gate would freeze every candidate on a plant commissioned from
    # zero residual
    controller = partial(dual_pid_controller, feedforward=feedforward,
                         warmup_gate=False)
    with torch.no_grad():
        _, _, _, traj = rollout_closed_loop(
            params, state, boundary, controller, gains, carry,
            dt=float(dt), substeps=int(substeps), n_steps=int(n_steps),
            stages=stages, observe="true",
            record_obs=("chlorine_outlet", "pH_inlet", "flow_main"))
        scores = tracking_scores(traj, gains, float(dt), effort_weight)
    best = int(torch.argmin(scores))
    out = {"scores": scores, "best_index": best, "best": _pick(gains, best)}
    if return_traj:
        out["traj"] = traj
    return out


# ---------------------------------------------------------------------------
# Gradient tuning
# ---------------------------------------------------------------------------

_TUNED_FIELDS = ("kp", "ki", "kd")
# the leaves in optax's order (sorted keys of {"chlorine": {...}, "ph":
# {...}}): the global norm sums them in this order
_LEAVES = tuple((loop, f) for loop in ("chlorine", "ph")
                for f in sorted(_TUNED_FIELDS))


def _unpack(gains: DualPIDGains, leaves) -> DualPIDGains:
    theta = dict(zip(_LEAVES, leaves))
    return DualPIDGains(
        chlorine=replace(gains.chlorine, **{f: theta["chlorine", f]
                                            for f in _TUNED_FIELDS}),
        ph=replace(gains.ph, **{f: theta["ph", f] for f in _TUNED_FIELDS}))


def tune_pid_gradient(config: R.ReactorConfiguration, gains0: DualPIDGains,
                      dt: float, n_steps: int, iters: int = 50,
                      learning_rate: float = 0.05,
                      boundary: Optional[R.BoundaryConditions] = None,
                      substeps: Optional[int] = None, stages=None,
                      effort_weight: float = 0.0, dtype=DEFAULT_DTYPE,
                      device=None) -> Dict:
    """Multi-start Adam on (kp, ki, kd) of both loops through the
    differentiable closed-loop rollout, on ``device`` (``None``: the
    card). ``gains0`` may carry a leading ``[n_starts]`` axis: every start
    descends on its own plant lane (the loss is a per-lane sum, so the
    lanes' gradients are independent). Setpoints and output limits are
    held.

    Returns ``{"gains": tuned DualPIDGains, "best": DualPIDGains of the
    best start, "loss_history": [iters], "final_scores": [n_starts]}``.
    """
    dev = resolve_device(device)
    n = n_gains(gains0)
    params, state = _batched_plant(config, n, dtype, dev)
    if substeps is None:
        substeps = R.default_substeps(config, dt)
    if boundary is None:
        boundary = R.BoundaryConditions()
    carry0 = make_dual_pid_carry((n,), dtype, dev)

    # straight-through clipping: the hard-clipped trajectories, with
    # gradients that survive actuator saturation (pid.st_clip)
    controller = partial(dual_pid_controller, clip_mode="straight-through",
                         warmup_gate=False)

    def scores_of(leaves):
        gains = _unpack(gains0, leaves)
        _, _, _, traj = rollout_closed_loop(
            params, state, boundary, controller, gains, carry0,
            dt=float(dt), substeps=int(substeps), n_steps=int(n_steps),
            stages=stages, observe="true",
            record_obs=("chlorine_outlet", "pH_inlet"))
        return tracking_scores(traj, gains, float(dt), effort_weight)

    leaves = [getattr(getattr(gains0, loop), f).detach()
              for loop, f in _LEAVES]
    opt_state = optim.adam_init(leaves)
    losses = []
    for _ in range(iters):
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        loss = torch.sum(scores_of(leaves))
        grads = torch.autograd.grad(loss, leaves)
        # a candidate that wanders into an unstable loop must not poison
        # the other starts (the loss sums over lanes)
        grads = [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
                 for g in grads]
        steps, opt_state = optim.adam_update(grads, opt_state,
                                             learning_rate, max_norm=10.0)
        leaves = optim.apply_updates([x.detach() for x in leaves], steps)
        losses.append(loss.detach())
    with torch.no_grad():
        final_scores = scores_of(leaves)
    tuned = _unpack(gains0, leaves)
    best = int(torch.argmin(final_scores))
    loss_history = torch.stack(losses) if losses else \
        torch.zeros((0,), dtype=dtype, device=dev)
    return {"gains": tuned, "best": _pick(tuned, best),
            "loss_history": loss_history, "final_scores": final_scores}


def robust_gain_sweep(config: R.ReactorConfiguration, gains: DualPIDGains,
                      dt: float, n_steps: int, n_plants: int = 64,
                      seed: int = 0,
                      boundary: Optional[R.BoundaryConditions] = None,
                      substeps: Optional[int] = None, stages=None,
                      effort_weight: float = 0.0,
                      worst_weight: float = 0.5,
                      dtype=DEFAULT_DTYPE, device=None) -> Dict:
    """Uncertainty-robust gain selection: every candidate runs in closed
    loop against a Monte-Carlo ensemble of ``n_plants`` parameter-
    randomized plants (``models/monte_carlo.py``), the whole ``[n_gains *
    n_plants]`` grid as one batched loop on ``device`` (``None``: the
    card).

    Ranking: ``worst_weight * worst + (1 - worst_weight) * mean`` per
    candidate.

    Returns ``{"scores_mean": [G], "scores_worst": [G], "robust": [G],
    "best_index": int, "best": DualPIDGains (0-d fields)}``.
    """
    from ics_wt_physicsengine_torch.models.monte_carlo import (
        make_monte_carlo_batch)

    dev = resolve_device(device)
    G = n_gains(gains)
    if substeps is None:
        substeps = R.default_substeps(config, dt)
    if boundary is None:
        boundary = R.BoundaryConditions()
    mc_params, mc_states = make_monte_carlo_batch(config, n_plants,
                                                  seed=seed, dtype=dtype,
                                                  device=dev)

    def tile_plants(x):
        """[P, ...] -> [G*P, ...] (plants fastest, gains slowest)."""
        if x.ndim == 0:
            return x
        return x.repeat((G,) + (1,) * (x.ndim - 1))

    params_t = map_tensors(tile_plants, mc_params)
    states_t = map_tensors(tile_plants, mc_states)
    gains_t = map_tensors(
        lambda x: torch.repeat_interleave(x, n_plants, dim=0), gains)
    carry = make_dual_pid_carry((G * n_plants,), dtype, dev)
    controller = partial(dual_pid_controller, warmup_gate=False)
    with torch.no_grad():
        _, _, _, traj = rollout_closed_loop(
            params_t, states_t, boundary, controller, gains_t, carry,
            dt=float(dt), substeps=int(substeps), n_steps=int(n_steps),
            stages=stages, observe="true",
            record_obs=("chlorine_outlet", "pH_inlet"))
        per_gain = tracking_scores(traj, gains_t, float(dt),
                                   effort_weight).reshape(G, n_plants)
        mean_s = torch.mean(per_gain, dim=1)
        worst_s = torch.amax(per_gain, dim=1)
    robust = worst_weight * worst_s + (1.0 - worst_weight) * mean_s
    best = int(torch.argmin(robust))
    return {"scores_mean": mean_s, "scores_worst": worst_s,
            "robust": robust, "best_index": best, "best": _pick(gains, best)}
