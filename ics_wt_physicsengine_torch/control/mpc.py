"""
Shooting MPC: receding-horizon optimal dosing through the differentiable
plant (port of ``ics_wt_physicsengine_tpu/control/mpc.py``).

The predicted trajectory is a loop of the physics and the tracking cost is
differentiable through it, so each re-plan is a few Adam steps
(``control/optim.py``) on the move sequence. ``controls`` names any set of
actuator fields and ``track`` any set of observed variables with per-step
setpoint programs and weights (e.g. a chlorine residual and a pH target
with two coupled pumps).

``run_mpc`` tracks a time-varying program on the true plant;
``run_mpc_output_feedback`` plans from an EKF's estimate of the
instrumented plant (``control/ekf.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ics_wt_physicsengine_torch.control import optim
from ics_wt_physicsengine_torch.control.closed_loop import (_COMMAND_LIMITS,
                                                            observe_true)
from ics_wt_physicsengine_torch.control.pid import st_clip
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.device import DEFAULT_DTYPE, resolve_device
from ics_wt_physicsengine_torch.utils.dispatch import clip

_DEFAULT_CONTROLS = ("chlorine_flow_rate",)


def _clip_moves(moves, controls):
    """Straight-through clip of each control column to its actuator
    limit: out-of-range candidates are applied clipped, but the optimizer
    still feels which way to move them (``pid.st_clip``)."""
    cols = [st_clip(moves[..., i], 0.0, _COMMAND_LIMITS[f])
            for i, f in enumerate(controls)]
    return torch.stack(cols, dim=-1)


def _apply(boundary, controls, u_t):
    return dataclasses.replace(
        boundary, **{f: u_t[i] for i, f in enumerate(controls)})


def _predict_cost(params, state, boundary, moves, setpoints, weights,
                  controls, dt, substeps, steps_per_move, stages,
                  move_weight):
    """Cost of a candidate move sequence: the weighted ISE of every tracked
    observable against its setpoint program plus a move-smoothness
    penalty. ``moves`` is ``[n_moves, n_controls]``, each row held for
    ``steps_per_move`` physics steps; ``setpoints`` maps observable names
    (``observe_true`` keys) to ``[n_moves * steps_per_move]`` programs."""
    u = torch.repeat_interleave(_clip_moves(moves, controls),
                                steps_per_move, dim=0)
    st = state
    sq_err = []
    for t in range(u.shape[0]):
        st = R.step(params, st, _apply(boundary, controls, u[t]), dt=dt,
                    substeps=substeps, stages=stages)
        obs = observe_true(st)
        sq_err.append(sum(weights[k] * (obs[k] - setpoints[k][t]) ** 2
                          for k in setpoints))
    smooth = torch.sum((moves[1:] - moves[:-1]) ** 2) \
        if moves.shape[0] > 1 else 0.0
    return torch.sum(torch.stack(sq_err)) * dt + move_weight * smooth


def mpc_plan(params, state: R.ReactorState, boundary: R.BoundaryConditions,
             setpoints, moves0: torch.Tensor, dt: float,
             substeps: int, steps_per_move: int, stages=None,
             iters: int = 30, learning_rate: float = 0.08,
             move_weight: float = 0.05,
             controls: Sequence[str] = _DEFAULT_CONTROLS, weights=None):
    """Optimize a move sequence over the horizon by Adam on the shooting
    cost. ``setpoints``: a ``[horizon]`` tensor (tracks chlorine_outlet) or
    a mapping of observable name -> ``[horizon]`` program. ``moves0``:
    ``[n_moves]`` (one control) or ``[n_moves, n_controls]``. Returns
    ``(moves, cost_history)``, the moves clipped to the actuator limits in
    the shape ``moves0`` came in."""
    controls = tuple(controls)
    single = moves0.ndim == 1
    moves = moves0[:, None] if single else moves0
    if not isinstance(setpoints, dict):
        setpoints = {"chlorine_outlet": torch.as_tensor(setpoints)}
    if weights is None:
        weights = {k: 1.0 for k in setpoints}
    state = R.ReactorState(**{f.name: (None if getattr(state, f.name) is None
                                       else getattr(state, f.name).detach())
                              for f in dataclasses.fields(state)})

    moves = moves.detach()
    opt_state = optim.adam_init([moves])
    costs = []
    for _ in range(iters):
        moves = moves.detach().requires_grad_(True)
        c = _predict_cost(params, state, boundary, moves, setpoints,
                          weights, controls, dt, substeps, steps_per_move,
                          stages, move_weight)
        (g,) = torch.autograd.grad(c, moves)
        g = torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
        (upd,), opt_state = optim.adam_update([g], opt_state, learning_rate,
                                              max_norm=10.0)
        moves = moves.detach() + upd
        costs.append(c.detach())
    lims = torch.tensor([_COMMAND_LIMITS[f] for f in controls],
                        dtype=moves.dtype).to(moves.device)
    moves = clip(moves, 0.0, lims)
    costs = torch.stack(costs) if costs else moves.new_zeros((0,))
    return (moves[:, 0] if single else moves), costs


def _programs(setpoint_program, dtype, device):
    if not isinstance(setpoint_program, dict):
        setpoint_program = {"chlorine_outlet": setpoint_program}
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, dtype=dtype, device=device)
        for k, v in setpoint_program.items()}


def _receding(programs, replan_every, steps_per_move, horizon_moves,
              dtype, device, plan, advance):
    """The receding-horizon loop both runners share: every
    ``replan_every`` steps ``plan(setpoints ahead, previous moves)``
    re-plans, and ``advance(u_t)`` steps the plant under each applied
    command, returning the tracked values. Returns (applied commands
    ``[n_steps, n_controls]``, tracked ``{name: [n_steps]}``, and the
    per-step extras ``advance`` returns)."""
    horizon = horizon_moves * steps_per_move
    padded = {k: torch.cat([v, v[-1:].expand(horizon)])
              for k, v in programs.items()}
    n_steps = next(iter(programs.values())).shape[0]
    moves_prev = None
    applied, tracked, extras = [], [], []
    for k in range(n_steps // replan_every):
        sp_h = {name: p[k * replan_every:k * replan_every + horizon]
                for name, p in padded.items()}
        moves = plan(sp_h, moves_prev)
        u_applied = torch.repeat_interleave(
            moves, steps_per_move, dim=0)[:replan_every]
        with torch.no_grad():
            for u_t in u_applied:
                t_out, extra = advance(u_t)
                tracked.append(t_out)
                extras.append(extra)
        applied.append(u_applied)
        moves_prev = torch.cat([moves[1:], moves[-1:]]) \
            if replan_every == steps_per_move else moves
    u = torch.cat(applied)
    tracked = {name: torch.stack([t[name] for t in tracked])
               for name in programs}
    return u, tracked, extras


def _check_programs(programs, replan_every):
    lengths = {int(v.shape[0]) for v in programs.values()}
    if len(lengths) != 1:
        raise ValueError(f"programs disagree on n_steps: {lengths}")
    n_steps = lengths.pop()
    if n_steps % replan_every:
        raise ValueError(f"n_steps={n_steps} must be a multiple of "
                         f"replan_every={replan_every}")
    return n_steps


def _score(tracked, programs, weights, dt):
    return sum(float(weights[k])
               * float(torch.sum((tracked[k] - programs[k]) ** 2) * dt)
               for k in programs)


def run_mpc(config: R.ReactorConfiguration, setpoint_program,
            dt: float, horizon_moves: int = 8, steps_per_move: int = 15,
            replan_every: Optional[int] = None, iters: int = 30,
            learning_rate: float = 0.08, move_weight: float = 0.05,
            boundary: Optional[R.BoundaryConditions] = None,
            substeps: Optional[int] = None, stages=None,
            controls: Sequence[str] = _DEFAULT_CONTROLS, weights=None,
            dtype=DEFAULT_DTYPE, device=None) -> Dict:
    """Receding-horizon control of the true plant on ``device`` (``None``:
    the card).

    ``setpoint_program``: a ``[n_steps]`` array (the chlorine_outlet
    target) or a mapping of observable name -> ``[n_steps]`` program.
    Every ``replan_every`` steps (default: one move length) the controller
    re-plans ``horizon_moves`` moves against the programs ahead
    (edge-padded past their end), applies the plan until the next re-plan,
    and the plant advances.

    Returns the applied per-control commands, the realized tracked
    trajectories, the weighted tracking score, the final state and its
    observations (single-program callers also get ``commands`` /
    ``chlorine_outlet``)."""
    dev = resolve_device(device)
    controls = tuple(controls)
    programs = _programs(setpoint_program, dtype, dev)
    if weights is None:
        weights = {k: 1.0 for k in programs}
    if replan_every is None:
        replan_every = steps_per_move
    _check_programs(programs, replan_every)
    if substeps is None:
        substeps = R.default_substeps(config, dt)
    if boundary is None:
        boundary = R.BoundaryConditions()
    params = R.make_params(config, dtype=dtype, device=dev)
    state = [R.make_initial_state(config, dtype=dtype, device=dev)]

    def plan(sp_h, moves_prev):
        if moves_prev is None:
            moves_prev = torch.full((horizon_moves, len(controls)), 0.2,
                                    dtype=dtype, device=dev)
        moves, _ = mpc_plan(params, state[0], boundary, sp_h, moves_prev,
                            dt=float(dt), substeps=int(substeps),
                            steps_per_move=int(steps_per_move),
                            stages=stages, iters=int(iters),
                            learning_rate=learning_rate,
                            move_weight=move_weight, controls=controls,
                            weights=weights)
        return moves

    def advance(u_t):
        state[0] = R.step(params, state[0], _apply(boundary, controls, u_t),
                          dt=float(dt), substeps=int(substeps),
                          stages=stages)
        obs = observe_true(state[0])
        return {name: obs[name] for name in programs}, None

    u, tracked, _ = _receding(programs, replan_every, steps_per_move,
                              horizon_moves, dtype, dev, plan, advance)
    out = {"commands_by_control": {f: u[:, i]
                                   for i, f in enumerate(controls)},
           "tracked": tracked,
           "score": _score(tracked, programs, weights, dt),
           "final_state": state[0], "observe": observe_true(state[0])}
    if controls == _DEFAULT_CONTROLS:
        out["commands"] = u[:, 0]
    if "chlorine_outlet" in tracked:
        out["chlorine_outlet"] = tracked["chlorine_outlet"]
    return out


def run_mpc_output_feedback(
        config: R.ReactorConfiguration, setpoint_program, dt: float,
        taps: Sequence, measured: Sequence[str],
        horizon_moves: int = 8, steps_per_move: int = 15,
        replan_every: Optional[int] = None, iters: int = 30,
        learning_rate: float = 0.08, move_weight: float = 0.05,
        boundary: Optional[R.BoundaryConditions] = None,
        substeps: Optional[int] = None, stages=None,
        controls: Sequence[str] = _DEFAULT_CONTROLS, weights=None,
        measurement_noise=0.01, process_noise=(1e-6, 1e-5, 1e-5),
        p0=(0.05, 1.0, 4.0), seed: int = 0,
        dtype=DEFAULT_DTYPE, device=None, rand=None) -> Dict:
    """Output-feedback (LQG-style) receding-horizon control: the MPC never
    sees the true state; it shoots from the EKF's estimate, which
    assimilates the instrument suite's readings every tick.

    ``taps`` are the EKF's ``(field, zone)`` channels and ``measured`` the
    matching reading names of the instrumented plant (``"pH_inlet"``,
    ``"chlorine_outlet"``, ...). The instruments draw from a generator
    seeded with ``seed``, or from ``rand``: a sequence of ``n_steps``
    per-step ``plant_step`` draws. Runs on ``device`` (``None``: the card).

    Returns the applied commands, the realized true tracked trajectories,
    the measured readings, the score, the final plant and the final
    estimate."""
    from ics_wt_physicsengine_torch.control.ekf import (make_ekf,
                                                        make_ekf_carry,
                                                        state_fields,
                                                        unflatten_state)
    from ics_wt_physicsengine_torch.models.plant import (make_plant,
                                                         plant_step)

    dev = resolve_device(device)
    controls = tuple(controls)
    programs = _programs(setpoint_program, dtype, dev)
    if weights is None:
        weights = {k: 1.0 for k in programs}
    if replan_every is None:
        replan_every = steps_per_move
    n_steps = _check_programs(programs, replan_every)
    if rand is not None and len(rand) != n_steps:
        raise ValueError(f"rand holds {len(rand)} steps of draws, not "
                         f"{n_steps}")
    if substeps is None:
        substeps = R.default_substeps(config, dt)
    if boundary is None:
        boundary = R.BoundaryConditions()
    zones = config.n_zones
    pparams, plant = make_plant(config, dtype=dtype, warmed_up=True,
                                device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    rparams = pparams.reactor
    # the EKF's state layout follows the plant's enabled species
    nitrogen = rparams.nitrogen is not None
    gas = rparams.gas is not None
    biofilm = rparams.biofilm is not None
    n_cls = (0 if rparams.particles is None
             else rparams.particles.ntu_per_mgl.shape[-1])
    n_fields = len(state_fields(nitrogen, gas, biofilm))
    p0_arr = np.asarray(p0, np.float32)
    if p0_arr.shape == (3,) and (n_fields > 3 or n_cls):
        # unit variance for each extension field (the process-noise rule)
        pads = [p0_arr, np.full((n_fields - 3,), 1.0, np.float32)]
        if n_cls:
            pads.append(np.asarray([25.0, 1.0], np.float32))
        p0 = np.concatenate(pads)
    ekf_step = make_ekf(rparams, zones, taps, dt, substeps,
                        process_noise=process_noise,
                        measurement_noise=measurement_noise,
                        stages=stages)
    ekf_carry = make_ekf_carry(
        R.make_initial_state(config, dtype=dtype, device=dev), p0=p0,
        n_zones=zones)
    carry = {"plant": plant, "ekf": ekf_carry, "step": 0}

    def plan(sp_h, moves_prev):
        if moves_prev is None:
            moves_prev = torch.full((horizon_moves, len(controls)), 0.2,
                                    dtype=dtype, device=dev)
        # plan from the estimate: the only state the controller has
        est_state = unflatten_state(carry["ekf"].x, zones,
                                    nitrogen=nitrogen, gas=gas,
                                    biofilm=biofilm, n_classes=n_cls)
        moves, _ = mpc_plan(rparams, est_state, boundary, sp_h, moves_prev,
                            dt=float(dt), substeps=int(substeps),
                            steps_per_move=int(steps_per_move),
                            stages=stages, iters=int(iters),
                            learning_rate=learning_rate,
                            move_weight=move_weight, controls=controls,
                            weights=weights)
        return moves

    def advance(u_t):
        bc = _apply(boundary, controls, u_t)
        j = carry["step"]
        carry["plant"], readings = plant_step(
            pparams, carry["plant"], bc, dt, int(substeps), stages=stages,
            rand=None if rand is None else rand[j], generator=generator)
        z = torch.stack([readings[n].value for n in measured])
        carry["ekf"], _ = ekf_step(carry["ekf"], z, bc)
        carry["step"] = j + 1
        obs_true = observe_true(carry["plant"].reactor)
        return ({name: obs_true[name] for name in programs},
                {n: readings[n].value for n in measured})

    u, tracked, extras = _receding(programs, replan_every, steps_per_move,
                                   horizon_moves, dtype, dev, plan, advance)
    meas = {n: torch.stack([e[n] for e in extras]) for n in measured}
    out = {"commands_by_control": {f: u[:, i]
                                   for i, f in enumerate(controls)},
           "tracked": tracked, "measured": meas,
           "score": _score(tracked, programs, weights, dt),
           "final_plant": carry["plant"], "final_estimate": carry["ekf"]}
    if controls == _DEFAULT_CONTROLS:
        out["commands"] = u[:, 0]
    if "chlorine_outlet" in tracked:
        out["chlorine_outlet"] = tracked["chlorine_outlet"]
    return out
