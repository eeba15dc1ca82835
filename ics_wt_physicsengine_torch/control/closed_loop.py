"""
Closed-loop rollout: controller + physics (+ instruments) step by step
(port of ``ics_wt_physicsengine_tpu/control/closed_loop.py``).

Each tick steps the reactor, observes it (the true state or the full
instrument pipeline), runs a pure controller transform, validates the
commands as the orchestrator's zero-trust boundary does (non-finite -> 0,
clamp to the register limits), and applies them to the next tick's
BoundaryConditions: the reference HIL loop's shape. The order matches the
HIL serving loop tick for tick: physics advances under the previous tick's
commands, then sensors read, then the controller acts.

The JAX package scans the body inside one jit; here it is a Python loop
over plain PyTorch (no kernel lies on this path), ``jax.checkpoint`` of the
body becomes ``torch.utils.checkpoint``, and the instruments' randomness
comes from a ``torch.Generator`` or from draws the caller injects.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Callable, Dict

import torch

from ics_wt_physicsengine_torch.control.pid import (PIDCarry, PIDGains,
                                                    make_pid_carry, pid_step,
                                                    st_clip)
from ics_wt_physicsengine_torch.core import biofilm as biofilm_mod
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.device import DEFAULT_DTYPE
from ics_wt_physicsengine_torch.utils.dispatch import (checkpointed, clip,
                                                       filled, map_tensors,
                                                       tensor_leaves)

# Orchestrator zero-trust limits (``__main__.py::read_modbus_commands``):
# commands beyond these are clamped, non-finite commands become 0.
_COMMAND_LIMITS = {
    "acid_flow_rate": 2.0,
    "chlorine_flow_rate": 1.0,
    "inlet_flow_rate": 20.0,
    # extension-species actuators, at the orchestrator's register clamps
    "aeration_kla": 0.1,
    "coagulant_dose": 100.0,
    "filter_flow_rate": 60.0,
    "sludge_blowdown": 0.01,
    "uv_intensity": 50.0,
    "inlet_toc": 20.0,
    "inlet_bdoc": 10.0,
    "inlet_bacteria": 2.0e-3,   # mg C/L (~1e7 CFU/mL, the register cap)
}


def validate_commands(commands: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The orchestrator's ``validate_flow_rate`` on tensors: non-finite ->
    0, clip to [0, max]."""
    out = {}
    for name, value in commands.items():
        if name not in _COMMAND_LIMITS:
            raise ValueError(
                f"unknown actuator command {name!r}; controllers may set "
                f"{sorted(_COMMAND_LIMITS)}")
        value = torch.as_tensor(value)
        value = torch.where(torch.isfinite(value), value, 0.0)
        out[name] = clip(value, 0.0, _COMMAND_LIMITS[name])
    return out


def apply_commands(boundary: R.BoundaryConditions,
                   commands: Dict[str, torch.Tensor],
                   dt: float, actuator_tau: float = 0.0
                   ) -> R.BoundaryConditions:
    """Validated commands -> new BoundaryConditions; ``actuator_tau`` > 0
    applies the first-order pump/valve lag
    (``__main__.py::apply_actuator_dynamics``)."""
    commands = validate_commands(commands)
    if actuator_tau > 0.0:
        alpha = 1.0 - math.exp(-dt / actuator_tau)
        commands = {f: getattr(boundary, f)
                    + alpha * (v - getattr(boundary, f))
                    for f, v in commands.items()}
    return replace(boundary, **commands)


# ---------------------------------------------------------------------------
# The canonical two-loop controller (examples/pid_controller.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DualPIDGains:
    """The canonical plant's two loops: chlorine residual
    (chlorine_outlet -> chlorine_flow_rate) and pH
    (pH_inlet -> acid_flow_rate)."""

    chlorine: PIDGains
    ph: PIDGains


@dataclass
class DualPIDCarry:
    chlorine: PIDCarry
    ph: PIDCarry


def make_dual_pid_carry(batch_shape=(), dtype=DEFAULT_DTYPE,
                        device=None) -> DualPIDCarry:
    """Fresh carries for both loops on ``device`` (``None``: the card)."""
    return DualPIDCarry(chlorine=make_pid_carry(batch_shape, dtype, device),
                        ph=make_pid_carry(batch_shape, dtype, device))


def dual_pid_controller(gains: DualPIDGains, carry: DualPIDCarry,
                        obs: Dict[str, torch.Tensor], dt: float,
                        feedforward: bool = False,
                        chlorine_stock_mg_L: float = 50.0,
                        clip_mode: str = "hard",
                        warmup_gate: bool = True):
    """One controller tick with ``examples/pid_controller.py::control_loop``
    semantics: warm-up gating (``reading > 0`` ticks the loop, else hold
    zero and freeze the PID), optional mass-balance feedforward on the
    chlorine loop, and the final [0, 1] chlorine-command clip. Returns
    ``(carry, commands)``. ``clip_mode="straight-through"`` keeps the
    values and lets gradients pass saturation (``pid.st_clip``).

    ``warmup_gate=False`` replaces the ``> 0`` gate with a finiteness gate:
    against noise-free observations a plant commissioned from zero residual
    reads exactly 0.0, and the ``> 0`` gate would freeze the PID for good
    (the tuners pass False)."""
    clip_fn = clip if clip_mode == "hard" else st_clip
    cl_meas = obs["chlorine_outlet"]
    ph_meas = obs["pH_inlet"]

    def gate(m):
        return m > 0.0 if warmup_gate else torch.isfinite(m)

    cl_carry, cl_cmd = pid_step(gains.chlorine, carry.chlorine, cl_meas, dt,
                                active=gate(cl_meas), clip_mode=clip_mode)
    if feedforward:
        flow = obs["flow_main"]
        ff = torch.where(flow > 0.0,
                         gains.chlorine.setpoint * flow / chlorine_stock_mg_L,
                         0.0)
        cl_cmd = cl_cmd + torch.where(gate(cl_meas), ff, 0.0)
    cl_cmd = clip_fn(cl_cmd, 0.0, 1.0)

    ph_carry, acid_cmd = pid_step(gains.ph, carry.ph, ph_meas, dt,
                                  active=gate(ph_meas), clip_mode=clip_mode)

    return DualPIDCarry(chlorine=cl_carry, ph=ph_carry), {
        "chlorine_flow_rate": cl_cmd,
        "acid_flow_rate": acid_cmd,
    }


# ---------------------------------------------------------------------------
# Observation
# ---------------------------------------------------------------------------

def observe_true(state: R.ReactorState) -> Dict[str, torch.Tensor]:
    """Noise-free observations named like the sensor-suite readings: the
    true zone values at the canonical instrument locations (pH / Cl / temp
    at inlet zone 0 and outlet zone -1, one flow sensor), plus the
    observables of each extension axis that is on."""
    obs = {
        "pH_inlet": state.pH[..., 0],
        "pH_outlet": state.pH[..., -1],
        "chlorine_inlet": state.chlorine[..., 0],
        "chlorine_outlet": state.chlorine[..., -1],
        "temp_inlet": state.temperature[..., 0],
        "temp_outlet": state.temperature[..., -1],
        "flow_main": state.flow_rate,
    }
    if state.chloramine is not None:   # nitrogen chemistry
        obs["ammonia_outlet"] = state.ammonia[..., -1]
        obs["chloramine_outlet"] = state.chloramine[..., -1]
        obs["total_chlorine_outlet"] = state.chlorine[..., -1] \
            + state.chloramine[..., -1]
    if state.oxygen is not None:       # gas exchange
        obs["oxygen_outlet"] = state.oxygen[..., -1]
        obs["carbonate_outlet"] = state.carbonate[..., -1]
    if state.tss is not None:          # particles (TSS; NTU is the
        #                                instrument's weighting)
        obs["tss_outlet"] = torch.sum(state.tss[..., -1], dim=-1)
        obs["sludge_total"] = torch.sum(state.sludge, dim=-1)
    if state.pathogens is not None:    # disinfection: the regulatory
        #                                channels of the UV/CT problem
        n0 = clip(state.pathogens[..., 0], 1e-30)
        n1 = clip(state.pathogens[..., -1], 1e-30 * n0)
        removal = torch.log10(n0 / n1)
        obs["giardia_log_removal"] = removal[..., 1]
        obs["crypto_log_removal"] = removal[..., 2]
        obs["ct_outlet"] = state.ct[..., -1]
        obs["thm_outlet"] = state.thm[..., -1]
        obs["toc_outlet"] = state.toc[..., -1]
    if state.bacteria is not None:     # biofilm / regrowth: the plate
        #                                count of booster chlorination
        obs["hpc_outlet"] = biofilm_mod.hpc_cfu_per_ml(
            state.bacteria[..., -1])
        obs["bdoc_outlet"] = state.bdoc[..., -1]
        obs["biofilm_peak"] = torch.amax(state.biofilm, dim=-1)
    return obs


# ---------------------------------------------------------------------------
# The closed-loop rollout
# ---------------------------------------------------------------------------

def _broadcast_boundary(boundary, shape, dtype, device):
    return R.BoundaryConditions(**{
        f.name: (None if getattr(boundary, f.name) is None else
                 filled(getattr(boundary, f.name), shape, dtype, device))
        for f in fields(boundary)})


def rollout_closed_loop(params, state, boundary: R.BoundaryConditions,
                        controller: Callable, gains, ctrl_carry,
                        dt: float, substeps: int, n_steps: int,
                        stages=None, observe: str = "true",
                        actuator_tau: float = 0.0, batched: bool = False,
                        record: bool = True, record_obs=None,
                        gains_schedule=None, disturbance=None,
                        controller_owned=("acid_flow_rate",
                                          "chlorine_flow_rate"),
                        remat: bool = False, generator=None, rand=None):
    """Loop {physics -> observe -> controller -> validated commands} for
    ``n_steps``.

    ``controller(gains, carry, obs, dt) -> (carry, commands)`` is any pure
    transform (``dual_pid_controller`` is the canonical one); ``commands``
    maps actuator field names to values, which pass the zero-trust clamps
    before reaching the plant. A controller with a true ``wants_boundary``
    attribute (``control.ekf.ekf_observer``) is also given the boundary
    that drove the tick.

    ``observe``:
      - ``"true"``: params/state are ``ReactorParams``/``ReactorState``;
        the controller sees noise-free zone values (``observe_true``), and
        a sweep is one batched loop (leading ``[n]`` axes on the state and
        the gains).
      - ``"sensors"``: params/state are ``PlantParams``/``PlantState``;
        the controller sees the instruments' measured values. Set
        ``batched=True`` when the plant carries a leading batch axis. The
        instruments draw from ``generator`` (``None``: the global
        generator), or from ``rand``: a sequence of ``n_steps`` per-step
        ``{sensor: (normals, uniforms)}`` draws (``plant_step``'s).

    ``gains_schedule``: the structure of ``gains`` with a leading
    ``[n_steps]`` axis on every tensor (per-step controller parameters,
    e.g. a setpoint program); it overrides ``gains``.

    ``disturbance``: a BoundaryConditions with ``[n_steps]`` fields (numbers
    hold for every step): scripted forcing applied each step. The fields in
    ``controller_owned`` stay under controller authority; every other field
    is replaced from the disturbance each step.

    ``remat=True`` checkpoints each tick (``torch.utils.checkpoint``):
    long-horizon gradients keep only the carried state, controller carry
    and boundary per step.

    Returns ``(final_state, final_ctrl_carry, final_boundary, traj)``;
    ``traj`` (if ``record``) holds each step's observations (all, or those
    named in ``record_obs``) and the applied commands (``"cmd:<field>"``),
    stacked ``[n_steps, ...]``.
    """
    if observe not in ("true", "sensors"):
        raise ValueError(f"unknown observe mode: {observe!r}")

    # every boundary field takes the loop's batch shape up front: with
    # batched gains the commands carry the batch axis
    ref_pH = state.pH if observe == "true" else state.reactor.pH
    batch_shape = tuple(ref_pH.shape[:-1])
    dtype, device = ref_pH.dtype, ref_pH.device
    boundary = _broadcast_boundary(boundary, batch_shape, dtype, device)
    if rand is not None and len(rand) != n_steps:
        raise ValueError(f"rand holds {len(rand)} steps of draws, not "
                         f"{n_steps}")

    if observe == "true":
        def advance(st, bc, j, generator):
            new = R.step(params, st, bc, dt=dt, substeps=substeps,
                         stages=stages)
            return new, observe_true(new)
    else:
        from ics_wt_physicsengine_torch.models.plant import (
            plant_step, plant_step_batched)

        def advance(st, bc, j, generator):
            r = None if rand is None else rand[j]
            if batched:
                new, readings = plant_step_batched(
                    params, st, bc, dt, substeps, stages=stages, rand=r,
                    boundary_axes=0, generator=generator)
            else:
                new, readings = plant_step(params, st, bc, dt, substeps,
                                           stages=stages, rand=r,
                                           generator=generator)
            return new, {k: v.value for k, v in readings.items()}

    if gains_schedule is not None:
        for leaf in tensor_leaves(gains_schedule):
            if tuple(leaf.shape[:1]) != (n_steps,):
                raise ValueError(
                    f"gains_schedule leaves need a leading [{n_steps}] "
                    f"axis; got shape {tuple(leaf.shape)}")
    owned = set(controller_owned)
    if disturbance is not None:
        dist = {}
        for f in fields(disturbance):
            x = getattr(disturbance, f.name)
            if x is None or f.name in owned:
                continue
            x = torch.as_tensor(x, dtype=dtype, device=device)
            dist[f.name] = x.broadcast_to(
                (n_steps,) if x.ndim == 0 else (n_steps,) + x.shape[1:])
        unknown = owned - set(_COMMAND_LIMITS)
        if unknown:
            raise ValueError(f"controller_owned contains non-actuator "
                             f"fields: {sorted(unknown)}")

    def body(st, cc, bc, j, generator=None):
        if disturbance is not None:
            # scripted forcing; controller-owned fields keep their carried
            # (command-driven) values
            bc = replace(bc, **{name: x[j].broadcast_to(batch_shape)
                                for name, x in dist.items()})
        g = gains if gains_schedule is None else \
            map_tensors(lambda x: x[j], gains_schedule)
        st, obs = advance(st, bc, j, generator)
        if getattr(controller, "wants_boundary", False):
            cc, commands = controller(g, cc, obs, dt, bc)
        else:
            cc, commands = controller(g, cc, obs, dt)
        # shared gains over a batched plant still give per-lane commands
        commands = {k: filled(v, batch_shape, dtype, device)
                    for k, v in commands.items()}
        bc = apply_commands(bc, commands, dt, actuator_tau)
        out = None
        if record:
            kept = obs if record_obs is None \
                else {k: obs[k] for k in record_obs}
            out = {**kept, **{f"cmd:{k}": v for k, v in commands.items()}}
        return st, cc, bc, out

    records = []
    for j in range(n_steps):
        if remat:
            state, ctrl_carry, boundary, out = checkpointed(
                body, state, ctrl_carry, boundary, j, generator=generator)
        else:
            state, ctrl_carry, boundary, out = body(
                state, ctrl_carry, boundary, j, generator=generator)
        if record:
            records.append(out)
    traj = None
    if record and records:
        traj = {k: torch.stack([r[k] for r in records]) for k in records[0]}
    return state, ctrl_carry, boundary, traj
