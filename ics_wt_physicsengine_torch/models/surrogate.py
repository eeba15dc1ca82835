"""
Learned plant surrogate: a residual MLP one-step model of the reactor,
trained against the physics engine it replaces (port of
``ics_wt_physicsengine_tpu/models/surrogate.py``).

The plant transition becomes three dense layers, the one matmul workload
of the framework, which buys:

- cheap re-planning: shooting MPC whose inner rollouts cost matmuls instead
  of ``substeps`` physics sweeps per step; the surrogate plans, the exact
  plant applies (``run_mpc_surrogate``);
- massive scenario screening: batched surrogate rollouts screen 10^5
  dosing programs for the exact engine to verify the shortlist;
- a differentiable model of plants the engine does not model, fitted to
  plant-response data (``utils/history``) by the same training harness.

Design:
- residual form ``x' = clip(x + denorm(MLP(norm(x), norm(u))))`` with a
  zero output layer, so the untrained surrogate is the identity; the
  normalization statistics travel inside ``SurrogateParams``;
- the state layout is the control stack's flat vector
  (``control.ekf.flatten_state``);
- the MLP is float32 whatever the state's type: the weights are float32
  and every product returns float32. ``compute_dtype=torch.bfloat16``
  rounds both operands of each product to bfloat16 and multiplies them in
  float32 (their products are exact there), which is a bfloat16 GEMM with
  float32 accumulation and output, on the CPU and on the card alike;
- training is Adam in optax's order (``control/optim.py``); the one-step
  phase and the multi-step fine-tuning phase are loops on the device.

Randomness: the weight initialization, the minibatch indices, phase 2's
windows and the dataset's initial states and forcing are drawn from a
``torch.Generator`` (made from ``seed``, or passed as ``generator=``), and
each can also be given: ``init_weights``, ``batch_indices``,
``rollout_indices``, ``x0s``/``u_seq``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as TF

from ics_wt_physicsengine_torch.control import optim
from ics_wt_physicsengine_torch.control.closed_loop import _COMMAND_LIMITS
from ics_wt_physicsengine_torch.control.ekf import (_flat_bounds,
                                                   flatten_state,
                                                   state_fields,
                                                   tap_index,
                                                   unflatten_state)
from ics_wt_physicsengine_torch.control.mpc import (_check_programs,
                                                    _receding, _score)
from ics_wt_physicsengine_torch.control.pid import st_clip
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.device import DEFAULT_DTYPE, resolve_device
from ics_wt_physicsengine_torch.utils.dispatch import clip

_DEFAULT_CONTROLS = ("chlorine_flow_rate",)
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SurrogateParams:
    """MLP weights + the normalization statistics that make them
    portable. Every leaf is a tensor; ``utils.checkpoint.save_pytree``
    saves it as is."""
    weights: Tuple[torch.Tensor, ...]  # (W, b, W, b, ...), float32
    x_mean: torch.Tensor               # [n] state normalization
    x_std: torch.Tensor                # [n]
    u_scale: torch.Tensor              # [m] control normalization (0-max)
    r_mean: torch.Tensor               # [n] residual normalization
    r_std: torch.Tensor                # [n]
    lo: torch.Tensor                   # [n] physical bounds (step clamps)
    hi: torch.Tensor                   # [n]

    def to(self, device) -> "SurrogateParams":
        """A copy with every tensor on ``device``."""
        return SurrogateParams(
            weights=tuple(w.to(device) for w in self.weights),
            **{f.name: getattr(self, f.name).to(device)
               for f in dataclasses.fields(self) if f.name != "weights"})


def _generator(seed, generator, device) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(int(seed))


def _init_mlp(sizes: Sequence[int], generator: torch.Generator, device):
    """LeCun-normal hidden layers; a zero output layer, so the fresh
    surrogate predicts residual 0 (identity dynamics)."""
    ws = []
    n_layers = len(sizes) - 1
    for i in range(n_layers):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=generator,
                        dtype=_F32, device=device) / math.sqrt(sizes[i])
        if i == n_layers - 1:
            w = torch.zeros_like(w)
        ws.append(w)
        ws.append(torch.zeros((sizes[i + 1],), dtype=_F32, device=device))
    return tuple(ws)


def _mlp_apply(weights, z, compute_dtype):
    """Forward pass: each product on operands rounded to ``compute_dtype``,
    in float32 (``jnp.dot(..., preferred_element_type=float32)``); the
    tanh GELU is ``jax.nn.gelu``'s default."""
    n_layers = len(weights) // 2
    for i in range(n_layers):
        w, b = weights[2 * i], weights[2 * i + 1]
        z = torch.matmul(z.to(compute_dtype).to(_F32),
                         w.to(compute_dtype).to(_F32)) + b
        if i < n_layers - 1:
            z = TF.gelu(z, approximate="tanh")
    return z


# ---------------------------------------------------------------------------
# Dataset: physics rollouts under random piecewise-constant forcing
# ---------------------------------------------------------------------------

def _n_classes(params: R.ReactorParams) -> int:
    return (0 if params.particles is None
            else params.particles.ntu_per_mgl.shape[-1])


def _template_state(params: R.ReactorParams, n_zones: int, dtype,
                    device) -> R.ReactorState:
    """A structural template ReactorState matching the params' enabled
    axes (values irrelevant beyond being in-domain)."""
    cfg = R.ReactorConfiguration(
        n_zones=n_zones,
        enable_nitrogen=params.nitrogen is not None,
        enable_gas=params.gas is not None,
        enable_particles=params.particles is not None,
        enable_disinfection=params.disinfection is not None,
        enable_biofilm=params.biofilm is not None,
        enable_phase=params.phase is not None)
    return R.make_initial_state(cfg, dtype=dtype, device=device)


def _unflatten(params, x, n_zones, template: R.ReactorState):
    return unflatten_state(
        x, n_zones,
        time=template.time, flow_rate=template.flow_rate,
        nitrogen=params.nitrogen is not None,
        gas=params.gas is not None,
        biofilm=params.biofilm is not None,
        n_classes=_n_classes(params))


def make_surrogate_dataset(params: R.ReactorParams, n_zones: int,
                           boundary: R.BoundaryConditions, seed: int,
                           n_traj: int, n_steps: int, dt: float,
                           substeps: int,
                           controls: Sequence[str] = _DEFAULT_CONTROLS,
                           hold: int = 8, stages=None,
                           init_ranges: Optional[Dict] = None,
                           dtype=DEFAULT_DTYPE, generator=None,
                           x0s=None, u_seq=None):
    """Roll ``n_traj`` physics trajectories of ``n_steps`` under random
    piecewise-constant actuation (each control resampled uniformly in
    [0, limit] every ``hold`` steps) from randomized initial states, on the
    params' device.

    Returns ``(X, U)`` with ``X: [n_traj, n_steps+1, n]`` flat states and
    ``U: [n_traj, n_steps, m]`` applied controls; the supervised pairs are
    ``(X[:, k], U[:, k]) -> X[:, k+1]``. The trajectories are one batch of
    plants, each with its own control values in the boundary.

    ``init_ranges`` overrides the per-field uniform initial-condition
    envelope, e.g. ``{"pH": (6.0, 8.5)}``. The draws come from
    ``generator`` (``None``: one seeded with ``seed``); ``x0s``
    (``[n_traj, n]``) and ``u_seq`` (``[n_traj, n_steps, m]``) replace
    them."""
    controls = tuple(controls)
    if params.disinfection is not None:
        raise NotImplementedError(
            "surrogate state layout follows control.ekf.flatten_state, "
            "which does not carry the disinfection axis (pathogens/CT/"
            "THM) — train on a plant without enable_disinfection")
    nitrogen = params.nitrogen is not None
    gas = params.gas is not None
    biofilm = params.biofilm is not None
    dev = params.volume_L.device

    base = _template_state(params, n_zones, dtype, dev)
    x_base = flatten_state(base)
    n = x_base.shape[0]
    lo, hi = _flat_bounds(n_zones, nitrogen, gas, biofilm,
                          _n_classes(params), dtype, dev)
    ranges = {"pH": (6.0, 8.5), "chlorine": (0.0, 4.0),
              "temperature": (5.0, 30.0)}
    if init_ranges:
        ranges.update(init_ranges)
    fields = state_fields(nitrogen, gas, biofilm)
    limits = torch.tensor([_COMMAND_LIMITS[f] for f in controls],
                          dtype=dtype, device=dev)
    g = _generator(seed, generator, dev)

    def uniform(shape, a, b):
        return a + (b - a) * torch.rand(shape, generator=g, dtype=dtype,
                                        device=dev)

    if x0s is None:
        # randomized initial states: per-trajectory base value + per-zone
        # jitter within each field's envelope, flat layout
        x0s = x_base.expand(n_traj, n).clone()
        for i, f in enumerate(fields):
            if f not in ranges:
                continue
            a, b = ranges[f]
            jit_w = (b - a) * 0.1
            vals = uniform((n_traj, 1), a, b) \
                + uniform((n_traj, n_zones), -jit_w, jit_w)
            x0s[:, i * n_zones:(i + 1) * n_zones] = clip(vals, a, b)
        x0s = clip(x0s, lo, hi)
    else:
        x0s = torch.as_tensor(x0s, dtype=dtype, device=dev)
    if u_seq is None:
        n_holds = -(-n_steps // hold)
        u_draw = uniform((n_traj, n_holds, len(controls)), 0.0, 1.0) \
            * limits
        u_seq = torch.repeat_interleave(u_draw, hold, dim=1)[:, :n_steps]
    else:
        u_seq = torch.as_tensor(u_seq, dtype=dtype, device=dev)

    st = _unflatten(params, x0s, n_zones, base)
    xs = [x0s]
    with torch.no_grad():
        for t in range(n_steps):
            u_t = u_seq[:, t]
            bc = dataclasses.replace(
                boundary, **{f: u_t[:, i] for i, f in enumerate(controls)})
            st = R.step(params, st, bc, dt=dt, substeps=substeps,
                        stages=stages)
            xs.append(flatten_state(st))
    return torch.stack(xs, dim=1), u_seq


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

def surrogate_step(sp: SurrogateParams, x: torch.Tensor, u: torch.Tensor,
                   compute_dtype=_F32) -> torch.Tensor:
    """One surrogate transition ``x' = clip(x + residual(x, u))``.
    Broadcasts over any leading batch axes of ``x``/``u``."""
    xn = (x - sp.x_mean) / sp.x_std
    un = (u / sp.u_scale).expand(xn.shape[:-1] + u.shape[-1:])
    z = torch.cat([xn, un], dim=-1)
    r = _mlp_apply(sp.weights, z, compute_dtype)
    x_next = x + r * sp.r_std + sp.r_mean
    return clip(x_next, sp.lo, sp.hi)


def surrogate_rollout(sp: SurrogateParams, x0: torch.Tensor,
                      us: torch.Tensor,
                      compute_dtype=_F32) -> torch.Tensor:
    """Roll the surrogate over a ``[n_steps, ..., m]`` control sequence;
    returns the ``[n_steps, ..., n]`` predicted states. A batch of
    trajectories rides on the axes after the first (``x0: [B, n]``,
    ``us: [n_steps, B, m]``)."""
    x = x0
    xs = []
    for t in range(us.shape[0]):
        x = surrogate_step(sp, x, us[t], compute_dtype)
        xs.append(x)
    return torch.stack(xs)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _adam_loop(ws, n_steps, learning_rate, loss_fn):
    """``n_steps`` Adam steps of ``loss_fn(ws, i)`` over the weight list;
    returns the weights and the per-step losses (kept on the device)."""
    opt_state = optim.adam_init(ws)
    losses = []
    for i in range(n_steps):
        ws = [w.detach().requires_grad_(True) for w in ws]
        loss = loss_fn(ws, i)
        grads = torch.autograd.grad(loss, ws)
        with torch.no_grad():
            upd, opt_state = optim.adam_update(grads, opt_state,
                                               learning_rate)
            ws = optim.apply_updates(ws, upd)
        losses.append(loss.detach())
    ws = [w.detach() for w in ws]
    return ws, (torch.stack(losses) if losses
                else torch.zeros((0,), device=ws[0].device))


def _indices(values, device):
    return None if values is None else torch.as_tensor(
        values, dtype=torch.long, device=device)


def train_surrogate(X: torch.Tensor, U: torch.Tensor, n_zones: int,
                    seed: int = 0, hidden: Sequence[int] = (128, 128),
                    controls: Sequence[str] = _DEFAULT_CONTROLS,
                    n_steps: int = 6000, batch_size: int = 2048,
                    learning_rate: float = 3e-3,
                    rollout_steps: int = 0, rollout_horizon: int = 8,
                    nitrogen: bool = False, gas: bool = False,
                    biofilm: bool = False, n_classes: int = 0,
                    compute_dtype=_F32, generator=None,
                    init_weights=None, batch_indices=None,
                    rollout_indices=None
                    ) -> Tuple[SurrogateParams, Dict]:
    """Fit the surrogate to physics data by Adam, on ``X``'s device.

    ``X: [T, S+1, n]``, ``U: [T, S, m]`` as returned by
    :func:`make_surrogate_dataset` (or assembled from real plant
    history). Two phases:

    1. ``n_steps`` one-step minibatch MSE steps on the normalized
       residual;
    2. optional ``rollout_steps`` fine-tuning steps on
       ``rollout_horizon``-step open-loop rollouts (Adam at 0.3 x the
       rate), which suppresses the compounding drift one-step training
       ignores.

    The draws come from ``generator`` (``None``: one seeded with
    ``seed``); ``init_weights`` (the ``(W, b, ...)`` sequence),
    ``batch_indices`` (``[n_steps, batch_size]`` pair indices) and
    ``rollout_indices`` (``(ti, si)``, each ``[rollout_steps, rb]``)
    replace them. Returns ``(params, info)`` with per-phase loss curves
    in ``info``."""
    controls = tuple(controls)
    T, S1, n = X.shape
    S = S1 - 1
    if S < 1:
        raise ValueError(f"X needs >= 2 ticks per trajectory for "
                         f"transition pairs, got shape {tuple(X.shape)}")
    if U.ndim != 3 or tuple(U.shape[:2]) != (T, S):
        raise ValueError(f"U must be [{T}, {S}, m] to pair with X "
                         f"{tuple(X.shape)} (X[:, k] + U[:, k] -> "
                         f"X[:, k+1]); got {tuple(U.shape)}")
    m = U.shape[-1]
    dtype, dev = X.dtype, X.device

    x_k = X[:, :-1].reshape(-1, n)
    u_k = U.reshape(-1, m)
    x_k1 = X[:, 1:].reshape(-1, n)
    res = x_k1 - x_k
    x_mean = torch.mean(x_k, dim=0)
    x_std = clip(torch.std(x_k, dim=0, correction=0), 1e-6)
    r_mean = torch.mean(res, dim=0)
    r_std = clip(torch.std(res, dim=0, correction=0), 1e-8)
    u_scale = torch.tensor([_COMMAND_LIMITS[f] for f in controls],
                           dtype=dtype, device=dev)
    lo, hi = _flat_bounds(n_zones, nitrogen, gas, biofilm, n_classes,
                          dtype, dev)

    g = _generator(seed, generator, dev)
    if init_weights is None:
        weights = _init_mlp((n + m, *hidden, n), g, dev)
    else:
        weights = tuple(torch.as_tensor(w, dtype=_F32, device=dev)
                        for w in init_weights)
    sp = SurrogateParams(weights=weights, x_mean=x_mean, x_std=x_std,
                         u_scale=u_scale, r_mean=r_mean, r_std=r_std,
                         lo=lo, hi=hi)

    n_pairs = x_k.shape[0]
    batch_indices = _indices(batch_indices, dev)

    def one_step_loss(ws, i):
        idx = batch_indices[i] if batch_indices is not None else \
            torch.randint(0, n_pairs, (batch_size,), generator=g,
                          device=dev)
        xb, ub, rb = x_k[idx], u_k[idx], res[idx]
        spw = dataclasses.replace(sp, weights=tuple(ws))
        pred = surrogate_step(spw, xb, ub, compute_dtype)
        return torch.mean((((pred - xb) - rb) / sp.r_std) ** 2)

    ws, loss1 = _adam_loop(list(weights), n_steps, learning_rate,
                           one_step_loss)
    info = {"one_step_loss": loss1}

    if rollout_steps > 0:
        H = rollout_horizon
        if S < H:
            # the JAX package draws its windows from an empty range here
            raise ValueError(f"rollout fine-tuning needs trajectories of "
                             f">= rollout_horizon={H} transitions, got "
                             f"{S}")
        rb = max(1, batch_size // H)
        ti_all, si_all = (None, None) if rollout_indices is None else (
            _indices(v, dev) for v in rollout_indices)
        window = torch.arange(H, device=dev)

        def rollout_loss(ws, i):
            if ti_all is None:
                ti = torch.randint(0, T, (rb,), generator=g, device=dev)
                si = torch.randint(0, S - H + 1, (rb,), generator=g,
                                   device=dev)
            else:
                ti, si = ti_all[i], si_all[i]
            x0b = X[ti, si]
            steps = si[:, None] + window                     # [rb, H]
            usb = U[ti[:, None], steps].transpose(0, 1)      # [H, rb, m]
            xsb = X[ti[:, None], steps + 1].transpose(0, 1)  # [H, rb, n]
            spw = dataclasses.replace(sp, weights=tuple(ws))
            pred = surrogate_rollout(spw, x0b, usb, compute_dtype)
            return torch.mean(((pred - xsb) / sp.x_std) ** 2)

        ws, loss2 = _adam_loop(ws, rollout_steps, learning_rate * 0.3,
                               rollout_loss)
        info["rollout_loss"] = loss2

    return dataclasses.replace(sp, weights=tuple(ws)), info


def fit_plant_surrogate(config: R.ReactorConfiguration, dt: float,
                        boundary: Optional[R.BoundaryConditions] = None,
                        controls: Sequence[str] = _DEFAULT_CONTROLS,
                        n_traj: int = 512, n_steps: int = 48,
                        hidden: Sequence[int] = (128, 128),
                        train_steps: int = 6000,
                        rollout_steps: int = 600,
                        substeps: Optional[int] = None, stages=None,
                        seed: int = 0, compute_dtype=_F32,
                        dtype=DEFAULT_DTYPE, device=None,
                        generator=None) -> Tuple[SurrogateParams, Dict]:
    """Convenience end-to-end on ``device`` (``None``: the card): generate
    a physics dataset for ``config`` and train a surrogate on it. Returns
    ``(params, info)``; ``info`` carries the loss curves plus a held-out
    one-step RMSE per field. Every draw comes from one generator
    (``generator``, or one seeded with ``seed``): the training set, the
    training, then the held-out set."""
    dev = resolve_device(device)
    if substeps is None:
        substeps = R.default_substeps(config, dt)
    if boundary is None:
        boundary = R.BoundaryConditions()
    controls = tuple(controls)
    params = R.make_params(config, dtype=dtype, device=dev)
    g = _generator(seed, generator, dev)
    X, U = make_surrogate_dataset(params, config.n_zones, boundary, seed,
                                  n_traj, n_steps, dt, substeps,
                                  controls=controls, stages=stages,
                                  dtype=dtype, generator=g)
    sp, info = train_surrogate(
        X, U, config.n_zones, hidden=hidden, controls=controls,
        n_steps=train_steps, rollout_steps=rollout_steps,
        nitrogen=params.nitrogen is not None,
        gas=params.gas is not None,
        biofilm=params.biofilm is not None,
        n_classes=_n_classes(params), compute_dtype=compute_dtype,
        generator=g)

    # held-out validation: fresh trajectories, per-field one-step RMSE
    Xv, Uv = make_surrogate_dataset(params, config.n_zones, boundary, seed,
                                    max(8, n_traj // 8), n_steps, dt,
                                    substeps, controls=controls,
                                    stages=stages, dtype=dtype, generator=g)
    with torch.no_grad():
        err = surrogate_step(sp, Xv[:, :-1], Uv, compute_dtype) - Xv[:, 1:]
    fields = state_fields(params.nitrogen is not None,
                          params.gas is not None,
                          params.biofilm is not None)
    Z = config.n_zones
    info["val_rmse"] = {
        f: torch.sqrt(torch.mean(err[..., i * Z:(i + 1) * Z] ** 2))
        for i, f in enumerate(fields)}
    return sp, info


# ---------------------------------------------------------------------------
# Surrogate-planned MPC against the exact plant
# ---------------------------------------------------------------------------

def _plan(sp, x0, programs, moves0, dt, steps_per_move, iters,
          learning_rate, move_weight, controls, weights, tap_idx,
          compute_dtype):
    def cost(moves):
        cols = [st_clip(moves[..., i], 0.0, _COMMAND_LIMITS[f])
                for i, f in enumerate(controls)]
        u = torch.repeat_interleave(torch.stack(cols, dim=-1),
                                    steps_per_move, dim=0)
        x = x0
        sq = []
        for t in range(u.shape[0]):
            x = surrogate_step(sp, x, u[t], compute_dtype)
            sq.append(sum(w * (x[..., idx] - programs[t, j]) ** 2
                          for j, (idx, w) in enumerate(zip(tap_idx,
                                                           weights))))
        smooth = torch.sum((moves[1:] - moves[:-1]) ** 2) \
            if moves.shape[0] > 1 else 0.0
        return torch.sum(torch.stack(sq)) * dt + move_weight * smooth

    x0 = x0.detach()
    moves = moves0.detach()
    opt_state = optim.adam_init([moves])
    costs = []
    for _ in range(iters):
        moves = moves.detach().requires_grad_(True)
        c = cost(moves)
        (g,) = torch.autograd.grad(c, moves)
        g = torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
        with torch.no_grad():
            (upd,), opt_state = optim.adam_update(
                [g], opt_state, learning_rate, max_norm=10.0)
            moves = moves + upd
        costs.append(c.detach())
    lims = torch.tensor([_COMMAND_LIMITS[f] for f in controls],
                        dtype=moves.dtype, device=moves.device)
    costs = torch.stack(costs) if costs else moves.new_zeros((0,))
    return clip(moves.detach(), 0.0, lims), costs


def surrogate_mpc_plan(sp: SurrogateParams, x0: torch.Tensor,
                       setpoints: Dict, moves0: torch.Tensor, dt: float,
                       n_zones: int, steps_per_move: int,
                       iters: int = 30, learning_rate: float = 0.08,
                       move_weight: float = 0.05,
                       controls: Sequence[str] = _DEFAULT_CONTROLS,
                       weights: Optional[Dict] = None,
                       nitrogen: bool = False, gas: bool = False,
                       biofilm: bool = False,
                       compute_dtype=_F32):
    """Optimize a move sequence through the SURROGATE (same shooting
    shape as ``control.mpc.mpc_plan``, ~substeps x cheaper per Adam
    iteration). ``setpoints`` maps ``(field, zone)`` taps to
    ``[horizon]`` programs. A 1-D ``moves0`` is one control's column.
    Returns ``(moves [n_moves, m], costs)``."""
    controls = tuple(controls)
    taps = tuple(setpoints.keys())
    tap_idx = tuple(int(tap_index(f, z, n_zones, nitrogen, gas,
                                  biofilm=biofilm)) for f, z in taps)
    progs = torch.stack([torch.as_tensor(setpoints[t], device=x0.device)
                         for t in taps], dim=-1)
    w = tuple(float((weights or {}).get(t, 1.0)) for t in taps)
    if moves0.ndim == 1:
        moves0 = moves0[:, None]
    return _plan(sp, x0, progs, moves0, dt, int(steps_per_move),
                 int(iters), learning_rate, move_weight, controls, w,
                 tap_idx, compute_dtype)


def run_mpc_surrogate(config: R.ReactorConfiguration, sp: SurrogateParams,
                      setpoint_program, dt: float,
                      horizon_moves: int = 8, steps_per_move: int = 15,
                      replan_every: Optional[int] = None, iters: int = 30,
                      learning_rate: float = 0.08,
                      move_weight: float = 0.05,
                      boundary: Optional[R.BoundaryConditions] = None,
                      substeps: Optional[int] = None, stages=None,
                      controls: Sequence[str] = _DEFAULT_CONTROLS,
                      weights: Optional[Dict] = None,
                      compute_dtype=_F32, dtype=DEFAULT_DTYPE,
                      device=None) -> Dict:
    """Receding-horizon control of the TRUE plant with SURROGATE
    planning, on ``device`` (``None``: the card): every re-plan shoots
    through the learned model, the exact physics applies the moves and
    produces the state the next plan starts from (so surrogate model
    error cannot accumulate beyond one horizon). Mirrors
    ``control.mpc.run_mpc``'s interface and receding-horizon loop
    (padding, warm-start shift, score); the default program tracks
    ``("chlorine", -1)``.

    Returns applied commands, realized tracked trajectories (TRUE values)
    and the weighted tracking score, directly comparable to ``run_mpc``'s
    on the same program."""
    dev = resolve_device(device)
    controls = tuple(controls)
    if not isinstance(setpoint_program, dict):
        setpoint_program = {("chlorine", -1): setpoint_program}
    programs = {k: torch.as_tensor(v, dtype=dtype, device=dev)
                for k, v in setpoint_program.items()}
    if replan_every is None:
        replan_every = steps_per_move
    _check_programs(programs, replan_every)
    if substeps is None:
        substeps = R.default_substeps(config, dt)
    if boundary is None:
        boundary = R.BoundaryConditions()
    params = R.make_params(config, dtype=dtype, device=dev)
    state = [R.make_initial_state(config, dtype=dtype, device=dev)]
    Z = config.n_zones
    nitrogen = params.nitrogen is not None
    gas = params.gas is not None
    biofilm = params.biofilm is not None
    tap_idx = {t: int(tap_index(t[0], t[1], Z, nitrogen, gas,
                                biofilm=biofilm)) for t in programs}
    moves0 = torch.full((horizon_moves, len(controls)), 0.2, dtype=dtype,
                        device=dev)

    def plan(sp_h, moves_prev):
        moves, _ = surrogate_mpc_plan(
            sp, flatten_state(state[0]), sp_h,
            moves0 if moves_prev is None else moves_prev, dt=float(dt),
            n_zones=Z, steps_per_move=int(steps_per_move),
            iters=int(iters), learning_rate=learning_rate,
            move_weight=move_weight, controls=controls, weights=weights,
            nitrogen=nitrogen, gas=gas, biofilm=biofilm,
            compute_dtype=compute_dtype)
        return moves

    def advance(u_t):
        bc = dataclasses.replace(
            boundary, **{f: u_t[i] for i, f in enumerate(controls)})
        state[0] = R.step(params, state[0], bc, dt=float(dt),
                          substeps=int(substeps), stages=stages)
        x = flatten_state(state[0])
        return {t: x[idx] for t, idx in tap_idx.items()}, None

    u, tracked, _ = _receding(programs, replan_every, steps_per_move,
                              horizon_moves, dtype, dev, plan, advance)
    wts = weights or {}
    score = _score(tracked, programs,
                   {k: wts.get(k, 1.0) for k in programs}, dt)
    out = {"commands_by_control": {f: u[:, i]
                                   for i, f in enumerate(controls)},
           "tracked": tracked, "score": score, "final_state": state[0]}
    if controls == _DEFAULT_CONTROLS:
        out["commands"] = u[:, 0]
    if ("chlorine", -1) in tracked:
        out["chlorine_outlet"] = tracked[("chlorine", -1)]
    return out
