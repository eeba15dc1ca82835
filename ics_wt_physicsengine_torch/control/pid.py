"""
PID as a pure, batchable, differentiable transform on tensors (port of
``ics_wt_physicsengine_tpu/control/pid.py``).

``pid_step`` is a function of a small carry, so it runs in the closed-loop
rollout with the plant (``control/closed_loop.py``), broadcasts over a
``[n_gains]`` axis for tuning sweeps (``control/tuning.py``) and
differentiates for gradient tuning. Its order of operations and float
comparisons are those of ``examples/pid_controller.py::PID``, the host
controller the HIL tests drive over Modbus, so a swept gain transfers
verbatim to an external PLC.

``st_clip`` and ``ste_clip`` (``jax.custom_jvp`` in the JAX package) are
``torch.autograd.Function``s with a ``backward``, a ``jvp`` and a generated
vmap rule: ``torch.autograd.grad``, ``torch.func.jacfwd`` and
``torch.func.vmap`` all pass through them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ics_wt_physicsengine_torch.device import DEFAULT_DTYPE, resolve_device
from ics_wt_physicsengine_torch.utils.dispatch import clip


@dataclass(frozen=True)
class PIDGains:
    """Controller parameters: every field may carry a leading batch axis
    (a ``[n_gains]`` sweep) or require grad (gradient tuning)."""

    kp: torch.Tensor
    ki: torch.Tensor
    kd: torch.Tensor
    setpoint: torch.Tensor
    out_min: torch.Tensor
    out_max: torch.Tensor


@dataclass
class PIDCarry:
    """Controller state carried between ticks (the host PID's
    ``integral`` / ``prev_error``; ``has_prev`` encodes its
    ``prev_error is None`` first-call branch)."""

    integral: torch.Tensor
    prev_error: torch.Tensor
    has_prev: torch.Tensor     # bool


def make_gains(kp: float, ki: float, kd: float, setpoint: float,
               out_min: float, out_max: float, dtype=DEFAULT_DTYPE,
               device=None) -> PIDGains:
    """Gains on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)

    def a(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)
    return PIDGains(kp=a(kp), ki=a(ki), kd=a(kd), setpoint=a(setpoint),
                    out_min=a(out_min), out_max=a(out_max))


def make_pid_carry(batch_shape=(), dtype=DEFAULT_DTYPE,
                   device=None) -> PIDCarry:
    """A fresh carry on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    shape = tuple(batch_shape)
    return PIDCarry(integral=torch.zeros(shape, dtype=dtype, device=dev),
                    prev_error=torch.zeros(shape, dtype=dtype, device=dev),
                    has_prev=torch.zeros(shape, dtype=torch.bool,
                                         device=dev))


_ST_CLIP_LEAK = 0.1


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """``g`` summed over the axes broadcasting added to an input of
    ``shape``."""
    if g.shape == shape:
        return g
    lead = g.ndim - len(shape)
    g = g.sum(dim=tuple(range(lead))) if lead else g
    keep = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=keep, keepdim=True) if keep else g


class _ClipStraightThrough(torch.autograd.Function):
    """``clip(x, lo, hi)`` forward; the tangent of ``x`` scaled by 1 in
    range and by ``leak`` where clipped (``lo`` and ``hi`` get none)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, lo, hi, leak):
        return clip(x, lo, hi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, lo, hi, leak = inputs
        if leak == 1.0:
            scale = torch.ones_like(output)
        else:
            in_range = ((x >= lo) & (x <= hi)).to(output.dtype)
            scale = in_range + leak * (1.0 - in_range)
        ctx.save_for_backward(scale)
        ctx.save_for_forward(scale)
        ctx.x_shape = x.shape

    @staticmethod
    def backward(ctx, grad):
        (scale,) = ctx.saved_tensors
        return _sum_to(grad * scale, ctx.x_shape), None, None, None

    @staticmethod
    def jvp(ctx, dx, dlo, dhi, dleak):
        (scale,) = ctx.saved_tensors
        return dx * scale


def st_clip(x, lo, hi):
    """Leaky straight-through clip: forward ``clip(x, lo, hi)``; the
    tangent passes scaled by 1 in range and by ``_ST_CLIP_LEAK`` (0.1) when
    saturated.

    Gradient tuning (``control/tuning.py``, ``control/mpc.py``) needs
    gradients that survive actuator saturation: through a hard clip a
    rollout whose command rails has zero gradient in the gains, and one
    optimizer step into the rail stalls the tuner. A full straight-through
    clip makes the tangent system the unclipped loop instead, which for
    aggressive gains grows exponentially over a long rollout; the leak
    keeps an escape direction at the rail and damps the recurrent tangent
    tenfold per saturated step."""
    return _ClipStraightThrough.apply(x, lo, hi, _ST_CLIP_LEAK)


def ste_clip(x, lo, hi):
    """Full straight-through clip: forward ``clip(x, lo, hi)``, the tangent
    passes unchanged.

    The estimation-side counterpart of :func:`st_clip`. A Kalman filter's
    process Jacobian must be the physical sensitivity at the nearest
    feasible point: any discount at the bound scales a state's
    self-transition below 1, and the covariance predict shrinks that
    state's variance by its square every step (an unmeasured wall film
    pushed below zero by one noisy update would read "clean tank" for
    good). An EKF relinearizes every step, so the recurrent growth the
    leak guards against cannot accumulate here."""
    return _ClipStraightThrough.apply(x, lo, hi, 1.0)


def pid_step(gains: PIDGains, carry: PIDCarry, measurement, dt: float,
             active=None, clip_mode: str = "hard"):
    """One discrete PID update -> ``(new_carry, command)``.

    Matches ``examples/pid_controller.py::PID.update`` operation for
    operation: error, integral accumulation, first-call derivative 0,
    output clamp to [out_min, out_max], and the anti-windup rule that
    un-accumulates the integral whenever the clamp engaged (the exact float
    ``!=`` of the host version).

    ``active`` (optional bool mask): where False the carry passes through
    unchanged and the command is 0 (the host loop's "sensor still warming
    up" gate). A NaN measurement makes any comparison False, so a faulted
    reading freezes rather than poisons the controller.

    ``clip_mode``: ``"hard"`` (exact host semantics) or
    ``"straight-through"`` (the same values, saturation-proof gradients:
    ``st_clip``).
    """
    error = gains.setpoint - measurement
    integral = carry.integral + error * dt
    derivative = torch.where(carry.has_prev,
                             (error - carry.prev_error) / dt, 0.0)
    out = gains.kp * error + gains.ki * integral + gains.kd * derivative
    clip_fn = clip if clip_mode == "hard" else st_clip
    clamped = clip_fn(out, gains.out_min, gains.out_max)
    # anti-windup: the host PID's float comparison
    integral = torch.where(clamped != out, integral - error * dt, integral)

    new_carry = PIDCarry(integral=integral, prev_error=error,
                         has_prev=torch.ones_like(carry.has_prev))
    if active is None:
        return new_carry, clamped

    def sel(n, o):
        return torch.where(active, n, o)
    gated = PIDCarry(integral=sel(new_carry.integral, carry.integral),
                     prev_error=sel(new_carry.prev_error, carry.prev_error),
                     has_prev=sel(new_carry.has_prev, carry.has_prev))
    return gated, torch.where(active, clamped, torch.zeros_like(clamped))
