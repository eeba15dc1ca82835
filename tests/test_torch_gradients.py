"""Gradients of the port's reactor step at its clipped bounds against the
JAX package's, on the CPU in float64.

JAX's ``jnp.clip``, ``jnp.maximum`` and ``jnp.minimum`` split the tangent
half and half where the value sits on the bound; ``torch.clip`` and
``torch.clamp`` pass all of it. The port's step clips through
``utils.dispatch.clip`` / ``nonneg``, which follow JAX's rule, so a state
on its bounds (chlorine 0, pH 14, ammonia 0) has the same Jacobian in both
packages. Held: ``torch.func.jacfwd`` of one step against ``jax.jacfwd``
at atol 1e-12, and ``torch.autograd.grad`` through 3 steps against
``jax.grad`` at atol 1e-12 (both float64; the forward values of the two
steps agree to ~1e-15, and a wrong tie rule moves entries by ~0.3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import reactor as JR

from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.utils import dispatch as D

torch.set_num_threads(1)

ATOL = 1e-12
F64 = torch.float64
DT = 1.0
N_ZONES = 3
BC = dict(inlet_flow_rate=5.0, inlet_pH=7.5, inlet_chlorine=0.0,
          chlorine_flow_rate=0.0, acid_flow_rate=0.0, inlet_ammonia=0.0)
# (substeps, stages): RK4 x 3 and RKC x 4
PLANS = {"rk4": (3, None), "rkc": (1, 4)}
CASES = [(False, "rk4"), (False, "rkc"), (True, "rk4")]


def _fields(nitrogen):
    return ("pH", "chlorine", "temperature") + (
        TR.EXTENSION_STATE["nitrogen"] if nitrogen else ())


def _case(nitrogen):
    """(port params, port state, JAX params, JAX state, y0): a 3-zone
    plant whose chlorine is 0 and pH 14 in every zone (with nitrogen on,
    ammonia 0 too), y0 the flat state (field-major)."""
    kw = dict(n_zones=N_ZONES, initial_pH=14.0, initial_chlorine=0.0,
              enable_nitrogen=nitrogen, initial_nitrate=0.4,
              initial_nitrite=0.1, initial_chloramine=0.3)
    tp = TR.make_params(TR.ReactorConfiguration(**kw), dtype=F64,
                        device="cpu")
    ts = TR.make_initial_state(TR.ReactorConfiguration(**kw), dtype=F64,
                               device="cpu")
    jp = JR.make_params(JR.ReactorConfiguration(**kw), dtype=jnp.float64)
    js = JR.make_initial_state(JR.ReactorConfiguration(**kw),
                               dtype=jnp.float64)
    rng = np.random.default_rng(4)
    y0 = np.concatenate([np.asarray(getattr(js, f)) for f in
                         _fields(nitrogen)])
    # the temperature differs by zone; every bound stays as set
    y0[2 * N_ZONES:3 * N_ZONES] = rng.uniform(12.0, 24.0, N_ZONES)
    return tp, ts, jp, js, y0


def _port_fn(tp, ts, nitrogen, plan):
    bc = TR.BoundaryConditions(**BC)
    names = _fields(nitrogen)

    def f(y):
        parts = {n: y[i * N_ZONES:(i + 1) * N_ZONES]
                 for i, n in enumerate(names)}
        out = TR.step(tp, dataclasses.replace(ts, **parts), bc, DT, *plan)
        return torch.cat([getattr(out, n) for n in names])
    return f


def _jax_fn(jp, js, nitrogen, plan):
    bc = JR.BoundaryConditions(**BC)
    names = _fields(nitrogen)
    m, s = plan

    def f(y):
        parts = {n: y[i * N_ZONES:(i + 1) * N_ZONES]
                 for i, n in enumerate(names)}
        out = JR.step(jp, dataclasses.replace(js, **parts), bc, DT, m,
                      stages=s)
        return jnp.concatenate([getattr(out, n) for n in names])
    return f


@pytest.mark.parametrize("nitrogen,plan", CASES,
                         ids=["core-rk4", "core-rkc", "nitrogen-rk4"])
def test_step_jacobian_at_the_bounds_matches_jax(nitrogen, plan):
    tp, ts, jp, js, y0 = _case(nitrogen)
    f_t = _port_fn(tp, ts, nitrogen, PLANS[plan])
    f_j = _jax_fn(jp, js, nitrogen, PLANS[plan])
    np.testing.assert_allclose(f_t(torch.from_numpy(y0)).numpy(),
                               np.asarray(f_j(jnp.asarray(y0))), rtol=0,
                               atol=ATOL)
    got = torch.func.jacfwd(f_t)(torch.from_numpy(y0)).numpy()
    want = np.asarray(jax.jacfwd(f_j)(jnp.asarray(y0)))
    # the bounds are ties: the rule decides entries of order 0.1-1
    cl = slice(N_ZONES, 2 * N_ZONES)
    assert np.abs(want[cl, cl]).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nitrogen", [False, True], ids=["core", "nitrogen"])
def test_three_step_gradient_at_the_bounds_matches_jax(nitrogen):
    tp, ts, jp, js, y0 = _case(nitrogen)
    f_t = _port_fn(tp, ts, nitrogen, PLANS["rk4"])
    f_j = _jax_fn(jp, js, nitrogen, PLANS["rk4"])
    w = np.random.default_rng(8).uniform(0.5, 1.5, y0.shape)

    def loss_j(y):
        for _ in range(3):
            y = f_j(y)
        return jnp.sum(jnp.asarray(w) * y)

    y = torch.from_numpy(y0).requires_grad_(True)
    out = y
    for _ in range(3):
        out = f_t(out)
    (got,) = torch.autograd.grad(torch.sum(torch.from_numpy(w) * out), y)
    want = np.asarray(jax.grad(loss_j)(jnp.asarray(y0)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_tie_helpers_keep_the_values_and_take_jax_rule():
    x = torch.tensor([-1.0, 0.0, 0.5, 1.0, 2.0, float("nan")], dtype=F64)
    np.testing.assert_array_equal(D.clip(x, 0.0, 1.0).numpy(),
                                  torch.clip(x, 0.0, 1.0).numpy())
    np.testing.assert_array_equal(D.nonneg(x).numpy(),
                                  torch.clamp(x, min=0.0).numpy())
    np.testing.assert_array_equal(D.absolute(x[:-1]).numpy(),
                                  torch.abs(x[:-1]).numpy())
    xs = x[:-1].numpy()
    for port, ref in ((lambda a: D.clip(a, 0.0, 1.0),
                       lambda a: jnp.clip(a, 0.0, 1.0)),
                      (D.nonneg, lambda a: jnp.maximum(a, 0.0)),
                      (lambda a: D.clip(a, hi=0.5),
                       lambda a: jnp.minimum(a, 0.5)),
                      (D.absolute, jnp.abs)):
        got = torch.func.vmap(torch.func.grad(port))(torch.from_numpy(xs))
        want = jax.vmap(jax.grad(ref))(jnp.asarray(xs))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _dose_loss_t(tp, ts, remat, scheduled):
    def loss(q):
        if scheduled:
            bc = TR.BoundaryConditions(**dict(
                BC, chlorine_flow_rate=q * torch.linspace(0.5, 1.5, 4,
                                                          dtype=F64)))
            f, traj = TR.rollout_scheduled(tp, ts, bc, DT, 2, remat=remat)
        else:
            bc = TR.BoundaryConditions(**dict(BC, chlorine_flow_rate=q))
            f, traj = TR.rollout(tp, ts, bc, DT, 2, 4, remat=remat)
        return torch.sum(f.chlorine) + torch.sum(traj["pH"])
    return loss


@pytest.mark.parametrize("scheduled", [False, True],
                         ids=["rollout", "rollout_scheduled"])
def test_remat_rollouts_keep_values_and_match_jax_gradients(scheduled):
    """``remat=True`` (``torch.utils.checkpoint`` per step) gives the same
    loss and gradient bit for bit as ``remat=False``, and JAX's
    ``remat=True`` gradient at rtol 1e-9."""
    kw = dict(n_zones=N_ZONES, initial_chlorine=0.6)
    tp = TR.make_params(TR.ReactorConfiguration(**kw), dtype=F64,
                        device="cpu")
    ts = TR.make_initial_state(TR.ReactorConfiguration(**kw), dtype=F64,
                               device="cpu")
    jp = JR.make_params(JR.ReactorConfiguration(**kw), dtype=jnp.float64)
    js = JR.make_initial_state(JR.ReactorConfiguration(**kw),
                               dtype=jnp.float64)
    got = []
    for remat in (False, True):
        q = torch.tensor(0.2, dtype=F64, requires_grad=True)
        val = _dose_loss_t(tp, ts, remat, scheduled)(q)
        (grad,) = torch.autograd.grad(val, q)
        got.append((val.item(), grad.item()))
    assert got[0] == got[1]

    def loss_j(q):
        if scheduled:
            bc = JR.BoundaryConditions(**dict(
                BC, chlorine_flow_rate=q * jnp.linspace(0.5, 1.5, 4)))
            f, traj = JR.rollout_scheduled(jp, js, bc, DT, 2, remat=True)
        else:
            bc = JR.BoundaryConditions(**dict(BC, chlorine_flow_rate=q))
            f, traj = JR.rollout(jp, js, bc, DT, 2, 4, remat=True)
        return jnp.sum(f.chlorine) + jnp.sum(traj["pH"])

    want = jax.jit(jax.value_and_grad(loss_j))(0.2)
    np.testing.assert_allclose(got[1], [float(w) for w in want], rtol=1e-9,
                               atol=0)
    assert got[1][1] != 0.0


def test_plant_rollout_remat_replays_the_generator():
    """``plant_rollout(remat=True)``: the same readings and gradient as
    without it, and the caller's generator left where the plain run
    leaves it (the recomputation draws from a copy)."""
    from ics_wt_physicsengine_torch.models import plant as TPL

    pp, pl = TPL.make_plant(TR.ReactorConfiguration(n_zones=N_ZONES),
                            dtype=F64, device="cpu")
    out = []
    for remat in (False, True):
        g = torch.Generator().manual_seed(3)
        q = torch.tensor(0.1, dtype=F64, requires_grad=True)
        fin, rd = TPL.plant_rollout(
            pp, pl, TR.BoundaryConditions(chlorine_flow_rate=q), DT, 2, 5,
            generator=g, remat=remat)
        val = fin.reactor.chlorine.sum() + rd["chlorine_outlet"].sum()
        (grad,) = torch.autograd.grad(val, q)
        out.append((rd["chlorine_outlet"].detach().numpy(), float(grad),
                    g.get_state()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] != 0.0
    assert torch.equal(out[0][2], out[1][2])
