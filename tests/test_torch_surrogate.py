"""The port's learned plant surrogate (``models/surrogate.py``) against the
JAX package's, on the CPU with 3-zone plants and (16, 16) hidden layers.

The port cannot reproduce ``jax.random``'s draws, so the tests compute
them with ``jax.random`` exactly as the JAX functions do and inject them:
the dataset's initial states and forcing (``x0s``/``u_seq``), the initial
weights, the minibatch indices and phase 2's ``(ti, si)``. Tolerances:
- the dataset in float64: atol 1e-10 + rtol 1e-10 (the physics, as the
  port's other float64 reactor tests);
- ``surrogate_step``/``surrogate_rollout``: the MLP is float32 in both
  packages whatever the state's type, so the error is held, as a share of
  ``x_std``, to 1e-5 with float32 products and to 1e-4 with bfloat16
  ones (the same rounded operands, summed in another order);
- training: the normalization statistics to 1e-12; the loss curves and
  the final weights to rtol 1e-4 (float32 weights through 25 Adam steps),
  the weights with an atol of 1e-7 besides, a few float32 ulps at their
  scale (0.1-1), for the entries that pass near 0;
- ``surrogate_mpc_plan`` and ``run_mpc_surrogate``: moves, costs,
  commands, tracked values and the score to rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.control.ekf import _flat_bounds as j_bounds
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import surrogate as JSG

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch import models as TM
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models import surrogate as TSG

from torch_port_util import to_numpy

torch.set_num_threads(1)

F64 = torch.float64
Z = 3
N = 3 * Z
DT = 30.0
DATA = dict(atol=1e-10, rtol=1e-10)
ADAM = dict(rtol=1e-4, atol=0.0)
CFG = dict(volume=1000.0, n_zones=Z, flow_rate=5.0, initial_pH=7.2,
           initial_chlorine=2.0, temperature=20.0)


def _close(port, ref, rtol=0.0, atol=0.0, what=""):
    np.testing.assert_allclose(to_numpy(port), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


def _port_sp(jsp, dtype=F64):
    return convert.surrogate_params_from_numpy(
        {f.name: (tuple(np.asarray(w) for w in jsp.weights)
                  if f.name == "weights" else np.asarray(getattr(jsp,
                                                                 f.name)))
         for f in dataclasses.fields(jsp)}, dtype=dtype, device="cpu")


def _dataset(n_traj=6, n_steps=12, key=0, **cfg_extra):
    """A JAX float64 dataset and its configuration pieces."""
    cfg = JR.ReactorConfiguration(**CFG, **cfg_extra)
    params = JR.make_params(cfg, dtype=jnp.float64)
    substeps = JR.default_substeps(cfg, DT)
    X, U = JSG.make_surrogate_dataset(
        params, Z, JR.BoundaryConditions(), jax.random.PRNGKey(key),
        n_traj, n_steps, DT, substeps, hold=4, dtype=jnp.float64)
    return cfg_extra, substeps, X, U


@pytest.fixture(scope="module")
def data():
    return _dataset()


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [{}, {"enable_nitrogen": True}],
                         ids=["core", "nitrogen"])
def test_dataset_matches_jax_with_its_draws_injected(axis, data):
    extra, substeps, X, U = data if not axis else _dataset(
        n_traj=3, n_steps=8, **axis)
    params = TR.make_params(TR.ReactorConfiguration(**CFG, **extra),
                            dtype=F64, device="cpu")
    Xp, Up = TSG.make_surrogate_dataset(
        params, Z, TR.BoundaryConditions(), 0, X.shape[0], U.shape[1], DT,
        substeps, hold=4, dtype=F64, x0s=np.array(X[:, 0]),
        u_seq=np.array(U))
    assert Xp.shape == X.shape and Xp.dtype == F64
    _close(Up, U)
    _close(Xp, X, **DATA)


def test_dataset_draws_its_own_forcing_in_the_envelope():
    params = TR.make_params(TR.ReactorConfiguration(**CFG), dtype=F64,
                            device="cpu")
    X, U = TSG.make_surrogate_dataset(params, Z, TR.BoundaryConditions(), 3,
                                      5, 10, DT, 2, hold=4, dtype=F64)
    assert X.shape == (5, 11, N) and U.shape == (5, 10, 1)
    u = to_numpy(U)[..., 0]
    assert u.min() >= 0.0 and u.max() <= 1.0
    assert (u[:, :4] == u[:, :1]).all() and (u[:, 4:8] == u[:, 4:5]).all()
    x0 = to_numpy(X[:, 0])
    assert (x0[:, :Z] >= 6.0).all() and (x0[:, :Z] <= 8.5).all()
    assert (x0[:, Z:2 * Z] >= 0.0).all() and (x0[:, Z:2 * Z] <= 4.0).all()
    X2, _ = TSG.make_surrogate_dataset(params, Z, TR.BoundaryConditions(),
                                       3, 5, 10, DT, 2, hold=4, dtype=F64)
    assert torch.equal(X, X2)


def test_dataset_refuses_the_disinfection_axis_as_jax_does():
    cfg = dict(CFG, enable_disinfection=True)
    with pytest.raises(NotImplementedError, match="disinfection"):
        JSG.make_surrogate_dataset(
            JR.make_params(JR.ReactorConfiguration(**cfg)), Z,
            JR.BoundaryConditions(), jax.random.PRNGKey(0), 2, 2, DT, 1)
    with pytest.raises(NotImplementedError, match="disinfection"):
        TSG.make_surrogate_dataset(
            TR.make_params(TR.ReactorConfiguration(**cfg), device="cpu"),
            Z, TR.BoundaryConditions(), 0, 2, 2, DT, 1)


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def _random_jax_sp(dtype):
    """bench.py's construction: LeCun-normal layers, the output layer
    un-zeroed, bench-like statistics in ``dtype``."""
    key = jax.random.PRNGKey(4)
    ws = list(JSG._init_mlp(key, (N + 1, 16, 16, N)))
    ws[-2] = 0.3 * jax.random.normal(jax.random.fold_in(key, 9),
                                     ws[-2].shape, jnp.float32)
    ws[-1] = 0.1 * jax.random.normal(jax.random.fold_in(key, 8),
                                     ws[-1].shape, jnp.float32)
    lo, hi = j_bounds(Z, False, False, False, 0, dtype)
    rep = lambda a, b, c: jnp.asarray(np.repeat([a, b, c], Z), dtype)
    return JSG.SurrogateParams(
        weights=tuple(ws), x_mean=rep(7.0, 2.0, 20.0),
        x_std=rep(0.7, 1.0, 5.0), u_scale=jnp.ones(1, dtype),
        r_mean=rep(0.01, -0.02, 0.05), r_std=rep(0.05, 0.2, 0.5), lo=lo,
        hi=hi)


def _states(dtype, shape):
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(6.0, 8.5, shape + (Z,)),
                        rng.uniform(0.0, 4.0, shape + (Z,)),
                        rng.uniform(5.0, 30.0, shape + (Z,))], axis=-1)
    return x.astype(dtype)


@pytest.mark.parametrize("compute,tol", [("float32", 1e-5),
                                         ("bfloat16", 1e-4)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_step_and_rollout_match_jax(dtype, compute, tol):
    jsp = _random_jax_sp(dtype)
    tsp = _port_sp(jsp, getattr(torch, dtype))
    jc, tc = getattr(jnp, compute), getattr(torch, compute)
    scale = np.asarray(jsp.x_std)
    x = _states(dtype, (7,))
    u = np.random.default_rng(2).uniform(0.0, 1.0, (7, 1)).astype(dtype)
    want = np.asarray(JSG.surrogate_step(jsp, x, u, compute_dtype=jc))
    got = TSG.surrogate_step(tsp, torch.from_numpy(x), torch.from_numpy(u),
                             compute_dtype=tc)
    assert got.dtype == getattr(torch, dtype)
    assert np.abs(want - x).max() > 0.01     # the MLP moves the state
    assert (np.abs(to_numpy(got) - want) / scale).max() <= tol

    us = np.random.default_rng(3).uniform(0.0, 1.0, (7, 8, 1)) \
        .astype(dtype)
    want = np.asarray(jax.vmap(lambda x0, v: JSG.surrogate_rollout(
        jsp, x0, v, compute_dtype=jc))(x, us))
    got = TSG.surrogate_rollout(tsp, torch.from_numpy(x),
                                torch.from_numpy(us).transpose(0, 1),
                                compute_dtype=tc).transpose(0, 1)
    assert got.shape == (7, 8, N)
    assert (np.abs(to_numpy(got) - want) / scale).max() <= tol


def test_mlp_uses_the_tanh_gelu():
    """jax.nn.gelu's default is the tanh form; torch's default is the erf
    form. A one-layer-deep net tells them apart."""
    z = torch.linspace(-3.0, 3.0, 13)
    w = (torch.eye(13), torch.zeros(13), torch.eye(13), torch.zeros(13))
    got = TSG._mlp_apply(w, z, torch.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(to_numpy(z))))
    _close(got, want, atol=1e-6)
    assert (got - torch.nn.functional.gelu(z)).abs().max() > 1e-4


def test_untrained_surrogate_is_identity_dynamics():
    n, m = N, 1
    ws = TSG._init_mlp((n + m, 32, n), torch.Generator().manual_seed(0),
                       "cpu")
    sp = TSG.SurrogateParams(
        weights=ws, x_mean=torch.zeros(n), x_std=torch.ones(n),
        u_scale=torch.ones(m), r_mean=torch.zeros(n), r_std=torch.ones(n),
        lo=torch.full((n,), -1e9), hi=torch.full((n,), 1e9))
    x = torch.linspace(0.0, 5.0, n)
    assert torch.equal(TSG.surrogate_step(sp, x, torch.tensor([0.3])), x)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

H = 4
BATCH = 32
PHASE1, PHASE2 = 20, 5


def _jax_draws(X):
    """The initial weights, minibatch indices and phase-2 windows that
    ``JSG.train_surrogate(..., key=PRNGKey(1))`` draws."""
    T, S1, n = X.shape
    S = S1 - 1
    key, k_w = jax.random.split(jax.random.PRNGKey(1))
    weights = JSG._init_mlp(k_w, (n + 1, 16, 16, n), jnp.float32)
    k1 = jax.random.fold_in(key, 1)
    idx = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(k1, i), (BATCH,), 0, T * S))
        for i in range(PHASE1)])
    k2 = jax.random.fold_in(key, 2)
    rb = BATCH // H
    ks = [jax.random.fold_in(k2, i) for i in range(PHASE2)]
    ti = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(k, 0), (rb,), 0, T)) for k in ks])
    si = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(k, 1), (rb,), 0, S - H + 1)) for k in ks])
    return [np.array(w) for w in weights], idx, (ti, si)


@pytest.fixture(scope="module")
def trained(data):
    _, _, X, U = data
    jsp, jinfo = JSG.train_surrogate(
        X, U, Z, jax.random.PRNGKey(1), hidden=(16, 16), n_steps=PHASE1,
        batch_size=BATCH, rollout_steps=PHASE2, rollout_horizon=H)
    w0, idx, windows = _jax_draws(X)
    tsp, tinfo = TSG.train_surrogate(
        torch.from_numpy(np.array(X)), torch.from_numpy(np.array(U)), Z,
        hidden=(16, 16), n_steps=PHASE1, batch_size=BATCH,
        rollout_steps=PHASE2, rollout_horizon=H, init_weights=w0,
        batch_indices=idx, rollout_indices=windows)
    return jsp, jinfo, tsp, tinfo


def test_training_statistics_match_jax(trained):
    jsp, _, tsp, _ = trained
    for name in ("x_mean", "x_std", "u_scale", "r_mean", "r_std", "lo",
                 "hi"):
        assert getattr(tsp, name).dtype == F64, name
        _close(getattr(tsp, name), getattr(jsp, name), rtol=1e-12,
               atol=1e-12, what=name)


def test_training_losses_and_weights_match_jax(trained):
    jsp, jinfo, tsp, tinfo = trained
    for name in ("one_step_loss", "rollout_loss"):
        assert tinfo[name].shape == jinfo[name].shape
        _close(tinfo[name], jinfo[name], **ADAM, what=name)
    for i, (a, b) in enumerate(zip(tsp.weights, jsp.weights)):
        assert a.dtype == torch.float32
        _close(a, b, rtol=ADAM["rtol"], atol=1e-7, what=f"weights[{i}]")


def test_training_draws_its_own_batches(data):
    _, _, X, U = data
    X, U = torch.from_numpy(np.array(X)), torch.from_numpy(np.array(U))
    runs = [TSG.train_surrogate(X, U, Z, seed=5, hidden=(8,), n_steps=4,
                                batch_size=16, rollout_steps=2,
                                rollout_horizon=H)[0] for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0].weights,
                                                 runs[1].weights))
    with pytest.raises(ValueError, match="U must be"):
        TSG.train_surrogate(X, U[:, 1:], Z)
    with pytest.raises(ValueError, match="rollout_horizon"):
        TSG.train_surrogate(X[:, :4], U[:, :3], Z, n_steps=1,
                            rollout_steps=1, rollout_horizon=H)


def test_fit_plant_surrogate_on_the_cpu():
    cfg = TR.ReactorConfiguration(**CFG)
    sp, info = TSG.fit_plant_surrogate(
        cfg, DT, n_traj=8, n_steps=8, hidden=(8,), train_steps=3,
        rollout_steps=2, seed=1, device="cpu")
    assert set(info) == {"one_step_loss", "rollout_loss", "val_rmse"}
    assert set(info["val_rmse"]) == {"pH", "chlorine", "temperature"}
    assert all(bool(torch.isfinite(v)) for v in info["val_rmse"].values())
    assert sp.x_mean.shape == (N,)


def test_entry_points_want_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg = TR.ReactorConfiguration(**CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSG.fit_plant_surrogate(cfg, DT, n_traj=2, n_steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSG.run_mpc_surrogate(cfg, None, np.full(15, 2.0), DT)


# ---------------------------------------------------------------------------
# surrogate-planned MPC
# ---------------------------------------------------------------------------

PROGRAM = np.concatenate([np.full(15, 1.5), np.full(15, 2.5)])


def _x0():
    return np.array(JSG.flatten_state(JR.make_initial_state(
        JR.ReactorConfiguration(**CFG), dtype=jnp.float64)))


def test_plan_matches_jax(trained):
    jsp, _, tsp, _ = trained
    x0 = _x0()
    sp_h = {("chlorine", -1): np.linspace(1.5, 2.5, 30),
            ("pH", 0): np.full(30, 7.1)}
    w = {("pH", 0): 0.5}
    moves0 = np.array([0.2, 0.4])
    jm, jc = JSG.surrogate_mpc_plan(
        jsp, jnp.asarray(x0), {k: jnp.asarray(v) for k, v in sp_h.items()},
        jnp.asarray(moves0), DT, Z, 15, iters=3, weights=w)
    tm, tc = TSG.surrogate_mpc_plan(
        tsp, torch.from_numpy(x0),
        {k: torch.from_numpy(v) for k, v in sp_h.items()},
        torch.from_numpy(moves0), DT, Z, 15, iters=3, weights=w)
    assert tm.shape == jm.shape == (2, 1)
    _close(tm, jm, **ADAM, what="moves")
    _close(tc, jc, **ADAM, what="costs")


def test_plan_through_a_pinned_prediction_keeps_the_dead_zone(trained):
    """A residual that drives the predicted chlorine below 0 pins it at
    the bound: the clip passes no gradient there, in JAX and in the port,
    so the tracking term cannot move the moves; only the smoothness term
    does."""
    jsp, _, _, _ = trained
    r_mean = np.asarray(jsp.r_mean).copy()
    r_mean[Z:2 * Z] = -50.0
    jsp = dataclasses.replace(jsp, r_mean=jnp.asarray(r_mean))
    tsp = _port_sp(jsp)
    x0 = _x0()
    cl = Z + Z - 1

    jg = jax.grad(lambda u: JSG.surrogate_step(jsp, jnp.asarray(x0),
                                               u)[cl])(jnp.asarray([0.4]))
    u = torch.tensor([0.4], dtype=F64, requires_grad=True)
    (tg,) = torch.autograd.grad(
        TSG.surrogate_step(tsp, torch.from_numpy(x0), u)[cl], u)
    assert float(to_numpy(tg)[0]) == float(np.asarray(jg)[0]) == 0.0

    sp_h = {("chlorine", -1): np.full(30, 2.0)}
    moves0 = np.array([0.1, 0.9])
    jm, jc = JSG.surrogate_mpc_plan(
        jsp, jnp.asarray(x0), {k: jnp.asarray(v) for k, v in sp_h.items()},
        jnp.asarray(moves0), DT, Z, 15, iters=3)
    tm, tc = TSG.surrogate_mpc_plan(
        tsp, torch.from_numpy(x0),
        {k: torch.from_numpy(v) for k, v in sp_h.items()},
        torch.from_numpy(moves0), DT, Z, 15, iters=3)
    _close(tm, jm, **ADAM, what="moves")
    _close(tc, jc, **ADAM, what="costs")
    # the tracking error never shrinks: every cost is the pinned 0 mg/L
    # against 2 mg/L, plus the smoothness term
    assert float(tc.min()) >= 2.0 ** 2 * 30 * DT


def test_run_mpc_surrogate_matches_jax(trained):
    jsp, _, tsp, _ = trained
    cfg = dict(CFG)
    ref = JSG.run_mpc_surrogate(JR.ReactorConfiguration(**cfg), jsp,
                                PROGRAM, DT, horizon_moves=2,
                                steps_per_move=15, iters=2,
                                dtype=jnp.float64)
    got = TM.run_mpc_surrogate(TR.ReactorConfiguration(**cfg), tsp,
                               PROGRAM, DT, horizon_moves=2,
                               steps_per_move=15, iters=2, dtype=F64,
                               device="cpu")
    assert set(got) == set(ref)
    _close(got["commands"], ref["commands"], **ADAM, what="commands")
    _close(got["commands_by_control"]["chlorine_flow_rate"],
           ref["commands_by_control"]["chlorine_flow_rate"], **ADAM)
    _close(got["chlorine_outlet"], ref["chlorine_outlet"], **ADAM,
           what="chlorine_outlet")
    assert set(got["tracked"]) == {("chlorine", -1)}
    np.testing.assert_allclose(got["score"], ref["score"], **ADAM)
    _close(got["final_state"].chlorine, ref["final_state"].chlorine,
           **ADAM)
