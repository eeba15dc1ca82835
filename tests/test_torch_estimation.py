"""The port's estimators and MPC (``control/estimator.py``, ``ekf.py``,
``enkf.py``, ``mhe.py``, ``mpc.py``) against the JAX package's, on the CPU
in float64 with 3-zone plants.

Seeded NumPy inputs go into both packages. Tolerances:
- forward values (the scalar Kalman filter, state estimates, the EnKF
  ensemble, tracked trajectories): atol 1e-10 + rtol 1e-10;
- what a Jacobian or a gradient sets (EKF covariances and gains, and the
  estimates, NIS and commands downstream of them): rtol 1e-9 + atol 1e-12;
- Adam-driven results (MHE, ``mpc_plan``, ``run_mpc``,
  ``run_mpc_output_feedback``, at most 4 iterations): rtol 1e-8 + atol
  1e-12.

The EnKF's draws come from ``jax.random`` exactly as the JAX step splits
its carried key (``enkf.py``: ``key, k_q, k_r = split(key, 3)``) and are
injected into the port's step; the instrumented plant's draws are NumPy
arrays given to both (the JAX ``plant_step`` patched by the plant's step
index).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu import control as JC
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL

from ics_wt_physicsengine_torch import control as TC
from ics_wt_physicsengine_torch.control import ekf as TE
from ics_wt_physicsengine_torch.core import reactor as TR

from torch_port_util import to_numpy

torch.set_num_threads(1)

ATOL = RTOL = 1e-10
JAC = dict(rtol=1e-9, atol=1e-12)
ADAM = dict(rtol=1e-8, atol=1e-12)
F64 = torch.float64
DT = 1.0
M = 2
Z = 3
CFG = dict(n_zones=Z, initial_chlorine=0.9, initial_pH=7.3)
BC = dict(inlet_flow_rate=5.0, inlet_pH=7.6, inlet_chlorine=0.4,
          inlet_temperature=21.0, chlorine_flow_rate=0.05)
TAPS = [("pH", 0), ("chlorine", -1), ("temperature", -1)]


def _close(port, ref, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(to_numpy(port), np.asarray(ref), rtol=rtol,
                               atol=atol, equal_nan=True, err_msg=what)


def _pair(**extra):
    cfg = dict(CFG, **extra)
    return (TR.make_params(TR.ReactorConfiguration(**cfg), dtype=F64,
                           device="cpu"),
            TR.make_initial_state(TR.ReactorConfiguration(**cfg), dtype=F64,
                                  device="cpu"),
            JR.make_params(JR.ReactorConfiguration(**cfg),
                           dtype=jnp.float64),
            JR.make_initial_state(JR.ReactorConfiguration(**cfg),
                                  dtype=jnp.float64))


def _measurements(n_steps, m, seed, shape=()):
    """Seeded readings near the plant's values, a few dropped (NaN)."""
    rng = np.random.default_rng(seed)
    base = np.array([7.35, 0.7, 20.4, 0.2, 0.1][:m])
    z = base + rng.normal(0.0, 0.02, (n_steps,) + shape + (m,))
    z[rng.random(z.shape) < 0.1] = np.nan
    return z


# ---------------------------------------------------------------------------
# scalar Kalman filter
# ---------------------------------------------------------------------------

def test_kalman_step_and_filtered_controller_match_jax():
    tp = TC.make_kalman_params(1e-4, 4e-4, dtype=F64, device="cpu")
    jp = JC.make_kalman_params(1e-4, 4e-4, dtype=jnp.float64)
    tc = TC.make_kalman_carry((4,), x0=1.0, dtype=F64, device="cpu")
    jc = JC.make_kalman_carry((4,), x0=1.0, dtype=jnp.float64)
    for z in _measurements(12, 4, 0)[:, :]:
        tc, tx = TC.kalman_step(tp, tc, torch.from_numpy(z), 2.0)
        jc, jx = JC.kalman_step(jp, jc, jnp.asarray(z), 2.0)
        _close(tx, jx)
        _close(tc.p, jc.p)
        np.testing.assert_array_equal(tc.initialized.numpy(),
                                      np.asarray(jc.initialized))
    # the wrapper filters the named readings before the control law
    gains_t = TC.DualPIDGains(
        chlorine=TC.make_gains(0.4, 0.02, 0.0, 1.0, 0.0, 1.0, F64, "cpu"),
        ph=TC.make_gains(-0.8, -0.05, 0.0, 7.2, 0.0, 2.0, F64, "cpu"))
    gains_j = JC.DualPIDGains(
        chlorine=JC.make_gains(0.4, 0.02, 0.0, 1.0, 0.0, 1.0, jnp.float64),
        ph=JC.make_gains(-0.8, -0.05, 0.0, 7.2, 0.0, 2.0, jnp.float64))
    wt = TC.filtered_controller(TC.dual_pid_controller,
                                {"chlorine_outlet": tp})
    wj = JC.filtered_controller(JC.dual_pid_controller,
                                {"chlorine_outlet": jp})
    ct = (TC.make_dual_pid_carry(dtype=F64, device="cpu"),
          {"chlorine_outlet": TC.make_kalman_carry(dtype=F64,
                                                   device="cpu")})
    cj = (JC.make_dual_pid_carry(dtype=jnp.float64),
          {"chlorine_outlet": JC.make_kalman_carry(dtype=jnp.float64)})
    for z in _measurements(6, 2, 1):
        obs = {"chlorine_outlet": z[0], "pH_inlet": 7.0 + z[1]}
        ct, cmd_t = wt(gains_t, ct, {k: torch.tensor(v, dtype=F64)
                                     for k, v in obs.items()}, 1.0)
        cj, cmd_j = wj(gains_j, cj, {k: jnp.float64(v)
                                     for k, v in obs.items()}, 1.0)
        for k in cmd_j:
            _close(cmd_t[k], cmd_j[k])


# ---------------------------------------------------------------------------
# EKF
# ---------------------------------------------------------------------------

def _ekf_run(tstep, jstep, tcarry, jcarry, zs, tbc, jbc, diag=False):
    jfn = jax.jit(jstep)
    for z in zs:
        tout = tstep(tcarry, torch.from_numpy(z), tbc)
        jout = jfn(jcarry, jnp.asarray(z), jbc)
        tcarry, jcarry = tout[0], jout[0]
        _close(tout[1], jout[1], **JAC, what="x")
        _close(tcarry.P, jcarry.P, **JAC, what="P")
        if diag:
            for k in jout[2]:
                _close(tout[2][k], jout[2][k], **JAC, what=k)
    return tcarry, jcarry


def test_ekf_step_with_diagnostics_and_dropouts_matches_jax():
    tp, ts, jp, js = _pair()
    tstep = TC.make_ekf(tp, Z, TAPS, DT, M, measurement_noise=(4e-4, 1e-3,
                                                               0.01),
                        diagnostics=True)
    jstep = JC.make_ekf(jp, Z, TAPS, DT, M, measurement_noise=(4e-4, 1e-3,
                                                               0.01),
                        diagnostics=True)
    p0 = (0.05, 1.0, 4.0)
    tc = TC.make_ekf_carry(ts, p0, Z)
    jc = JC.make_ekf_carry(js, p0, Z)
    _close(tc.P, jc.P, rtol=0, atol=0)
    zs = _measurements(5, 3, 2)
    zs[2, 1] = np.nan                      # a dropped chlorine sample
    tc, jc = _ekf_run(tstep, jstep, tc, jc, zs, TR.BoundaryConditions(**BC),
                      JR.BoundaryConditions(**BC), diag=True)
    # the NIS monitor over those diagnostics
    ema_t, upd_t = TC.nis_fault_monitor(3, dtype=F64, device="cpu")
    ema_j, upd_j = JC.nis_fault_monitor(3, dtype=jnp.float64)
    _, _, d_t = tstep(tc, torch.from_numpy(zs[0]),
                      TR.BoundaryConditions(**BC))
    _, _, d_j = jax.jit(jstep)(jc, jnp.asarray(zs[0]),
                               JR.BoundaryConditions(**BC))
    for _ in range(3):
        ema_t, f_t = upd_t(ema_t, d_t)
        ema_j, f_j = upd_j(ema_j, d_j)
    _close(ema_t, ema_j, **JAC)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))


def test_ekf_measurement_rows_on_an_extension_plant_match_jax():
    """Turbidity and plate-count taps are measurement rows; ammonia and
    oxygen taps read extension species."""
    axes = dict(enable_nitrogen=True, enable_gas=True,
                enable_particles=True, enable_biofilm=True,
                initial_ammonia=0.5, initial_tss=15.0,
                initial_bacteria=1e-3)
    tp, ts, jp, js = _pair(**axes)
    taps = [("turbidity", -1), ("hpc", -1), ("ammonia", -1),
            ("oxygen", -1), ("tss", 0)]
    tstep = TC.make_ekf(tp, Z, taps, DT, M, measurement_noise=0.05)
    jstep = JC.make_ekf(jp, Z, taps, DT, M, measurement_noise=0.05)
    p0 = 0.1
    rng = np.random.default_rng(3)
    zs = np.stack([[2.0, 400.0, 0.45, 8.5, 15.0] for _ in range(3)]) \
        * rng.uniform(0.95, 1.05, (3, 5))
    _ekf_run(tstep, jstep, TC.make_ekf_carry(ts, p0, Z),
             JC.make_ekf_carry(js, p0, Z), zs,
             TR.BoundaryConditions(**BC), JR.BoundaryConditions(**BC))
    for f, z in (("bacteria", -1), ("oxygen", 0)):
        assert TC.tap_index(f, z, Z, True, True, True) == \
            JC.tap_index(f, z, Z, True, True, True)
    assert TC.tss_index(1, -1, Z, 3, True, True, True) == \
        JC.tss_index(1, -1, Z, 3, True, True, True)
    x = TC.flatten_state(ts)
    back = TC.unflatten_state(x, Z, nitrogen=True, gas=True, biofilm=True,
                              n_classes=3)
    _close(TC.flatten_state(back), JC.flatten_state(js), rtol=0, atol=0)
    with pytest.raises(ValueError, match="turbidity taps need"):
        TC.make_ekf(_pair()[0], Z, [("turbidity", 0)], DT, M)


def test_augmented_ekf_matches_jax():
    tp, ts, jp, js = _pair()
    kw = dict(augment=("inlet_chlorine", "inlet_temperature"),
              augment_noise=(1e-5, 1e-4), measurement_noise=1e-3)
    tstep = TC.make_augmented_ekf(tp, Z, TAPS, DT, M, **kw)
    jstep = JC.make_augmented_ekf(jp, Z, TAPS, DT, M, **kw)
    tc = TC.make_augmented_carry(ts, (0.1, 18.0), 0.05, (0.5, 9.0), Z)
    jc = JC.make_augmented_carry(js, (0.1, 18.0), 0.05, (0.5, 9.0), Z)
    _close(tc.P, jc.P, rtol=0, atol=0)
    _ekf_run(tstep, jstep, tc, jc, _measurements(4, 3, 4),
             TR.BoundaryConditions(**BC), JR.BoundaryConditions(**BC))
    with pytest.raises(ValueError, match="not a BoundaryConditions"):
        TC.make_augmented_ekf(tp, Z, TAPS, DT, M, augment=("pump",))


def test_a_bank_of_filters_matches_jax_vmap():
    """A [4]-filter carry with per-filter boundaries: the port's natively
    batched step (vmap of jacfwd inside) against ``jax.vmap``."""
    tp, ts, jp, js = _pair()
    tstep = TC.make_ekf(tp, Z, TAPS, DT, M, measurement_noise=4e-4)
    jstep = JC.make_ekf(jp, Z, TAPS, DT, M, measurement_noise=4e-4)
    one_t, one_j = TC.make_ekf_carry(ts, 0.05, Z), JC.make_ekf_carry(js,
                                                                     0.05, Z)
    tc = TE.EKFCarry(x=one_t.x.expand(4, -1), P=one_t.P.expand(4, -1, -1))
    jc = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(
        a, (4,) + a.shape), one_j)
    q = np.array([0.0, 0.05, 0.1, 0.2])
    tbc = TR.BoundaryConditions(**dict(BC, chlorine_flow_rate=(
        torch.from_numpy(q))))
    jbc = JR.BoundaryConditions(**dict(BC, chlorine_flow_rate=jnp.asarray(
        q)))
    zs = _measurements(3, 3, 5, shape=(4,))
    bank = jax.vmap(jstep, in_axes=(0, 0, JR.BoundaryConditions(**{
        f.name: (0 if f.name == "chlorine_flow_rate" else None)
        for f in dataclasses.fields(JR.BoundaryConditions)})))
    _ekf_run(tstep, bank, tc, jc, zs, tbc, jbc)


@pytest.mark.parametrize("batched", [False, True])
def test_ekf_observer_in_a_closed_loop_matches_jax(batched):
    tp, ts, jp, js = _pair()
    n = 2 if batched else None
    shape = () if n is None else (n,)
    tstep = TC.make_ekf(tp, Z, TAPS, DT, M, measurement_noise=1e-3)
    jstep = JC.make_ekf(jp, Z, TAPS, DT, M, measurement_noise=1e-3)
    measured = ("pH_inlet", "chlorine_outlet", "temp_outlet")
    estimates = {"chlorine_outlet": ("chlorine", -1),
                 "chlorine_middle": ("chlorine", 1)}
    ctrl_t = TC.ekf_observer(functools.partial(TC.dual_pid_controller,
                                               warmup_gate=False),
                             tstep, Z, measured, estimates, batched=batched)
    ctrl_j = JC.ekf_observer(functools.partial(JC.dual_pid_controller,
                                               warmup_gate=False),
                             jstep, Z, measured, estimates, batched=batched)
    guess = dict(CFG, initial_chlorine=0.5)
    gt = TE.make_ekf_carry(TR.make_initial_state(
        TR.ReactorConfiguration(**guess), dtype=F64, device="cpu"), 0.05, Z)
    gj = JC.make_ekf_carry(JR.make_initial_state(
        JR.ReactorConfiguration(**guess), dtype=jnp.float64), 0.05, Z)
    if n:
        ts = TR.ReactorState(**{
            f.name: (None if getattr(ts, f.name) is None else
                     getattr(ts, f.name).expand(
                         (n,) + getattr(ts, f.name).shape))
            for f in dataclasses.fields(ts)})
        js = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), js)
        gt = TE.EKFCarry(x=gt.x.expand(n, -1), P=gt.P.expand(n, -1, -1))
        gj = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (n,) + x.shape), gj)
    gains_t = TC.DualPIDGains(
        chlorine=TC.make_gains(0.4, 0.02, 0.0, 1.0, 0.0, 1.0, F64, "cpu"),
        ph=TC.make_gains(-0.8, -0.05, 0.0, 7.2, 0.0, 2.0, F64, "cpu"))
    gains_j = JC.DualPIDGains(
        chlorine=JC.make_gains(0.4, 0.02, 0.0, 1.0, 0.0, 1.0, jnp.float64),
        ph=JC.make_gains(-0.8, -0.05, 0.0, 7.2, 0.0, 2.0, jnp.float64))
    got = TC.rollout_closed_loop(
        tp, ts, TR.BoundaryConditions(**BC), ctrl_t, gains_t,
        (TC.make_dual_pid_carry(shape, F64, "cpu"), gt), DT, M, 5,
        batched=batched)
    want = jax.jit(functools.partial(
        JC.rollout_closed_loop, controller=ctrl_j, dt=DT, substeps=M,
        n_steps=5, batched=batched))(
            jp, js, JR.BoundaryConditions(**BC), gains=gains_j,
            ctrl_carry=(JC.make_dual_pid_carry(shape, jnp.float64), gj))
    for k in want[3]:
        _close(got[3][k], want[3][k], **JAC, what=k)
    _close(got[1][1].x, want[1][1].x, **JAC)
    _close(got[1][1].P, want[1][1].P, **JAC)


# ---------------------------------------------------------------------------
# EnKF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("localize", [None, 1.0])
def test_enkf_with_jax_draws_matches_jax(localize):
    tp, ts, jp, js = _pair()
    n_ens = 16
    kw = dict(measurement_noise=(4e-4, 1e-3, 0.01), inflation=1.02,
              localization_radius=localize, diagnostics=True)
    tstep = TC.make_enkf(tp, Z, TAPS, DT, M, **kw)
    jstep = jax.jit(JC.make_enkf(jp, Z, TAPS, DT, M, **kw))
    key = jax.random.PRNGKey(3)
    jc = JC.make_enkf_carry(js, (0.05, 1.0, 4.0), Z, n_ens, key)
    # the carry's draw, as make_enkf_carry splits the key
    _, sub = jax.random.split(key)
    pert = jax.random.normal(sub, (n_ens, 3 * Z), jnp.float64)
    tc = TC.make_enkf_carry(ts, (0.05, 1.0, 4.0), Z, n_ens,
                            pert=torch.from_numpy(np.array(pert)))
    _close(tc.ensemble, jc.ensemble)
    for z in _measurements(4, 3, 6):
        # the step's draws, as enkf_step splits the carried key
        _, k_q, k_r = jax.random.split(jc.key, 3)
        w = np.asarray(jax.random.normal(k_q, (n_ens, 3 * Z), jnp.float64))
        eps = np.asarray(jax.random.normal(k_r, (3, n_ens), jnp.float64))
        tc, tx, td = tstep(tc, torch.from_numpy(z),
                           TR.BoundaryConditions(**BC),
                           w=torch.from_numpy(w),
                           eps_all=torch.from_numpy(eps))
        jc, jx, jd = jstep(jc, jnp.asarray(z), JR.BoundaryConditions(**BC))
        _close(tc.ensemble, jc.ensemble)
        _close(tx, jx)
        for k in jd:
            _close(td[k], jd[k], what=k)
    _close(TC.ensemble_spread(tc), JC.ensemble_spread(jc))
    # drawing from the carried generator runs and keeps the bounds
    tc, tx = TC.make_enkf(tp, Z, TAPS, DT, M)(
        TC.make_enkf_carry(ts, 0.05, Z, n_ens, generator=7),
        torch.from_numpy(_measurements(1, 3, 7)[0]),
        TR.BoundaryConditions(**BC))
    assert bool(torch.isfinite(tc.ensemble).all())
    with pytest.raises(ValueError, match="n_ensemble must be >= 2"):
        TC.make_enkf_carry(ts, 0.05, Z, 1)


# ---------------------------------------------------------------------------
# MHE
# ---------------------------------------------------------------------------

def test_mhe_matches_jax():
    tp, ts, jp, js = _pair()
    kw = dict(horizon=3, prior_variance=(0.05, 0.5, 2.0),
              measurement_noise=(4e-4, 1e-3, 0.01), iters=4,
              learning_rate=0.05)
    tstep = TC.make_mhe(tp, Z, TAPS, DT, M, **kw)
    jstep = JC.make_mhe(jp, Z, TAPS, DT, M, **kw)
    guess = dict(CFG, initial_chlorine=0.5, initial_pH=7.0)
    tc = TC.make_mhe_carry(TR.make_initial_state(
        TR.ReactorConfiguration(**guess), dtype=F64, device="cpu"), 3, 3,
        TR.BoundaryConditions(**BC))
    jc = JC.make_mhe_carry(JR.make_initial_state(
        JR.ReactorConfiguration(**guess), dtype=jnp.float64), 3, 3,
        JR.BoundaryConditions(**BC))
    for z in _measurements(4, 3, 8):
        tc, tx = tstep(tc, torch.from_numpy(z), TR.BoundaryConditions(**BC))
        jc, jx = jstep(jc, jnp.asarray(z), JR.BoundaryConditions(**BC))
        _close(tx, jx, **ADAM)
        _close(tc.x0, jc.x0, **ADAM)
        _close(tc.z_buf, jc.z_buf, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# MPC
# ---------------------------------------------------------------------------

def test_mpc_plan_matches_jax():
    tp, ts, jp, js = _pair()
    sp = {"chlorine_outlet": np.linspace(1.0, 1.4, 4),
          "pH_inlet": np.full(4, 7.2)}
    kw = dict(dt=DT, substeps=M, steps_per_move=2, iters=4,
              learning_rate=0.08, move_weight=0.05,
              controls=("chlorine_flow_rate", "acid_flow_rate"),
              weights={"chlorine_outlet": 1.0, "pH_inlet": 0.5})
    moves0 = np.array([[0.2, 0.1], [0.3, 0.0]])
    tm, tcost = TC.mpc_plan(tp, ts, TR.BoundaryConditions(**BC),
                            {k: torch.from_numpy(v) for k, v in sp.items()},
                            torch.from_numpy(moves0), **kw)
    jm, jcost = JC.mpc_plan(jp, js, JR.BoundaryConditions(**BC),
                            {k: jnp.asarray(v) for k, v in sp.items()},
                            jnp.asarray(moves0), **kw)
    _close(tm, jm, **ADAM)
    _close(tcost, jcost, **ADAM)
    # one control and an array program
    kw1 = dict(kw, controls=("chlorine_flow_rate",), weights=None)
    tm, tcost = TC.mpc_plan(tp, ts, TR.BoundaryConditions(**BC),
                            torch.from_numpy(sp["chlorine_outlet"]),
                            torch.tensor([0.9, 1.5], dtype=F64), **kw1)
    jm, jcost = JC.mpc_plan(jp, js, JR.BoundaryConditions(**BC),
                            jnp.asarray(sp["chlorine_outlet"]),
                            jnp.asarray([0.9, 1.5]), **kw1)
    assert tm.shape == (2,)
    _close(tm, jm, **ADAM)
    _close(tcost, jcost, **ADAM)


def test_run_mpc_matches_jax():
    kw = dict(dt=DT, horizon_moves=2, steps_per_move=2, iters=3,
              substeps=M, controls=("chlorine_flow_rate", "acid_flow_rate"))
    program = {"chlorine_outlet": np.array([1.0, 1.0, 1.3, 1.3]),
               "pH_inlet": np.full(4, 7.2)}
    got = TC.run_mpc(TR.ReactorConfiguration(**CFG), program, dtype=F64,
                     device="cpu", **kw)
    want = JC.run_mpc(JR.ReactorConfiguration(**CFG), program,
                      dtype=jnp.float64, **kw)
    for f in kw["controls"]:
        _close(got["commands_by_control"][f],
               want["commands_by_control"][f], **ADAM)
    for k in program:
        _close(got["tracked"][k], want["tracked"][k], **ADAM)
    assert got["score"] == pytest.approx(want["score"], rel=1e-8)
    with pytest.raises(ValueError, match="multiple of"):
        TC.run_mpc(TR.ReactorConfiguration(**CFG), np.ones(5), DT,
                   steps_per_move=2, device="cpu")


def test_run_mpc_output_feedback_matches_jax(monkeypatch):
    n_steps = 4
    rng = np.random.default_rng(11)
    steps = []
    for _ in range(n_steps):
        rand = {}
        for name, n_normals, n_uniforms in JPL._RAND_LAYOUT:
            u = rng.random((n_uniforms,))
            u[1] = 0.5                 # no open or short circuit rolled
            rand[name] = (rng.standard_normal((n_normals,)), u)
        steps.append(rand)
    stacked = {name: tuple(jnp.asarray(np.stack([s[name][i] for s in steps]))
                           for i in range(2))
               for name, _, _ in JPL._RAND_LAYOUT}
    orig = JPL.plant_step

    def patched(p, s, bc, dt, substeps, stages=None, rand=None,
                delayed=None):
        j = jnp.round(s.reactor.time / dt).astype(jnp.int32)
        return orig(p, s, bc, dt, substeps, stages=stages,
                    rand={k: (v[0][j], v[1][j]) for k, v in stacked.items()})
    monkeypatch.setattr(JPL, "plant_step", patched)

    kw = dict(dt=DT, taps=TAPS, measured=("pH_inlet", "chlorine_outlet",
                                          "temp_outlet"),
              horizon_moves=2, steps_per_move=2, iters=3, substeps=M,
              measurement_noise=(4e-4, 1e-3, 0.01))
    program = np.array([1.0, 1.0, 1.2, 1.2])
    got = TC.run_mpc_output_feedback(
        TR.ReactorConfiguration(**CFG), program, dtype=F64, device="cpu",
        rand=[{k: tuple(torch.from_numpy(x) for x in v)
               for k, v in s.items()} for s in steps], **kw)
    want = JC.run_mpc_output_feedback(JR.ReactorConfiguration(**CFG),
                                      program, dtype=jnp.float64, **kw)
    _close(got["commands"], want["commands"], **ADAM)
    _close(got["chlorine_outlet"], want["chlorine_outlet"], **ADAM)
    for k in kw["measured"]:
        _close(got["measured"][k], want["measured"][k], **ADAM)
    _close(got["final_estimate"].x, want["final_estimate"].x, **ADAM)
    assert got["score"] == pytest.approx(want["score"], rel=1e-8)
