"""The port's control package (``control/pid.py``, ``closed_loop.py``,
``optim.py``, ``tuning.py``) against the JAX package's, on the CPU in
float64.

Seeded NumPy inputs go into both packages. Tolerances:
- ``pid_step``, the active gate, the straight-through clips' values and
  tangents, and the command validation are bit-equal (the same float
  operations in the same order);
- forward paths through the plant (``rollout_closed_loop`` with ``observe``
  ``"true"`` and ``"sensors"``, schedules, disturbances, sweeps): atol 1e-10
  + rtol 1e-10 (float64 rounding over at most 10 steps, the two libraries'
  ``exp``/``pow``);
- gradients through the closed loop: rtol 1e-9;
- Adam-driven results (``tune_pid_gradient``, 3 iterations): rtol 1e-8.

The instruments get the same draws on both sides: the port through
``rollout_closed_loop(rand=...)``, the JAX package through its
``plant_step(rand=...)``, patched in by the plant's step index (its
reactor time over dt).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu import control as JC
from ics_wt_physicsengine_tpu.control import closed_loop as JCL
from ics_wt_physicsengine_tpu.control import pid as JP
from ics_wt_physicsengine_tpu.control import tuning as JT
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL

from ics_wt_physicsengine_torch import control as TC
from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch.control import optim as TO
from ics_wt_physicsengine_torch.control import pid as TP
from ics_wt_physicsengine_torch.core import reactor as TR

from torch_port_util import to_numpy, tree_to_numpy

torch.set_num_threads(1)

ATOL = RTOL = 1e-10
GRAD_RTOL = 1e-9
ADAM_RTOL = 1e-8
F64 = torch.float64
DT = 1.0
M = 2                      # RK4 substeps
CFG = dict(n_zones=3, initial_chlorine=0.8, initial_pH=7.3)
BC = dict(inlet_flow_rate=5.0, inlet_pH=7.6, inlet_chlorine=0.3,
          inlet_temperature=21.0)
LAYOUT = JPL._RAND_LAYOUT


def _close(port, ref, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(to_numpy(port), np.asarray(ref), rtol=rtol,
                               atol=atol, equal_nan=True, err_msg=what)


def _tree_close(port, ref, rtol=RTOL, atol=ATOL, path=""):
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _tree_close(getattr(port, f.name), getattr(ref, f.name), rtol,
                        atol, f"{path}.{f.name}")
    elif isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            _tree_close(port[k], ref[k], rtol, atol, f"{path}[{k}]")
    elif isinstance(port, (tuple, list)):
        for i, (a, b) in enumerate(zip(port, ref)):
            _tree_close(a, b, rtol, atol, f"{path}[{i}]")
    elif port is None or isinstance(port, (int, str)):
        assert port == ref, path
    else:
        _close(port, ref, rtol, atol, path)


def _gains(mod, n=None, kd=0.05):
    """Dual PID gains of either package; ``n`` lanes of seeded gains."""
    if n is None:
        kw = dict(dtype=F64, device="cpu") if mod is TC else dict(
            dtype=jnp.float64)
        return mod.DualPIDGains(
            chlorine=mod.make_gains(0.4, 0.02, kd, 1.0, 0.0, 1.0, **kw),
            ph=mod.make_gains(-0.8, -0.05, 0.0, 7.2, 0.0, 2.0, **kw))
    rng = np.random.default_rng(n)
    kp_cl, ki_cl, kp_ph, ki_ph = (rng.uniform(lo, hi, n) for lo, hi in (
        (0.1, 1.5), (0.0, 0.1), (-2.0, -0.2), (-0.2, 0.0)))

    def arr(x):
        return torch.from_numpy(np.asarray(x, np.float64)) if mod is TC \
            else jnp.asarray(x, jnp.float64)

    def full(v):
        return arr(np.full(n, v))
    return mod.DualPIDGains(
        chlorine=mod.PIDGains(kp=arr(kp_cl), ki=arr(ki_cl), kd=full(kd),
                              setpoint=full(1.0), out_min=full(0.0),
                              out_max=full(1.0)),
        ph=mod.PIDGains(kp=arr(kp_ph), ki=arr(ki_ph), kd=full(0.0),
                        setpoint=full(7.2), out_min=full(0.0),
                        out_max=full(2.0)))


def _reactors(n=None, **extra):
    """(port params, port state, JAX params, JAX state); ``n`` lanes."""
    cfg = dict(CFG, **extra)
    jp = JR.make_params(JR.ReactorConfiguration(**cfg), dtype=jnp.float64)
    js = JR.make_initial_state(JR.ReactorConfiguration(**cfg),
                               dtype=jnp.float64)
    tp = TR.make_params(TR.ReactorConfiguration(**cfg), dtype=F64,
                        device="cpu")
    ts = TR.make_initial_state(TR.ReactorConfiguration(**cfg), dtype=F64,
                               device="cpu")
    if n is not None:
        js = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), js)
        ts = TR.ReactorState(**{
            f.name: (None if getattr(ts, f.name) is None else
                     getattr(ts, f.name).expand(
                         (n,) + getattr(ts, f.name).shape))
            for f in dataclasses.fields(ts)})
    return tp, ts, jp, js


# ---------------------------------------------------------------------------
# pid
# ---------------------------------------------------------------------------

def test_pid_step_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    tg, jg = _gains(TC).chlorine, _gains(JC).chlorine
    tc = TC.make_pid_carry(dtype=F64, device="cpu")
    jc = JC.make_pid_carry(dtype=jnp.float64)
    for i in range(120):
        m = float(rng.uniform(-1.0, 5.0))
        tc, got = TC.pid_step(tg, tc, torch.tensor(m, dtype=F64), 1.0)
        jc, want = JC.pid_step(jg, jc, jnp.float64(m), 1.0)
        assert float(got) == float(want), i
        assert float(tc.integral) == float(jc.integral), i
    # batched gains, both clip modes, one frozen lane
    tg, jg = _gains(TC, 5).chlorine, _gains(JC, 5).chlorine
    meas = rng.uniform(0.0, 3.0, (8, 5))
    for mode in ("hard", "straight-through"):
        tc = TC.make_pid_carry((5,), dtype=F64, device="cpu")
        jc = JC.make_pid_carry((5,), dtype=jnp.float64)
        for row in meas:
            active = row > 0.3
            tc, got = TC.pid_step(tg, tc, torch.from_numpy(row), 0.5,
                                  active=torch.from_numpy(active),
                                  clip_mode=mode)
            jc, want = JC.pid_step(jg, jc, jnp.asarray(row), 0.5,
                                   active=jnp.asarray(active),
                                   clip_mode=mode)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            for f in ("integral", "prev_error", "has_prev"):
                np.testing.assert_array_equal(
                    getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))


def test_active_gate_freezes_the_carry_like_jax():
    tg = TC.make_gains(1.0, 0.5, 0.0, 2.0, 0.0, 10.0, F64, device="cpu")
    jg = JC.make_gains(1.0, 0.5, 0.0, 2.0, 0.0, 10.0, jnp.float64)
    tc, _ = TC.pid_step(tg, TC.make_pid_carry(dtype=F64, device="cpu"),
                        torch.tensor(1.0, dtype=F64), 1.0)
    jc, _ = JC.pid_step(jg, JC.make_pid_carry(dtype=jnp.float64),
                        jnp.float64(1.0), 1.0)
    nan = torch.tensor(float("nan"), dtype=F64)
    tf, tcmd = TC.pid_step(tg, tc, nan, 1.0, active=nan > 0.0)
    jf, jcmd = JC.pid_step(jg, jc, jnp.float64(float("nan")), 1.0,
                           active=jnp.float64(float("nan")) > 0.0)
    assert float(tcmd) == float(jcmd) == 0.0
    for f in ("integral", "prev_error", "has_prev"):
        assert float(getattr(tf, f)) == float(getattr(jf, f)) \
            == float(getattr(tc, f))


@pytest.mark.parametrize("name", ["st_clip", "ste_clip"])
def test_straight_through_clips_match_jax_custom_jvp(name):
    port, ref = getattr(TP, name), getattr(JP, name)
    x = np.array([-1.0, 0.0, 0.25, 0.5, 1.0, 2.5])
    lo, hi = 0.0, 1.0
    np.testing.assert_array_equal(
        port(torch.from_numpy(x), lo, hi).numpy(),
        np.asarray(ref(jnp.asarray(x), lo, hi)))
    # grad of each element, mapped (vmap over grad)
    got = torch.func.vmap(torch.func.grad(
        lambda a: port(a * 3.0, lo, hi)))(torch.from_numpy(x))
    want = jax.vmap(jax.grad(lambda a: ref(a * 3.0, lo, hi)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # forward mode through a composition, with tensor bounds
    tlo = torch.tensor(0.1, dtype=F64)
    got = torch.func.jacfwd(lambda a: port(torch.sin(a), tlo, hi) ** 2)(
        torch.from_numpy(x))
    want = jax.jacfwd(lambda a: ref(jnp.sin(a), 0.1, hi) ** 2)(
        jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name == "ste_clip":
        return        # JAX's ste_clip takes no bounds wider than x
    # reverse mode, broadcast against [3] bounds
    xs = torch.tensor(0.5, dtype=F64, requires_grad=True)
    bounds = np.array([0.0, 0.6, 0.0]), np.array([1.0, 1.0, 0.4])
    (got,) = torch.autograd.grad(
        port(xs, *map(torch.from_numpy, bounds)).sum(), xs)
    want = jax.grad(lambda a: ref(a, *map(jnp.asarray, bounds)).sum())(0.5)
    assert float(got) == float(want)


def test_validate_and_apply_commands_match_jax():
    raw = {"acid_flow_rate": np.array([-1.0, 0.5, 3.0, np.nan]),
           "chlorine_flow_rate": np.array([np.inf, 0.2, 1.0, 1.5]),
           "uv_intensity": np.array([60.0, 10.0, -np.inf, 49.0])}
    got = TC.validate_commands({k: torch.from_numpy(v)
                                for k, v in raw.items()})
    want = JC.validate_commands({k: jnp.asarray(v) for k, v in raw.items()})
    for k in raw:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError) as e_t:
        TC.validate_commands({"pump": torch.tensor(1.0)})
    with pytest.raises(ValueError) as e_j:
        JC.validate_commands({"pump": jnp.asarray(1.0)})
    assert str(e_t.value) == str(e_j.value)
    base = dict(BC, acid_flow_rate=0.4, chlorine_flow_rate=0.1)
    for tau in (0.0, 30.0):
        tb = TC.apply_commands(
            TR.BoundaryConditions(**base),
            {k: torch.from_numpy(v) for k, v in raw.items()}, 5.0, tau)
        jb = JC.apply_commands(
            JR.BoundaryConditions(**base),
            {k: jnp.asarray(v) for k, v in raw.items()}, 5.0, tau)
        for k in raw:
            np.testing.assert_array_equal(to_numpy(getattr(tb, k)),
                                          np.asarray(getattr(jb, k)))
        assert tb.inlet_pH == jb.inlet_pH


def test_observe_true_on_every_axis_matches_jax():
    full = dict(enable_nitrogen=True, enable_gas=True,
                enable_particles=True, enable_disinfection=True,
                enable_biofilm=True, initial_ammonia=1.0,
                initial_pathogens=1e4, initial_bacteria=1e-3)
    js = JR.make_initial_state(JR.ReactorConfiguration(**CFG, **full),
                               dtype=jnp.float64)
    values = tree_to_numpy(js)
    rng = np.random.default_rng(2)
    for k, v in values.items():
        if v is not None and k not in ("time", "flow_rate"):
            values[k] = v * rng.uniform(0.5, 1.5, np.shape(v))
    js = JR.ReactorState(**{k: (None if v is None else jnp.asarray(v))
                            for k, v in values.items()})
    ts = convert.state_from_numpy(values, dtype=F64, device="cpu")
    got, want = TC.observe_true(ts), JC.observe_true(js)
    assert set(got) == set(want) and len(got) == 22
    for k in want:
        _close(got[k], want[k], what=k)


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------

def _jax_loop(jp, js, jg, jcarry, n_steps, controller, **kw):
    return jax.jit(functools.partial(
        JC.rollout_closed_loop, controller=controller, dt=DT, substeps=M,
        n_steps=n_steps, **kw))(jp, js, JR.BoundaryConditions(**BC),
                                gains=jg, ctrl_carry=jcarry)


@pytest.mark.parametrize("remat", [False, True])
def test_closed_loop_true_state_matches_jax(remat):
    tp, ts, jp, js = _reactors(n=4)
    tg, jg = _gains(TC, 4), _gains(JC, 4)
    kw = dict(stages=None, actuator_tau=20.0, remat=remat)
    ctrl_t = functools.partial(TC.dual_pid_controller, warmup_gate=False)
    ctrl_j = functools.partial(JC.dual_pid_controller, warmup_gate=False)
    got = TC.rollout_closed_loop(
        tp, ts, TR.BoundaryConditions(**BC), ctrl_t, tg,
        TC.make_dual_pid_carry((4,), F64, "cpu"), DT, M, 8, **kw)
    want = _jax_loop(jp, js, jg, JC.make_dual_pid_carry((4,), jnp.float64),
                     8, ctrl_j, **kw)
    _tree_close(got, want)
    assert got[3]["cmd:acid_flow_rate"].shape == (8, 4)


def test_closed_loop_schedule_disturbance_and_feedforward_match_jax():
    tp, ts, jp, js = _reactors(n=2)
    sched = np.linspace(0.6, 1.4, 6)

    def schedule(mod, g):
        arr = torch.from_numpy if mod is TC else jnp.asarray
        return dataclasses.replace(g, chlorine=dataclasses.replace(
            g.chlorine, **{f: (arr(np.repeat(sched[:, None], 2, 1))
                               if f == "setpoint" else
                               arr(np.repeat(np.asarray(
                                   getattr(g.chlorine, f))[None], 6, 0)))
                           for f in ("kp", "ki", "kd", "setpoint",
                                     "out_min", "out_max")}),
            ph=dataclasses.replace(g.ph, **{
                f: arr(np.repeat(np.asarray(getattr(g.ph, f))[None], 6, 0))
                for f in ("kp", "ki", "kd", "setpoint", "out_min",
                          "out_max")}))

    dist = dict(inlet_temperature=np.linspace(18.0, 24.0, 6),
                inlet_chlorine=np.linspace(0.0, 0.5, 6), inlet_pH=7.9,
                inlet_flow_rate=5.0)
    tdist = TR.BoundaryConditions(**{k: (torch.from_numpy(v) if isinstance(
        v, np.ndarray) else v) for k, v in dist.items()})
    jdist = JR.BoundaryConditions(**{k: (jnp.asarray(v) if isinstance(
        v, np.ndarray) else v) for k, v in dist.items()})
    ctrl_t = functools.partial(TC.dual_pid_controller, feedforward=True,
                               warmup_gate=False)
    ctrl_j = functools.partial(JC.dual_pid_controller, feedforward=True,
                               warmup_gate=False)
    tg, jg = _gains(TC, 2), _gains(JC, 2)
    got = TC.rollout_closed_loop(
        tp, ts, TR.BoundaryConditions(**BC), ctrl_t, tg,
        TC.make_dual_pid_carry((2,), F64, "cpu"), DT, M, 6,
        gains_schedule=schedule(TC, tg), disturbance=tdist,
        record_obs=("chlorine_outlet", "temp_inlet"))
    want = _jax_loop(jp, js, jg, JC.make_dual_pid_carry((2,), jnp.float64),
                     6, ctrl_j, gains_schedule=schedule(JC, jg),
                     disturbance=jdist,
                     record_obs=("chlorine_outlet", "temp_inlet"))
    _tree_close(got, want)
    with pytest.raises(ValueError, match="leading \\[6\\] axis"):
        TC.rollout_closed_loop(tp, ts, TR.BoundaryConditions(**BC), ctrl_t,
                               tg, TC.make_dual_pid_carry((2,), F64, "cpu"),
                               DT, M, 6, gains_schedule=tg)
    with pytest.raises(ValueError, match="non-actuator"):
        TC.rollout_closed_loop(tp, ts, TR.BoundaryConditions(**BC), ctrl_t,
                               tg, TC.make_dual_pid_carry((2,), F64, "cpu"),
                               DT, M, 6, disturbance=tdist,
                               controller_owned=("inlet_pH",))


def test_closed_loop_gradient_with_and_without_remat_matches_jax():
    """d(ISE)/d(kp, ki) through 10 steps of the straight-through loop:
    remat on and off give the same gradient, and both JAX's (rtol
    1e-9)."""
    tp, ts, jp, js = _reactors(n=3)
    kp0 = np.array([0.3, 0.9, 1.4])

    def t_loss(kp, remat):
        g = _gains(TC, 3)
        g = dataclasses.replace(g, chlorine=dataclasses.replace(
            g.chlorine, kp=kp))
        _, _, _, traj = TC.rollout_closed_loop(
            tp, ts, TR.BoundaryConditions(**BC), functools.partial(
                TC.dual_pid_controller, clip_mode="straight-through",
                warmup_gate=False), g,
            TC.make_dual_pid_carry((3,), F64, "cpu"), DT, M, 10,
            remat=remat, record_obs=("chlorine_outlet", "pH_inlet"))
        return torch.sum(TC.tracking_scores(traj, g, DT))

    def j_loss(kp):
        g = _gains(JC, 3)
        g = dataclasses.replace(g, chlorine=dataclasses.replace(
            g.chlorine, kp=kp))
        _, _, _, traj = JC.rollout_closed_loop(
            jp, js, JR.BoundaryConditions(**BC), functools.partial(
                JC.dual_pid_controller, clip_mode="straight-through",
                warmup_gate=False), g,
            JC.make_dual_pid_carry((3,), jnp.float64), dt=DT, substeps=M,
            n_steps=10, record_obs=("chlorine_outlet", "pH_inlet"))
        return jnp.sum(JC.tracking_scores(traj, g, DT))

    grads = []
    for remat in (False, True):
        kp = torch.from_numpy(kp0).requires_grad_(True)
        grads.append(torch.autograd.grad(t_loss(kp, remat), kp)[0].numpy())
    np.testing.assert_array_equal(grads[0], grads[1])
    want = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(kp0)))
    assert np.abs(want).min() > 0.0
    np.testing.assert_allclose(grads[0], want, rtol=GRAD_RTOL, atol=0)


def _step_rand(rng, shape=()):
    rand = {}
    for name, n_normals, n_uniforms in LAYOUT:
        u = rng.random(shape + (n_uniforms,))
        u[..., 1] = 0.5                  # no open or short circuit rolled
        rand[name] = (rng.standard_normal(shape + (n_normals,)), u)
    return rand


@pytest.mark.parametrize("batched", [False, True])
def test_closed_loop_on_the_instruments_matches_jax(batched, monkeypatch):
    n_steps, n = 6, (3 if batched else None)
    jcfg = JR.ReactorConfiguration(**CFG)
    if batched:
        jpp, jps = JPL.make_plant_batch(jcfg, n, seed=1, dtype=jnp.float64)
    else:
        jpp, jps = JPL.make_plant(jcfg, seed=1, dtype=jnp.float64)
    tpp = convert.plant_params_from_numpy(tree_to_numpy(jpp), dtype=F64,
                                          device="cpu")
    tps = convert.plant_state_from_numpy(tree_to_numpy(jps), dtype=F64,
                                         device="cpu")
    rng = np.random.default_rng(5)
    shape = () if n is None else (n,)
    steps = [_step_rand(rng, shape) for _ in range(n_steps)]
    stacked = {name: tuple(jnp.asarray(np.stack([s[name][i] for s in steps]))
                           for i in range(2)) for name, _, _ in LAYOUT}

    def index(s):
        t = s.reactor.time if not batched else s.reactor.time[0]
        return jnp.round(t / DT).astype(jnp.int32)

    if batched:
        orig = JPL.plant_step_batched

        def patched(p, s, bc, dt, substeps, stages=None, rand=None,
                    boundary_axes=None):
            j = index(s)
            return orig(p, s, bc, dt, substeps, stages=stages,
                        boundary_axes=boundary_axes,
                        rand={k: (v[0][j], v[1][j])
                              for k, v in stacked.items()})
        monkeypatch.setattr(JPL, "plant_step_batched", patched)
    else:
        orig = JPL.plant_step

        def patched(p, s, bc, dt, substeps, stages=None, rand=None,
                    delayed=None):
            j = index(s)
            return orig(p, s, bc, dt, substeps, stages=stages,
                        rand={k: (v[0][j], v[1][j])
                              for k, v in stacked.items()})
        monkeypatch.setattr(JPL, "plant_step", patched)

    tg = _gains(TC) if n is None else _gains(TC, n)
    jg = _gains(JC) if n is None else _gains(JC, n)
    got = TC.rollout_closed_loop(
        tpp, tps, TR.BoundaryConditions(**BC), TC.dual_pid_controller, tg,
        TC.make_dual_pid_carry(shape, F64, "cpu"), DT, M, n_steps,
        observe="sensors", batched=batched,
        rand=[{k: tuple(torch.from_numpy(x) for x in v)
               for k, v in s.items()} for s in steps])
    want = JC.rollout_closed_loop(
        jpp, jps, JR.BoundaryConditions(**BC), JC.dual_pid_controller, jg,
        JC.make_dual_pid_carry(shape, jnp.float64), dt=DT, substeps=M,
        n_steps=n_steps, observe="sensors", batched=batched)
    _tree_close(got[3], want[3])
    _tree_close(got[1], want[1])
    _tree_close(got[0].reactor, want[0].reactor)
    assert np.isfinite(to_numpy(got[3]["pH_inlet"])).any()


# ---------------------------------------------------------------------------
# tuning
# ---------------------------------------------------------------------------

def test_gain_sweep_matches_jax():
    grid = ([0.2, 1.0], [0.0, 0.05], [-0.8], [-0.1, 0.0])
    tg = TC.make_gain_grid(*grid, cl_setpoint=1.0, ph_setpoint=7.2,
                           kd_cl=0.02, dtype=F64, device="cpu")
    jg = JC.make_gain_grid(*grid, cl_setpoint=1.0, ph_setpoint=7.2,
                           kd_cl=0.02, dtype=jnp.float64)
    _tree_close(tg, jg, rtol=0, atol=0)
    assert TC.n_gains(tg) == JC.n_gains(jg) == 8
    kw = dict(dt=DT, n_steps=8, boundary=None, substeps=M,
              effort_weight=0.1, feedforward=True, return_traj=True)
    got = TC.gain_sweep(TR.ReactorConfiguration(**CFG), tg, dtype=F64,
                        device="cpu", **kw)
    want = JC.gain_sweep(JR.ReactorConfiguration(**CFG), jg,
                         dtype=jnp.float64, **kw)
    _close(got["scores"], want["scores"])
    assert got["best_index"] == want["best_index"]
    _tree_close(got["best"], want["best"], rtol=0, atol=0)
    _tree_close(got["traj"], want["traj"])
    # lanes are independent: a lane's score does not see its neighbours
    one = TC.gain_sweep(TR.ReactorConfiguration(**CFG), TC.DualPIDGains(
        **{loop: TP.PIDGains(**{f: getattr(getattr(tg, loop), f)[3:4]
                                for f in ("kp", "ki", "kd", "setpoint",
                                          "out_min", "out_max")})
           for loop in ("chlorine", "ph")}), dtype=F64, device="cpu", **kw)
    _close(one["scores"][0], got["scores"][3])


def test_tune_pid_gradient_matches_jax():
    kw = dict(dt=DT, n_steps=6, iters=3, learning_rate=0.05, substeps=M,
              effort_weight=0.01)
    got = TC.tune_pid_gradient(TR.ReactorConfiguration(**CFG),
                               _gains(TC, 2), dtype=F64, device="cpu", **kw)
    want = JC.tune_pid_gradient(JR.ReactorConfiguration(**CFG),
                                _gains(JC, 2), dtype=jnp.float64, **kw)
    _close(got["loss_history"], want["loss_history"], rtol=ADAM_RTOL,
           atol=0)
    _close(got["final_scores"], want["final_scores"], rtol=ADAM_RTOL,
           atol=0)
    _tree_close(got["gains"], want["gains"], rtol=ADAM_RTOL, atol=0)
    _tree_close(got["best"], want["best"], rtol=ADAM_RTOL, atol=0)
    assert float(got["loss_history"][-1]) < float(got["loss_history"][0])


def test_robust_gain_sweep_matches_jax():
    kw = dict(dt=DT, n_steps=6, n_plants=3, seed=4, substeps=M,
              worst_weight=0.7)
    got = TC.robust_gain_sweep(TR.ReactorConfiguration(**CFG),
                               _gains(TC, 3), dtype=F64, device="cpu", **kw)
    want = JC.robust_gain_sweep(JR.ReactorConfiguration(**CFG),
                                _gains(JC, 3), dtype=jnp.float64, **kw)
    for k in ("scores_mean", "scores_worst", "robust"):
        _close(got[k], want[k], what=k)
    assert got["best_index"] == want["best_index"]
    _tree_close(got["best"], want["best"], rtol=0, atol=0)


def test_adam_follows_optax():
    """The port's Adam and global-norm clip against optax's chain on the
    same gradient stream, bit for bit on the CPU in float64 apart from the
    bias correction's power (rtol 1e-15)."""
    import optax

    rng = np.random.default_rng(9)
    params = [rng.normal(size=(4,)), rng.normal(size=(2, 3))]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(0.05))
    jparams = {"a": jnp.asarray(params[0]), "b": jnp.asarray(params[1])}
    jstate = opt.init(jparams)
    tparams = [torch.from_numpy(p) for p in params]
    tstate = TO.adam_init(tparams)
    for i in range(6):
        grads = [rng.normal(size=p.shape) * (3.0 if i % 2 else 0.1)
                 for p in params]
        upd, jstate = opt.update({"a": jnp.asarray(grads[0]),
                                  "b": jnp.asarray(grads[1])}, jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, upd)
        steps, tstate = TO.adam_update([torch.from_numpy(g) for g in grads],
                                       tstate, 0.05, max_norm=1.0)
        tparams = TO.apply_updates(tparams, steps)
        for p, k in zip(tparams, ("a", "b")):
            _close(p, jparams[k], rtol=1e-15, atol=0)


def test_control_package_exports_match_jax():
    assert sorted(TC.__all__) == sorted(JC.__all__)
    for name in JC.__all__:
        assert hasattr(TC, name), name
    assert TC.rollout_closed_loop.__module__.startswith(
        "ics_wt_physicsengine_torch")
    assert JCL._COMMAND_LIMITS == TC.closed_loop._COMMAND_LIMITS
    assert JT._TUNED_FIELDS == TC.tuning._TUNED_FIELDS
