"""The port's integrated plant (``models/plant.py``, ``entry.py``) against
the JAX package's on the CPU.

``make_plant`` and ``make_plant_batch`` must equal JAX's bit for bit, both
built directly and carried across through ``convert``. ``plant_step`` and
the rollouts built on it are held in float64 at atol 1e-10 (the reactor's
tolerance: float64 rounding over a few dozen steps with the two libraries'
``exp``/``pow``), with status codes equal and NaN in the same places. Both
sides get the same randomness, made with NumPy from a seed: the JAX side
through ``plant_step(rand=...)``, the port's loops, which draw from a
generator, through a stand-in for ``draw_read_rand`` that hands out the same
arrays in call order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL
from ics_wt_physicsengine_tpu.sensors import base as JB

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch import entry as port_entry
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models import plant as TPL
from ics_wt_physicsengine_torch.sensors import base as TB

from torch_port_util import assert_tree_close, to_numpy, tree_to_numpy

torch.set_num_threads(1)

ATOL = 1e-10
F64 = torch.float64
DT = 1.0
BC = dict(inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
          inlet_temperature=26.0, acid_flow_rate=0.1, acid_concentration=0.1,
          ambient_temperature=15.0, heat_loss_coefficient=50.0)
LAYOUT = JPL._RAND_LAYOUT


def configs(n_zones, **kw):
    kw = dict(n_zones=n_zones, enable_thermal_stratification=True, **kw)
    return JR.ReactorConfiguration(**kw), TR.ReactorConfiguration(**kw)


def plants(n_zones, batch=None, dtype=jnp.float64):
    """The JAX plant and its carry-across through ``convert``."""
    jcfg, _ = configs(n_zones)
    if batch is None:
        jp, js = JPL.make_plant(jcfg, seed=1, dtype=dtype)
    else:
        jp, js = JPL.make_plant_batch(jcfg, batch, seed=1, dtype=dtype)
    tdtype = F64 if dtype == jnp.float64 else torch.float32
    tp = convert.plant_params_from_numpy(tree_to_numpy(jp), dtype=tdtype,
                                         device="cpu")
    ts = convert.plant_state_from_numpy(tree_to_numpy(js), dtype=tdtype,
                                        device="cpu")
    return (jp, js), (tp, ts)


def step_rand(rng, shape=()):
    """One step's draws for all seven instruments as NumPy arrays; a
    quarter of the steps roll an open or short circuit somewhere."""
    rand = {}
    for name, n_normals, n_uniforms in LAYOUT:
        u = rng.random(shape + (n_uniforms,))
        u[..., 1] = np.where(rng.random(shape) < 0.04, 0.0, 0.5)
        rand[name] = (rng.standard_normal(shape + (n_normals,)), u)
    return rand


def as_jax(rand):
    return {k: tuple(jnp.asarray(x) for x in v) for k, v in rand.items()}


def as_torch(rand):
    return {k: tuple(torch.from_numpy(x) for x in v) for k, v in rand.items()}


class Scripted:
    """Stands in for ``sensors.base.draw_read_rand``: hands out the draws of
    ``steps`` (a list of ``step_rand`` results) in the order the seven
    instruments ask for them."""

    def __init__(self, steps):
        self.queue = [s[name] for s in steps for name, _, _ in LAYOUT]

    def __call__(self, generator, shape, dtype, device, extra_normals=0,
                 extra_uniforms=0):
        normals, uniforms = self.queue.pop(0)
        assert normals.shape == tuple(shape) + (
            TB.BASE_NORMALS + extra_normals,)
        assert uniforms.shape == tuple(shape) + (
            TB.BASE_UNIFORMS + extra_uniforms,)
        return torch.from_numpy(normals), torch.from_numpy(uniforms)


def jax_loop(jp, js, bcs, steps, substeps, stages=None):
    """The JAX oracle: ``plant_step`` with injected draws, step by step.
    Returns the final plant and the per-step readings."""
    fn = jax.jit(lambda p, s, bc, rand: JPL.plant_step(
        p, s, bc, DT, substeps, stages=stages, rand=rand))
    out = []
    for bc, rand in zip(bcs, steps):
        js, readings = fn(jp, js, bc, as_jax(rand))
        out.append(readings)
    return js, out


def assert_values_close(port_values, jax_outputs, atol=ATOL):
    """Port ``{name: [n_steps, ...]}`` values against the JAX per-step
    ``SensorOutput`` list."""
    for name, _, _ in LAYOUT:
        want = np.stack([np.asarray(o[name].value) for o in jax_outputs])
        np.testing.assert_allclose(to_numpy(port_values[name]), want, rtol=0,
                                   atol=atol, equal_nan=True, err_msg=name)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_zones,warmed_up,t0", [(2, True, 0.0),
                                                  (5, False, 0.0),
                                                  (20, True, 86400.0)])
def test_make_plant_bit_equal(n_zones, warmed_up, t0, dtype):
    jcfg, tcfg = configs(n_zones, flow_rate=6.5)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    jp, js = JPL.make_plant(jcfg, seed=1, dtype=jdtype, warmed_up=warmed_up,
                            t0=t0)
    tp, ts = TPL.make_plant(tcfg, dtype=dtype, warmed_up=warmed_up, t0=t0,
                            device="cpu")
    assert_tree_close(tp, jp, atol=0.0)
    assert_tree_close(ts, js, atol=0.0)
    # and the carry-across gives the same objects
    cp = convert.plant_params_from_numpy(tree_to_numpy(jp), dtype=dtype,
                                         device="cpu")
    cs = convert.plant_state_from_numpy(tree_to_numpy(js), dtype=dtype,
                                        device="cpu")
    assert_tree_close(cp, jp, atol=0.0)
    assert_tree_close(cs, js, atol=0.0)
    assert tp.ph_outlet.zone_index == -1
    assert tp.ph_inlet.base.line_capacity == jp.ph_inlet.base.line_capacity


@pytest.mark.parametrize("randomize", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_make_plant_batch_bit_equal(randomize, dtype):
    jcfg, tcfg = configs(5)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    jp, js = JPL.make_plant_batch(jcfg, 6, seed=4, dtype=jdtype,
                                  randomize=randomize, t0=100.0)
    tp, ts = TPL.make_plant_batch(tcfg, 6, seed=4, dtype=dtype,
                                  randomize=randomize, t0=100.0,
                                  device="cpu")
    assert_tree_close(tp, jp, atol=0.0)
    assert_tree_close(ts, js, atol=0.0)
    assert ts.ph_inlet.base.line_values.shape == (
        6, tp.ph_inlet.base.line_capacity)
    with pytest.raises(ValueError):
        TPL.make_plant_batch(tcfg, 0, device="cpu")


def test_convert_ignores_keys_and_carries_extension_sensors():
    (jp, js), _ = plants(2)
    values = tree_to_numpy(js)
    values["ph_inlet"]["base"]["key"] = np.zeros(2, np.uint32)
    ts = convert.plant_state_from_numpy(values, dtype=F64, device="cpu")
    assert not hasattr(ts.ph_inlet.base, "key")
    assert ts.ammonia_outlet is None
    # a plant with the three instrumented axes carries its extra sensors
    jcfg, _ = configs(2, enable_nitrogen=True, enable_gas=True,
                      enable_particles=True)
    jp, js = JPL.make_plant(jcfg, seed=1, dtype=jnp.float64)
    values = tree_to_numpy(js)
    values["ammonia_outlet"]["base"]["key"] = np.zeros(2, np.uint32)
    ts = convert.plant_state_from_numpy(values, dtype=F64, device="cpu")
    tp = convert.plant_params_from_numpy(tree_to_numpy(jp), dtype=F64,
                                         device="cpu")
    assert not hasattr(ts.ammonia_outlet.base, "key")
    assert_tree_close(ts, js, atol=0.0)
    assert_tree_close(tp, jp, atol=0.0)


@pytest.mark.parametrize("flag", ["enable_nitrogen", "enable_gas",
                                  "enable_particles"])
def test_extension_flags_build(flag):
    """Each instrumented axis adds its instrument to the plant and to the
    plant batch, bit for bit as in the JAX package."""
    jcfg, tcfg = configs(5, **{flag: True})
    tp, ts = TPL.make_plant(tcfg, dtype=F64, device="cpu")
    jp, js = JPL.make_plant(jcfg, seed=1, dtype=jnp.float64)
    assert_tree_close(tp, jp, atol=0.0)
    assert_tree_close(ts, js, atol=0.0)
    name = {"enable_nitrogen": "ammonia_outlet",
            "enable_gas": "oxygen_outlet",
            "enable_particles": "turbidity_outlet"}[flag]
    assert getattr(tp, name) is not None
    tp, ts = TPL.make_plant_batch(tcfg, 3, seed=4, dtype=F64, device="cpu")
    jp, js = JPL.make_plant_batch(jcfg, 3, seed=4, dtype=jnp.float64)
    assert_tree_close(tp, jp, atol=0.0)
    assert_tree_close(ts, js, atol=0.0)
    assert getattr(ts, name).base.current_value.shape == (3,)


def test_named_configurations():
    for name in ("config1_two_zone", "config2_stratified_20_zone"):
        a, b = getattr(TPL, name)(), getattr(JPL, name)()
        assert dataclasses.asdict(a) == {
            k: v for k, v in dataclasses.asdict(b).items()
            if k in dataclasses.asdict(a)}
    tp, ts = TPL.config3_full_sensors(dtype=torch.float32, device="cpu")
    jp, js = JPL.config3_full_sensors(seed=0, dtype=jnp.float32)
    assert_tree_close(tp, jp, atol=0.0)
    assert_tree_close(ts, js, atol=0.0)
    tparams, tstate = TPL.config4_monte_carlo(5, seed=2, device="cpu")
    jparams, jstate = JPL.config4_monte_carlo(5, seed=2)
    assert_tree_close(tstate, jstate, atol=0.0)


# ---------------------------------------------------------------------------
# plant_step and the rollouts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 5, 20])
def stepped(request):
    """Twelve JAX plant steps with injected draws at one zone count, shared
    by the tests that hold the port's step and rollout against them."""
    n_zones = request.param
    (jp, js), (tp, ts) = plants(n_zones)
    jcfg, _ = configs(n_zones)
    substeps = JR.default_substeps(jcfg, DT)
    rng = np.random.default_rng(n_zones)
    steps = [step_rand(rng) for _ in range(12)]
    jfinal, jout = jax_loop(jp, js, [JR.BoundaryConditions(**BC)] * 12,
                            steps, substeps)
    return dict(n_zones=n_zones, tp=tp, ts=ts, substeps=substeps,
                steps=steps, jfinal=jfinal, jout=jout)


def test_plant_step_matches_jax(stepped):
    tp, ts = stepped["tp"], stepped["ts"]
    bc = TR.BoundaryConditions(**BC)
    for i, rand in enumerate(stepped["steps"]):
        ts, readings = TPL.plant_step(tp, ts, bc, DT, stepped["substeps"],
                                      rand=as_torch(rand))
        for name, _, _ in LAYOUT:
            assert_tree_close(readings[name], stepped["jout"][i][name],
                              atol=ATOL, path=f"step{i}.{name}")
    assert_tree_close(ts, stepped["jfinal"], atol=ATOL)
    assert list(readings) == [name for name, _, _ in LAYOUT]


def test_plant_rollout_matches_jax(stepped, monkeypatch):
    monkeypatch.setattr(TB, "draw_read_rand", Scripted(stepped["steps"]))
    final, values = TPL.plant_rollout(
        stepped["tp"], stepped["ts"], TR.BoundaryConditions(**BC), DT,
        stepped["substeps"], 12)
    assert_tree_close(final, stepped["jfinal"], atol=ATOL)
    assert_values_close(values, stepped["jout"])
    assert values["pH_inlet"].shape == (12,)


def test_plant_rollout_without_record():
    _, (tp, ts) = plants(2)
    g = torch.Generator().manual_seed(0)
    final, values = TPL.plant_rollout(tp, ts, TR.BoundaryConditions(**BC),
                                      DT, 2, 3, record=False, generator=g)
    assert values is None and float(final.reactor.time) == 3.0


def _schedule(n_steps):
    t = np.arange(n_steps)
    return dict(BC, inlet_flow_rate=5.0 + 2.0 * np.sin(2 * np.pi * t / 17.0),
                inlet_chlorine=np.where(t % 10 < 5, 0.5, 1.5),
                acid_flow_rate=np.where(t % 8 < 4, 0.0, 0.3))


@pytest.fixture(scope="module")
def scheduled():
    """Ten scheduled JAX plant steps (RKC-fast physics) at five zones."""
    (jp, js), (tp, ts) = plants(5)
    jcfg, _ = configs(5)
    substeps, stages = JR.default_rkc_plan(jcfg, DT, mode="fast")
    rng = np.random.default_rng(11)
    steps = [step_rand(rng) for _ in range(10)]
    sched = _schedule(10)
    rows = [JR.BoundaryConditions(**{
        k: (float(v[i]) if np.ndim(v) else v) for k, v in sched.items()})
        for i in range(10)]
    jfinal, jout = jax_loop(jp, js, rows, steps, substeps, stages=stages)
    return dict(tp=tp, ts=ts, substeps=substeps, stages=stages, steps=steps,
                sched=sched, jfinal=jfinal, jout=jout)


def test_plant_rollout_scheduled_matches_jax(scheduled, monkeypatch):
    monkeypatch.setattr(TB, "draw_read_rand", Scripted(scheduled["steps"]))
    final, values = TPL.plant_rollout_scheduled(
        scheduled["tp"], scheduled["ts"],
        TR.BoundaryConditions(**scheduled["sched"]), DT,
        scheduled["substeps"], stages=scheduled["stages"])
    assert_tree_close(final, scheduled["jfinal"], atol=ATOL)
    assert_values_close(values, scheduled["jout"])
    # the flow meter read the scheduled flow, not a constant
    flow = values["flow_main"]
    assert float(flow[~torch.isnan(flow)].std()) > 0.1


def test_plant_rollout_serve_matches_jax(scheduled, monkeypatch):
    monkeypatch.setattr(TB, "draw_read_rand", Scripted(scheduled["steps"]))
    final, per_step = TPL.plant_rollout_serve(
        scheduled["tp"], scheduled["ts"],
        TR.BoundaryConditions(**scheduled["sched"]), DT,
        scheduled["substeps"], stages=scheduled["stages"])
    assert_tree_close(final, scheduled["jfinal"], atol=ATOL)
    for name, _, _ in LAYOUT:
        want = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                      *[o[name] for o in scheduled["jout"]])
        assert_tree_close(per_step[name], want, atol=ATOL, path=name)
        assert per_step[name].status.shape == (10,)


@pytest.mark.parametrize("boundary_axes", [None, 0])
def test_plant_step_batched_matches_jax(boundary_axes):
    """Four plants with their own rings, physics and draws in one natively
    batched port step, against ``jax.vmap`` of the JAX step; with
    ``boundary_axes=0`` every plant has its own boundary."""
    n = 4
    (jp, js), (tp, ts) = plants(5, batch=n)
    jcfg, _ = configs(5)
    substeps = JR.default_substeps(jcfg, DT)
    rng = np.random.default_rng(21)
    if boundary_axes == 0:
        bc = dict(BC, inlet_flow_rate=np.array([4.0, 5.0, 6.0, 7.0]),
                  acid_flow_rate=np.array([0.0, 0.1, 0.2, 0.3]))
        tbc = TR.BoundaryConditions(**bc)      # every field becomes [n]
        tbc = TR.BoundaryConditions(**{
            f.name: torch.from_numpy(np.broadcast_to(
                np.asarray(getattr(tbc, f.name), float), (n,)).copy())
            for f in dataclasses.fields(tbc)})
    else:
        bc, tbc = BC, TR.BoundaryConditions(**BC)
    jbc = JR.BoundaryConditions(**bc)
    if boundary_axes == 0:      # vmap maps every field, also those unused
        jbc = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(jnp.asarray(x, jnp.float64), (n,)),
            jbc)
    step_j = jax.jit(lambda p, s, b, r: JPL.plant_step_batched(
        p, s, b, DT, substeps, rand=r, boundary_axes=boundary_axes))
    for i in range(8):
        rand = step_rand(rng, (n,))
        js, jout = step_j(jp, js, jbc, as_jax(rand))
        ts, tout = TPL.plant_step_batched(tp, ts, tbc, DT, substeps,
                                          rand=as_torch(rand),
                                          boundary_axes=boundary_axes)
        for name, _, _ in LAYOUT:
            assert_tree_close(tout[name], jout[name], atol=ATOL,
                              path=f"step{i}.{name}")
    assert_tree_close(ts, js, atol=ATOL)
    assert tout["pH_outlet"].value.shape == (n,)


def test_plant_step_batched_rejects_bad_boundaries():
    _, (tp, ts) = plants(2, batch=3)
    per_plant = TR.BoundaryConditions(**{
        k: torch.full((3,), float(v), dtype=F64) for k, v in BC.items()})
    with pytest.raises(ValueError, match="boundary_axes"):
        TPL.plant_step_batched(tp, ts, per_plant, DT, 2)
    with pytest.raises(ValueError, match=r"\[3\]"):
        TPL.plant_step_batched(tp, ts, TR.BoundaryConditions(**BC), DT, 2,
                               boundary_axes=0)
    with pytest.raises(ValueError):
        TPL.plant_step_batched(tp, ts, per_plant, DT, 2, boundary_axes=1)


def test_draw_packed_rand_layout():
    g = torch.Generator().manual_seed(7)
    rand = TPL.draw_packed_rand(g, (3,), F64, "cpu")
    assert TPL._RAND_LAYOUT == JPL._RAND_LAYOUT
    assert [(k, v[0].shape[-1], v[1].shape[-1]) for k, v in rand.items()] \
        == list(JPL._RAND_LAYOUT)
    assert all(v[0].shape[0] == 3 for v in rand.values())
    _, (tp, ts) = plants(2, batch=3)
    ts2, out = TPL.plant_step_batched(tp, ts, TR.BoundaryConditions(**BC),
                                      DT, 2, rand=rand)
    assert bool(torch.isfinite(out["temp_inlet"].value).all())
    u = torch.cat([v[1].reshape(-1) for v in rand.values()])
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


# ---------------------------------------------------------------------------
# plant_rollout_auto and entry()
# ---------------------------------------------------------------------------


def test_plant_rollout_auto_on_cpu_takes_the_step_loop(monkeypatch):
    """A CPU plant never reaches the fused path: constant and scheduled
    forcing, single and batched, recorded or not."""
    from ics_wt_physicsengine_torch.ops import fused_plant

    def fail(*a, **kw):
        raise AssertionError("the fused path ran for a CPU plant")

    monkeypatch.setattr(fused_plant, "plant_rollout_fused", fail)
    _, (tp, ts) = plants(2)
    bc = TR.BoundaryConditions(**BC)
    final, traj = TPL.plant_rollout_auto(tp, ts, bc, DT, 2, 6, seed=3)
    assert traj["pH_inlet"].shape == (6,)
    assert float(final.reactor.time) == pytest.approx(6.0)
    again, traj2 = TPL.plant_rollout_auto(tp, ts, bc, DT, 2, 6, seed=3)
    assert torch.equal(traj["chlorine_outlet"], traj2["chlorine_outlet"])
    # the loop path is plant_rollout with a generator of that seed
    g = torch.Generator().manual_seed(3)
    _, ref = TPL.plant_rollout(tp, ts, bc, DT, 2, 6, generator=g)
    assert torch.equal(traj["temp_outlet"], ref["temp_outlet"])

    sched = TR.BoundaryConditions(**_schedule(5))
    final, traj = TPL.plant_rollout_auto(tp, ts, sched, DT, 2, 5)
    assert traj["flow_main"].shape == (5,)
    with pytest.raises(ValueError, match="n_steps"):
        TPL.plant_rollout_auto(tp, ts, sched, DT, 2, 7)

    _, (bp, bs) = plants(2, batch=3)
    final, traj = TPL.plant_rollout_auto(bp, bs, bc, DT, 2, 4)
    assert traj["pH_inlet"].shape == (4, 3)
    final, none = TPL.plant_rollout_auto(bp, bs, bc, DT, 2, 4, record=False)
    assert none is None and final.reactor.pH.shape == (3, 2)


def test_plant_rollout_auto_has_no_rerouting_except():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(TPL.plant_rollout_auto))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert "fused_max_batch" not in inspect.signature(
        TPL.plant_rollout_auto).parameters


def test_entry_matches_the_jax_entry():
    """The port's ``entry()`` against ``__graft_entry__.entry()``: the same
    20-zone plant (bit-equal), and one step of ``fn`` in float32 given the
    draws the JAX step makes from its carried keys."""
    import __graft_entry__ as ge

    jfn, (jp, js, jbc) = ge.entry()
    tfn, (tp, ts, tbc) = port_entry.entry(device="cpu")
    assert_tree_close(tp, jp, atol=0.0)
    assert_tree_close(ts, js, atol=0.0)
    assert dataclasses.asdict(tbc) == {
        k: v for k, v in dataclasses.asdict(jbc).items()
        if k in dataclasses.asdict(tbc)}

    rand = {}
    for (name, n_normals, n_uniforms), attr in zip(
            LAYOUT, ("ph_inlet", "ph_outlet", "chlorine_inlet",
                     "chlorine_outlet", "flow_main", "temp_inlet",
                     "temp_outlet")):
        _, normals, uniforms = JB.draw_read_rand(
            getattr(js, attr).base.key, jnp.float32,
            extra_normals=n_normals - JB.BASE_NORMALS,
            extra_uniforms=n_uniforms - JB.BASE_UNIFORMS)
        rand[name] = (torch.from_numpy(np.array(normals)),
                      torch.from_numpy(np.array(uniforms)))
    want = jax.jit(jfn)(jp, js, jbc)
    got = tfn(tp, ts, tbc, rand=rand)
    assert got[0].shape == (20,) and got[0].dtype == torch.float32
    # float32: a few ulp of pH 7 / 2 mg/L over one RK4 step and one read
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=5e-6)
    # without rand it draws from its own seeded generator: finite, and the
    # same for two fresh entries
    a = port_entry.entry(device="cpu")[0](tp, ts, tbc)
    b = port_entry.entry(device="cpu")[0](tp, ts, tbc)
    assert all(bool(torch.isfinite(x).all()) for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
