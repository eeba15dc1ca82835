"""The PyTorch port's core physics against the JAX package, on the CPU in
float64: parameter and state construction and the Monte-Carlo batch bit for
bit, the physics formulas, ``step``/``rollout``/``rollout_scheduled`` and
``IntegratedCSTR`` at atol 1e-10 (float64 rounding over a few dozen steps;
the two packages evaluate ``exp``/``pow`` with different libraries)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import chemistry as jchem
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.core import spatial as jspatial
from ics_wt_physicsengine_tpu.core import thermodynamics as jthermo
from ics_wt_physicsengine_tpu.core import transport as jtransport
from ics_wt_physicsengine_tpu.models.monte_carlo import (
    make_monte_carlo_batch as j_make_batch)

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch.core import chemistry as tchem
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.core import spatial as tspatial
from ics_wt_physicsengine_torch.core import thermodynamics as tthermo
from ics_wt_physicsengine_torch.core import transport as ttransport
from ics_wt_physicsengine_torch.models.monte_carlo import (
    make_monte_carlo_batch as t_make_batch)

torch.set_num_threads(1)

ATOL = 1e-10
F64 = torch.float64

BC = dict(inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
          inlet_temperature=26.0, acid_flow_rate=0.1, acid_concentration=0.1,
          chlorine_flow_rate=0.2, chlorine_concentration=50.0,
          ambient_temperature=15.0, heat_loss_coefficient=50.0)


def _configs(n_zones, stratified):
    kw = dict(n_zones=n_zones, enable_thermal_stratification=stratified,
              temperature=18.0, initial_pH=7.3)
    return JR.ReactorConfiguration(**kw), TR.ReactorConfiguration(**kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree_equal(port, ref):
    """Every field of a port dataclass equals the JAX one bit for bit."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _assert_tree_equal(a, b)
        elif a is None or isinstance(a, int):
            assert a == b, f.name
        else:
            assert _np(a).dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(_np(a), np.asarray(b),
                                          err_msg=f.name)


def _assert_close(port, ref, atol=ATOL):
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=0, atol=atol)


def _assert_state_close(port, ref):
    for name in ("pH", "chlorine", "temperature", "H_concentration",
                 "density", "chlorine_decay_rate", "flow_rate", "time"):
        _assert_close(getattr(port, name), getattr(ref, name))


GRID = [(2, True), (2, False), (5, True), (5, False), (20, True),
        (20, False)]


@pytest.mark.parametrize("n_zones,stratified", GRID)
def test_make_params_bit_equal(n_zones, stratified):
    jcfg, tcfg = _configs(n_zones, stratified)
    for jd, td in ((jnp.float64, F64), (jnp.float32, torch.float32)):
        _assert_tree_equal(TR.make_params(tcfg, dtype=td, device="cpu"),
                           JR.make_params(jcfg, dtype=jd))


@pytest.mark.parametrize("n_zones,stratified", GRID)
def test_make_initial_state_bit_equal(n_zones, stratified):
    jcfg, tcfg = _configs(n_zones, stratified)
    for jd, td in ((jnp.float64, F64), (jnp.float32, torch.float32)):
        _assert_tree_equal(
            TR.make_initial_state(tcfg, dtype=td, device="cpu"),
            JR.make_initial_state(jcfg, dtype=jd))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_plants,seed", [(1, 0), (37, 5)])
def test_monte_carlo_batch_bit_equal(dtype, n_plants, seed):
    jcfg, tcfg = _configs(20, True)
    jp, js = j_make_batch(jcfg, n_plants, seed=seed, dtype=getattr(jnp, dtype))
    tp, ts = t_make_batch(tcfg, n_plants, seed=seed,
                          dtype=getattr(torch, dtype), device="cpu")
    _assert_tree_equal(tp, jp)
    _assert_tree_equal(ts, js)


def test_convert_round_trip_bit_equal():
    jcfg, _ = _configs(5, True)
    jp, js = j_make_batch(jcfg, 9, seed=2, dtype=jnp.float64)
    tp = convert.params_from_numpy(dataclasses.asdict(jp), dtype=F64,
                                   device="cpu")
    ts = convert.state_from_numpy(dataclasses.asdict(js), dtype=F64,
                                  device="cpu")
    _assert_tree_equal(tp, jp)
    _assert_tree_equal(ts, js)
    bc = convert.boundary_from_numpy(
        dataclasses.asdict(JR.BoundaryConditions(**BC)), dtype=F64,
        device="cpu")
    assert bc == TR.BoundaryConditions(**BC)


def _scaled_constants(k):
    """The constant bundle as one O(1) array (for the formula cases)."""
    return 1e14 * k.Kw + 1e7 * k.Ka1 + 1e11 * k.Ka2 + 1e8 * k.Ka_HOCl \
        + 1e3 * k.C_T_mol + 1e3 * k.alk_eq


def _formula_cases():
    rng = np.random.default_rng(11)
    t = rng.uniform(0.0, 40.0, (4, 6))
    ph = rng.uniform(5.0, 10.0, (4, 6))
    ka1 = rng.uniform(3e-7, 6e-7, 4)
    ka2 = rng.uniform(3e-11, 6e-11, 4)
    k = dict(Kw=rng.uniform(0.5e-14, 2e-14, 4), Ka1=ka1, Ka2=ka2,
             Ka_HOCl=rng.uniform(2e-8, 4e-8, 4),
             C_T_mol=rng.uniform(1e-3, 4e-3, 4),
             alk_eq=rng.uniform(1e-3, 2e-3, 4))
    jk = jchem.ChemistryConstants(**{n: jnp.asarray(v) for n, v in k.items()})
    tk = tchem.ChemistryConstants(**{n: torch.from_numpy(v)
                                     for n, v in k.items()})
    rho = rng.uniform(995.0, 1000.0, (4, 6))
    kif = rng.uniform(0.01, 0.1, (4, 5))
    return {
        "arrhenius": (lambda m, x: 1e4 * m.arrhenius_rate(x), jthermo, tthermo,
                      t),
        "kw": (lambda m, x: 1e14 * m.water_ionization_constant(x), jthermo,
               tthermo, t),
        "neutral_pH": (lambda m, x: m.neutral_pH(x), jthermo, tthermo, t),
        "compensation": (lambda m, x: m.temperature_compensation_factor(x),
                         jthermo, tthermo, t),
        "constants_in_graph": (lambda m, x: _scaled_constants(
            m.make_chemistry_constants(100.0 + 0.0 * x, 2.0 + 0.0 * x, x)),
            jchem, tchem, t),
        "pka": (lambda m, x: m.carbonate_pKa1(x) + m.carbonate_pKa2(x)
                + m.pKa_HOCl(x), jthermo, tthermo, t),
        "diffusion": (lambda m, x: 1e9 * m.diffusion_coefficient(x), jthermo,
                      tthermo, t),
        "alpha": (lambda m, x: m.alpha_carbonate(
            x, *(jk.Ka1, jk.Ka2) if m is jchem else (tk.Ka1, tk.Ka2))[1],
            jchem, tchem, ph),
        "charge_balance": (lambda m, x: 1e3 * m.charge_balance_error(
            x, jk if m is jchem else tk), jchem, tchem, ph),
        "charge_balance_derivative": (
            lambda m, x: 1e3 * m.charge_balance_derivative(
                x, jk if m is jchem else tk), jchem, tchem, ph),
        "buffering": (lambda m, x: 1e3 * m.buffering_capacity(
            x, jk if m is jchem else tk), jchem, tchem, ph),
        "decay_factor": (lambda m, x: m.pH_dependent_chlorine_decay_factor(
            x, (jk if m is jchem else tk).Ka_HOCl), jchem, tchem, ph),
        "solve_pH": (lambda m, x: m.solve_pH(
            jk if m is jchem else tk, initial_guess=x[:, 0]), jchem, tchem,
            ph),
        "density": (lambda m, x: m.water_density(x), jspatial, tspatial, t),
        "suppression": (lambda m, x: m.mixing_suppression(
            x, 0.1 * np.ones(4) if m is jspatial else torch.full((4,), 0.1,
                                                                 dtype=F64),
            2e-4 * np.ones(4) if m is jspatial else torch.full((4,), 2e-4,
                                                               dtype=F64)),
            jspatial, tspatial, rho),
        "exchange": (lambda m, x: m.apply_exchange(
            x, jnp.asarray(kif) if m is jtransport else torch.from_numpy(kif),
            jnp.full(4, 1e-4) if m is jtransport else torch.full(
                (4,), 1e-4, dtype=F64)), jtransport, ttransport, ph),
    }


@pytest.mark.parametrize("name", sorted(_formula_cases()))
def test_formulas_match_jax(name):
    fn, jmod, tmod, x = _formula_cases()[name]
    ref = fn(jmod, jnp.asarray(x))
    got = fn(tmod, torch.from_numpy(x))
    # O(1) outputs; the Newton solve ends on a step below its 1e-6
    # tolerance, which carries the last-bit differences of f/f' further.
    _assert_close(got, ref, atol=ATOL if name == "solve_pH" else 1e-12)


@pytest.mark.parametrize("lam", [0.01, 0.9, 3.7, 25.0])
def test_integrator_plans_match_jax(lam):
    from ics_wt_physicsengine_tpu.ops import integrators as jint
    from ics_wt_physicsengine_torch.ops import integrators as tint

    assert tint.stable_substeps(1.0, lam) == jint.stable_substeps(1.0, lam)
    assert tint.stable_substeps(1.0, lam, min_h=0.3) == \
        jint.stable_substeps(1.0, lam, min_h=0.3)
    for span in (1.5, None):
        assert tint.rkc_plan(1.0, lam, accuracy_span=span) == \
            jint.rkc_plan(1.0, lam, accuracy_span=span)
    s = tint.rkc_plan(1.0, lam, accuracy_span=None)[1]
    for a, b in zip(tint._rkc2_coefficients(s), jint._rkc2_coefficients(s)):
        np.testing.assert_array_equal(a, b)


def _integrator_plan(jcfg, integrator):
    if integrator == "rk4":
        return JR.default_substeps(jcfg, 1.0), None
    return JR.default_rkc_plan(jcfg, 1.0, mode=integrator)


# Each zone count, stratification setting and integrator appears at least
# once; the pairs are spread to keep the JAX compile count small.
STEP_CASES = [(2, True, "rk4"), (2, False, "fast"), (5, False, "rk4"),
              (5, True, "strict"), (20, True, "rk4"), (20, True, "fast"),
              (20, False, "strict")]


@pytest.mark.parametrize("n_zones,stratified,integrator", STEP_CASES)
def test_rollout_matches_jax(n_zones, stratified, integrator):
    jcfg, tcfg = _configs(n_zones, stratified)
    m, s = _integrator_plan(jcfg, integrator)
    if integrator == "rk4":
        assert m == TR.default_substeps(tcfg, 1.0)
    else:
        assert (m, s) == TR.default_rkc_plan(tcfg, 1.0, mode=integrator)
    jp, js = JR.make_params(jcfg, jnp.float64), \
        JR.make_initial_state(jcfg, jnp.float64)
    tp = TR.make_params(tcfg, F64, device="cpu")
    ts = TR.make_initial_state(tcfg, F64, device="cpu")
    jbc, tbc = JR.BoundaryConditions(**BC), TR.BoundaryConditions(**BC)

    jfinal, jtraj = jax.jit(lambda p, st, b: JR.rollout(
        p, st, b, dt=1.0, substeps=m, n_steps=8, stages=s))(jp, js, jbc)
    tfinal, ttraj = TR.rollout(tp, ts, tbc, 1.0, m, 8, stages=s)
    _assert_state_close(tfinal, jfinal)
    for key in ("pH", "chlorine", "temperature"):
        assert ttraj[key].shape == jtraj[key].shape
        _assert_close(ttraj[key], jtraj[key])

    one = TR.step(tp, ts, tbc, 1.0, m, stages=s)
    for key in ("pH", "chlorine", "temperature"):
        _assert_close(getattr(one, key), jtraj[key][0])


def _square_wave(n_steps):
    t = np.arange(n_steps)
    return dict(
        inlet_flow_rate=5.0 + 2.0 * np.sin(2 * np.pi * t / 17.0),
        inlet_pH=7.2,
        inlet_chlorine=np.where(t % 10 < 5, 0.5, 1.5).astype(float),
        inlet_temperature=26.0 - 0.05 * t,
        acid_flow_rate=np.where(t % 8 < 4, 0.0, 0.3).astype(float),
        acid_concentration=0.1, chlorine_flow_rate=0.2,
        chlorine_concentration=50.0, ambient_temperature=15.0,
        heat_loss_coefficient=50.0)


@pytest.mark.parametrize("n_zones,integrator", [(5, "rk4"), (20, "fast")])
def test_rollout_scheduled_matches_jax(n_zones, integrator):
    jcfg, tcfg = _configs(n_zones, True)
    m, s = _integrator_plan(jcfg, integrator)
    jp, js = j_make_batch(jcfg, 3, seed=1, dtype=jnp.float64)
    tp, ts = t_make_batch(tcfg, 3, seed=1, dtype=F64, device="cpu")
    sched = _square_wave(12)
    jfinal, jtraj = jax.jit(lambda p, st, b: JR.rollout_scheduled(
        p, st, b, dt=1.0, substeps=m, stages=s))(
            jp, js, JR.BoundaryConditions(**sched))
    tsched = convert.boundary_from_numpy(sched, dtype=F64, device="cpu")
    tfinal, ttraj = TR.rollout_scheduled(tp, ts, tsched, 1.0, m, stages=s)
    _assert_state_close(tfinal, jfinal)
    _assert_close(ttraj["chlorine"], jtraj["chlorine"])


def test_stack_boundary_schedule_and_length_checks():
    rows = [TR.BoundaryConditions(inlet_pH=7.0 + 0.1 * i) for i in range(4)]
    sched = TR.stack_boundary_schedule(rows)
    ref = JR.stack_boundary_schedule(
        [JR.BoundaryConditions(inlet_pH=7.0 + 0.1 * i) for i in range(4)])
    np.testing.assert_array_equal(sched.inlet_pH, ref.inlet_pH)
    assert TR.schedule_length(sched) == 4
    with pytest.raises(ValueError, match="no \\[n_steps\\]"):
        TR.schedule_length(TR.BoundaryConditions())
    with pytest.raises(ValueError, match="disagree"):
        TR.schedule_length(TR.BoundaryConditions(
            inlet_pH=np.ones(3), inlet_chlorine=np.ones(4)))


def test_conservation_metrics_match_jax():
    jcfg, tcfg = _configs(5, True)
    jp, js = j_make_batch(jcfg, 4, seed=9, dtype=jnp.float64)
    tp, ts = t_make_batch(tcfg, 4, seed=9, dtype=F64, device="cpu")
    ref = JR.conservation_metrics(jp, js)
    got = TR.conservation_metrics(tp, ts)
    assert got.keys() == ref.keys()
    for key in ref:
        if key == "zones":
            assert got[key] == ref[key]
        else:
            np.testing.assert_allclose(_np(got[key]), np.asarray(ref[key]),
                                       rtol=1e-13, atol=0)


@pytest.mark.parametrize("integrator", ["rk4", "rkc-strict", "rkc-fast"])
def test_integrated_cstr_matches_jax(integrator):
    jcfg, tcfg = _configs(5, True)
    jr = JR.IntegratedCSTR(jcfg, dtype=jnp.float64, integrator=integrator)
    tr = TR.IntegratedCSTR(tcfg, dtype=F64, device="cpu",
                           integrator=integrator)
    jbc, tbc = JR.BoundaryConditions(**BC), TR.BoundaryConditions(**BC)
    jr.step(1.0, jbc)
    tr.step(1.0, tbc)
    _assert_state_close(tr.state, jr.state)
    jr.rollout(1.0, jbc, 5, record=False)
    tr.rollout(1.0, tbc, 5, record=False)
    _assert_state_close(tr.state, jr.state)
    jr.rollout_fused(1.0, jbc, 5)
    tr.rollout_fused(1.0, tbc, 5)
    _assert_state_close(tr.state, jr.state)
    sched = _square_wave(4)
    _, jtraj = jr.rollout_scheduled(1.0, JR.BoundaryConditions(**sched))
    _, ttraj = tr.rollout_scheduled(1.0, convert.boundary_from_numpy(
        sched, dtype=F64, device="cpu"))
    _assert_state_close(tr.state, jr.state)
    _assert_close(ttraj["pH"], jtraj["pH"])
    for zone in (0, 4):
        for name in ("pH", "chlorine", "temperature", "density"):
            assert tr.get_state_at_location(zone, name) == pytest.approx(
                jr.get_state_at_location(zone, name), abs=ATOL)
    ref = jr.validate_conservation()
    got = tr.validate_conservation()
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-12)
    with pytest.raises(ValueError, match="out of range"):
        tr.get_state_at_location(5, "pH")
    with pytest.raises(ValueError, match="Unknown parameter"):
        tr.get_state_at_location(0, "turbidity")


VALIDATION_CASES = [
    ("config", dict(volume=500.0)), ("config", dict(flow_rate=-1.0)),
    ("config", dict(initial_pH=15.0)), ("config", dict(initial_chlorine=11.0)),
    ("config", dict(temperature=45.0)),
    ("geometry", dict(volume=500.0)), ("geometry", dict(n_zones=1)),
    ("flow", dict(flow_rate=-1.0)), ("flow", dict(turbulent_intensity=2.0)),
    ("flow", dict(recirculation_ratio=-1.0)),
    ("flow", dict(impeller_speed=-1.0)), ("flow", dict(impeller_diameter=0.0)),
]


@pytest.mark.parametrize("kind,bad", VALIDATION_CASES)
def test_validation_matches_jax(kind, bad):
    def build(mod, tmod):
        if kind == "config":
            return mod.ReactorConfiguration(**bad)
        if kind == "geometry":
            return tmod.GeometryParameters(**{
                **dict(volume=1000.0, height=2.0, diameter=0.798), **bad})
        return tmod.FlowParameters(**{**dict(flow_rate=5.0), **bad})

    for mod, tmod in ((JR, jtransport), (TR, ttransport)):
        with pytest.raises(ValueError):
            build(mod, tmod).validate()
    # the default of each kind is valid in both packages
    TR.ReactorConfiguration().validate()
    ttransport.GeometryParameters(volume=1000.0, height=2.0,
                                  diameter=0.798).validate()
    ttransport.FlowParameters(flow_rate=5.0).validate()


@pytest.mark.parametrize("flag", TR.EXTENSION_FLAGS)
def test_extension_axes_ported(flag):
    """Each extension axis builds on the CPU, bit for bit as in the JAX
    package: its parameters, initial state and Monte-Carlo batch (the
    dynamics are held in tests/test_torch_extensions.py)."""
    jcfg = JR.ReactorConfiguration(n_zones=5, **{flag: True})
    tcfg = TR.ReactorConfiguration(n_zones=5, **{flag: True})
    axis = flag[len("enable_"):]
    tp = TR.make_params(tcfg, F64, device="cpu")
    assert getattr(tp, axis) is not None
    _assert_tree_equal(tp, JR.make_params(jcfg, jnp.float64))
    _assert_tree_equal(TR.make_initial_state(tcfg, F64, device="cpu"),
                       JR.make_initial_state(jcfg, jnp.float64))
    jp, js = j_make_batch(jcfg, 2, seed=3, dtype=jnp.float64)
    tp, ts = t_make_batch(tcfg, 2, seed=3, dtype=F64, device="cpu")
    _assert_tree_equal(tp, jp)
    _assert_tree_equal(ts, js)


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid here")
    cfg = TR.ReactorConfiguration(n_zones=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.make_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.IntegratedCSTR(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make_batch(cfg, 4)
