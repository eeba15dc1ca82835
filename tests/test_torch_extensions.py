"""The PyTorch port's six extension axes (nitrogen, gas, particles,
disinfection, biofilm, phase) against the JAX package, on the CPU in
float64.

Inputs come from a seed through NumPy and go into both packages: a
Monte-Carlo batch (bit-identical in both), its state scattered by seeded
factors so that every zone and class differs, and a forcing that lights the
UV bank, doses coagulant, aerates and blows a cold wind over the surface.
For each axis alone and for all six together the right-hand side, one
``step`` and a 10-step ``rollout`` on 2 plants x 5 zones agree within
atol 1e-10 + rtol 1e-10 (float64 rounding over a few hundred evaluations;
the two packages evaluate ``exp``/``pow`` with different libraries, and the
pathogen counts sit near 1e4 org/L, hence the relative term). One
single-plant case, the two operator splits, a freezing case, the
Monte-Carlo batch and the object API are held the same way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models.monte_carlo import (
    make_monte_carlo_batch as j_make_batch)

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch import core as tcore
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models.monte_carlo import (
    make_monte_carlo_batch as t_make_batch)
from ics_wt_physicsengine_torch.utils.dispatch import map_tensors

from torch_port_util import assert_tree_close, to_numpy, tree_to_numpy

torch.set_num_threads(1)

ATOL = RTOL = 1e-10
F64 = torch.float64
AXES = ("nitrogen", "gas", "particles", "disinfection", "biofilm", "phase")
FLAG = {axis: f"enable_{axis}" for axis in AXES}

# bench.py's full-chemistry configuration (20 zones there; 5 here) and its
# forcing
FULL = dict(initial_ammonia=1.0, initial_tss=20.0, initial_pathogens=1e4,
            initial_bacteria=1e-3, initial_bdoc=0.5)
BC = dict(inlet_flow_rate=5.0, inlet_pH=7.5, inlet_chlorine=0.3,
          chlorine_flow_rate=0.1, chlorine_concentration=50.0,
          inlet_ammonia=1.0, aeration_kla=1e-3, inlet_tss=20.0,
          coagulant_dose=20.0, filter_flow_rate=10.0, sludge_blowdown=1e-5,
          inlet_pathogens=1e4, uv_intensity=10.0, inlet_bacteria=1e-3,
          inlet_bdoc=0.5, ambient_temperature=2.0, ambient_humidity=0.4,
          wind_speed=3.0, heat_loss_coefficient=100.0)


def _config(mod, axes, n_zones=5, **extra):
    kw = dict(n_zones=n_zones, **FULL, **extra)
    kw.update({FLAG[a]: True for a in axes})
    return mod.ReactorConfiguration(**kw)


def _scatter(state_values, seed):
    """The state's primary fields each times seeded factors in [0.8, 1.2]
    (pH in +-0.3, temperature in +-2 C), so zones and classes differ."""
    rng = np.random.default_rng(seed)
    out = dict(state_values)
    for name, v in state_values.items():
        if v is None or name in ("time", "flow_rate", "H_concentration",
                                 "density", "chlorine_decay_rate"):
            continue
        v = np.asarray(v)
        if name == "pH":
            out[name] = v + rng.uniform(-0.3, 0.3, v.shape)
        elif name == "temperature":
            out[name] = v + rng.uniform(-2.0, 2.0, v.shape)
        else:
            out[name] = v * rng.uniform(0.8, 1.2, v.shape) \
                + 0.01 * rng.uniform(0.0, 1.0, v.shape)
    return out


def _inputs(axes, n_plants=2, n_zones=5, seed=0, single=False,
            t_range=None, **extra):
    """(jax params, jax state, port params, port state) built from the same
    NumPy values; ``t_range`` draws the zone temperatures from it."""
    jp, js = j_make_batch(_config(JR, axes, n_zones, **extra), n_plants,
                          seed=seed, dtype=jnp.float64)
    pv, sv = tree_to_numpy(jp), _scatter(tree_to_numpy(js), seed + 1)
    if t_range is not None:
        sv["temperature"] = np.random.default_rng(seed + 2).uniform(
            *t_range, sv["temperature"].shape)
    if single:
        def first(v):
            if isinstance(v, dict):
                return {k: first(x) for k, x in v.items()}
            return v if v is None or isinstance(v, int) else v[0]
        pv, sv = first(pv), first(sv)
    jp = JR.ReactorParams(**{
        k: (v if k == "n_zones" or v is None else
            type(getattr(jp, k))(**{kk: jnp.asarray(vv)
                                    for kk, vv in v.items()})
            if isinstance(v, dict) else jnp.asarray(v))
        for k, v in pv.items()})
    js = JR.ReactorState(**{k: (None if v is None else jnp.asarray(v))
                            for k, v in sv.items()})
    tp = convert.params_from_numpy(pv, dtype=F64, device="cpu")
    ts = convert.state_from_numpy(sv, dtype=F64, device="cpu")
    return jp, js, tp, ts


def _close(port, ref, what=""):
    np.testing.assert_allclose(to_numpy(port), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _state_close(port, ref):
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            _close(a, b, f.name)


def _species(state, axes):
    """The extension species of ``state`` as ``derivatives`` keywords."""
    return {axis: tuple(getattr(state, n) for n in TR.EXTENSION_STATE[axis])
            for axis in axes if axis in TR.EXTENSION_STATE}


def _jax_all(p, s, b, axes, substeps, n_steps):
    """The right-hand side and a scan that keeps every state: the first is
    one step, the last the rollout's final state (one compile of the step,
    not two). Jitted once per structure, so cases that differ only in
    values share the compile."""
    d = JR.derivatives(p, s.pH, s.chlorine, s.temperature, b,
                       **_species(s, axes))
    _, states = jax.lax.scan(
        lambda c, _: (JR.step(p, c, b, dt=1.0, substeps=substeps),) * 2,
        s, None, length=n_steps)
    return d, states


_jax_all_jit = jax.jit(_jax_all, static_argnames=("axes", "substeps",
                                                  "n_steps"))


def _run_both(axes, jp, js, tp, ts, bc=BC, n_steps=10, substeps=3):
    jbc, tbc = JR.BoundaryConditions(**bc), TR.BoundaryConditions(**bc)
    jd, states = _jax_all_jit(jp, js, jbc, axes=tuple(axes),
                              substeps=substeps, n_steps=n_steps)
    jone = jax.tree_util.tree_map(lambda x: x[0], states)
    jfinal = jax.tree_util.tree_map(lambda x: x[-1], states)
    td = TR.derivatives(tp, ts.pH, ts.chlorine, ts.temperature, tbc,
                        **_species(ts, axes))
    tone = TR.step(tp, ts, tbc, 1.0, substeps)
    tfinal, ttraj = TR.rollout(tp, ts, tbc, 1.0, substeps, n_steps)
    assert len(td) == len(jd)
    for i, (a, b) in enumerate(zip(td, jd)):
        _close(a, b, f"derivative {i}")
    _state_close(tone, jone)
    _state_close(tfinal, jfinal)
    for key in ("pH", "chlorine", "temperature"):
        _close(ttraj[key], getattr(states, key), key)
    return tone, tfinal


@pytest.mark.parametrize("axes", [(a,) for a in AXES] + [AXES],
                         ids=list(AXES) + ["all"])
def test_axes_match_jax(axes):
    jp, js, tp, ts = _inputs(axes, seed=3)
    tfinal, _ = _run_both(axes, jp, js, tp, ts)
    for axis in axes:
        for name in TR.EXTENSION_STATE.get(axis, ()):
            assert getattr(tfinal, name) is not None, name


def test_all_axes_single_plant_matches_jax():
    jp, js, tp, ts = _inputs(AXES, seed=5, single=True)
    assert ts.tss.shape == (3, 5) and ts.pathogens.shape == (3, 5)
    assert ts.sludge.shape == (3,)
    _run_both(AXES, jp, js, tp, ts, n_steps=4)


# The per-axis cases of the particle and disinfection axes feed per-class
# inlet vectors (the connected-network path), the others the scalar inlets.
CLASS_INLETS = {
    "particles": dict(inlet_tss_classes=np.array([[9.0, 7.0, 4.0],
                                                  [12.0, 5.0, 3.0]])),
    "disinfection": dict(inlet_pathogen_classes=np.array(
        [[1e4, 5e3, 2e3], [8e3, 1e3, 3e3]])),
}


@pytest.mark.parametrize("axes", [(a,) for a in AXES] + [AXES],
                         ids=list(AXES) + ["all"])
def test_axes_match_jax(axes):
    jp, js, tp, ts = _inputs(axes, seed=3)
    bc = dict(BC, **CLASS_INLETS.get(axes[0], {})) if len(axes) == 1 else BC
    tone, tfinal = _run_both(axes, jp, js, tp, ts, bc=bc)
    for axis in axes:
        for name in TR.EXTENSION_STATE.get(axis, ()):
            assert getattr(tfinal, name) is not None, name
    assert bool(torch.isfinite(tfinal.pH).all())


def test_all_axes_single_plant_matches_jax():
    jp, js, tp, ts = _inputs(AXES, seed=5, single=True)
    assert ts.tss.shape == (3, 5) and ts.pathogens.shape == (3, 5)
    assert ts.sludge.shape == (3,) and ts.pH.shape == (5,)
    _run_both(AXES, jp, js, tp, ts)


@pytest.mark.parametrize("split", ["uv", "chloramination"])
def test_operator_splits_match_jax(split):
    """Both splits against JAX, each beside a run without it: the lit UV
    bank lowers the outlet pathogens of one step and leaves the other zones
    alone, and chloramination moves free chlorine into monochloramine."""
    jp, js, tp, ts = _inputs(AXES, seed=11)
    if split == "uv":
        on, off = BC, dict(BC, uv_intensity=0.0)
    else:
        on, off = BC, dict(BC, inlet_ammonia=0.0)
    lit, _ = _run_both(AXES, jp, js, tp, ts, bc=on)
    dark, _ = _run_both(AXES, jp, js, tp, ts, bc=off)
    if split == "uv":
        # virus is UV-hardy (143 mJ/cm2 for 3 logs), the protozoa are not
        assert bool((lit.pathogens[..., -1] < dark.pathogens[..., -1]).all())
        assert bool((lit.pathogens[..., 1:, -1]
                     < 0.5 * dark.pathogens[..., 1:, -1]).all())
        assert torch.equal(lit.pathogens[..., :-1], dark.pathogens[..., :-1])
    else:
        gained = lit.chloramine - ts.chloramine
        assert float(gained.max()) > 1e-3
        assert bool((lit.chlorine < ts.chlorine + 0.05).all())


def test_freezing_case_matches_jax():
    """All axes with zone temperatures drawn from [-2, 2] C under a -10 C
    wind: ice, mushy and liquid zones side by side (ice lid, mixture
    density, insulation, the widened clip)."""
    jp, js, tp, ts = _inputs(AXES, seed=17, t_range=(-2.0, 2.0))
    bc = dict(BC, ambient_temperature=-10.0, inlet_temperature=0.5,
              wind_speed=8.0, ambient_humidity=0.2)
    tone, tfinal = _run_both(AXES, jp, js, tp, ts, bc=bc)
    ice = tcore.ice_fraction(ts.temperature,
                             map_tensors(lambda x: x[:, None], tp.phase))
    assert float(ice.max()) == 1.0 and float(ice.min()) == 0.0
    assert float(tfinal.temperature.min()) < 0.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_plants,seed", [(3, 0), (4, 7)])
def test_monte_carlo_batch_bit_equal(dtype, n_plants, seed):
    """All axes, bit for bit (3 plants: as many as particle classes, the
    case a shape test would get wrong); the core fields are the core-only
    batch's, as the nitrogen draws come after the core ones."""
    jp, js = j_make_batch(_config(JR, AXES), n_plants, seed=seed,
                          dtype=getattr(jnp, dtype))
    tp, ts = t_make_batch(_config(TR, AXES), n_plants, seed=seed,
                          dtype=getattr(torch, dtype), device="cpu")
    assert_tree_close(tp, jp)
    assert_tree_close(ts, js)
    assert tp.particles.diameters_m.shape == (n_plants, 3)
    assert tp.disinfection.k_uv.shape == (n_plants, 3)
    assert len(set(tp.nitrogen.k_nitrif.tolist())) == n_plants
    cp, cs = t_make_batch(TR.ReactorConfiguration(n_zones=5, **FULL),
                          n_plants, seed=seed, dtype=getattr(torch, dtype),
                          device="cpu")
    for name in ("pH", "chlorine", "temperature", "flow_rate"):
        torch.testing.assert_close(getattr(ts, name), getattr(cs, name),
                                   rtol=0, atol=0)
    torch.testing.assert_close(tp.chem.alk_eq, cp.chem.alk_eq, rtol=0,
                               atol=0)


def test_make_params_and_state_bit_equal():
    for jd, td in ((jnp.float64, F64), (jnp.float32, torch.float32)):
        for axes in [AXES] + [(a,) for a in AXES]:
            assert_tree_close(
                TR.make_params(_config(TR, axes), td, device="cpu"),
                JR.make_params(_config(JR, axes), jd))
            assert_tree_close(
                TR.make_initial_state(_config(TR, axes), td, device="cpu"),
                JR.make_initial_state(_config(JR, axes), jd))
    overrides = dict(nitrogen_kinetics=dict(k_nitrif=3.0),
                     gas_params=dict(kl_surface=4e-5),
                     particle_params=dict(inlet_fractions=(1.0, 1.0, 2.0)),
                     disinfection_params=dict(r_ocl=0.1),
                     biofilm_params=dict(ct_3log_hpc=20.0),
                     phase_params=dict(solute_molality=0.5),
                     initial_oxygen=7.0)
    assert_tree_close(
        TR.make_params(_config(TR, AXES, **overrides), F64, device="cpu"),
        JR.make_params(_config(JR, AXES, **overrides), jnp.float64))
    assert_tree_close(
        TR.make_initial_state(_config(TR, AXES, **overrides), F64,
                              device="cpu"),
        JR.make_initial_state(_config(JR, AXES, **overrides), jnp.float64))


def test_convert_and_schedules_carry_the_extension_fields():
    jp, js = j_make_batch(_config(JR, AXES), 2, seed=1, dtype=jnp.float64)
    tp = convert.params_from_numpy(dataclasses.asdict(jp), dtype=F64,
                                   device="cpu")
    ts = convert.state_from_numpy(dataclasses.asdict(js), dtype=F64,
                                  device="cpu")
    assert_tree_close(tp, jp)
    assert_tree_close(ts, js)
    bc = convert.boundary_from_numpy(
        dataclasses.asdict(JR.BoundaryConditions(**BC)), dtype=F64,
        device="cpu")
    assert bc == TR.BoundaryConditions(**BC)
    assert bc.inlet_tss_classes is None
    rows = [TR.BoundaryConditions(**dict(BC, uv_intensity=float(i)))
            for i in range(4)]
    sched = TR.stack_boundary_schedule(rows)
    assert sched.inlet_tss_classes is None and TR.schedule_length(sched) == 4
    a, traj = TR.rollout_scheduled(tp, ts, sched, 1.0, 2)
    b = ts
    for row in rows:
        b = TR.step(tp, b, row, 1.0, 2)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert traj["pH"].shape == (4, 2, 5)


def test_integrated_cstr_reads_the_extension_species():
    cfg = _config(TR, AXES)
    reactor = TR.IntegratedCSTR(cfg, dtype=F64, device="cpu")
    params = TR.make_params(cfg, F64, device="cpu")
    state = TR.make_initial_state(cfg, F64, device="cpu")
    bc = TR.BoundaryConditions(**BC)
    m = reactor.substeps_for(1.0)
    for _ in range(3):
        reactor.step(1.0, bc)
        state = TR.step(params, state, bc, 1.0, m)
    torch.testing.assert_close(reactor.state.pathogens, state.pathogens,
                               rtol=0, atol=0)
    from ics_wt_physicsengine_tpu.core import particles as jparticles
    jpp = JR.make_params(_config(JR, AXES), jnp.float64).particles
    want = np.asarray(jparticles.turbidity_ntu(
        jnp.asarray(to_numpy(state.tss)), jpp))
    for zone in (0, 4):
        for name in ("ammonia", "nitrite", "nitrate", "chloramine",
                     "oxygen", "carbonate"):
            assert reactor.get_state_at_location(zone, name) == float(
                getattr(state, name)[zone])
        assert reactor.get_state_at_location(zone, "tss") == pytest.approx(
            float(state.tss[:, zone].sum()), rel=1e-15)
        assert reactor.get_state_at_location(zone, "turbidity") == \
            pytest.approx(float(want[zone]), rel=1e-14)
    with pytest.raises(ValueError, match="Unknown parameter"):
        reactor.get_state_at_location(0, "pathogens")


def test_phase_validation_range_matches_jax():
    for mod in (JR, TR):
        mod.ReactorConfiguration(temperature=-5.0, enable_phase=True) \
            .validate()
        with pytest.raises(ValueError, match="phase-change range"):
            mod.ReactorConfiguration(temperature=-70.0,
                                     enable_phase=True).validate()
        with pytest.raises(ValueError, match="typical range"):
            mod.ReactorConfiguration(temperature=-5.0).validate()


SUITES = ("nitrogen", "gas", "particles", "disinfection", "biofilm", "phase")


@pytest.mark.parametrize("suite", SUITES)
def test_axis_validation_suite_passes_on_the_cpu(suite, capsys):
    assert getattr(tcore, f"validate_{suite}")(device="cpu")
    out = capsys.readouterr().out
    assert "ALL PASS" in out and "FAIL:" not in out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chloramination_extent_guards_match_jax(dtype):
    """The split's extent over equal, near-equal, both-zero and lopsided
    pools and step lengths up to 1e9 s: finite, within [0, smaller pool],
    and JAX's value (float64 within 1e-12 relative; float32 within 1e-5
    relative, and no NaN from the branch not taken)."""
    from ics_wt_physicsengine_tpu.core import nitrogen as jn
    from ics_wt_physicsengine_torch.core import nitrogen as tn

    n_eq = 2.0 * tn.MW_N / tn.MW_CL2          # as many mol/L as 2 mg/L Cl2
    cl = np.array([2.0, 2.0, 2.0, 0.0, 2.0, 1e-6, 20.0, 0.3])
    tan = np.array([n_eq, n_eq * (1 + 5e-7), n_eq * (1 + 2e-6), 0.0, 10.0,
                    5.0, 1e-6, 0.3])
    ph = np.linspace(6.5, 9.5, cl.size)
    t = np.linspace(2.0, 30.0, cl.size)
    jp = jn.make_nitrogen_params(dtype=getattr(jnp, dtype))
    tp = tn.make_nitrogen_params(dtype=getattr(torch, dtype), device="cpu")
    for dt in (1.0, 60.0, 1e9):
        want = np.asarray(jn.chloramination_extent(
            *(jnp.asarray(x, getattr(jnp, dtype)) for x in (cl, tan, ph, t)),
            jnp.asarray(10 ** -7.5, getattr(jnp, dtype)), jp, dt))
        got = to_numpy(tn.chloramination_extent(
            *(torch.tensor(x, dtype=getattr(torch, dtype))
              for x in (cl, tan, ph, t)),
            torch.tensor(10 ** -7.5, dtype=getattr(torch, dtype)), tp, dt))
        assert np.all(np.isfinite(got)) and np.all(got >= 0.0)
        tdt = getattr(torch, dtype)
        smaller = to_numpy(torch.minimum(
            torch.tensor(cl, dtype=tdt) / tn._CL2_MGL_PER_MOL,
            torch.tensor(tan, dtype=tdt) / tn._N_MGL_PER_MOL))
        assert np.all(got <= smaller)
        np.testing.assert_allclose(got, want, atol=0,
                                   rtol=1e-12 if dtype == "float64" else 1e-5)
