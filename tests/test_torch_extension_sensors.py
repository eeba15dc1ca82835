"""The port's three extension instruments (ammonia, dissolved oxygen,
turbidity) and the ten-instrument plant against the JAX package, on the CPU
in float64.

Parameters and carries are built bit for bit alike. Reads take the same
injected draws (made with NumPy from a seed) on both sides and carry their
state forward over a run of reads; every float of the output and the carry
agrees within atol 1e-12 (the same operations in the same order; only the
libraries' ``exp``/``pow`` last bit differs), status and fault codes equal,
NaN in the same places. The plant with all six axes takes a 5-step
``plant_rollout`` with identical draws, held at the reactor's atol 1e-10 +
rtol 1e-10 (pathogen counts near 1e4 org/L)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL
from ics_wt_physicsengine_tpu.sensors import ammonia as JA
from ics_wt_physicsengine_tpu.sensors import oxygen as JO
from ics_wt_physicsengine_tpu.sensors import turbidity as JTB
from ics_wt_physicsengine_tpu.sensors import types as JTY

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch import sensors as TS
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models import plant as TPL
from ics_wt_physicsengine_torch.sensors import ammonia as TA
from ics_wt_physicsengine_torch.sensors import base as TB
from ics_wt_physicsengine_torch.sensors import oxygen as TO
from ics_wt_physicsengine_torch.sensors import turbidity as TTB
from ics_wt_physicsengine_torch.sensors import types as TTY

from torch_port_util import assert_tree_close, to_numpy, tree_to_numpy

torch.set_num_threads(1)

ATOL = 1e-12
F64 = torch.float64
KEY = jax.random.PRNGKey(0)     # the JAX carries want one; never drawn from
ROUGH = dict(flow_velocity=0.05, air_bubble_frequency=6.0,
             grounding_quality=0.5, pipe_vibration_g=0.4,
             ambient_temperature=31.0)
LINE = dict(volume_mL=250, flow_rate_mL_min=500, ambient_temp=25.0)

# kind -> (JAX module, port module, maker kwargs, read inputs of step i)
KINDS = {
    "ammonia-ise": (JA, TA, dict(sensor_type="ise"),
                    lambda i: (1.0 + 0.3 * np.sin(0.4 * i), 7.2 + 0.1 * i,
                               18.0 + 0.5 * i)),
    "ammonia-gsm": (JA, TA, dict(sensor_type="gsm"),
                    lambda i: (2.0 + 0.2 * np.cos(0.3 * i), 8.5, 12.0)),
    "oxygen-optical": (JO, TO, dict(sensor_type="optical"),
                       lambda i: (8.0 + 0.5 * np.sin(0.2 * i),
                                  15.0 + 0.3 * i, 5.0)),
    "oxygen-clark": (JO, TO, dict(sensor_type="clark"),
                     lambda i: (7.0 - 0.1 * i, 22.0, 0.02 + 0.5 * (i % 3))),
    "turbidity": (JTB, TTB, dict(bubble_rate=0.3),
                  lambda i: (4.0 + 3.0 * np.sin(0.5 * i) ** 2,)),
}
READS = {JA: "ammonia_read", JO: "oxygen_read", JTB: "turbidity_read"}
MAKERS = {JA: ("make_ammonia_params", "make_ammonia_carry"),
          JO: ("make_oxygen_params", "make_oxygen_carry"),
          JTB: ("make_turbidity_params", "make_turbidity_carry")}


def _make(kind, dtype):
    jm, tm, kw, _ = KINDS[kind]
    mp, mc = MAKERS[jm]
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    jinst = JTY.InstallationQuality(**ROUGH)
    tinst = TTY.InstallationQuality(**ROUGH)
    jp = getattr(jm, mp)(zone_index=-1, installation=jinst,
                         sample_line=JTY.SampleLine(**LINE), dtype=jdtype,
                         **kw)
    tp = getattr(tm, mp)(zone_index=-1, installation=tinst,
                         sample_line=TTY.SampleLine(**LINE), dtype=dtype,
                         device="cpu", **kw)
    jc = getattr(jm, mc)(jp, KEY, t0=12.5, dtype=jdtype)
    tc = getattr(tm, mc)(tp, t0=12.5, dtype=dtype, device="cpu")
    return jp, jc, tp, tc


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_make_params_and_carry_bit_equal(kind, dtype):
    jp, jc, tp, tc = _make(kind, dtype)
    assert_tree_close(tp, jp, atol=0.0)
    assert_tree_close(tc, jc, atol=0.0)
    carried = convert.sensor_carry_from_numpy(type(tc), tree_to_numpy(jc),
                                              dtype=dtype, device="cpu")
    assert_tree_close(carried, jc, atol=0.0)


def _warm(carry):
    return dataclasses.replace(carry, base=dataclasses.replace(
        carry.base, power_on_time=np.float64(-4000.0),
        last_calibration_time=np.float64(0.0),
        has_calibration=np.asarray(True)))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_read_sequence_matches_jax(kind):
    """Forty reads with injected draws: warm-up is behind, a few reads
    roll a bubble or an open/short circuit, the carry ages between reads."""
    jm, tm, _, inputs = KINDS[kind]
    jp, jc, tp, tc = _make(kind, F64)
    jc = _warm(jc)
    tc = convert.sensor_carry_from_numpy(type(tc), tree_to_numpy(jc),
                                         dtype=F64, device="cpu")
    read_j = jax.jit(getattr(jm, READS[jm]))
    read_t = getattr(tm, READS[jm])
    rng = np.random.default_rng(len(kind))
    faults = set()
    for i in range(40):
        normals = rng.standard_normal(jm.N_NORMALS)
        uniforms = rng.random(jm.N_UNIFORMS)
        uniforms[1] = 0.0 if i in (17, 31) else 0.5
        t = 100.0 + 900.0 * i
        x = inputs(i)
        jc, jo = read_j(jp, jc, *x, t, rand=(jnp.asarray(normals),
                                             jnp.asarray(uniforms)))
        tc, to = read_t(tp, tc, *x, t, rand=(torch.from_numpy(normals),
                                             torch.from_numpy(uniforms)))
        assert_tree_close(to, jo, atol=ATOL, path=f"read{i}.out")
        assert_tree_close(tc, jc, atol=ATOL, path=f"read{i}.carry")
        faults.add(int(to.fault))
    assert len(faults) > 1          # the injected circuit faults showed


def test_overlay_maintenance_ops_match_jax():
    jp, jc, tp, tc = _make("oxygen-clark", F64)
    jc = dataclasses.replace(jc, cap_age_days=np.float64(3.0),
                             membrane_fouling=np.float64(0.2))
    tc = convert.sensor_carry_from_numpy(TO.OxygenSensorCarry,
                                         tree_to_numpy(jc), dtype=F64,
                                         device="cpu")
    assert_tree_close(TO.replace_cap(tc), JO.replace_cap(jc), atol=0.0)
    _, jt, _, _ = _make("turbidity", F64)
    jt = dataclasses.replace(jt, window_fouling_ntu=np.float64(2.0))
    tt = convert.sensor_carry_from_numpy(TTB.TurbiditySensorCarry,
                                         tree_to_numpy(jt), dtype=F64,
                                         device="cpu")
    assert_tree_close(TTB.wipe_window(tt), JTB.wipe_window(jt), atol=0.0)
    t = torch.linspace(0.0, 30.0, 7, dtype=F64)
    np.testing.assert_allclose(
        to_numpy(TO.percent_saturation(8.0 + 0.0 * t, t)),
        np.asarray(JO.percent_saturation(8.0 + 0.0 * np.asarray(t),
                                         np.asarray(t))),
        rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["ammonia", "oxygen", "turbidity"])
def test_extension_sensor_suites_pass_on_the_cpu(name, capsys):
    assert getattr(TS, f"validate_{name}_sensor")(device="cpu")
    assert "ALL PASS" in capsys.readouterr().out


# wrapper class -> (its module, its functional read)
WRAPPERS = {"AmmoniaSensor": (TA, TA.ammonia_read),
            "OxygenSensor": (TO, TO.oxygen_read),
            "TurbiditySensor": (TTB, TTB.turbidity_read)}


@pytest.mark.parametrize("cls", sorted(WRAPPERS))
def test_wrapper_reads_match_the_functional_read(cls):
    """The object API: a wrapper's reads, with injected draws, equal the
    functional read on its own params and carry; its maintenance op and
    properties act on the carry."""
    sensor = getattr(TS, cls)(name="x", zone_index=-1, seed=3,
                              dtype=F64, device="cpu")
    params, carry = sensor.params, sensor.carry

    class State:
        pH = np.full(5, 7.2)
        temperature = np.full(5, 18.0)
        flow_rate = 5.0
        ammonia = np.linspace(1.0, 2.0, 5)
        oxygen = np.linspace(7.0, 9.0, 5)
        tss = np.stack([np.linspace(5.0, 9.0, 5), np.full(5, 3.0),
                        np.full(5, 1.0)])

    rng = np.random.default_rng(4)
    mod, read = WRAPPERS[cls]
    for i in range(4):
        rand = (torch.from_numpy(rng.standard_normal(mod.N_NORMALS)),
                torch.from_numpy(rng.random(mod.N_UNIFORMS)))
        reading = sensor.read(State, 2000.0 + 10.0 * i, rand=rand)
        inputs = sensor._extract_inputs(State)
        carry, out = read(params, carry, *inputs, 2000.0 + 10.0 * i,
                          rand=rand)
        assert reading.value == pytest.approx(float(out.value), abs=0) \
            or (np.isnan(reading.value) and bool(torch.isnan(out.value)))
    if cls == "TurbiditySensor":
        ntu = float(sensor._extract_inputs(State)[0])
        assert ntu == pytest.approx(3.0 * 9.0 + 3.0 + 0.25, rel=1e-15)
        sensor.wipe_window()
        assert sensor.window_fouling_ntu == 0.0
    elif cls == "OxygenSensor":
        sensor.replace_cap()
        assert sensor.cap_age_days == 0.0 and sensor.electrolyte == 1.0
    else:
        assert sensor.slope_percentage <= 100.0


# ---------------------------------------------------------------------------
# the ten-instrument plant
# ---------------------------------------------------------------------------

AXES = dict(enable_nitrogen=True, enable_gas=True, enable_particles=True,
            enable_disinfection=True, enable_biofilm=True, enable_phase=True,
            initial_ammonia=1.0, initial_tss=20.0, initial_pathogens=1e4)
PLANT_BC = dict(inlet_flow_rate=5.0, inlet_pH=7.4, inlet_chlorine=0.3,
                chlorine_flow_rate=0.1, inlet_ammonia=1.0, aeration_kla=1e-3,
                inlet_tss=20.0, coagulant_dose=10.0, filter_flow_rate=5.0,
                inlet_pathogens=1e4, uv_intensity=10.0,
                ambient_temperature=5.0, wind_speed=2.0,
                heat_loss_coefficient=50.0)
EXT = (("ammonia_outlet", JA), ("oxygen_outlet", JO),
       ("turbidity_outlet", JTB))
LAYOUT = tuple(JPL._RAND_LAYOUT) + tuple(
    (name, m.N_NORMALS, m.N_UNIFORMS) for name, m in EXT)


def _plants(n_zones=5):
    jp, js = JPL.make_plant(JR.ReactorConfiguration(n_zones=n_zones, **AXES),
                            seed=1, dtype=jnp.float64)
    tp = convert.plant_params_from_numpy(tree_to_numpy(jp), dtype=F64,
                                         device="cpu")
    ts = convert.plant_state_from_numpy(tree_to_numpy(js), dtype=F64,
                                        device="cpu")
    return jp, js, tp, ts


def test_make_plant_with_all_axes_bit_equal():
    jp, js, tp, ts = _plants()
    for dtype, jdtype in ((F64, jnp.float64), (torch.float32, jnp.float32)):
        p, s = TPL.make_plant(TR.ReactorConfiguration(n_zones=5, **AXES),
                              dtype=dtype, device="cpu")
        jp2, js2 = JPL.make_plant(JR.ReactorConfiguration(n_zones=5, **AXES),
                                  seed=1, dtype=jdtype)
        assert_tree_close(p, jp2, atol=0.0)
        assert_tree_close(s, js2, atol=0.0)
    assert_tree_close(tp, jp, atol=0.0)
    assert_tree_close(ts, js, atol=0.0)


class Scripted:
    """Stands in for ``sensors.base.draw_read_rand``: hands out the draws of
    ``steps`` in the order the ten instruments ask for them."""

    def __init__(self, steps):
        self.queue = [s[name] for s in steps for name, _, _ in LAYOUT]

    def __call__(self, generator, shape, dtype, device, extra_normals=0,
                 extra_uniforms=0):
        normals, uniforms = self.queue.pop(0)
        assert normals.shape[-1] == TB.BASE_NORMALS + extra_normals
        assert uniforms.shape[-1] == TB.BASE_UNIFORMS + extra_uniforms
        return torch.from_numpy(normals), torch.from_numpy(uniforms)


def test_plant_rollout_with_all_axes_matches_jax(monkeypatch):
    """Five steps of the ten-instrument plant: JAX's ``plant_step`` with
    injected draws against the port's ``plant_rollout``, whose instruments
    take the same draws in call order, and against ``plant_step`` with
    ``rand=``."""
    jp, js, tp, ts = _plants()
    substeps = 3
    rng = np.random.default_rng(9)
    steps = [{name: (rng.standard_normal(n), rng.random(u))
              for name, n, u in LAYOUT} for _ in range(5)]
    fn = jax.jit(lambda p, s, bc, rand: JPL.plant_step(
        p, s, bc, 1.0, substeps, rand=rand))
    jbc = JR.BoundaryConditions(**PLANT_BC)
    outs = []
    for rand in steps:
        js, readings = fn(jp, js, jbc, {k: tuple(map(jnp.asarray, v))
                                        for k, v in rand.items()})
        outs.append(readings)
    assert set(outs[0]) == {name for name, _, _ in LAYOUT}

    tbc = TR.BoundaryConditions(**PLANT_BC)
    stepped = ts
    for i, rand in enumerate(steps):
        stepped, readings = TPL.plant_step(
            tp, stepped, tbc, 1.0, substeps,
            rand={k: tuple(map(torch.from_numpy, v))
                  for k, v in rand.items()})
        for name, _, _ in LAYOUT:
            np.testing.assert_allclose(
                to_numpy(readings[name].value),
                np.asarray(outs[i][name].value), rtol=1e-10, atol=1e-10,
                equal_nan=True, err_msg=name)
    monkeypatch.setattr(TB, "draw_read_rand", Scripted(steps))
    final, values = TPL.plant_rollout(tp, ts, tbc, 1.0, substeps, 5)
    for got in (stepped, final):
        for f in dataclasses.fields(got.reactor):
            a, b = getattr(got.reactor, f.name), getattr(js.reactor, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                np.testing.assert_allclose(to_numpy(a), np.asarray(b),
                                           rtol=1e-10, atol=1e-10,
                                           err_msg=f.name)
        for name, _ in EXT:
            assert_tree_close(getattr(got, name), getattr(js, name),
                              atol=1e-10)
    for name, _, _ in LAYOUT:
        want = np.stack([np.asarray(o[name].value) for o in outs])
        np.testing.assert_allclose(to_numpy(values[name]), want, rtol=1e-10,
                                   atol=1e-10, equal_nan=True, err_msg=name)
