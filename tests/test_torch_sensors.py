"""The port's seven-instrument suite against the JAX package's: the same
parameters, carries and injected randomness (made with NumPy from a seed) go
through ``base_read`` and each overlay on both sides, in float64, carrying
the state forward over ~50 reads.

Tolerance: atol 1e-12 on every float of the output and the carry (the
formulas are the same operations in the same order; the only difference is
the libraries' ``exp``/``pow`` last bit), status and fault codes equal, NaN
in the same places. The scenarios force each branch of the pipeline by
injecting the draws that reach it, so nothing is left to chance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.sensors import base as JB
from ics_wt_physicsengine_tpu.sensors import chlorine as JC
from ics_wt_physicsengine_tpu.sensors import flow as JF
from ics_wt_physicsengine_tpu.sensors import ph as JP
from ics_wt_physicsengine_tpu.sensors import temperature as JT
from ics_wt_physicsengine_tpu.sensors import types as JTY

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch.sensors import base as TB
from ics_wt_physicsengine_torch.sensors import chlorine as TC
from ics_wt_physicsengine_torch.sensors import flow as TF
from ics_wt_physicsengine_torch.sensors import ph as TP
from ics_wt_physicsengine_torch.sensors import temperature as TT
from ics_wt_physicsengine_torch.sensors import types as TTY

from torch_port_util import assert_tree_close, tree_to_numpy

torch.set_num_threads(1)

ATOL = 1e-12
F64 = torch.float64
KEY = jax.random.PRNGKey(0)     # the JAX carries want one; never drawn from

ROUGH = dict(flow_velocity=0.05, air_bubble_frequency=6.0,
             grounding_quality=0.5, pipe_vibration_g=0.4,
             ambient_temperature=31.0)
LINE = dict(volume_mL=250, flow_rate_mL_min=500, ambient_temp=25.0)


def port_params(cls, jax_params):
    return convert.sensor_params_from_numpy(cls, tree_to_numpy(jax_params),
                                            dtype=F64, device="cpu")


def port_carry(cls, jax_carry):
    return convert.sensor_carry_from_numpy(cls, tree_to_numpy(jax_carry),
                                           dtype=F64, device="cpu")


def draws(rng, n_normals, n_uniforms, shape=()):
    return (rng.standard_normal(shape + (n_normals,)),
            rng.random(shape + (n_uniforms,)))


def both(rand):
    """One set of draws for each side."""
    return (tuple(jnp.asarray(x) for x in rand),
            tuple(torch.from_numpy(np.array(x)) for x in rand))


def warm(jax_carry, t0=0.0):
    """Backdate power-on and calibrate, as ``make_plant(warmed_up=True)``."""
    if hasattr(jax_carry, "base"):
        return dataclasses.replace(jax_carry, base=warm(jax_carry.base, t0))
    return dataclasses.replace(
        jax_carry, power_on_time=np.float64(t0 - 4000.0),
        last_calibration_time=np.float64(t0), has_calibration=np.asarray(True))


# ---------------------------------------------------------------------------
# the types module is a copy
# ---------------------------------------------------------------------------


def test_types_match_the_jax_package():
    assert [s.name for s in TTY.SensorStatus] == \
        [s.name for s in JTY.SensorStatus]
    assert [f.name for f in TTY.SensorFault] == \
        [f.name for f in JTY.SensorFault]
    assert {k.name: v for k, v in TTY.STATUS_CODE.items()} == \
        {k.name: v for k, v in JTY.STATUS_CODE.items()}
    assert {k.name: v for k, v in TTY.FAULT_CODE.items()} == \
        {k.name: v for k, v in JTY.FAULT_CODE.items()}
    line_t, line_j = TTY.SampleLine(**LINE), JTY.SampleLine(**LINE)
    assert line_t.transport_delay_s == line_j.transport_delay_s == 30.0
    assert line_t.buffer_capacity == line_j.buffer_capacity
    with pytest.raises(ValueError):
        TTY.InstallationQuality(grounding_quality=1.5).validate()
    for name in ("SensorReading", "CalibrationRecord"):
        assert [f.name for f in dataclasses.fields(getattr(TTY, name))] == \
            [f.name for f in dataclasses.fields(getattr(JTY, name))]


# ---------------------------------------------------------------------------
# makers: bit-equal parameters and carries
# ---------------------------------------------------------------------------

MAKERS = {
    "base": (lambda m, kw: m.make_sensor_params((0.0, 10.0), 0.01,
                                                drift_rate=0.001, **kw),
             lambda m, p, kw: m.make_sensor_carry(p, **kw), JB, TB),
    "ph": (lambda m, kw: m.make_ph_params(zone_index=-1, **kw),
           lambda m, p, kw: m.make_ph_carry(p, **kw), JP, TP),
    "chlorine-amperometric": (
        lambda m, kw: m.make_chlorine_params(sensor_type=m.AMPEROMETRIC,
                                             **kw),
        lambda m, p, kw: m.make_chlorine_carry(p, **kw), JC, TC),
    "chlorine-dpd": (
        lambda m, kw: m.make_chlorine_params(sensor_type=m.DPD,
                                             measurement_type="total", **kw),
        lambda m, p, kw: m.make_chlorine_carry(p, **kw), JC, TC),
    "flow-turbine": (
        lambda m, kw: m.make_flow_params(sensor_type=m.TURBINE,
                                         full_scale=20.0, **kw),
        lambda m, p, kw: m.make_flow_carry(p, **kw), JF, TF),
    "flow-magnetic": (
        lambda m, kw: m.make_flow_params(sensor_type=m.MAGNETIC, **kw),
        lambda m, p, kw: m.make_flow_carry(p, **kw), JF, TF),
    "temperature-rtd": (
        lambda m, kw: m.make_temperature_params(sensor_type=m.RTD_PT100,
                                                **kw),
        lambda m, p, kw: m.make_temperature_carry(p, **kw), JT, TT),
    "temperature-thermocouple": (
        lambda m, kw: m.make_temperature_params(
            sensor_type=m.THERMOCOUPLE_K, **kw),
        lambda m, p, kw: m.make_temperature_carry(p, **kw), JT, TT),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_make_params_and_carry_bit_equal(kind, dtype):
    make_p, make_c, jm, tm = MAKERS[kind]
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    jkw = dict(installation=JTY.InstallationQuality(**ROUGH),
               sample_line=JTY.SampleLine(**LINE), dtype=jdtype)
    tkw = dict(installation=TTY.InstallationQuality(**ROUGH),
               sample_line=TTY.SampleLine(**LINE), dtype=dtype, device="cpu")
    jp, tp = make_p(jm, jkw), make_p(tm, tkw)
    assert_tree_close(tp, jp, atol=0.0)
    jc = make_c(jm, jp, dict(t0=12.5, dtype=jdtype, key=KEY))
    tc = make_c(tm, tp, dict(t0=12.5, dtype=dtype, device="cpu"))
    assert_tree_close(tc, jc, atol=0.0)
    assert tc.base.line_values.shape[-1] == tp.base.line_capacity \
        if kind != "base" else tc.line_values.shape[-1] == tp.line_capacity


# ---------------------------------------------------------------------------
# base_read scenarios
# ---------------------------------------------------------------------------


def _base_pair(installation=None, line=False, **params_kw):
    jp = JB.make_sensor_params(
        (0.0, 10.0), 0.01, drift_rate=0.002,
        installation=JTY.InstallationQuality(**(installation or {})),
        sample_line=JTY.SampleLine(**LINE) if line else None,
        dtype=jnp.float64, **params_kw)
    jc = JB.make_sensor_carry(jp, KEY, t0=0.0, dtype=jnp.float64)
    return jp, jc


def _run_base(jp, jc, script, n_reads=50, seed=0, dt=1.0, between=None):
    """Both pipelines over ``n_reads`` reads. ``script(i, truth, normals,
    uniforms)`` may overwrite the step's draws and return a new true
    value; ``between(i, jax_carry, port_carry)`` may act on the carries
    before read ``i``. Returns the codes seen, for the scenario to check."""
    tp, tc = port_params(TB.SensorParams, jp), port_carry(TB.SensorCarry, jc)
    rng = np.random.default_rng(seed)
    read_j = jax.jit(JB.base_read)
    seen = {"status": set(), "fault": set(), "nan": 0}
    for i in range(n_reads):
        t = (i + 1) * dt
        normals, uniforms = draws(rng, JB.BASE_NORMALS, JB.BASE_UNIFORMS)
        truth = 5.0 + 0.5 * np.sin(0.3 * i)
        truth = script(i, truth, normals, uniforms) or truth
        if between is not None:
            jc, tc = between(i, jc, tc)
        rj, rt = both((normals, uniforms))
        jc, jo = read_j(jp, jc, truth, t, rand=rj)
        tc, to = TB.base_read(tp, tc, truth, t, rand=rt)
        assert_tree_close(to, jo, atol=ATOL, path=f"read{i}.out")
        assert_tree_close(tc, jc, atol=ATOL, path=f"read{i}.carry")
        seen["status"].add(int(to.status))
        seen["fault"].add(int(to.fault))
        seen["nan"] += int(torch.isnan(to.value))
    return seen


def _code(table, enum, name):
    return table[getattr(enum, name)]


def S(name):
    return _code(TTY.STATUS_CODE, TTY.SensorStatus, name)


def Fc(name):
    return _code(TTY.FAULT_CODE, TTY.SensorFault, name)


def test_base_read_warmup_and_calibration_expiry():
    """A cold sensor warms up for 20 s, reads uncalibrated (expired), is
    calibrated with an 0.01 h validity at read 30 (which restarts the
    warm-up), reads normally, and expires again 36 s after that."""
    jp, jc = _base_pair(warmup_time_s=20.0)

    def between(i, jc, tc):
        if i == 30:
            jc, off_j = JB.calibrate(jc, 5.2, 30.0, validity_hours=0.01)
            tc, off_t = TB.calibrate(tc, 5.2, 30.0, validity_hours=0.01)
            np.testing.assert_allclose(off_t.numpy(), np.asarray(off_j),
                                       rtol=0, atol=ATOL)
        return jc, tc

    seen = _run_base(jp, jc, lambda *a: None, n_reads=75, between=between)
    assert {S("WARMING_UP"), S("CALIBRATION_EXPIRED"), S("NORMAL")} \
        <= seen["status"]
    assert seen["nan"] >= 38        # two warm-ups of ~19 reads each


def test_base_read_power_faults_drawn_and_injected():
    """The voltage walk leaves [20, 28] V at read 10 (drawn: n_volt = 5) and
    latches; it is cleared at read 20; a low-voltage fault is injected at
    read 30 and cleared at read 40."""
    jp, jc = _base_pair()
    jc = warm(jc)

    def script(i, truth, normals, uniforms):
        if i == 10:
            normals[0] = 5.0

    def between(i, jc, tc):
        if i in (20, 40):
            return JB.clear_power_fault(jc), TB.clear_power_fault(tc)
        if i == 30:
            return (JB.inject_power_fault(jc, "power_low"),
                    TB.inject_power_fault(tc, "power_low"))
        return jc, tc

    seen = _run_base(jp, jc, script, between=between)
    assert {Fc("POWER_HIGH"), Fc("POWER_LOW"), Fc("NONE")} <= seen["fault"]
    assert S("POWER_FAULT") in seen["status"] and seen["nan"] >= 18
    with pytest.raises(ValueError):
        TB.inject_power_fault(port_carry(TB.SensorCarry, jc), "brownout")


def test_base_read_bubble_and_open_short_latch():
    """Rough installation (every installation term active). A bubble at
    read 8 gives one NaN that the lag then keeps; an open circuit at read
    20 and a short at read 30 set FAILED. The NaN latch of the reference
    is preserved on both sides."""
    jp, jc = _base_pair(installation=ROUGH)
    jc = warm(jc)

    def script(i, truth, normals, uniforms):
        uniforms[0] = 0.9            # no chance bubbles
        uniforms[1] = 0.5            # no chance faults
        if i == 8:
            uniforms[0] = 0.0        # bubble
        if i == 20:
            uniforms[1], uniforms[2] = 0.0, 0.2     # open circuit
        if i == 30:
            uniforms[1], uniforms[2] = 0.0, 0.8     # short circuit

    seen = _run_base(jp, jc, script)
    assert {Fc("OPEN_CIRCUIT"), Fc("SHORT_CIRCUIT")} <= seen["fault"]
    assert S("FAILED") in seen["status"]
    assert seen["nan"] == 42         # latched from read 8 on


def test_base_read_open_circuit_without_bubble_recovers_nothing():
    """An open circuit alone also latches: current_value becomes NaN and
    the lag carries it."""
    jp, jc = _base_pair()
    jc = warm(jc)

    def script(i, truth, normals, uniforms):
        uniforms[1] = 0.5
        if i == 5:
            uniforms[1], uniforms[2] = 0.0, 0.1

    seen = _run_base(jp, jc, script, n_reads=20)
    assert seen["nan"] == 15


def test_base_read_out_of_range_saturation_and_rate_fault():
    """True values beyond the range + 10 % span (out of range), inside the
    margin (saturated), and a jump faster than the rate limit."""
    jp, jc = _base_pair(max_rate_of_change=0.8)
    jc = warm(jc)

    def script(i, truth, normals, uniforms):
        uniforms[1] = 0.5
        if 10 <= i < 16:
            return 40.0              # lag climbs past 11: out of range
        if 25 <= i < 32:
            return 10.8              # settles between 10 and 11: saturated
        if i == 40:
            return 9.0               # +2/s against 0.8/s

    seen = _run_base(jp, jc, script)
    assert {Fc("OUT_OF_RANGE"), Fc("RATE_FAULT")} <= seen["fault"]
    assert {S("OUT_OF_RANGE"), S("SATURATED"),
            S("RATE_OF_CHANGE_FAULT")} <= seen["status"]


def test_base_read_drift_warning():
    jp, jc = _base_pair()
    jc = dataclasses.replace(warm(jc), calibration_offset=np.float64(1.5))
    seen = _run_base(jp, jc, lambda *a: None, n_reads=10)
    assert S("DRIFT_WARNING") in seen["status"]


@pytest.mark.parametrize("dt", [1.0, 4.0, 7.5])
def test_base_read_exact_ring_with_a_30s_delay(dt):
    """The sample-line ring: nearest-timestamp lookup 30 s back, including
    the young-line clamp, steps that do not divide the delay, and appends
    skipped while a power fault holds (reads 12-17)."""
    jp, jc = _base_pair(line=True)
    jc = warm(jc)

    def script(i, truth, normals, uniforms):
        uniforms[1] = 0.5
        if i == 12:
            normals[0] = -5.0        # 19 V: power low, latches

    def between(i, jc, tc):
        if i == 18:
            return JB.clear_power_fault(jc), TB.clear_power_fault(tc)
        return jc, tc

    _run_base(jp, jc, script, dt=dt, between=between)


def test_ring_lookup_breaks_an_argmin_tie_by_slot_order():
    """Two ring entries exactly as far from ``t - delay``: both packages
    pick the first in storage order, even where that is the newer one."""
    jp, jc = _base_pair(line=True)
    cap = jp.line_capacity
    values = np.zeros(cap)
    times = np.full(cap, -np.inf)
    values[:3] = [1.0, 2.0, 3.0]
    times[:3] = [72.0, 68.0, 50.0]        # target 70: slots 0 and 1 tie
    jc = dataclasses.replace(jc, line_values=values, line_times=times,
                             line_count=np.asarray(3, np.int32),
                             line_ptr=np.asarray(3, np.int32))
    tp, tc = port_params(TB.SensorParams, jp), port_carry(TB.SensorCarry, jc)
    jn, jd = JB._ring_append_and_lookup(jp, jc, jnp.asarray(9.0),
                                        jnp.asarray(100.0),
                                        jnp.asarray(False))
    tn, td = TB._ring_append_and_lookup(tp, tc, torch.tensor(9.0, dtype=F64),
                                        torch.tensor(100.0, dtype=F64),
                                        torch.tensor(False))
    assert float(td) == float(jd) == 1.0
    assert_tree_close(tn, jn, atol=0.0)
    # with the append the new sample (t = 100) joins and slot order holds
    jn, jd = JB._ring_append_and_lookup(jp, jc, jnp.asarray(9.0),
                                        jnp.asarray(100.0),
                                        jnp.asarray(True))
    tn, td = TB._ring_append_and_lookup(tp, tc, torch.tensor(9.0, dtype=F64),
                                        torch.tensor(100.0, dtype=F64),
                                        torch.tensor(True))
    assert float(td) == float(jd) == 1.0
    assert_tree_close(tn, jn, atol=0.0)
    assert int(tn.line_ptr) == 4 and int(tn.line_count) == 4


def test_base_read_natively_batched_equals_vmapped_jax():
    """A batch of four sensors with their own rings and draws in one port
    call, against ``jax.vmap`` of the single-sensor read."""
    jp, jc = _base_pair(line=True)
    jc = warm(jc)
    n = 4
    jcb = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x), (n,) + jnp.shape(x)),
        dataclasses.replace(jc, key=jnp.zeros(2, jnp.uint32)))
    tp = port_params(TB.SensorParams, jp)
    tc = port_carry(TB.SensorCarry, jcb)
    read_j = jax.jit(jax.vmap(
        lambda c, v, t, r: JB.base_read(jp, c, v, t, rand=r),
        in_axes=(0, 0, None, 0)))
    rng = np.random.default_rng(5)
    for i in range(45):
        t = float(i + 1)
        normals, uniforms = draws(rng, JB.BASE_NORMALS, JB.BASE_UNIFORMS,
                                  (n,))
        uniforms[:, 1] = 0.5
        if i == 7:
            uniforms[2, 1] = 0.0         # plant 2 fails, the others do not
        truth = 5.0 + np.arange(n) + 0.2 * i
        rj, rt = both((normals, uniforms))
        jcb, jo = read_j(jcb, jnp.asarray(truth), t, rj)
        tc, to = TB.base_read(tp, tc, torch.from_numpy(truth), t, rand=rt)
        assert_tree_close(to, jo, atol=ATOL, path=f"read{i}.out")
        assert_tree_close(tc, jcb, atol=ATOL, path=f"read{i}.carry")
    assert torch.isnan(to.value).tolist() == [False, False, True, False]


def test_base_read_draws_from_a_generator():
    """Without ``rand`` the read draws from the generator: reproducible for
    a seed, and the same as handing it ``draw_read_rand``'s draws."""
    jp, jc = _base_pair()
    tp = port_params(TB.SensorParams, jp)
    tc = port_carry(TB.SensorCarry, warm(jc))
    g = torch.Generator().manual_seed(3)
    _, a = TB.base_read(tp, tc, 5.0, 1.0, generator=g)
    g.manual_seed(3)
    rand = TB.draw_read_rand(g, (), F64, "cpu")
    _, b = TB.base_read(tp, tc, 5.0, 1.0, rand=rand)
    assert rand[0].shape == (TB.BASE_NORMALS,)
    assert rand[1].shape == (TB.BASE_UNIFORMS,)
    assert float(a.value) == float(b.value)
    assert (TB.BASE_NORMALS, TB.BASE_UNIFORMS) == \
        (JB.BASE_NORMALS, JB.BASE_UNIFORMS)


# ---------------------------------------------------------------------------
# overlays
# ---------------------------------------------------------------------------


def _overlay_sequence(jparams, jcarry, tparams_cls, tcarry_cls, read_j,
                      read_t, n_normals, n_uniforms, inputs, n_reads=50,
                      seed=0, events=None):
    tp = port_params(tparams_cls, jparams)
    tc = port_carry(tcarry_cls, jcarry)
    jc = jcarry
    rng = np.random.default_rng(seed)
    read_j = jax.jit(read_j)
    nans = 0
    for i in range(n_reads):
        t = 10.0 * (i + 1)
        normals, uniforms = draws(rng, n_normals, n_uniforms)
        uniforms[1] = 0.5
        if events:
            events(i, normals, uniforms)
        args = inputs(i)
        rj, rt = both((normals, uniforms))
        jc, jo = read_j(jparams, jc, *args, t, rand=rj)
        tc, to = read_t(tp, tc, *args, t, rand=rt)
        assert_tree_close(to, jo, atol=ATOL, path=f"read{i}.out")
        assert_tree_close(tc, jc, atol=ATOL, path=f"read{i}.carry")
        nans += int(torch.isnan(to.value))
    return jc, tc, nans


def _fault_then_nothing(i, normals, uniforms):
    if i == 35:
        uniforms[1], uniforms[2] = 0.0, 0.3


@pytest.mark.parametrize("installation", [None, ROUGH])
def test_ph_read_sequence(installation):
    """Fouling, slope and contamination accumulate; outside the 4-7
    calibration window the slope error is live; an open circuit at read 35
    freezes the overlay state."""
    inst = JTY.InstallationQuality(**(installation or {}))
    jp = JP.make_ph_params(zone_index=-1, sample_line=JTY.SampleLine(**LINE),
                           installation=inst, dtype=jnp.float64)
    jc = warm(JP.make_ph_carry(jp, KEY, dtype=jnp.float64))
    jc = dataclasses.replace(jc, membrane_fouling=np.float64(0.04999),
                             reference_contamination=np.float64(0.2))
    assert (TP.N_NORMALS, TP.N_UNIFORMS) == (JP.N_NORMALS, JP.N_UNIFORMS)

    def events(i, normals, uniforms):
        uniforms[0] = 0.9
        _fault_then_nothing(i, normals, uniforms)

    _, tc, nans = _overlay_sequence(
        jp, jc, TP.PHSensorParams, TP.PHSensorCarry, JP.ph_read, TP.ph_read,
        JP.N_NORMALS, JP.N_UNIFORMS,
        lambda i: (6.0 + 0.08 * i, 18.0 + 0.4 * i), events=events)
    assert nans == 15
    assert float(tc.membrane_fouling) > 0.04999
    # the overlay value becomes last_value (the preserved quirk)
    assert torch.isnan(tc.base.last_value)


def test_ph_read_delayed_true_hook_and_nernst():
    """``delayed_true`` bypasses the ring (``line_capacity = 0`` params), as
    the fused kernel calls the read; ``nernst_compensated_ph`` agrees."""
    jp = JP.make_ph_params(dtype=jnp.float64)
    jc = warm(JP.make_ph_carry(jp, KEY, dtype=jnp.float64))
    tp = port_params(TP.PHSensorParams, jp)
    tc = port_carry(TP.PHSensorCarry, jc)
    rng = np.random.default_rng(2)
    for i in range(10):
        rj, rt = both(draws(rng, JP.N_NORMALS, JP.N_UNIFORMS))
        ph, temp, t = 6.5 + 0.1 * i, 21.0 + i, float(i + 1)
        comp_j = JP.nernst_compensated_ph(jp, ph, temp, dtype=jnp.float64)
        comp_t = TP.nernst_compensated_ph(
            tp, torch.tensor(ph, dtype=F64), torch.tensor(temp, dtype=F64))
        assert abs(float(comp_t) - float(comp_j)) <= ATOL
        jc, jo = JP.ph_read(jp, jc, ph, temp, t, rand=rj,
                            delayed_true=comp_j - 0.3)
        tc, to = TP.ph_read(tp, tc, ph, temp, t, rand=rt,
                            delayed_true=comp_t - 0.3)
        assert_tree_close(to, jo, atol=ATOL)
        assert_tree_close(tc, jc, atol=ATOL)


@pytest.mark.parametrize("method", ["water_rinse", "acid_clean",
                                    "pepsin_clean"])
def test_clean_electrode(method):
    jp = JP.make_ph_params(dtype=jnp.float64)
    jc = dataclasses.replace(
        JP.make_ph_carry(jp, KEY, dtype=jnp.float64),
        membrane_fouling=np.float64(0.6), glass_etching=np.float64(0.01),
        days_since_cleaning=np.float64(12.0))
    tc = port_carry(TP.PHSensorCarry, jc)
    assert_tree_close(TP.clean_electrode(tc, method, 77.0),
                      JP.clean_electrode(jc, method, 77.0), atol=ATOL)
    with pytest.raises(ValueError):
        TP.clean_electrode(tc, "sandblast", 1.0)


@pytest.mark.parametrize("sensor_type", ["AMPEROMETRIC", "DPD"])
@pytest.mark.parametrize("installation", [None, ROUGH])
def test_chlorine_read_sequence(sensor_type, installation):
    inst = JTY.InstallationQuality(**(installation or {}))
    jp = JC.make_chlorine_params(sensor_type=getattr(JC, sensor_type),
                                 installation=inst, dtype=jnp.float64)
    jc = warm(JC.make_chlorine_carry(jp, KEY, dtype=jnp.float64))
    assert (TC.N_NORMALS, TC.N_UNIFORMS) == (JC.N_NORMALS, JC.N_UNIFORMS)

    def events(i, normals, uniforms):
        uniforms[0] = 0.9
        _fault_then_nothing(i, normals, uniforms)

    jc, tc, nans = _overlay_sequence(
        jp, jc, TC.ChlorineSensorParams, TC.ChlorineSensorCarry,
        JC.chlorine_read, TC.chlorine_read, JC.N_NORMALS, JC.N_UNIFORMS,
        lambda i: (1.0 + 0.02 * i, 6.8 + 0.03 * i), events=events)
    assert nans == 15
    # maintenance on the aged carries
    assert_tree_close(TC.replace_membrane(tc, 600.0),
                      JC.replace_membrane(jc, 600.0), atol=ATOL)
    assert_tree_close(TC.replace_reagent(tc, 600.0, storage_temp=4.0),
                      JC.replace_reagent(jc, 600.0, storage_temp=4.0),
                      atol=ATOL)


def test_chlorine_read_interferents_and_total_measurement():
    """Amperometric cross-sensitivities, and a "total" sensor adding the
    combined species; ``chlorine_true_value`` on an array."""
    jp = JC.make_chlorine_params(measurement_type="total", dtype=jnp.float64)
    jc = warm(JC.make_chlorine_carry(jp, KEY, dtype=jnp.float64))
    tp = port_params(TC.ChlorineSensorParams, jp)
    tc = port_carry(TC.ChlorineSensorCarry, jc)
    rj, rt = both(draws(np.random.default_rng(1), JC.N_NORMALS,
                        JC.N_UNIFORMS))
    kw = dict(ozone=0.1, hydrogen_peroxide=0.2, chlorine_dioxide=0.05)
    jc2, jo = JC.chlorine_read(jp, jc, 1.2, 7.3, 5.0, combined_zone=0.4,
                               rand=rj, **kw)
    tc2, to = TC.chlorine_read(tp, tc, 1.2, 7.3, 5.0, combined_zone=0.4,
                               rand=rt, **kw)
    assert_tree_close(to, jo, atol=ATOL)
    assert_tree_close(tc2, jc2, atol=ATOL)
    cl, ph = np.linspace(0.0, 3.0, 7), np.linspace(5.5, 9.5, 7)
    np.testing.assert_allclose(
        TC.chlorine_true_value(torch.from_numpy(cl),
                               torch.from_numpy(ph)).numpy(),
        np.asarray(JC.chlorine_true_value(jnp.asarray(cl), jnp.asarray(ph))),
        rtol=0, atol=ATOL)
    with pytest.raises(ValueError):
        TC.make_chlorine_params(measurement_type="combined", device="cpu")


@pytest.mark.parametrize("sensor_type", ["TURBINE", "MAGNETIC"])
@pytest.mark.parametrize("installation", [None, ROUGH])
def test_flow_read_sequence(sensor_type, installation):
    """Bearing wear or electrode fouling accumulate; a bubble roll (the
    fourth uniform) zeroes the reading; flows under 1 % of full scale cut
    off; low conductivity scales a magnetic meter."""
    inst = JTY.InstallationQuality(**(installation or {}))
    jp = JF.make_flow_params(sensor_type=getattr(JF, sensor_type),
                             full_scale=20.0, installation=inst,
                             dtype=jnp.float64)
    jc = warm(JF.make_flow_carry(jp, KEY, dtype=jnp.float64))
    jc = dataclasses.replace(jc, fluid_conductivity=np.float64(12.0))
    assert (TF.N_NORMALS, TF.N_UNIFORMS) == (JF.N_NORMALS, JF.N_UNIFORMS)

    def events(i, normals, uniforms):
        uniforms[0] = 0.9
        uniforms[3] = 0.0 if i in (12, 13) else 0.9
        _fault_then_nothing(i, normals, uniforms)

    _, _, nans = _overlay_sequence(
        jp, jc, TF.FlowSensorParams, TF.FlowSensorCarry, JF.flow_read,
        TF.flow_read, JF.N_NORMALS, JF.N_UNIFORMS,
        lambda i: (0.05 if 20 <= i < 24 else 5.0 + 0.1 * i,), events=events)
    assert nans == 15


@pytest.mark.parametrize("sensor_type", ["RTD_PT100", "THERMOCOUPLE_K"])
@pytest.mark.parametrize("installation", [None, ROUGH])
def test_temperature_read_sequence(sensor_type, installation):
    """RTD lead resistance and self-heating, or the thermocouple's cold
    junction drift (a random walk on the sixth normal); the base read gets
    the unsliced uniforms, as in the JAX package."""
    inst = JTY.InstallationQuality(**(installation or {}))
    jp = JT.make_temperature_params(sensor_type=getattr(JT, sensor_type),
                                    sample_line=JTY.SampleLine(**LINE),
                                    installation=inst, dtype=jnp.float64)
    jc = warm(JT.make_temperature_carry(jp, KEY, dtype=jnp.float64))
    assert (TT.N_NORMALS, TT.N_UNIFORMS) == (JT.N_NORMALS, JT.N_UNIFORMS)

    def events(i, normals, uniforms):
        uniforms[0] = 0.9
        _fault_then_nothing(i, normals, uniforms)

    _, tc, nans = _overlay_sequence(
        jp, jc, TT.TemperatureSensorParams, TT.TemperatureSensorCarry,
        JT.temperature_read, TT.temperature_read, JT.N_NORMALS,
        JT.N_UNIFORMS, lambda i: (15.0 + 0.3 * i,), events=events)
    assert nans == 15
    if sensor_type == "THERMOCOUPLE_K":
        assert float(tc.cold_junction_drift) != 0.0


def test_temperature_read_delayed_true_hook():
    jp = JT.make_temperature_params(dtype=jnp.float64)
    jc = warm(JT.make_temperature_carry(jp, KEY, dtype=jnp.float64))
    tp = port_params(TT.TemperatureSensorParams, jp)
    tc = port_carry(TT.TemperatureSensorCarry, jc)
    rng = np.random.default_rng(4)
    for i in range(8):
        rj, rt = both(draws(rng, JT.N_NORMALS, JT.N_UNIFORMS))
        jc, jo = JT.temperature_read(jp, jc, 20.0 + i, float(i + 1), rand=rj,
                                     delayed_true=jnp.asarray(19.0 + i))
        tc, to = TT.temperature_read(
            tp, tc, 20.0 + i, float(i + 1), rand=rt,
            delayed_true=torch.tensor(19.0 + i, dtype=F64))
        assert_tree_close(to, jo, atol=ATOL)
        assert_tree_close(tc, jc, atol=ATOL)
