"""The port's sensor object API against the JAX package's, on the CPU in
float64: the four sensor classes over a scripted run (warm-up, live reads,
an injected power fault and its repair, an open circuit, maintenance,
calibration), the electrical stage, the suite factory, the validation
suites and the demo.

Both sides get the same draws. The port's ``read`` takes them (``rand=``);
on the JAX side the test replaces the instance's ``_read_fn`` with one that
hands them to the same functional read (nothing in the JAX package
changes). Draws come from a NumPy seed.

Tolerance: 1e-12 on every float of a ``SensorReading``, of a calibration
record and of the carry (same operations in the same order; the libraries'
``exp``/``pow`` may differ in the last bit), NaN in the same places, status
and fault enums equal by name.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu import sensors as JS
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.sensors import chlorine as JC
from ics_wt_physicsengine_tpu.sensors import electrical as JE
from ics_wt_physicsengine_tpu.sensors import flow as JF
from ics_wt_physicsengine_tpu.sensors import ph as JP
from ics_wt_physicsengine_tpu.sensors import temperature as JT

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch import sensors as TS
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.sensors import chlorine as TC
from ics_wt_physicsengine_torch.sensors import electrical as TE
from ics_wt_physicsengine_torch.sensors import flow as TF
from ics_wt_physicsengine_torch.sensors import ph as TP
from ics_wt_physicsengine_torch.sensors import temperature as TT
from ics_wt_physicsengine_torch.sensors.__main__ import main as demo_main

from torch_port_util import assert_tree_close, tree_to_numpy

torch.set_num_threads(1)

ATOL = 1e-12
F64 = torch.float64
LINE = dict(volume_mL=250, flow_rate_mL_min=500, ambient_temp=25.0)
ROUGH = dict(flow_velocity=0.05, air_bubble_frequency=0.0,
             grounding_quality=0.5, pipe_vibration_g=0.4,
             ambient_temperature=31.0)


class State:
    """The duck-typed reactor state of tick ``i``: NumPy profiles that move,
    so lag, line delay and rate checks all see changing inputs."""

    def __init__(self, i, tensors=False):
        wrap = torch.from_numpy if tensors else (lambda x: x)
        z = np.arange(5)
        self.pH = wrap(7.0 + 0.1 * z + 0.02 * math.sin(i / 5.0))
        self.chlorine = wrap(2.0 - 0.1 * z + 0.05 * math.cos(i / 7.0))
        self.temperature = wrap(20.0 + 0.3 * z + 0.1 * math.sin(i / 9.0))
        self.ozone = wrap(np.full(5, 0.05))
        self.chloramine = wrap(np.full(5, 0.3))
        self.flow_rate = 5.0 + 0.5 * math.sin(i / 4.0)


def _jax_chlorine_read(params, carry, cl, ph, o3, h2o2, clo2, comb, t, rand):
    return JC.chlorine_read(params, carry, cl, ph, t, ozone=o3,
                            hydrogen_peroxide=h2o2, chlorine_dioxide=clo2,
                            combined_zone=comb, rand=rand)


# kind -> (port class, JAX class, constructor keywords, JAX functional read,
#          number of normals, number of uniforms, calibration reference)
KINDS = {
    "ph": (TS.pHSensor, JS.pHSensor,
           dict(zone_index=-1, sample_line=LINE, installation=ROUGH),
           lambda p, c, *a, rand: JP.ph_read(p, c, *a, rand=rand),
           TP.N_NORMALS, TP.N_UNIFORMS, 7.3),
    "chlorine-amperometric": (
        TS.ChlorineSensor, JS.ChlorineSensor,
        dict(zone_index=1, sensor_type=TC.AMPEROMETRIC, installation=ROUGH),
        _jax_chlorine_read, TC.N_NORMALS, TC.N_UNIFORMS, 1.9),
    "chlorine-dpd-total": (
        TS.ChlorineSensor, JS.ChlorineSensor,
        dict(zone_index=-1, sensor_type=TC.DPD, measurement_type="total"),
        _jax_chlorine_read, TC.N_NORMALS, TC.N_UNIFORMS, 1.6),
    "flow-magnetic": (
        TS.FlowSensor, JS.FlowSensor,
        dict(sensor_type=TF.MAGNETIC, full_scale=10.0, installation=ROUGH),
        lambda p, c, *a, rand: JF.flow_read(p, c, *a, rand=rand),
        TF.N_NORMALS, TF.N_UNIFORMS, 5.0),
    "flow-turbine": (
        TS.FlowSensor, JS.FlowSensor,
        dict(sensor_type=TF.TURBINE, full_scale=20.0),
        lambda p, c, *a, rand: JF.flow_read(p, c, *a, rand=rand),
        TF.N_NORMALS, TF.N_UNIFORMS, 5.0),
    "temperature-rtd": (
        TS.TemperatureSensor, JS.TemperatureSensor,
        dict(zone_index=0, sample_line=LINE, installation=ROUGH),
        lambda p, c, *a, rand: JT.temperature_read(p, c, *a, rand=rand),
        TT.N_NORMALS, TT.N_UNIFORMS, 20.0),
    "temperature-thermocouple": (
        TS.TemperatureSensor, JS.TemperatureSensor,
        dict(zone_index=2, sensor_type=TT.THERMOCOUPLE_K),
        lambda p, c, *a, rand: JT.temperature_read(p, c, *a, rand=rand),
        TT.N_NORMALS, TT.N_UNIFORMS, 20.6),
}


def _pair(kind):
    """A port sensor and a JAX sensor of ``kind`` with the same settings,
    and ``read(i, t, **force)``: one read of ``State(i)`` at time ``t`` on
    both with the same draws."""
    port_cls, jax_cls, kw, jax_read, n_normals, n_uniforms, _ = KINDS[kind]

    def build(cls, types, **extra):
        kw2 = dict(kw)
        if "sample_line" in kw2:
            kw2["sample_line"] = types.SampleLine(**kw2["sample_line"])
        if "installation" in kw2:
            kw2["installation"] = types.InstallationQuality(
                **kw2["installation"])
        return cls(name=kind, seed=5, **kw2, **extra)

    port = build(port_cls, TS, dtype=F64, device="cpu")
    ref = build(jax_cls, JS, dtype=jnp.float64)
    rng = np.random.default_rng(17)
    holder = {}
    ref._read_fn = lambda p, c, *a: jax_read(p, c, *a, rand=holder["rand"])

    def read(i, t, fault_roll=None, tensors=False):
        normals = rng.standard_normal(n_normals)
        uniforms = rng.random(n_uniforms)
        # base layout: fault roll, then type pick. The 1e-4 roll is kept
        # off except where the script forces it.
        uniforms[1] = max(uniforms[1], 1e-3)
        if fault_roll is not None:
            uniforms[1], uniforms[2] = fault_roll
        holder["rand"] = (jnp.asarray(normals), jnp.asarray(uniforms))
        got = port.read(State(i, tensors), t,
                        rand=(torch.from_numpy(normals),
                              torch.from_numpy(uniforms)))
        want = ref.read(State(i), t)
        return got, want

    return port, ref, read


def _same_reading(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, float):
            assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= ATOL, \
                (f.name, a, b)
        else:
            assert a.name == b.name, (f.name, a, b)


def _same_record(got, want):
    assert got.operator_id == want.operator_id
    for name in ("timestamp", "reference_value", "measured_value", "offset",
                 "validity_hours"):
        assert abs(getattr(got, name) - getattr(want, name)) <= ATOL, name


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sensor_class_matches_jax_over_a_scripted_run(kind):
    port, ref, read = _pair(kind)
    reference_value = KINDS[kind][-1]
    warmup = float(port.params.base.warmup_time_s)
    assert (port.min_value, port.max_value, port.precision) == \
        (ref.min_value, ref.max_value, ref.precision)
    assert_tree_close(port.params, ref.params)
    assert_tree_close(port.carry, ref.carry)

    _same_record(port.calibrate(reference_value, 0.0, operator_id="test"),
                 ref.calibrate(reference_value, 0.0, operator_id="test"))
    statuses = set()
    for i in range(2):                       # inside the warm-up window
        got, want = read(i, 1.0 + i)
        _same_reading(got, want)
        assert got.status is TS.SensorStatus.WARMING_UP
        assert math.isnan(got.value)
    t0 = warmup + 10.0
    for i in range(60):                      # live
        if i == 20:
            port.inject_fault("power_low")
            ref.inject_fault("power_low")
        if i == 25:
            # the power-fault path freezes the carried status and fault
            assert port.status.name == ref.status.name
            assert port.fault.name == ref.fault.name
            port.clear_faults()
            ref.clear_faults()
        got, want = read(i, t0 + i, tensors=i % 2 == 1)
        _same_reading(got, want)
        statuses.add(got.status.name)
        if 20 <= i < 25:
            assert math.isnan(got.value) and got.status.name == "POWER_FAULT"
        elif i in (10, 30, 59):
            assert math.isfinite(got.value)
        assert port.status.name == ref.status.name
        assert abs(port.current_value - ref.current_value) <= ATOL
    assert_tree_close(port.carry, ref.carry, atol=ATOL)
    assert "POWER_FAULT" in statuses and len(statuses) >= 2

    # histories and statistics
    assert len(port.reading_history) == len(ref.reading_history) == 62
    for window in (5.0, 60.0, 1e6):
        got, want = port.get_statistics(window), ref.get_statistics(window)
        assert got.keys() == want.keys()
        for key in got:
            assert got[key] == pytest.approx(want[key], abs=1e-10,
                                             nan_ok=True), key
        assert len(port.get_recent_readings(window)) == \
            len(ref.get_recent_readings(window))
    assert port.calculate_drift_rate(30.0) == pytest.approx(
        ref.calculate_drift_rate(30.0), abs=1e-9)
    assert port.cumulative_drift == pytest.approx(ref.cumulative_drift,
                                                  abs=ATOL)
    assert repr(port).startswith(type(port).__name__ + "(name=")

    # time may not run backwards
    with pytest.raises(ValueError, match="Non-monotonic time"):
        port.read(State(0), t0)

    # an open circuit: NaN, FAILED, and the NaN stays in the lag afterwards
    t1 = t0 + 100.0
    got, want = read(60, t1, fault_roll=(0.0, 0.1))
    _same_reading(got, want)
    assert got.status is TS.SensorStatus.FAILED
    assert got.fault is TS.SensorFault.OPEN_CIRCUIT and math.isnan(got.value)
    got, want = read(61, t1 + 1.0)
    _same_reading(got, want)
    assert_tree_close(port.carry, ref.carry, atol=ATOL)

    # reset: fresh carry, empty histories
    port.reset(seed=3)
    ref.reset(seed=3)
    assert not port.reading_history and not port.calibration_history
    assert_tree_close(port.carry, ref.carry)
    got, want = read(0, 1.0)
    _same_reading(got, want)


def test_ph_sensor_extras_match_jax():
    port, ref, read = _pair("ph")
    for s in (port, ref):
        s.calibrate(7.3, 0.0)
        s.set_water_hardness(250.0)
    t = 1900.0
    for i in range(12):
        _same_reading(*read(i, t + 3600.0 * i))      # fouling builds up
    assert port.membrane_fouling == pytest.approx(ref.membrane_fouling,
                                                  abs=ATOL)
    assert port.membrane_fouling > 0.0
    t += 3600.0 * 12
    got, want = port.check_slope_health(), ref.check_slope_health()
    for key in got:
        if key != "days_since_calibration":     # reads the monotonic clock
            assert got[key] == pytest.approx(want[key], abs=ATOL), key
    for method in ("water_rinse", "acid_clean", "pepsin_clean"):
        port.clean_electrode(method, t)
        ref.clean_electrode(method, t)
        assert_tree_close(port.carry, ref.carry, atol=ATOL)
        assert port.slope_percentage == pytest.approx(ref.slope_percentage,
                                                      abs=ATOL)
    with pytest.raises(ValueError, match="Unknown cleaning method"):
        port.clean_electrode("sandblast", t)
    _same_record(port.calibrate_two_point(4.0, 7.0, 4.05, 6.9, t + 1.0),
                 ref.calibrate_two_point(4.0, 7.0, 4.05, 6.9, t + 1.0))
    assert port.slope_percentage == pytest.approx(95.0, abs=1e-9)
    _same_record(port.calibrate_two_point(7.0, 7.0, 7.0, 7.0, t + 2.0),
                 ref.calibrate_two_point(7.0, 7.0, 7.0, 7.0, t + 2.0))
    assert_tree_close(port.carry, ref.carry, atol=ATOL)
    for i in range(3):                           # past the restarted warm-up
        _same_reading(*read(20 + i, t + 2000.0 + i))
    with pytest.raises(ValueError, match="non-negative"):
        port.set_water_hardness(-1.0)
    assert port.sample_line.transport_delay_s == 30.0
    assert port.temperature_coefficient == ref.temperature_coefficient


def test_chlorine_sensor_consumables_match_jax():
    amp, ref_amp, read_amp = _pair("chlorine-amperometric")
    dpd, ref_dpd, read_dpd = _pair("chlorine-dpd-total")
    for s in (amp, ref_amp, dpd, ref_dpd):
        s.calibrate(1.8, 0.0)
    for i in range(10):
        _same_reading(*read_amp(i, 400.0 + 7200.0 * i))
        _same_reading(*read_dpd(i, 400.0 + 7200.0 * i))
    t = 400.0 + 7200.0 * 10
    assert amp.membrane_fouling == pytest.approx(ref_amp.membrane_fouling,
                                                 abs=ATOL)
    assert dpd.reagent_potency == pytest.approx(ref_dpd.reagent_potency,
                                                abs=ATOL)
    assert dpd.reagent_potency < 1.0
    amp.replace_membrane(t)
    ref_amp.replace_membrane(t)
    dpd.replace_reagent(t, storage_temp=8.0)
    ref_dpd.replace_reagent(t, storage_temp=8.0)
    assert_tree_close(amp.carry, ref_amp.carry, atol=ATOL)
    assert_tree_close(dpd.carry, ref_dpd.carry, atol=ATOL)
    assert amp.calibration_history[-1].operator_id == "membrane_replacement"
    assert dpd.calibration_history[-1].operator_id == "reagent_replacement"
    assert dpd.reagent_potency == 1.0
    with pytest.raises(ValueError, match="amperometric"):
        dpd.replace_membrane(t)
    with pytest.raises(ValueError, match="DPD"):
        amp.replace_reagent(t)
    for i in range(3):
        _same_reading(*read_amp(30 + i, t + 400.0 + i))
        _same_reading(*read_dpd(30 + i, t + 400.0 + i))
    # enum-style arguments are accepted, as in the JAX package
    enum = TS.ChlorineSensor("e", sensor_type=TS.ChlorineSensorType.AMPEROMETRIC,
                             measurement_type="total", dtype=F64, device="cpu")
    assert enum.sensor_type == TC.AMPEROMETRIC
    assert enum.params.measurement_type == \
        TS.ChlorineMeasurementType.TOTAL_CHLORINE


def test_duck_typed_states_and_read_flow():
    flow, ref, _ = _pair("flow-magnetic")
    rand = (np.zeros(TF.N_NORMALS), np.full(TF.N_UNIFORMS, 0.9))
    ref._read_fn = lambda p, c, *a: JF.flow_read(
        p, c, *a, rand=tuple(jnp.asarray(x) for x in rand))
    got = flow.read_flow(6.5, 11.0,
                         rand=tuple(torch.from_numpy(x) for x in rand))
    _same_reading(got, ref.read_flow(6.5, 11.0))

    class NoFlow:
        pass

    with pytest.raises(AttributeError, match="flow_rate"):
        flow.read(NoFlow(), 12.0)

    class OnlyPH:
        pH = np.array([7.0, 7.1])

    ph = TS.pHSensor("p", zone_index=1, dtype=F64, device="cpu", seed=1)
    ph.calibrate(7.0, 0.0)
    assert math.isfinite(ph.read(OnlyPH(), 1900.0).value)   # 25 C assumed
    with pytest.raises(IndexError, match="out of bounds"):
        TS.pHSensor("q", zone_index=5, dtype=F64, device="cpu").read(
            OnlyPH(), 1.0)
    with pytest.raises(ValueError, match="non-empty"):
        TS.pHSensor("", dtype=F64, device="cpu")
    assert TS.BaseSensor is TS.wrappers._SensorShell


def test_seeded_sensors_repeat_and_differ():
    def run(seed):
        s = TS.TemperatureSensor("t", seed=seed, device="cpu")
        s.calibrate(20.0, 0.0)
        return [s.read(State(i), 100.0 + i).value for i in range(5)]

    assert run(11) == run(11)
    assert run(11) != run(12)
    assert run(None) != run(None)
    s = TS.TemperatureSensor("t", seed=11, device="cpu")
    s.calibrate(20.0, 0.0)
    first = [s.read(State(i), 100.0 + i).value for i in range(5)]
    s.reset(seed=11)
    s.calibrate(20.0, 0.0)
    assert [s.read(State(i), 100.0 + i).value for i in range(5)] == first
    assert s.read(State(0), 200.0).timestamp == 200.0


def test_a_sensor_wants_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for cls in (TS.pHSensor, TS.ChlorineSensor, TS.FlowSensor,
                TS.TemperatureSensor):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls("x")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.create_realistic_sensor_suite(TR.ReactorConfiguration())


# ---------------------------------------------------------------------------
# electrical stage
# ---------------------------------------------------------------------------

ELECTRICAL = dict(mains_frequency_hz=60.0, emi_pickup_amplitude=0.05,
                  emi_phase_rad=0.3, emi_burst_rate_per_hour=900.0,
                  emi_burst_amplitude=0.4, cable_length_m=80.0,
                  cable_capacitance_pf_per_m=110.0, source_impedance_ohm=1e8,
                  grounding_quality=0.4, ground_loop_amplitude=0.2,
                  ground_walk_tau_s=30.0, ground_walk_sigma=0.3)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batch3"])
def test_electrical_transform_matches_jax(batch):
    kw = dict(ELECTRICAL)
    if batch:
        kw["cable_length_m"] = np.array([0.0, 40.0, 80.0])
        kw["grounding_quality"] = np.array([1.0, 0.6, 0.2])
    jp = JE.make_electrical_params(**kw, dtype=jnp.float64)
    jp = jax_broadcast(jp, batch)
    tp = convert.electrical_params_from_numpy(tree_to_numpy(jp), dtype=F64,
                                              device="cpu")
    assert_tree_close(tp, jp)
    jc = JE.make_electrical_carry(jp, t0=0.5, dtype=jnp.float64)
    tc = TE.make_electrical_carry(tp, t0=0.5)
    assert_tree_close(tc, jc)
    assert_tree_close(convert.electrical_carry_from_numpy(
        tree_to_numpy(jc), dtype=F64, device="cpu"), jc)
    _close = np.testing.assert_allclose
    _close(TE.cable_time_constant(tp).numpy(),
           np.asarray(JE.cable_time_constant(jp)), rtol=1e-15, atol=0)
    rng = np.random.default_rng(23)
    t = 0.5
    for i in range(40):
        t += float(rng.uniform(0.2, 3.0))
        value = 7.0 + 0.3 * np.sin(i / 3.0) + np.zeros(batch)
        if i in (12, 13):
            value = value * np.nan              # a sensor fault window
        normals = rng.standard_normal(batch + (2,))
        uniforms = rng.random(batch + (1,))
        if i == 5:
            uniforms[...] = 0.0                 # force a burst
        jc, want = JE.electrical_transform(
            jp, jc, jnp.asarray(value), t,
            rand=(jnp.asarray(normals), jnp.asarray(uniforms)))
        tc, got = TE.electrical_transform(
            tp, tc, torch.from_numpy(np.array(value)), t,
            rand=(torch.from_numpy(normals), torch.from_numpy(uniforms)))
        _close(got.numpy(), np.asarray(want), rtol=0, atol=ATOL,
               equal_nan=True)
        # the port keeps ``last_t`` in the carry's shape; JAX stores the
        # scalar clock it was given
        assert_tree_close(tc, dataclasses.replace(
            jc, last_t=jnp.broadcast_to(jc.last_t, batch)), atol=ATOL)
    assert bool(tc.cable_initialized.all())


def jax_broadcast(params, batch):
    """Every leaf of a JAX dataclass broadcast to ``batch``."""
    return type(params)(**{
        f.name: jnp.broadcast_to(getattr(params, f.name), batch)
        for f in dataclasses.fields(params)})


def test_electrical_defaults_leave_the_signal_bit_for_bit():
    params = TE.make_electrical_params(dtype=F64, device="cpu")
    carry = TE.make_electrical_carry(params)
    generator = torch.Generator().manual_seed(1)
    for i in range(20):
        value = torch.tensor(7.0 + 0.01 * i, dtype=F64)
        carry, out = TE.electrical_transform(params, carry, value, 1.0 + i,
                                             generator=generator)
        assert torch.equal(out, value)


def test_attached_electrical_stage_corrupts_only_the_value():
    ep = TE.make_electrical_params(**ELECTRICAL, dtype=F64, device="cpu")
    plain = TS.TemperatureSensor("a", seed=9, dtype=F64, device="cpu")
    wired = TS.TemperatureSensor("b", seed=9, dtype=F64, device="cpu")
    wired.attach_electrical(ep, seed=4)
    carry = None
    rng = np.random.default_rng(2)
    for s in (plain, wired):
        s.calibrate(20.0, 0.0)
    for i in range(15):
        t = 100.0 + 1.3 * i
        erand = (torch.from_numpy(rng.standard_normal(2)),
                 torch.from_numpy(rng.random(1)))
        a = plain.read(State(i), t)
        b = wired.read(State(i), t, electrical_rand=erand)
        if carry is None:
            carry = TE.make_electrical_carry(ep, t0=t)
        carry, want = TE.electrical_transform(
            ep, carry, torch.tensor(a.value, dtype=F64), t, rand=erand)
        assert b.value == pytest.approx(float(want), abs=ATOL)
        assert (b.raw_value, b.noise, b.drift, b.status, b.fault) == \
            (a.raw_value, a.noise, a.drift, a.status, a.fault)
    assert any(abs(x.value - y.value) > 1e-3 for x, y in
               zip(plain.reading_history, wired.reading_history))
    drawn = TS.TemperatureSensor("c", seed=9, dtype=F64, device="cpu")
    drawn.attach_electrical(ep, seed=4)
    drawn.calibrate(20.0, 0.0)
    again = TS.TemperatureSensor("d", seed=9, dtype=F64, device="cpu")
    again.attach_electrical(ep, seed=4)
    again.calibrate(20.0, 0.0)
    assert [drawn.read(State(i), 100.0 + i).value for i in range(5)] == \
        [again.read(State(i), 100.0 + i).value for i in range(5)]


# ---------------------------------------------------------------------------
# suite factory, validation suites, demo
# ---------------------------------------------------------------------------

SUITE_PARAMS = {"pH_inlet": TP.PHSensorParams, "pH_outlet": TP.PHSensorParams,
                "chlorine_inlet": TC.ChlorineSensorParams,
                "chlorine_outlet": TC.ChlorineSensorParams,
                "flow_main": TF.FlowSensorParams,
                "temp_inlet": TT.TemperatureSensorParams,
                "temp_outlet": TT.TemperatureSensorParams}


def test_suite_factory_builds_the_canonical_seven_with_jax_parameters():
    config = dict(n_zones=5, flow_rate=7.5)
    port = TS.create_realistic_sensor_suite(
        TR.ReactorConfiguration(**config), seed=42, dtype=F64, device="cpu")
    ref = JS.create_realistic_sensor_suite(JR.ReactorConfiguration(**config),
                                           seed=42)
    assert list(port) == list(ref) == list(SUITE_PARAMS)
    for name, sensor in port.items():
        assert type(sensor).__name__ == type(ref[name]).__name__
        assert sensor.name == name
        carried = convert.sensor_params_from_numpy(
            SUITE_PARAMS[name], tree_to_numpy(ref[name].params), dtype=F64,
            device="cpu")
        assert_tree_close(sensor.params, carried)
        assert_tree_close(sensor.carry, ref[name].carry)
        assert sensor.calibration_validity_hours == \
            ref[name].calibration_validity_hours
    assert port["flow_main"].full_scale == 15.0
    assert port["pH_inlet"].carry.base.line_values is not \
        port["temp_inlet"].carry.base.line_values
    assert TS._suite_seed(42, 3) == JS._suite_seed(42, 3) == 42003
    assert TS._suite_seed(None, 3) is None
    single = TS.create_realistic_sensor_suite(
        TR.ReactorConfiguration(**config), seed=42, device="cpu")
    assert single["pH_outlet"].carry.base.current_value.dtype == \
        torch.float32


@pytest.mark.parametrize("flag,instrument", [
    ("enable_nitrogen", "ammonia_outlet"), ("enable_gas", "oxygen_outlet"),
    ("enable_particles", "turbidity_outlet")])
def test_suite_factory_builds_the_extension_instruments(flag, instrument):
    """Each instrumented axis adds its instrument to the suite, built as
    the JAX package builds it."""
    port = TS.create_realistic_sensor_suite(
        TR.ReactorConfiguration(**{flag: True}), seed=42, dtype=F64,
        device="cpu")
    ref = JS.create_realistic_sensor_suite(
        JR.ReactorConfiguration(**{flag: True}), seed=42)
    assert list(port) == list(ref) and len(port) == 8
    sensor = port[instrument]
    assert type(sensor).__name__ == type(ref[instrument]).__name__
    assert_tree_close(sensor.params, ref[instrument].params)
    assert_tree_close(sensor.carry, ref[instrument].carry)
    assert sensor.calibration_validity_hours == \
        ref[instrument].calibration_validity_hours
    full = TS.create_realistic_sensor_suite(
        TR.ReactorConfiguration(enable_nitrogen=True, enable_gas=True,
                                enable_particles=True), device="cpu")
    assert len(full) == 10


def test_enum_style_aliases_match_jax():
    for name in ("ChlorineSensorType", "ChlorineMeasurementType",
                 "FlowSensorType", "TemperatureSensorType",
                 "OxygenSensorType"):
        ours, theirs = getattr(TS, name), getattr(JS, name)
        public = {k: v for k, v in vars(theirs).items()
                  if not k.startswith("_")}
        assert public and {k: getattr(ours, k) for k in public} == public


VALIDATIONS = {"pH": TS.validate_pH_sensor,
               "chlorine": TS.validate_chlorine_sensor,
               "flow": TS.validate_flow_sensor,
               "temperature": TS.validate_temperature_sensor}


@pytest.mark.parametrize("suite", sorted(VALIDATIONS))
def test_sensor_validation_suite_runs_on_the_cpu(suite, capsys):
    VALIDATIONS[suite]("cpu")
    assert "validation passed" in capsys.readouterr().out


def test_run_all_sensor_validations(capsys):
    """The four base suites, then the ammonia, oxygen and turbidity
    suites."""
    TS.run_all_sensor_validations("cpu")
    out = capsys.readouterr().out
    assert out.count("validation passed") == 4
    assert out.count("validation: ALL PASS") == 3
    assert "FAIL:" not in out and "ALL SENSOR VALIDATIONS PASSED" in out


def test_demo_runs_on_the_cpu(capsys):
    demo_main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "7 instruments on a 5-zone dosed reactor (cpu)" in out
    assert out.count("status=") == 7 and "Demo complete." in out
    rows = [line.split() for line in out.splitlines()
            if line.strip().startswith(("30 ", "180 "))]
    assert len(rows) == 2 and all(len(r) == 8 for r in rows)
    assert all(math.isfinite(float(x)) for r in rows for x in r)
