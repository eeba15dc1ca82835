"""The port's serving plane (``python -m ics_wt_physicsengine_torch``)
against the JAX package's orchestrator, on the CPU.

- The orchestrator's helpers (validators, ``apply_boundary_conditions``,
  ``apply_actuator_dynamics``, ``build_chunk_schedule``,
  ``update_modbus_inputs``) give equal results on equal inputs: exact for
  the host arithmetic, equal register snapshots in the two packages'
  slaves.
- A headless run leaves reactor states in its checkpoint that agree with
  the JAX run's at ``PHYS`` = 2e-5, the float32 tolerance of the port's
  fused-plant tests: the port's ``IntegratedCSTR`` runs float32; the JAX
  one runs float64 here because the test session enables x64 (float32
  without it). Ten 30 s steps, too few for the float32 stratification
  switch to flip a zone.
- ``plant_serve_chunk`` on the CPU (B3's plain version), fed words with
  ``rng="bits"``, against the JAX ``plant_step`` loop fed the same draws
  (decoded with ``rand_from_words``): physics within 1e-5, readings within
  3.5e-5 (the B3 tolerance); fault codes equal on every recorded step, and
  status and fault on the last. Excluded, and checked to be absent: a
  power fault or warm-up on a sampled instrument, where the fused line
  keeps recording and the JAX ring does not (ROADMAP's deliberate
  divergences).
- Chunks of 16 + 16 steps give one chunk of 32 bit for bit; two chunks of
  one seed draw different noise.
- The live loop: ``--fused-sensors --serve-chunk 32`` answers a Modbus
  client, whose acid command lowers ``pH_outlet``. ``--fleet 2`` and
  ``--network`` serve headless (``fleet.py``; its own tests are
  ``tests/test_torch_fleet.py``).
- Two repairs of JAX-package defects: ``--serve-chunk`` under the default
  endless ``--duration`` (JAX ``__main__.py:1366-1367``, ``OverflowError``
  at the first chunk) runs until stopped; the object path's maintenance of
  an extension instrument (JAX ``__main__.py:1340``, ``KeyError`` on
  ``refs[name[:2]]``) completes.

Every run of ``main`` passes ``--rtf 0``; servers bind port 0; socket
waits are bounded."""

import dataclasses
import math
import socket
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ics_wt_physicsengine_tpu.__main__ as JO
from ics_wt_physicsengine_tpu import modbus as JMB
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL
from ics_wt_physicsengine_tpu.sensors import types as JTY

import ics_wt_physicsengine_torch.__main__ as TO
from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch import modbus as TMB
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models import plant as TPL
from ics_wt_physicsengine_torch.ops import fused_plant as TFP
from ics_wt_physicsengine_torch.ops import kernel_checks as K
from ics_wt_physicsengine_torch.sensors import types as TTY

from torch_port_util import assert_tree_close, to_numpy, tree_to_numpy

torch.set_num_threads(1)

PHYS = 2e-5       # headless run, float32 reactor states
CHUNK_PHYS = 1e-5     # serve chunk against the JAX loop: physics
CHUNK_READ = 3.5e-5   # and readings


# ---------------------------------------------------------------------------
# helpers of the orchestrator
# ---------------------------------------------------------------------------

ODD = [0, 1, 2.5, -3.0, 1e9, -1e9, float("nan"), float("inf"),
       float("-inf"), "7", None, True, [1.0], 0.05]


@pytest.mark.parametrize("name", ["validate_flow_rate",
                                  "validate_concentration",
                                  "validate_ambient_temperature",
                                  "validate_ph"])
def test_validators_equal(name):
    port, ref = getattr(TO, name), getattr(JO, name)
    for v in ODD:
        a, b = port(v), ref(v)
        assert a == b or (a != a and b != b), (name, v, a, b)
    assert TO._hpc_to_mgC(500.0) == JO._hpc_to_mgC(500.0)


def _commands(rng, extended):
    base = (float(rng.uniform(-1, 3)), float(rng.uniform(-1, 2)),
            float(rng.uniform(-1, 25)), float(rng.uniform(0, 1.2)),
            float(rng.uniform(0, 1200)), bool(rng.integers(2)),
            bool(rng.integers(2)), True)
    if not extended:
        return base
    u = [float(x) for x in rng.uniform(0, 5, 12)]
    return base + (u[0], u[1] / 50.0, (u[2], u[3], u[4] / 500.0),
                   (u[5], u[6]), (u[7], u[8] * 1e5), (u[9] / 5, u[10],
                                                      u[11] - 2.0))


@pytest.mark.parametrize("extended", [False, True])
def test_boundary_and_actuator_helpers_equal(extended):
    rng = np.random.default_rng(5 + extended)
    for _ in range(20):
        cmds = _commands(rng, extended)
        tb = TO.apply_boundary_conditions(TR.BoundaryConditions(), cmds)
        jb = JO.apply_boundary_conditions(JR.BoundaryConditions(), cmds)
        for f in dataclasses.fields(tb):
            assert getattr(tb, f.name) == getattr(jb, f.name), f.name
        tau, dt = float(rng.uniform(0, 120)), float(rng.uniform(0.5, 30))
        ta = TO.apply_actuator_dynamics(TR.BoundaryConditions(), tb, dt, tau)
        ja = JO.apply_actuator_dynamics(JR.BoundaryConditions(), jb, dt, tau)
        for f in TO._ACTUATOR_FIELDS:
            assert getattr(ta, f) == getattr(ja, f)


@pytest.mark.parametrize("tau", [0.0, 45.0])
def test_chunk_schedule_equal(tau):
    applied = dict(acid_flow_rate=0.3, chlorine_flow_rate=0.1,
                   inlet_flow_rate=6.0)
    commanded = dict(acid_flow_rate=1.2, chlorine_flow_rate=0.0,
                     inlet_flow_rate=4.0, inlet_pH=7.1)
    ts, te = TO.build_chunk_schedule(
        TR.BoundaryConditions(**applied), TR.BoundaryConditions(**commanded),
        50, 2.0, tau, device="cpu")
    js, je = JO.build_chunk_schedule(
        JR.BoundaryConditions(**applied), JR.BoundaryConditions(**commanded),
        50, 2.0, tau)
    for f in TO._ACTUATOR_FIELDS:
        a = getattr(ts, f)
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(js, f)))
        assert getattr(te, f) == getattr(je, f)
    assert ts.inlet_pH == js.inlet_pH == 7.1


def _readings(types, rng, names):
    return {n: types.SensorReading(
        timestamp=10.0, value=float(v), raw_value=float(v), noise=0.0,
        drift=0.0, status=list(types.SensorStatus)[int(s)],
        uncertainty=0.01, fault=list(types.SensorFault)[int(f)])
        for n, v, s, f in zip(names, rng.uniform(0, 10, len(names)),
                              rng.integers(0, 3, len(names)),
                              rng.integers(0, 3, len(names)))}


def test_update_modbus_inputs_leaves_equal_snapshots():
    """All six extension axes on: every input register and discrete input
    the update writes, from the same readings and reactor state."""
    flags = dict(extended_nitrogen=True, extended_gas=True,
                 extended_particles=True, extended_disinfection=True,
                 extended_biofilm=True, extended_phase=True)
    cfg = dict(n_zones=5, enable_nitrogen=True, enable_gas=True,
               enable_particles=True, enable_disinfection=True,
               initial_pathogens=1e4, enable_biofilm=True,
               initial_bacteria=1e-3, enable_phase=True, temperature=1.0)
    jstate = JR.make_initial_state(JR.ReactorConfiguration(**cfg),
                                   dtype=jnp.float32)
    tstate = convert.state_from_numpy(tree_to_numpy(jstate),
                                      dtype=torch.float32, device="cpu")
    names = ["pH_inlet", "pH_outlet", "chlorine_inlet", "chlorine_outlet",
             "flow_main", "temp_inlet", "temp_outlet", "ammonia_outlet"]
    slaves = {}
    for tag, pkg, types, state, fn in (
            ("torch", TMB, TTY, tstate, TO.update_modbus_inputs),
            ("jax", JMB, JTY, jstate, JO.update_modbus_inputs)):
        slave = pkg.ModbusSlave(pkg.ModbusRegisterMap(**flags),
                                pkg.ModbusServerConfig(host="127.0.0.1",
                                                       port=0))
        slave.start(blocking=False)
        readings = _readings(types, np.random.default_rng(8), names)
        assert fn(slave, readings, state, 1234.0)
        slaves[tag] = slave
    try:
        a = slaves["torch"].get_all_input_registers()
        b = slaves["jax"].get_all_input_registers()
        assert a.keys() == b.keys() and len(a) > 30
        for name in a:
            assert a[name] == b[name] or (a[name] != a[name]
                                          and b[name] != b[name]), name
        for reg in slaves["torch"].register_map.discrete_inputs:
            assert slaves["torch"].read_discrete_input(reg.name) \
                == slaves["jax"].read_discrete_input(reg.name)
        assert a["simulation_time"] == 1234.0
    finally:
        for s in slaves.values():
            s.stop()


def test_read_modbus_commands_equal():
    """The validated command tuple read back from the two packages'
    slaves after the same writes, out-of-range ones included."""
    flags = dict(extended_nitrogen=True, extended_gas=True,
                 extended_particles=True, extended_disinfection=True,
                 extended_biofilm=True, extended_phase=True)
    writes = dict(acid_flow_rate=3.5, chlorine_flow_rate=0.4,
                  inlet_flow_rate=-2.0, acid_concentration=0.2,
                  chlorine_concentration=2000.0, inlet_ammonia=75.0,
                  aeration_kla=0.01, coagulant_dose=12.0,
                  filter_flow_rate=80.0, sludge_blowdown=0.002,
                  uv_intensity=5.0, inlet_toc=3.0, inlet_bdoc=0.5,
                  inlet_hpc=2.0e7, ambient_humidity=0.4, wind_speed=3.0,
                  ambient_temperature=-75.0)
    got = {}
    for tag, pkg, fn in (("torch", TMB, TO.read_modbus_commands),
                         ("jax", JMB, JO.read_modbus_commands)):
        slave = pkg.ModbusSlave(pkg.ModbusRegisterMap(**flags),
                                pkg.ModbusServerConfig(host="127.0.0.1",
                                                       port=0))
        slave.start(blocking=False)
        try:
            for name, v in writes.items():
                slave.write_holding_register(name, v)
            slave.write_coil("acid_pump_enable", False)
            slave.write_coil("simulation_running", True)
            got[tag] = fn(slave)
        finally:
            slave.stop()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 2.0 and got["torch"][5] is False
    assert TO.read_modbus_commands(None) == JO.read_modbus_commands(None)


def test_readings_from_outputs_equal():
    """One plant step of each package on the same plant and draws, its
    outputs converted to SensorReading objects."""
    jcfg = JR.ReactorConfiguration(n_zones=5)
    jp, js = JPL.make_plant(jcfg, seed=1, dtype=jnp.float32)
    tp = convert.plant_params_from_numpy(tree_to_numpy(jp),
                                         dtype=torch.float32, device="cpu")
    ts = convert.plant_state_from_numpy(tree_to_numpy(js),
                                        dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    rand = {name: (rng.standard_normal(n).astype(np.float32),
                   rng.random(u).astype(np.float32))
            for name, n, u in JPL._RAND_LAYOUT}
    _, jout = JPL.plant_step(jp, js, JR.BoundaryConditions(), 1.0, 2,
                             rand={k: tuple(map(jnp.asarray, v))
                                   for k, v in rand.items()})
    _, tout = TPL.plant_step(tp, ts, TR.BoundaryConditions(), 1.0, 2,
                             rand={k: tuple(map(torch.from_numpy, v))
                                   for k, v in rand.items()})
    a, b = TO._readings_from_outputs(tout), JO._readings_from_outputs(jout)
    assert list(a) == list(b)
    for name in a:
        for f in dataclasses.fields(a[name]):
            x, y = getattr(a[name], f.name), getattr(b[name], f.name)
            if isinstance(x, float):
                np.testing.assert_allclose(x, y, rtol=0, atol=CHUNK_READ,
                                           equal_nan=True)
            else:
                assert x.name == y.name, (name, f.name)


class _Broken:
    current_value = float("nan")

    def read(self, state, current_time=None):
        raise RuntimeError("open transmitter loop")


def test_sensor_suite_helpers_equal():
    """``initialize_sensors`` builds and calibrates the same suite, and
    ``read_all_sensors`` synthesizes the same failed reading for a
    sensor that raises."""
    cfg = dict(n_zones=5, enable_nitrogen=True, initial_ammonia=1.0)
    tsens = TO.initialize_sensors(TR.ReactorConfiguration(**cfg), 0.0,
                                  seed=3, device="cpu")
    jsens = JO.initialize_sensors(JR.ReactorConfiguration(**cfg), 0.0,
                                  seed=3)
    assert list(tsens) == list(jsens)
    for name in tsens:
        assert [r.reference_value for r in tsens[name].calibration_history] \
            == [r.reference_value for r in jsens[name].calibration_history]
        assert len(tsens[name].calibration_history) == 1
    state = TR.make_initial_state(TR.ReactorConfiguration(**cfg),
                                  device="cpu")
    a = TO.read_all_sensors({"x": _Broken()}, state, 5.0)["x"]
    b = JO.read_all_sensors({"x": _Broken()}, None, 5.0)["x"]
    assert (a.status.name, a.fault.name, a.timestamp) \
        == (b.status.name, b.fault.name, b.timestamp) \
        == ("FAILED", "OPEN_CIRCUIT", 5.0)
    readings = TO.read_all_sensors(tsens, state, 10.0)
    assert list(readings) == list(tsens)


# ---------------------------------------------------------------------------
# headless run against the JAX orchestrator
# ---------------------------------------------------------------------------

def test_headless_run_matches_the_jax_run(tmp_path):
    argv = ["--no-modbus", "--zones", "5", "--dt", "30", "--duration", "300",
            "--rtf", "0", "--seed", "7", "--checkpoint-file"]
    TO.running = JO.running = True
    assert TO.main(["--device", "cpu", *argv,
                    str(tmp_path / "port.npz")]) == 0
    assert JO.main([*argv, str(tmp_path / "jax.npz")]) == 0
    cfg = dict(volume=1000.0, n_zones=5, flow_rate=5.0, initial_pH=7.2,
               initial_chlorine=2.0, temperature=20.0)
    from ics_wt_physicsengine_torch import utils as TU
    from ics_wt_physicsengine_torch.sensors import (
        create_realistic_sensor_suite as t_suite)
    from ics_wt_physicsengine_tpu import utils as JU
    from ics_wt_physicsengine_tpu.core import IntegratedCSTR as JCSTR
    from ics_wt_physicsengine_tpu.sensors import (
        create_realistic_sensor_suite as j_suite)

    treactor = TR.IntegratedCSTR(TR.ReactorConfiguration(**cfg),
                                 device="cpu")
    TU.load_simulation(str(tmp_path / "port.npz"), treactor,
                       sensors=t_suite(treactor.config, seed=7,
                                       device="cpu"))
    jreactor = JCSTR(JR.ReactorConfiguration(**cfg))
    JU.load_simulation(str(tmp_path / "jax.npz"), jreactor,
                       sensors=j_suite(jreactor.config, seed=7))
    meta = TU.load_metadata(str(tmp_path / "port.npz"))
    assert meta == JU.load_metadata(str(tmp_path / "jax.npz"))
    assert meta["sim_time"] == 300.0
    assert float(treactor.state.time) == float(jreactor.state.time) == 300.0
    for f in ("pH", "chlorine", "temperature"):
        a = to_numpy(getattr(treactor.state, f))
        b = np.asarray(getattr(jreactor.state, f))
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=PHYS, err_msg=f)
    assert float(treactor.state.chlorine[-1]) < 2.0 - 1e-3   # it moved


# ---------------------------------------------------------------------------
# the serving chunk against the JAX plant_step loop
# ---------------------------------------------------------------------------

N_CHUNK, REC = 32, 4


@pytest.fixture(scope="module")
def chunk_vs_jax():
    """One 32-step chunk of a 5-zone float32 plant: the port's
    ``plant_serve_chunk`` on injected words (forced faults included:
    ``kernel_checks.plant_words``) and the JAX loop on the same draws."""
    jcfg = JR.ReactorConfiguration(n_zones=5,
                                   enable_thermal_stratification=True)
    jp, js = JPL.make_plant(jcfg, seed=1, dtype=jnp.float32, warmed_up=True)
    tp = convert.plant_params_from_numpy(tree_to_numpy(jp),
                                         dtype=torch.float32, device="cpu")
    ts = convert.plant_state_from_numpy(tree_to_numpy(js),
                                        dtype=torch.float32, device="cpu")
    substeps = JR.default_substeps(jcfg, 1.0)
    sched, _ = TO.build_chunk_schedule(
        TR.BoundaryConditions(), TR.BoundaryConditions(acid_flow_rate=0.4,
                                                       chlorine_flow_rate=0.1),
        N_CHUNK, 1.0, 20.0, device="cpu")
    words = K.plant_words(N_CHUNK, 1, "cpu", seed=4)
    chunk = TPL.plant_serve_chunk(tp, ts, sched, dt=1.0, substeps=substeps,
                                  record_every=REC, rng="bits", bits=words)

    step = jax.jit(lambda p, s, bc, rand: JPL.plant_step(
        p, s, bc, 1.0, substeps, rand=rand))
    outs = []
    for g in range(N_CHUNK):
        bc = JR.BoundaryConditions(**{
            f.name: (float(getattr(sched, f.name)[g])
                     if f.name in TO._ACTUATOR_FIELDS
                     else getattr(sched, f.name))
            for f in dataclasses.fields(sched)})
        rand = {}
        for name, attr, kind in TFP.SENSORS:
            w0 = TFP._WORD_OFFSET[attr]
            n, u = TFP.rand_from_words(
                words[g, w0:w0 + TFP.words_per_sensor(kind), 0],
                *TFP._RAND[kind])
            rand[name] = (jnp.asarray(n.numpy()), jnp.asarray(u.numpy()))
        js, out = step(jp, js, bc, rand)
        outs.append(out)
    return dict(chunk=chunk, jfinal=js, jout=outs)


def test_serve_chunk_matches_the_jax_loop(chunk_vs_jax):
    chunk, jfinal, jout = (chunk_vs_jax[k] for k in ("chunk", "jfinal",
                                                     "jout"))
    names = [name for name, _, _ in TFP.SENSORS]
    assert chunk.names == tuple(names)
    assert chunk.values.shape == chunk.faults.shape == (N_CHUNK // REC, 7)
    # excluded case (the fused line records through power faults and
    # warm-up; the JAX ring does not): absent from this chunk
    line_names = ("pH_inlet", "pH_outlet", "temp_inlet", "temp_outlet")
    power = {JTY.FAULT_CODE[JTY.SensorFault.POWER_LOW],
             JTY.FAULT_CODE[JTY.SensorFault.POWER_HIGH]}
    warming = JTY.STATUS_CODE[JTY.SensorStatus.WARMING_UP]
    for o in jout:
        for n in line_names:
            assert int(o[n].fault) not in power
            assert int(o[n].status) != warming
    # the forced faults are in the record
    assert {int(f) for f in chunk.faults.flatten()} > {0}
    for k, name in enumerate(names):
        want_v = np.array([float(o[name].value) for o in jout])[REC - 1::REC]
        want_f = np.array([int(o[name].fault) for o in jout])[REC - 1::REC]
        np.testing.assert_allclose(to_numpy(chunk.values[:, k]), want_v,
                                   rtol=0, atol=CHUNK_READ, equal_nan=True,
                                   err_msg=name)
        np.testing.assert_array_equal(to_numpy(chunk.faults[:, k]), want_f)
        value, status, fault = chunk.last[name]
        last = jout[-1][name]
        np.testing.assert_allclose(float(value), float(last.value), rtol=0,
                                   atol=CHUNK_READ, equal_nan=True)
        assert int(status) == int(last.status), name
        assert int(fault) == int(last.fault), name
    r, jr = chunk.plant.reactor, jfinal.reactor
    for f in ("pH", "chlorine", "temperature"):
        np.testing.assert_allclose(to_numpy(getattr(r, f)),
                                   np.asarray(getattr(jr, f)), rtol=0,
                                   atol=CHUNK_PHYS, err_msg=f)
    assert float(r.time) == float(jr.time) == float(N_CHUNK)


def test_serve_chunks_are_invariant_and_draw_new_noise():
    dev = torch.device("cpu")
    assert K.serve_chunks_invariant(dev)
    # two chunks shorter than the sample lines' 31-step history in a row:
    # each joins its ring with the one before it
    assert K.serve_chunks_invariant(dev, sizes=(4, 4, 24))
    params, plant = K.plant_case(20, 1, torch.float32, dev)
    substeps, _ = K.plant_plan(20, "rk4")
    sched = K.bench_schedule(16)
    a, b = (TPL.plant_serve_chunk(params, plant, sched, dt=1.0,
                                  substeps=substeps, seed=11, step0=s0)
            for s0 in (0, 16))
    finite = ~torch.isnan(a.values) & ~torch.isnan(b.values)
    assert bool(finite.any())
    assert not torch.equal(a.values[finite], b.values[finite])


def test_serve_chunk_routes_by_what_the_plant_shows(monkeypatch):
    """A CPU plant takes B3's plain version; a plant with an extension axis
    takes the plant_step loop (ten instruments); injected words need the
    kernel's configuration."""
    calls = []
    real = TFP.plant_plain
    monkeypatch.setattr(TFP, "plant_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    params, plant = K.plant_case(5, 1, torch.float32, "cpu")
    sched = K.bench_schedule(6)
    out = TPL.plant_serve_chunk(params, plant, sched, dt=1.0, substeps=2,
                                record_every=4)
    assert calls == [1] and out.values.shape == (1, 7)
    assert TFP.LAUNCHES["plant_rollout_fused"] == 0
    cfg = TR.ReactorConfiguration(n_zones=3, enable_nitrogen=True)
    xp, xs = TPL.make_plant(cfg, device="cpu")
    out = TPL.plant_serve_chunk(xp, xs, sched, dt=1.0, substeps=2,
                                record_every=3, seed=2, step0=5)
    assert calls == [1] and "ammonia_outlet" in out.names
    assert out.values.shape == (2, 8) and set(out.last) == set(out.names)
    with pytest.raises(ValueError, match="injected"):
        TPL.plant_serve_chunk(xp, xs, sched, dt=1.0, substeps=2, rng="bits",
                              bits=K.plant_words(6, 1, "cpu"))
    assert TPL.config5_hil_cli_args(5021) == JPL.config5_hil_cli_args(5021)


# ---------------------------------------------------------------------------
# the live loop, and what is not ported yet
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_live_serve_chunk_answers_a_modbus_client():
    """Mirrors the JAX ``test_serve_chunk_closed_loop_command``: an acid
    command written by the client is picked up at the next exchange and
    lowers pH_outlet (30 s steps, 32 a chunk, so a few chunks carry the
    acid front through the five zones)."""
    port = _free_port()
    TO.running = True
    thread = threading.Thread(target=TO.main, args=([
        "--device", "cpu", "--port", str(port), "--host", "127.0.0.1",
        "--dt", "30", "--duration", "1e7", "--rtf", "0", "--seed", "7",
        "--fused-sensors", "--serve-chunk", "32"],), daemon=True)
    thread.start()
    client = None
    try:
        deadline = time.time() + 30
        while client is None and time.time() < deadline:
            try:
                client = TMB.ModbusTcpClient("127.0.0.1", port,
                                             timeout=5).connect()
            except OSError:
                time.sleep(0.1)
        assert client is not None, "the Modbus server did not start"

        def ph_outlet(until):
            while time.time() < until:      # a latched fault reads 0
                v = client.read_float32(4)
                if v > 0.0:
                    return v
                time.sleep(0.05)
            return math.nan

        def wait_sim(target, until):
            while time.time() < until:
                if client.read_float32(100) >= target:
                    return True
                time.sleep(0.05)
            return False

        assert wait_sim(960.0, time.time() + 30)
        ph_before = ph_outlet(time.time() + 30)
        t0 = client.read_float32(100)
        client.write_float32(0, 1.5)                # acid_flow_rate
        assert wait_sim(t0 + 4000.0, time.time() + 30)
        ph_after = ph_outlet(time.time() + 30)
        assert ph_after < ph_before - 0.4, (ph_before, ph_after)
        client.write_float32(0, 0.0)
    finally:
        if client is not None:
            client.close()
        TO.running = False
        thread.join(timeout=30)
    assert not thread.is_alive()


TRAIN3 = str(Path(__file__).resolve().parents[1] / "examples"
             / "train3.json")


@pytest.mark.parametrize("flag", [["--fleet", "2"],
                                  ["--fleet", "2", "--serve-chunk", "4"],
                                  ["--network", TRAIN3],
                                  ["--network", TRAIN3, "--serve-chunk", "4"]],
                         ids=["fleet", "fleet-chunk", "network",
                              "network-chunk"])
def test_fleet_and_network_serve_headless(flag, tmp_path):
    """``--fleet 2`` and ``--network`` run a few steps or chunks headless
    and checkpoint the whole fleet."""
    from ics_wt_physicsengine_torch.utils import load_metadata

    path = str(tmp_path / "fleet.npz")
    TO.running = True
    assert TO.main(["--device", "cpu", "--no-modbus", "--rtf", "0",
                    "--zones", "3", "--duration", "12", "--checkpoint-file",
                    path, *flag]) == 0
    meta = load_metadata(path)
    assert meta["sim_time"] == 12.0 and meta["step_count"] == 12
    assert meta["fleet"] == (3 if "--network" in flag else 2)
    assert meta["network"] == ("--network" in flag)


def _wait_for(path, seconds):
    deadline = time.time() + seconds
    while time.time() < deadline and not path.exists():
        time.sleep(0.05)
    return path.exists()


def test_serve_chunk_runs_under_the_endless_default_duration(tmp_path):
    """No --duration: the chunk length is never clamped by int(round(inf))
    (the JAX orchestrator raises OverflowError at its first chunk); the
    loop runs until stopped and its clock advances by whole chunks."""
    from ics_wt_physicsengine_torch.utils import load_metadata

    path = tmp_path / "endless.npz"
    TO.running = True
    thread = threading.Thread(target=TO.main, args=([
        "--device", "cpu", "--no-modbus", "--rtf", "0", "--zones", "3",
        "--fused-sensors", "--serve-chunk", "8", "--checkpoint-file",
        str(path), "--checkpoint-hours", "0.01"],), daemon=True)
    thread.start()
    try:
        assert _wait_for(path, 60), "no periodic checkpoint"
    finally:
        TO.running = False
        thread.join(timeout=30)
    assert not thread.is_alive()
    meta = load_metadata(str(path))
    assert meta["sim_time"] >= 36.0 and meta["sim_time"] % 8 == 0


def test_object_path_maintains_an_extension_instrument(tmp_path, caplog):
    """The object path's maintenance with the nitrogen axis on: the ammonia
    instrument has no calibration reference, and the JAX orchestrator's
    ``refs[name[:2]]`` raises KeyError there, ending its loop; the port's
    revives it and keeps its commissioning calibration, twice in 80 s."""
    from ics_wt_physicsengine_torch.utils import load_metadata

    path = str(tmp_path / "maint.npz")
    TO.running = True
    with caplog.at_level("INFO"):
        assert TO.main(["--device", "cpu", "--no-modbus", "--rtf", "0",
                        "--zones", "3", "--enable-nitrogen", "--recal-hours",
                        "0.01", "--duration", "80", "--checkpoint-file",
                        path]) == 0
    text = caplog.text
    assert text.count("sensor maintenance/recalibration done") == 2
    assert "Simulation error" not in text
    assert load_metadata(path)["sim_time"] == 80.0


@pytest.mark.parametrize("chunk", ["1", "8"])
def test_a_failed_step_or_chunk_exits_non_zero(tmp_path, monkeypatch, chunk):
    """A step or chunk that raises (a kernel launch that fails on the card)
    ends the run with exit code 1, after the checkpoint is written; the JAX
    orchestrator breaks out of its loop and returns 0."""
    from ics_wt_physicsengine_torch.models import plant as PL

    def fail(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(PL, "plant_serve_chunk" if chunk == "8"
                        else "plant_step", fail)
    path = tmp_path / "failed.npz"
    TO.running = True
    with pytest.raises(SystemExit) as exc:
        TO.main(["--device", "cpu", "--no-modbus", "--rtf", "0", "--zones",
                 "3", "--fused-sensors", "--serve-chunk", chunk,
                 "--duration", "16", "--checkpoint-file", str(path)])
    assert exc.value.code == 1
    assert isinstance(exc.value.__cause__, RuntimeError)
    assert path.exists()


def test_the_card_is_required_unless_the_cpu_is_asked_for(monkeypatch):
    """Without a card, the default device raises (the probe fails); it
    never serves on the CPU instead."""
    from ics_wt_physicsengine_torch.utils import backend_select as BS

    def no_card(*a, **kw):
        return BS.ProbeResult(False, None, 0, "no CUDA device")

    monkeypatch.setattr(BS, "probe_default_backend", no_card)
    with pytest.raises(RuntimeError, match="no working CUDA device"):
        TO.main(["--no-modbus", "--rtf", "0", "--duration", "1"])
