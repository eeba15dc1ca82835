"""The port's fleet serving (``ics_wt_physicsengine_torch/fleet.py``,
``python -m ics_wt_physicsengine_torch --fleet N`` / ``--network``) against
the JAX package's, on the CPU.

- ``_stack_boundaries`` and ``_stack_boundary_schedule`` equal JAX's
  exactly.
- The masked per-tick step against the JAX masked step (JAX
  fleet.py:192-207, the same ``plant_step_batched`` plus ``jnp.where``
  through ``jax.jit``), and the masked chunk (kernel B3's plain version,
  injected words) against the JAX masked loop fed the same draws (decoded
  with ``rand_from_words``), with one lane paused and a lane on a lagging
  clock. Tolerances as the serving chunk's: physics ``PHYS`` 1e-5,
  readings ``READ`` 3.5e-5 in float32, fault codes equal; the paused lane
  is bit-equal to its carry before.
- The network step and chunk against JAX's ``_step_masked_network`` (JAX
  fleet.py:209-237, rebuilt from ``core/network.py``'s blend and ring) on
  ``examples/train3.json``, float64, atol = rtol = 1e-10 (the tolerance of
  ``tests/test_torch_network.py``).
- Kernel B3's ``plant0``, per-lane clocks and per-lane schedules: a shard of
  lanes with its ``plant0`` equals those lanes of the whole launch bit for
  bit.
- The live loop: the JAX package's Modbus client against the port's fleet
  units (one unit's acid dose, one unit's pause and resume), and the port's
  client against the JAX fleet's units; checkpoints (the step count and
  generator resume bit for bit, ``--checkpoint-resize`` 2 -> 3, the
  network ring, the mode check); the endless ``--duration`` repair; a
  SIGTERM stopping ``python -m``.

Every run of ``main`` passes ``--rtf 0``; servers bind free ports; socket
waits are bounded."""

import dataclasses
import json
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ics_wt_physicsengine_tpu.__main__ as JO
from ics_wt_physicsengine_tpu import fleet as JF
from ics_wt_physicsengine_tpu import modbus as JMB
from ics_wt_physicsengine_tpu.core import network as JN
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL
from ics_wt_physicsengine_tpu.sensors import types as JTY

import ics_wt_physicsengine_torch.__main__ as TO
from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch import fleet as TF
from ics_wt_physicsengine_torch import modbus as TMB
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models import plant as TPL
from ics_wt_physicsengine_torch.ops import fused_plant as TFP
from ics_wt_physicsengine_torch.ops import kernel_checks as K
from ics_wt_physicsengine_torch.utils import checkpoint as TCK

from torch_port_util import to_numpy, tree_to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRAIN3 = str(ROOT / "examples" / "train3.json")
PHYS = {torch.float32: 1e-5, torch.float64: 1e-10}
READ = {torch.float32: 3.5e-5, torch.float64: 1e-10}
NET_TOL = 1e-10
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
N, Z, DT = 3, 5, 1.0


def _fleet(dtype, n=N, seed=2):
    """A JAX fleet batch and its port copy."""
    cfg = JR.ReactorConfiguration(n_zones=Z,
                                  enable_thermal_stratification=True)
    jp, js = JPL.make_plant_batch(cfg, n, seed=seed, dtype=JDT[dtype],
                                  warmed_up=True)
    tp = convert.plant_params_from_numpy(tree_to_numpy(jp), dtype=dtype,
                                         device="cpu")
    ts = convert.plant_state_from_numpy(tree_to_numpy(js), dtype=dtype,
                                        device="cpu")
    return cfg, jp, js, tp, ts


def _units(pkg, n):
    """Per-unit boundaries that differ between lanes."""
    return [pkg.BoundaryConditions(
        inlet_flow_rate=5.0 + i, inlet_pH=7.5, acid_flow_rate=0.1 * i,
        acid_concentration=0.1, chlorine_flow_rate=0.05 * (n - i),
        ambient_temperature=15.0, heat_loss_coefficient=50.0)
        for i in range(n)]


def _rand(rng, n, dtype):
    """The same draws for both packages: ``{name: (normals, uniforms)}``."""
    host = {name: (rng.standard_normal((n, a)), rng.random((n, b)))
            for name, a, b in JPL._RAND_LAYOUT}
    npd = np.float32 if dtype == torch.float32 else np.float64
    t = {k: tuple(torch.from_numpy(x.astype(npd)) for x in v)
         for k, v in host.items()}
    j = {k: tuple(jnp.asarray(x.astype(npd)) for x in v)
         for k, v in host.items()}
    return t, j


def _where(mask, new, old):
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)),
                               a, b), new, old)


def _jax_step(substeps):
    """JAX fleet.py:192-207 with the draws injected."""
    @jax.jit
    def step(p, s, bc, mask, rand):
        new, out = JPL.plant_step_batched(p, s, bc, DT, substeps,
                                          boundary_axes=0, rand=rand)
        return _where(mask, new, s), out
    return step


def _close(a, b, atol, msg=""):
    np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=0,
                               atol=atol, equal_nan=True, err_msg=msg)


def _lane_equal(new, old, lane):
    """Lane ``lane`` of two plant trees bit for bit."""
    lanes = slice(lane, lane + 1)
    d = K.plant_diff(_slice(new, lanes), _slice(old, lanes))
    assert d["max_abs_err"] == 0.0 and d["nan_equal"] and d["ints_equal"], d


# ---------------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stacked_boundaries_equal_jax(dtype):
    tb = TF._stack_boundaries(_units(TR, 4), dtype, "cpu")
    jb = JF._stack_boundaries(_units(JR, 4), JDT[dtype])
    for f in dataclasses.fields(tb):
        a, b = getattr(tb, f.name), getattr(jb, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
            assert a.dtype == dtype


@pytest.mark.parametrize("tau", [0.0, 45.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stacked_boundary_schedule_equals_jax(tau, dtype):
    applied, commanded = _units(TR, 3), [dataclasses.replace(
        b, acid_flow_rate=0.4 + 0.1 * i, inlet_flow_rate=3.0)
        for i, b in enumerate(_units(TR, 3))]
    ts, te = TF._stack_boundary_schedule(applied, commanded, 40, 2.0, tau,
                                         dtype, "cpu")
    js, je = JF._stack_boundary_schedule(
        [JR.BoundaryConditions(**dataclasses.asdict(b)) for b in applied],
        [JR.BoundaryConditions(**dataclasses.asdict(b)) for b in commanded],
        40, 2.0, tau, JDT[dtype])
    for f in dataclasses.fields(ts):
        a, b = getattr(ts, f.name), getattr(js, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert tuple(a.shape) == (40, 3)
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b),
                                          err_msg=f.name)
    for a, b in zip(te, je):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# the masked step and the masked chunk against the JAX masked loop
# ---------------------------------------------------------------------------

N_CHUNK, REC = 24, 4


@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["f32", "f64"])
def masked_vs_jax(request):
    """Two masked per-tick steps with lane 1 paused, then one chunk with
    lane 2 paused (lane 1 now on a lagging clock), in both packages on the
    same draws."""
    dtype = request.param
    cfg, jp, js, tp, ts = _fleet(dtype)
    substeps = JR.default_substeps(cfg, DT)
    rng = np.random.default_rng(9)
    jstep = _jax_step(substeps)
    tbc = TF._stack_boundaries(_units(TR, N), dtype, "cpu")
    jbc = JF._stack_boundaries(_units(JR, N), JDT[dtype])
    ticks = []
    tick_mask = np.array([True, False, True])
    for _ in range(2):
        trand, jrand = _rand(rng, N, dtype)
        before = ts
        ts, tout = TF.step_masked(tp, ts, tbc, torch.from_numpy(tick_mask),
                                  dt=DT, substeps=substeps, rand=trand)
        js, jout = jstep(jp, js, jbc, jnp.asarray(tick_mask), jrand)
        ticks.append((before, ts, tout, js, jout))

    mask = np.array([True, True, False])
    applied, commanded = _units(TR, N), [dataclasses.replace(
        b, acid_flow_rate=0.3 * i) for i, b in enumerate(_units(TR, N))]
    sched, _ = TF._stack_boundary_schedule(applied, commanded, N_CHUNK, DT,
                                           6.0, dtype, "cpu")
    words = K.plant_words(N_CHUNK, N, "cpu", seed=4)
    chunk = TF.serve_chunk_masked(tp, ts, sched, torch.from_numpy(mask),
                                  dt=DT, substeps=substeps,
                                  record_every=REC, rng="bits", bits=words)
    jouts = []
    for g in range(N_CHUNK):
        row = JR.BoundaryConditions(**{
            k: (None if v is None else jnp.asarray(to_numpy(v[g])))
            for k, v in sched.__dict__.items()})
        rand = {}
        for name, attr, kind in TFP.SENSORS:
            w0 = TFP._WORD_OFFSET[attr]
            nrm, unf = TFP.rand_from_words(
                words[g, w0:w0 + TFP.words_per_sensor(kind)],
                *TFP._RAND[kind], dtype=dtype)
            rand[name] = (jnp.asarray(nrm.numpy()), jnp.asarray(unf.numpy()))
        js, out = jstep(jp, js, row, jnp.asarray(mask), rand)
        jouts.append(out)
    return dict(dtype=dtype, ticks=ticks, tick_mask=tick_mask, mask=mask,
                before=ts, chunk=chunk, jfinal=js, jouts=jouts)


def test_masked_tick_matches_jax_and_freezes_the_paused_lane(masked_vs_jax):
    dtype = masked_vs_jax["dtype"]
    for before, ts, tout, js, jout in masked_vs_jax["ticks"]:
        for f in ("pH", "chlorine", "temperature", "time"):
            _close(getattr(ts.reactor, f), getattr(js.reactor, f),
                   PHYS[dtype], f)
        for name in tout:
            _close(tout[name].value, jout[name].value, READ[dtype], name)
            np.testing.assert_array_equal(to_numpy(tout[name].fault),
                                          np.asarray(jout[name].fault))
            np.testing.assert_array_equal(to_numpy(tout[name].status),
                                          np.asarray(jout[name].status))
        _lane_equal(ts, before, 1)
    assert to_numpy(ts.reactor.time).tolist() == [2.0, 0.0, 2.0]


def test_masked_chunk_matches_the_jax_masked_loop(masked_vs_jax):
    d = masked_vs_jax
    dtype, chunk, jouts, mask = d["dtype"], d["chunk"], d["jouts"], d["mask"]
    run = np.flatnonzero(mask)
    names = [name for name, _, _ in TFP.SENSORS]
    assert chunk.names == tuple(names)
    assert chunk.values.shape == (N_CHUNK // REC, 7, N)
    # the fused line's documented differences (it records through a power
    # fault or warm-up, the JAX ring does not): absent from this chunk
    line = ("pH_inlet", "pH_outlet", "temp_inlet", "temp_outlet")
    power = {JTY.FAULT_CODE[JTY.SensorFault.POWER_LOW],
             JTY.FAULT_CODE[JTY.SensorFault.POWER_HIGH]}
    warming = JTY.STATUS_CODE[JTY.SensorStatus.WARMING_UP]
    for k, name in enumerate(names):
        want_v = np.stack([np.asarray(o[name].value) for o in jouts])
        want_f = np.stack([np.asarray(o[name].fault) for o in jouts])
        got_v = to_numpy(chunk.values[:, k])[:, run]
        got_f = to_numpy(chunk.faults[:, k])[:, run]
        np.testing.assert_allclose(got_v, want_v[REC - 1::REC][:, run],
                                   rtol=0, atol=READ[dtype],
                                   equal_nan=True, err_msg=name)
        np.testing.assert_array_equal(got_f, want_f[REC - 1::REC][:, run])
        value, status, fault = chunk.last[name]
        last = jouts[-1][name]
        _close(to_numpy(value)[run], np.asarray(last.value)[run],
               READ[dtype], name)
        np.testing.assert_array_equal(to_numpy(status)[run],
                                      np.asarray(last.status)[run])
        np.testing.assert_array_equal(to_numpy(fault)[run],
                                      np.asarray(last.fault)[run])
        if name in line:
            assert not np.isin(want_f[:, run], list(power)).any()
            assert not (np.stack([np.asarray(o[name].status) for o in jouts])
                        [:, run] == warming).any()
    # the forced faults of plant_words reach the record
    assert (to_numpy(chunk.faults[:, :, 0]) != 0).any()
    r, jr = chunk.plant.reactor, d["jfinal"].reactor
    for f in ("pH", "chlorine", "temperature"):
        _close(to_numpy(getattr(r, f))[run], np.asarray(getattr(jr, f))[run],
               PHYS[dtype], f)
    assert to_numpy(r.time).tolist() == np.asarray(jr.time).tolist() \
        == [2.0 + N_CHUNK, N_CHUNK, 2.0]
    _lane_equal(chunk.plant, d["before"], 2)


def test_per_tick_draws_cover_every_instrument():
    """``draw_rand`` names every instrument of the plant, extension ones
    included, so that no step draws from elsewhere."""
    cfg = TR.ReactorConfiguration(n_zones=3, enable_nitrogen=True,
                                  enable_gas=True, enable_particles=True)
    params, plant = TPL.make_plant_batch(cfg, 2, device="cpu")
    g = torch.Generator().manual_seed(0)
    rand = TF.draw_rand(g, params, 2, torch.float32, "cpu")
    _, out = TPL.plant_step_batched(params, plant, TR.BoundaryConditions(),
                                    DT, 2, rand=rand)
    assert set(rand) == set(out)
    assert all(v[0].shape[0] == 2 for v in rand.values())


# ---------------------------------------------------------------------------
# kernel B3's plant0, per-lane clocks and per-lane schedules (plain version)
# ---------------------------------------------------------------------------

def _slice(tree, lanes):
    from ics_wt_physicsengine_torch.parallel.mesh import _map
    return _map(lambda x: x[lanes] if x.ndim else x, tree)


@pytest.mark.parametrize("schedule", ["constant", "per_lane"])
def test_b3_shard_with_plant0_equals_its_lanes_of_the_whole(schedule):
    params, plant = K.plant_case(5, 4, torch.float32, "cpu", delays=True,
                                 clocks=True)
    boundary = K.fleet_schedule(16, 4) if schedule == "per_lane" else K.BC
    kw = dict(dt=DT, substeps=2, n_steps=16, record_every=4, seed=7,
              step0=123)
    whole, rw = TFP.plant_rollout_fused(params, plant, boundary, **kw)
    part_bc = TF._lane_rows(boundary, slice(2, 4), "cpu") \
        if schedule == "per_lane" else boundary
    part, rp = TFP.plant_rollout_fused(_slice(params, slice(2, 4)),
                                       _slice(plant, slice(2, 4)), part_bc,
                                       plant0=2, **kw)
    d = K.plant_diff((part, rp), (_slice(whole, slice(2, 4)),
                                  {k: v[:, 2:4] for k, v in rw.items()}))
    assert d == dict(max_abs_err=0.0, worst_leaf="", nan_equal=True,
                     ints_equal=True)
    # without plant0 the shard draws lanes 0..1's noise
    other, ro = TFP.plant_rollout_fused(_slice(params, slice(2, 4)),
                                        _slice(plant, slice(2, 4)), part_bc,
                                        **kw)
    assert not torch.equal(torch.stack(list(ro.values())).nan_to_num(),
                           torch.stack(list(rp.values())).nan_to_num())


def test_b3_keeps_each_lanes_clock():
    params, plant = K.plant_case(5, 3, torch.float32, "cpu", clocks=True)
    t0 = plant.reactor.time.clone()
    new, _ = TFP.plant_rollout_fused(params, plant, K.BC, dt=DT, substeps=2,
                                     n_steps=6)
    assert torch.equal(new.reactor.time, t0 + 6.0)
    assert len(set(t0.tolist())) == 3


def test_b3_per_lane_schedule_of_equal_lanes_equals_the_shared_one():
    params, plant = K.plant_case(5, 3, torch.float32, "cpu")
    shared = K.bench_schedule(12)
    per_lane = TR.BoundaryConditions(**{
        f.name: (np.broadcast_to(np.asarray(getattr(shared, f.name))[:, None],
                                 (12, 3)).copy()
                 if np.ndim(getattr(shared, f.name)) else
                 getattr(shared, f.name))
        for f in dataclasses.fields(shared)})
    kw = dict(dt=DT, substeps=2, n_steps=12, record_every=3, seed=1)
    a = TFP.plant_rollout_fused(params, plant, shared, **kw)
    b = TFP.plant_rollout_fused(params, plant, per_lane, **kw)
    d = K.plant_diff(a, b)
    assert d["max_abs_err"] == 0.0 and d["nan_equal"] and d["ints_equal"]
    tables = TFP.build_tables(params, plant, per_lane, dt=DT, n_steps=12)
    assert tables.scheduled == TFP.FORCING_PER_PLANT
    assert tuple(tables.forcing.shape) == (12, 10, 3)


def test_serve_chunk_masked_routes_an_extension_fleet_to_the_loop():
    cfg = TR.ReactorConfiguration(n_zones=3, enable_nitrogen=True)
    params, plant = TPL.make_plant_batch(cfg, 2, device="cpu")
    sched, _ = TF._stack_boundary_schedule(
        _units(TR, 2), _units(TR, 2), 4, DT, 0.0, torch.float32, "cpu")
    g = torch.Generator().manual_seed(3)
    mask = torch.tensor([True, False])
    before = plant
    TFP.reset_launch_counts()
    out = TF.serve_chunk_masked(
        params, plant, sched, mask, dt=DT, substeps=2, record_every=2,
        rand_fn=lambda: TF.draw_rand(g, params, 2, torch.float32, "cpu"))
    assert "ammonia_outlet" in out.names and out.values.shape == (2, 8, 2)
    assert to_numpy(out.plant.reactor.time).tolist() == [4.0, 0.0]
    _lane_equal(out.plant, before, 1)
    assert TFP.LAUNCHES["plant_rollout_fused"] == 0
    with pytest.raises(ValueError, match="injected"):
        TF.serve_chunk_masked(params, plant, sched, mask, dt=DT, substeps=2,
                              rng="bits", bits=K.plant_words(4, 2, "cpu"))


# ---------------------------------------------------------------------------
# the network step and chunk against JAX's _step_masked_network
# ---------------------------------------------------------------------------

def _jax_network_step(substeps, arrays, D):
    """JAX fleet.py:209-237 with the draws injected."""
    W, Minv, delays = arrays

    @jax.jit
    def step(p, s, bc, mask, ring, idx, rand):
        ns = JN.NetworkState(reactor=s.reactor, ring=ring, ring_index=idx)
        eff, _ = JN._blended_boundary(W, Minv, delays, ns, bc, False)
        new, out = JPL.plant_step_batched(p, s, eff, DT, substeps,
                                          boundary_axes=0, rand=rand)
        merged = _where(mask, new, s)
        sample = JN._outlet_sample(merged.reactor).astype(ring.dtype)
        ring = jax.lax.dynamic_update_index_in_dim(ring, sample,
                                                   jnp.mod(idx, D), axis=0)
        return merged, out, ring, idx + 1
    return step


def test_network_steps_and_chunk_match_jax():
    dtype = torch.float64
    cfg, jp, js, tp, ts = _fleet(dtype, n=3, seed=5)
    substeps = JR.default_substeps(cfg, DT)
    with open(TRAIN3) as f:
        spec = json.load(f)
    net = TF._network(spec, 3, dtype, "cpu")
    topo = JN.NetworkTopology(routing=np.asarray(spec["routing"]),
                              delay_steps=np.asarray(spec["delay_steps"]))
    jstep = _jax_network_step(substeps, JN.topology_arrays(topo, jnp.float64),
                              topo.max_delay)
    ring, idx = TF._network_ring(ts, net)
    jring = jnp.broadcast_to(JN._outlet_sample(js.reactor),
                             (topo.max_delay,) + ring.shape[1:])
    jidx = jnp.asarray(0, jnp.int32)
    units = [dataclasses.replace(b, inlet_flow_rate=x) for b, x in
             zip(_units(TR, 3), net["ext_flow"])]
    units[0] = dataclasses.replace(units[0], chlorine_flow_rate=0.5,
                                   chlorine_concentration=50.0)
    tbc = TF._stack_boundaries(units, dtype, "cpu")
    jbc = JR.BoundaryConditions(**{
        k: (None if v is None else jnp.asarray(to_numpy(v)))
        for k, v in tbc.__dict__.items()})
    rng = np.random.default_rng(1)
    masks = [[1, 1, 1], [1, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
             [1, 1, 1]]
    for m in masks:
        mk = np.array(m, bool)
        trand, jrand = _rand(rng, 3, dtype)
        ts, tout, ring, idx = TF.step_masked_network(
            tp, ts, tbc, torch.from_numpy(mk), ring, idx, net, dt=DT,
            substeps=substeps, rand=trand)
        js, jout, jring, jidx = jstep(jp, js, jbc, jnp.asarray(mk), jring,
                                      jidx, jrand)
        for f in ("pH", "chlorine", "temperature", "time"):
            np.testing.assert_allclose(to_numpy(getattr(ts.reactor, f)),
                                       np.asarray(getattr(js.reactor, f)),
                                       rtol=NET_TOL, atol=NET_TOL)
        np.testing.assert_allclose(to_numpy(ring), np.asarray(jring),
                                   rtol=NET_TOL, atol=NET_TOL)
        for name in tout:
            np.testing.assert_allclose(
                to_numpy(tout[name].value), np.asarray(jout[name].value),
                rtol=NET_TOL, atol=NET_TOL, equal_nan=True)
    assert int(idx) == int(jidx) == len(masks)

    # a chunk: the loop of the same step over a schedule
    sched, _ = TF._stack_boundary_schedule(units, units, 8, DT, 0.0, dtype,
                                           "cpu")
    mk = np.array([1, 1, 0], bool)
    draws = [_rand(rng, 3, dtype) for _ in range(8)]
    it = iter(d[0] for d in draws)
    chunk, ring2, idx2 = TF.serve_chunk_network(
        tp, ts, sched, torch.from_numpy(mk), ring, idx, net, dt=DT,
        substeps=substeps, record_every=4, rand_fn=lambda: next(it))
    for g in range(8):
        row = JR.BoundaryConditions(**{
            k: (None if v is None else jnp.asarray(to_numpy(v[g])))
            for k, v in sched.__dict__.items()})
        js, jout, jring, jidx = jstep(jp, js, row, jnp.asarray(mk), jring,
                                      jidx, draws[g][1])
    for f in ("pH", "chlorine", "temperature", "time"):
        np.testing.assert_allclose(to_numpy(getattr(chunk.plant.reactor, f)),
                                   np.asarray(getattr(js.reactor, f)),
                                   rtol=NET_TOL, atol=NET_TOL)
    np.testing.assert_allclose(to_numpy(ring2), np.asarray(jring),
                               rtol=NET_TOL, atol=NET_TOL)
    k = chunk.names.index("pH_outlet")
    np.testing.assert_allclose(to_numpy(chunk.last["pH_outlet"][0]),
                               np.asarray(jout["pH_outlet"].value),
                               rtol=NET_TOL, atol=NET_TOL, equal_nan=True)
    assert chunk.values.shape == (2, 7, 3) and k == 1
    assert int(idx2) == int(jidx) == len(masks) + 8


def test_stage_three_answers_stage_one_dose_after_the_pipe_delays():
    """Chlorine dosed into stage 1 only reaches stage 3 through the 2- and
    3-step pipes: against the same train undosed, stage 3 does not move at
    all for the first five steps, and then its chlorine keeps rising."""
    dtype = torch.float64
    _, _, _, tp, ts0 = _fleet(dtype, n=3, seed=5)
    with open(TRAIN3) as f:
        net = TF._network(json.load(f), 3, dtype, "cpu")
    mask = torch.ones(3, dtype=torch.bool)
    runs = []
    for strength in (0.0, 200.0):      # the same flows, dosed or not
        units = [dataclasses.replace(b, inlet_flow_rate=x,
                                     chlorine_flow_rate=0.0)
                 for b, x in zip(_units(TR, 3), net["ext_flow"])]
        units[0] = dataclasses.replace(units[0], chlorine_flow_rate=1.0,
                                       chlorine_concentration=strength)
        bc = TF._stack_boundaries(units, dtype, "cpu")
        ts, (ring, idx), cl3 = ts0, TF._network_ring(ts0, net), []
        for _ in range(30):
            ts, _, ring, idx = TF.step_masked_network(
                tp, ts, bc, mask, ring, idx, net, dt=60.0, substeps=8,
                rand=TF.draw_rand(torch.Generator().manual_seed(0), tp, 3,
                                  dtype, "cpu"))
            cl3.append(float(ts.reactor.chlorine[2].mean()))
        runs.append(np.array(cl3))
    diff = runs[1] - runs[0]
    first = int(np.flatnonzero(diff)[0])
    assert first >= 5, diff[:8]
    assert diff[-1] > 5e-4 and np.all(np.diff(diff[5:]) > 0), diff


# ---------------------------------------------------------------------------
# the live loop
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _serve(argv, module=TO):
    module.running = True
    thread = threading.Thread(target=module.main, args=(argv,), daemon=True)
    thread.start()
    return thread


def _stop(thread, module=TO):
    module.running = False
    thread.join(timeout=60)
    assert not thread.is_alive()


def _connect(client_cls, port, unit, until):
    while time.time() < until:
        try:
            return client_cls("127.0.0.1", port, unit_id=unit,
                              timeout=5).connect()
        except OSError:
            time.sleep(0.1)
    pytest.fail("the fleet's Modbus server did not start")


def _wait(pred, until, what):
    while time.time() < until:
        if pred():
            return
        time.sleep(0.05)
    pytest.fail(f"timed out waiting for {what}")


@pytest.mark.parametrize("chunk", [1, 16])
def test_jax_client_against_the_port_fleet_dose_pause_resume(chunk):
    """The JAX package's client on units 1-3 of the port's fleet: acid into
    unit 2 lowers its pH while unit 1's holds; clearing unit 3's
    simulation_running coil freezes its clock while unit 1 runs on;
    setting it again resumes it."""
    port = _free_port()
    thread = _serve(["--device", "cpu", "--fleet", "3", "--zones", "4",
                     "--port", str(port), "--host", "127.0.0.1", "--dt",
                     "30", "--rtf", "0", "--seed", "11", "--serve-chunk",
                     str(chunk)])
    clients = []
    try:
        until = time.time() + 60
        c1, c2, c3 = clients[:] = [_connect(JMB.ModbusTcpClient, port, u,
                                            until) for u in (1, 2, 3)]
        t = lambda c: c.read_float32(100)      # noqa: E731 simulation_time
        _wait(lambda: t(c1) >= 600.0, time.time() + 60, "t >= 600 s")
        ph1, ph2 = c1.read_float32(0), c2.read_float32(0)
        assert ph1 > 5.0 and ph2 > 5.0
        c2.write_float32(0, 0.5)                # acid_flow_rate, unit 2
        t1 = t(c1)
        _wait(lambda: t(c1) >= t1 + 1500.0, time.time() + 60, "dosing")
        assert c2.read_float32(0) < ph2 - 0.5
        assert abs(c1.read_float32(0) - ph1) < 0.3
        c2.write_float32(0, 0.0)

        c3.write_coil(2, False)                 # simulation_running
        # a chunk already running when the coil is cleared still publishes
        # unit 3's clock: wait two of unit 1's chunks before reading it
        t0 = t(c1)
        _wait(lambda: t(c1) >= t0 + 2 * chunk * 30.0, time.time() + 60,
              "the running chunk")
        frozen, t1 = t(c3), t(c1)
        _wait(lambda: t(c1) >= t1 + 600.0, time.time() + 60, "unit 1")
        assert t(c3) == frozen
        c3.write_coil(2, True)
        _wait(lambda: t(c3) > frozen + 60.0, time.time() + 60, "resume")
        assert t(c3) < t(c1)                    # its clock lags unit 1's
    finally:
        for c in clients:
            c.close()
        _stop(thread)


def test_port_client_against_the_jax_fleet_units():
    """The port's client reads and commands units of the JAX package's
    fleet (per-tick, 2 plants)."""
    port = _free_port()
    thread = _serve(["--fleet", "2", "--zones", "4", "--port", str(port),
                     "--host", "127.0.0.1", "--dt", "30", "--rtf", "0",
                     "--seed", "3"], module=JO)
    clients = []
    try:
        until = time.time() + 90
        c1, c2 = clients[:] = [_connect(TMB.ModbusTcpClient, port, u, until)
                               for u in (1, 2)]
        _wait(lambda: c2.read_float32(100) >= 60.0, time.time() + 90,
              "the JAX fleet's clock")
        assert np.isfinite(c1.read_float32(6))      # chlorine_inlet
        c2.write_float32(4, 7.5)            # inlet_flow_rate, unit 2

        def held(c):
            return c.read_float32(4, input_register=False)

        _wait(lambda: held(c2) == 7.5, time.time() + 10, "the write")
        assert held(c1) == 5.0
        # the JAX fleet steps unit 2 at its new inlet flow: its flow meter
        # (input register 10) moves toward 7.5 L/min
        t = c2.read_float32(100)
        _wait(lambda: c2.read_float32(100) >= t + 300.0, time.time() + 60,
              "the JAX fleet's clock")
        assert c2.read_float32(10) > c1.read_float32(10) + 1.0
    finally:
        for c in clients:
            c.close()
        _stop(thread, module=JO)


def _run(tmp, name, *argv):
    TO.running = True
    return TO.main(["--device", "cpu", "--no-modbus", "--rtf", "0",
                    "--zones", "4", "--seed", "5", "--checkpoint-file",
                    str(tmp / name), *argv])


def _saved(tmp, name, n, net=False):
    cfg = TR.ReactorConfiguration(n_zones=4)
    params, plant = TPL.make_plant_batch(cfg, n, seed=5, device="cpu")
    template = {"params": params, "plant": plant,
                "generator": torch.Generator()}
    if net:
        template["net_ring"] = torch.zeros((3, n, 3))
        template["net_index"] = torch.zeros((), dtype=torch.int64)
    path = str(tmp / name)
    return TCK.load_pytree(path, template), TCK.load_metadata(path)


@pytest.mark.parametrize("chunk", ["1", "8"])
def test_resumed_fleet_continues_its_noise_bit_for_bit(tmp_path, chunk):
    """A straight 32 s run against 16 s, a checkpoint and 16 s more: the
    step count (B3's noise) and the generator (the per-tick draws) ride the
    checkpoint, so the two end bit for bit alike."""
    argv = ["--fleet", "2", "--serve-chunk", chunk]
    assert _run(tmp_path, "a.npz", *argv, "--duration", "32") == 0
    assert _run(tmp_path, "b.npz", *argv, "--duration", "16") == 0
    assert _run(tmp_path, "b.npz", *argv, "--duration", "32") == 0
    (a, ma), (b, mb) = (_saved(tmp_path, x, 2) for x in ("a.npz", "b.npz"))
    assert ma["step_count"] == mb["step_count"] == 32
    assert ma["sim_time"] == mb["sim_time"] == 32.0
    d = K.plant_diff(a["plant"], b["plant"])
    assert d["max_abs_err"] == 0.0 and d["nan_equal"] and d["ints_equal"]
    assert torch.equal(a["generator"].get_state(), b["generator"].get_state())


def test_checkpoint_resize_two_to_three_lanes(tmp_path):
    assert _run(tmp_path, "c.npz", "--fleet", "2", "--duration", "10") == 0
    (saved, _) = _saved(tmp_path, "c.npz", 2)
    with pytest.raises(SystemExit):       # a size change must be asked for
        _run(tmp_path, "c.npz", "--fleet", "3", "--duration", "20")
    assert _run(tmp_path, "c.npz", "--fleet", "3", "--checkpoint-resize",
                "--duration", "20") == 0
    (grown, meta) = _saved(tmp_path, "c.npz", 3)
    assert meta["fleet"] == 3 and meta["sim_time"] == 20.0
    # the saved lanes went on from t = 10 s, the new lane started fresh
    assert to_numpy(grown["plant"].reactor.time).tolist() == [20.0, 20.0,
                                                              10.0]
    for (path, a), (_, b) in zip(K.tree_leaves(grown["params"]),
                                 K.tree_leaves(saved["params"])):
        assert torch.equal(a[:2], b), path


def test_network_checkpoint_round_trip_and_mode_check(tmp_path):
    argv = ["--network", TRAIN3]
    assert _run(tmp_path, "n1.npz", *argv, "--duration", "12") == 0
    assert _run(tmp_path, "n2.npz", *argv, "--duration", "6") == 0
    assert _run(tmp_path, "n2.npz", *argv, "--duration", "12") == 0
    (a, ma), (b, mb) = (_saved(tmp_path, x, 3, net=True)
                        for x in ("n1.npz", "n2.npz"))
    assert ma["network"] and mb["step_count"] == 12
    assert int(a["net_index"]) == int(b["net_index"]) == 12
    assert torch.equal(a["net_ring"], b["net_ring"])
    d = K.plant_diff(a["plant"], b["plant"])
    assert d["max_abs_err"] == 0.0 and d["ints_equal"]
    with pytest.raises(SystemExit):        # a network checkpoint, no network
        _run(tmp_path, "n2.npz", "--fleet", "3", "--duration", "20")


def test_endless_duration_fleet_chunk_runs(tmp_path):
    """The repair of JAX fleet.py:771-772: without --duration (endless) the
    first chunk must not compute int(round(inf)); the fleet runs until
    stopped and its clock advances."""
    path = tmp_path / "endless.npz"
    thread = _serve(["--device", "cpu", "--no-modbus", "--rtf", "0",
                     "--fleet", "2", "--zones", "3", "--serve-chunk", "8",
                     "--checkpoint-file", str(path), "--checkpoint-hours",
                     "0.01"])
    try:
        _wait(path.exists, time.time() + 60, "a periodic checkpoint")
    finally:
        _stop(thread)
    meta = TCK.load_metadata(str(path))
    assert meta["sim_time"] >= 36.0 and meta["sim_time"] % 8 == 0
    assert meta["step_count"] == meta["sim_time"]


def test_sigterm_stops_the_fleet_under_python_m(tmp_path):
    """Under ``python -m`` the signal handler clears the running module's
    flag; the fleet loop reads that module (the JAX fleet reads a second
    import of its ``__main__``, whose flag no signal clears)."""
    path = tmp_path / "sig.npz"
    proc = subprocess.Popen(
        [sys.executable, "-m", "ics_wt_physicsengine_torch", "--device",
         "cpu", "--no-modbus", "--rtf", "0", "--fleet", "2", "--zones", "3",
         "--serve-chunk", "4", "--checkpoint-file", str(path),
         "--checkpoint-hours", "0.002"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _wait(path.exists, time.time() + 90, "the first checkpoint")
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert "Fleet stopped cleanly" in err


@pytest.mark.parametrize("chunk, fn", [("8", "serve_chunk_masked"),
                                       ("1", "step_masked")])
def test_a_failed_chunk_or_tick_exits_non_zero(tmp_path, monkeypatch, chunk,
                                               fn):
    """A fleet chunk or tick that raises (a B3 launch that fails on the
    card) ends the run with exit code 1, after the checkpoint is written
    and the servers are closed; JAX fleet.py:785 breaks and returns 0."""
    def fail(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(TF, fn, fail)
    with pytest.raises(SystemExit) as exc:
        _run(tmp_path, "failed.npz", "--fleet", "2", "--serve-chunk", chunk,
             "--duration", "16")
    assert exc.value.code == 1
    assert isinstance(exc.value.__cause__, RuntimeError)
    assert TCK.load_metadata(str(tmp_path / "failed.npz"))["sim_time"] == 0.0


def test_fleet_cli_checks():
    for argv in (["--fleet", "255"], ["--fleet", "0"],
                 ["--fleet", "2", "--network", TRAIN3]):
        with pytest.raises(SystemExit):
            TO.main(["--device", "cpu", "--no-modbus", "--rtf", "0", *argv])
