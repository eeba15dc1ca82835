"""The port's utilities (``utils/checkpoint.py``, ``history.py``,
``netreap.py``, ``profiling.py``, ``backend_select.py``) on the CPU, and
checkpoints across the two packages.

- Checkpoints round-trip bit for bit; a file written by the JAX package
  loads into the port's templates and the reverse, with the leaves equal bit
  for bit, and the loaded objects compute what the writer's compute: the
  reactor in float64 at atol 1e-10 + rtol 1e-10 (the port's reactor
  tolerance), the surrogate at 1e-5 of ``x_std`` (its float32 MLP).
- ``diagnostics`` against the JAX package's in float64: 1e-12.
- Device selection runs fake probe children (one that hangs, one that
  crashes, one that is healthy); a failed probe raises.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import surrogate as JSG
from ics_wt_physicsengine_tpu.utils import checkpoint as JCK
from ics_wt_physicsengine_tpu.utils import profiling as JPF

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch import utils as TU
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models import surrogate as TSG
from ics_wt_physicsengine_torch.sensors import create_realistic_sensor_suite
from ics_wt_physicsengine_torch.utils import backend_select as BS
from ics_wt_physicsengine_torch.utils import checkpoint as CK
from ics_wt_physicsengine_torch.utils.history import ParquetHistoryLogger
from ics_wt_physicsengine_torch.utils.netreap import IdleReaper

from torch_port_util import to_numpy, tree_to_numpy

torch.set_num_threads(1)

F64 = torch.float64
Z = 3
N = 3 * Z
BC = dict(inlet_flow_rate=5.0, acid_flow_rate=0.2, chlorine_flow_rate=0.05)


def _leaves_equal(port, ref):
    a, b = CK.tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = to_numpy(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, i
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# checkpoints in the port
# ---------------------------------------------------------------------------

def test_roundtrip_with_a_generator_and_metadata(tmp_path):
    g = torch.Generator().manual_seed(7)
    torch.rand(3, generator=g)
    tree = {"b": (torch.tensor(2.5, dtype=F64), torch.ones((2, 3))),
            "a": torch.arange(5.0), "n": None, "key": g,
            "i": torch.arange(4, dtype=torch.int32)}
    path = str(tmp_path / "ckpt.npz")
    CK.save_pytree(path, tree, metadata={"note": "test"})
    assert os.listdir(tmp_path) == ["ckpt.npz"]
    restored = CK.load_pytree(path, tree)
    assert list(restored) == list(tree) and restored["n"] is None
    for k in ("a", "i"):
        assert restored[k].dtype == tree[k].dtype
        assert torch.equal(restored[k], tree[k])
    assert torch.equal(restored["b"][1], tree["b"][1])
    # the generator resumes its stream
    assert torch.equal(torch.rand(4, generator=restored["key"]),
                       torch.rand(4, generator=g))
    assert CK.load_metadata(path)["note"] == "test"


def test_leaf_order_is_jax_tree_flatten_order():
    """Dataclass fields in declaration order, no leaf for None, dict keys
    sorted: the port's order equals jax.tree_util's on the same tree."""
    names = lambda leaves: [float(x.reshape(-1)[0]) for x in leaves]
    port = {"state": torch.tensor([3.0]),
            "params": (torch.tensor([1.0]), None, torch.tensor([2.0])),
            "sensor_carries": {"z": torch.tensor([5.0]),
                               "a": torch.tensor([4.0])}}
    ref = {"state": jnp.asarray([3.0]),
           "params": (jnp.asarray([1.0]), None, jnp.asarray([2.0])),
           "sensor_carries": {"z": jnp.asarray([5.0]),
                              "a": jnp.asarray([4.0])}}
    assert names(CK.tree_leaves(port)) == names(
        jax.tree_util.tree_leaves(ref)) == [1.0, 2.0, 4.0, 5.0, 3.0]


@pytest.mark.parametrize("template,match", [
    ({"a": torch.zeros(3), "b": torch.zeros(3)}, "structure mismatch"),
    ({"a": torch.zeros(4)}, "shape"),
    ({"a": torch.zeros(3, dtype=F64)}, "dtype"),
    ({"a": torch.Generator()}, "structure mismatch"),
])
def test_mismatch_raises(tmp_path, template, match):
    path = str(tmp_path / "ckpt.npz")
    CK.save_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match=match):
        CK.load_pytree(path, template)


def test_failed_write_leaves_no_temp_file_and_the_old_checkpoint(
        tmp_path, monkeypatch):
    path = str(tmp_path / "ckpt.npz")
    CK.save_pytree(path, {"a": torch.zeros(3)})

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        CK.save_pytree(path, {"a": torch.ones(3)})
    assert os.listdir(tmp_path) == ["ckpt.npz"]
    monkeypatch.undo()
    assert torch.equal(CK.load_pytree(path, {"a": torch.ones(3)})["a"],
                       torch.zeros(3))


def test_merge_lanes_grows_and_shrinks():
    restored = {"x": torch.arange(6.0).reshape(3, 2), "s": torch.tensor(1.0),
                "flat": torch.ones(3)}
    grown = CK.merge_lanes(restored, {"x": torch.full((5, 2), -1.0),
                                      "s": torch.tensor(9.0),
                                      "flat": torch.zeros(5)})
    assert torch.equal(grown["x"][:3], restored["x"])
    assert torch.equal(grown["x"][3:], torch.full((2, 2), -1.0))
    assert torch.equal(grown["flat"], torch.tensor([1.0, 1, 1, 0, 0]))
    assert float(grown["s"]) == 1.0
    shrunk = CK.merge_lanes(restored, {"x": torch.zeros((2, 2)),
                                       "s": torch.tensor(9.0),
                                       "flat": torch.zeros((2, 1))})
    assert torch.equal(shrunk["x"], restored["x"][:2])
    assert torch.equal(shrunk["flat"], torch.zeros((2, 1)))   # rank differs


def _reactor(dtype=F64):
    return TR.IntegratedCSTR(TR.ReactorConfiguration(n_zones=Z),
                             dtype=dtype, device="cpu")


def test_simulation_resumes_identically_sensors_included(tmp_path):
    """Reactor state, sensor carries and sensor generators resume exactly:
    the resumed run's states and readings equal the uninterrupted run's."""
    config = TR.ReactorConfiguration(n_zones=Z)
    bc = TR.BoundaryConditions(**BC)
    path = str(tmp_path / "sim.npz")

    def suite(seed):
        s = create_realistic_sensor_suite(config, seed=seed, device="cpu")
        for x in s.values():
            x.calibrate(7.0, 0.0)
        return s

    def ticks(r, sensors, t0, n):
        out = []
        for i in range(n):
            r.step(1.0, bc)
            out.append([s.read(r.state, t0 + i).value
                        for s in sensors.values()])
        return np.asarray(out), to_numpy(r.state.chlorine)

    r1, s1 = _reactor(torch.float32), suite(3)
    ticks(r1, s1, 2000.0, 5)
    TU.save_simulation(path, r1, sensors=s1, metadata={"t": 5.0})
    assert CK.load_metadata(path) == {"t": 5.0, "has_sensors": True}
    want = ticks(r1, s1, 2010.0, 20)

    r2, s2 = _reactor(torch.float32), suite(999)   # another stream...
    TU.load_simulation(path, r2, sensors=s2)       # ...replaced
    assert float(r2.state.time) == 5.0
    got = ticks(r2, s2, 2010.0, 20)
    assert np.isfinite(got[0]).all()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _jax_reactor():
    r = JR.IntegratedCSTR(JR.ReactorConfiguration(n_zones=Z),
                          dtype=jnp.float64)
    for _ in range(10):
        r.step(1.0, JR.BoundaryConditions(**BC))
    return r


def _step_both(jr, tr, n=5):
    for _ in range(n):
        jr.step(1.0, JR.BoundaryConditions(**BC))
        tr.step(1.0, TR.BoundaryConditions(**BC))
    for name in ("pH", "chlorine", "temperature"):
        np.testing.assert_allclose(to_numpy(getattr(tr.state, name)),
                                   np.asarray(getattr(jr.state, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)


def test_a_jax_simulation_checkpoint_loads_into_the_port(tmp_path):
    path = str(tmp_path / "jax_sim.npz")
    jr = _jax_reactor()
    JCK.save_simulation(path, jr, metadata={"writer": "jax"})
    tr = _reactor()
    TU.load_simulation(path, tr)
    _leaves_equal({"params": tr.params, "state": tr.state},
                  {"params": jr.params, "state": jr.state})
    assert TU.load_metadata(path)["writer"] == "jax"
    _step_both(jr, tr)


def test_a_port_simulation_checkpoint_loads_into_jax(tmp_path):
    path = str(tmp_path / "port_sim.npz")
    tr = _reactor()
    for _ in range(10):
        tr.step(1.0, TR.BoundaryConditions(**BC))
    TU.save_simulation(path, tr)
    jr = JR.IntegratedCSTR(JR.ReactorConfiguration(n_zones=Z),
                           dtype=jnp.float64)
    JCK.load_simulation(path, jr)
    _leaves_equal({"params": tr.params, "state": tr.state},
                  {"params": jr.params, "state": jr.state})
    _step_both(jr, tr)


def _jax_sp():
    key = jax.random.PRNGKey(3)
    ws = list(JSG._init_mlp(key, (N + 1, 16, 16, N)))
    ws[-2] = 0.3 * jax.random.normal(key, ws[-2].shape, jnp.float32)
    lo, hi = JSG._flat_bounds(Z, False, False, False, 0, jnp.float64)
    rep = lambda a, b, c: jnp.asarray(np.repeat([a, b, c], Z), jnp.float64)
    return JSG.SurrogateParams(
        weights=tuple(ws), x_mean=rep(7.0, 2.0, 20.0),
        x_std=rep(0.7, 1.0, 5.0), u_scale=jnp.ones(1, jnp.float64),
        r_mean=rep(0.0, -0.01, 0.02), r_std=rep(0.05, 0.2, 0.5), lo=lo,
        hi=hi)


def _port_template(jsp):
    return convert.surrogate_params_from_numpy(
        {f.name: (tuple(np.zeros(w.shape, np.float32) for w in jsp.weights)
                  if f.name == "weights"
                  else np.zeros(getattr(jsp, f.name).shape))
         for f in dataclasses.fields(jsp)}, dtype=F64, device="cpu")


def _same_predictions(tsp, jsp):
    x = np.linspace([6.5] * Z + [0.5] * Z + [10.0] * Z,
                    [8.0] * Z + [3.0] * Z + [25.0] * Z, 5)
    u = np.full((5, 1), 0.4)
    want = np.asarray(JSG.surrogate_step(jsp, x, u))
    got = to_numpy(TSG.surrogate_step(tsp, torch.from_numpy(x),
                                      torch.from_numpy(u)))
    assert (np.abs(got - want) / np.asarray(jsp.x_std)).max() <= 1e-5


def test_surrogate_checkpoints_cross_both_ways(tmp_path):
    jsp = _jax_sp()
    path = str(tmp_path / "jax_sp.npz")
    JCK.save_pytree(path, jsp, metadata={"n_zones": Z})
    tsp = TU.load_pytree(path, _port_template(jsp))
    _leaves_equal(tsp, jsp)
    _same_predictions(tsp, jsp)

    path = str(tmp_path / "port_sp.npz")
    TU.save_pytree(path, tsp)
    back = JCK.load_pytree(path, jax.tree_util.tree_map(jnp.zeros_like,
                                                        jsp))
    _leaves_equal(tsp, back)
    _same_predictions(tsp, back)
    assert torch.equal(TU.load_pytree(path, tsp).weights[2], tsp.weights[2])


def test_a_jax_prng_key_is_refused(tmp_path):
    path = str(tmp_path / "key.npz")
    JCK.save_pytree(path, {"k": jax.random.key(1)})
    with pytest.raises(ValueError, match="PRNG key"):
        CK.load_pytree(path, {"k": torch.Generator()})


# ---------------------------------------------------------------------------
# history, reaper, profiling
# ---------------------------------------------------------------------------

def test_parquet_rotation_and_the_parts_read_back(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    path = str(tmp_path / "plant.parquet")
    log = ParquetHistoryLogger(path, ["t", "cl", "tick"],
                               int_fields=["tick"], rows_per_group=4,
                               rotate_groups=2)
    for i in range(19):
        log.log({"t": i * 0.5, "cl": 2.0 - 0.01 * i, "tick": i})
    # two finished parts of 8 rows are readable before close
    assert pq.read_table(str(tmp_path / "plant.part00000.parquet")) \
        .num_rows == 8
    log.close()
    parts = sorted(os.listdir(tmp_path))
    assert parts == [f"plant.part{i:05d}.parquet" for i in range(3)]
    rows = [r for p in parts
            for r in pq.read_table(str(tmp_path / p)).to_pylist()]
    assert [r["tick"] for r in rows] == list(range(19))
    assert rows[5] == {"t": 2.5, "cl": 2.0 - 0.05, "tick": 5}
    schema = pq.read_schema(str(tmp_path / parts[0]))
    assert str(schema.field("tick").type) == "int64"
    assert str(schema.field("cl").type) == "double"

    single = str(tmp_path / "one.parquet")
    log = ParquetHistoryLogger(single, ["t"], rows_per_group=3)
    for i in range(5):
        log.log({"t": float(i)})
    log.close()
    assert pq.read_table(single).column("t").to_pylist() == [0, 1, 2, 3, 4]


def test_parquet_logger_needs_pyarrow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(RuntimeError, match="pyarrow"):
        ParquetHistoryLogger(str(tmp_path / "x.parquet"), ["t"])


class _Transport:
    aborted = 0

    def abort(self):
        self.aborted += 1


class _Writer:
    def __init__(self):
        self.transport = _Transport()


def test_idle_reaper_drops_only_stale_connections():
    log = []
    reaper = IdleReaper(2.0, log=log.append)
    assert reaper.sweep_every == 0.5
    a, b = _Writer(), _Writer()
    cell_a = reaper.register(a, now=0.0)
    reaper.register(b, now=0.0)
    assert len(reaper) == 2
    assert reaper.maybe_sweep(0.1) == 0          # sets the first deadline
    assert reaper.maybe_sweep(0.3) == 0          # before the deadline
    cell_a[0] = 1.9                              # a made progress
    assert reaper.maybe_sweep(2.5) == 1          # b idle for 2.5 s > 2 s
    assert (a.transport.aborted, b.transport.aborted) == (0, 1)
    assert log == ["dropping idle/slow connection"]
    reaper.pop(b)
    assert len(reaper) == 1
    assert reaper.maybe_sweep(2.6) == 0          # next sweep at 3.0
    assert reaper.maybe_sweep(4.0) == 1


def test_diagnostics_match_jax():
    cfg = dict(n_zones=4, initial_chlorine=1.3, initial_pH=7.1)
    jr = JR.IntegratedCSTR(JR.ReactorConfiguration(**cfg),
                           dtype=jnp.float64)
    for _ in range(5):
        jr.step(1.0, JR.BoundaryConditions(inlet_chlorine=3.0,
                                           inlet_pH=8.0,
                                           inlet_temperature=24.0))
    want = JPF.diagnostics(jr.params, jr.state)
    params = convert.params_from_numpy(tree_to_numpy(jr.params), dtype=F64,
                                       device="cpu")
    state = convert.state_from_numpy(tree_to_numpy(jr.state), dtype=F64,
                                     device="cpu")
    got = TU.diagnostics(params, state)
    assert set(got) == set(want)
    assert got["zones"] == want["zones"] == 4
    assert float(want["pH_cv"]) > 0 and float(want["pH_range"]) > 0
    for k in sorted(set(want) - {"zones"}):
        np.testing.assert_allclose(to_numpy(got[k]), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-12, err_msg=k)


def test_step_timer_rates():
    timer = TU.StepTimer(window=4)
    assert timer.steps_per_second == 0.0 and timer.real_time_factor == 0.0
    for i in range(6):
        timer.tick(sim_time=i * 2.0)
        time.sleep(0.01)
    assert len(timer._stamps) == 4               # the rolling window
    assert 10 < timer.steps_per_second < 110
    assert timer.real_time_factor > 10           # 2 s of plant per ~10 ms


def test_trace_writes_a_chrome_trace(tmp_path):
    with TU.trace(str(tmp_path / "tr")) as d:
        torch.ones(64).cumsum(0)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# device selection: a failed probe raises
# ---------------------------------------------------------------------------

HANG = "import time; time.sleep(60)"
CRASH = "raise RuntimeError('driver gone')"
HEALTHY = "print('PROBE_OK gpu 2 NVIDIA H100 80GB HBM3')"


def test_probe_deadline_fires_on_a_hanging_child():
    t0 = time.monotonic()
    res = BS.probe_default_backend(deadline=1.0, retries=1, _code=HANG)
    assert not res.ok and "deadline" in res.reason
    assert time.monotonic() - t0 < 10.0


def test_probe_reports_a_crashing_child():
    res = BS.probe_default_backend(deadline=30.0, retries=1, _code=CRASH)
    assert not res.ok and "rc=1" in res.reason and "driver gone" in res.reason


def test_probe_parses_a_healthy_child():
    res = BS.probe_default_backend(deadline=30.0, retries=1, _code=HEALTHY)
    assert res == BS.ProbeResult(True, "gpu", 2, "ok",
                                 "NVIDIA H100 80GB HBM3")


def test_probe_deadline_escalates_per_attempt():
    timeouts = []

    def runner(cmd, **kw):
        timeouts.append(kw.get("timeout"))
        raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))

    res = BS.probe_default_backend(deadline=7.0, retries=3, _runner=runner)
    assert not res.ok and timeouts == [7.0, 14.0, 21.0]


@pytest.mark.parametrize("code", [HANG, CRASH], ids=["hang", "crash"])
def test_a_failed_probe_raises_and_never_falls_back(code, monkeypatch):
    monkeypatch.setattr(BS, "_PROBE_CODE", code)
    with pytest.raises(RuntimeError, match="no working CUDA device"):
        BS.ensure_default_backend(probe_deadline=0.5, retries=1)
    with pytest.raises(RuntimeError, match="no working CUDA device"):
        BS.select_devices(1, probe_deadline=0.5)


def test_a_healthy_probe_still_needs_enough_devices(monkeypatch):
    monkeypatch.setattr(BS, "_PROBE_CODE", HEALTHY)
    assert BS.ensure_default_backend(min_devices=2) == ("gpu", "ok")
    with pytest.raises(RuntimeError, match="3 CUDA devices requested"):
        BS.select_devices(3)
    if not torch.cuda.is_available():
        # the probe's word is not enough: each device must round-trip here
        with pytest.raises(RuntimeError, match="round trip"):
            BS.select_devices(1)


def test_the_real_probe_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    res = BS.probe_default_backend(deadline=120.0, retries=1)
    assert not res.ok and res.n_devices == 0
