"""The B3 and B1 wrappers without a host synchronization between launches
(``ops/fused_plant.py``, ``ops/fused_rollout.py``), on the CPU: the plain
path runs the same wrapper code as the card's.

- ``sensor_statics`` reads the sample lines' delays on the host once per
  parameter set and ``dt``: a hit on the same parameters and ``dt``, a
  miss after an in-place change of ``line_delay_s``, after another ``dt``
  and after another zone, each counted in ``STATICS_CACHE``; a served
  chunk misses once and then hits.
- ``on_device`` and the columns, tables and rebuilt rings made without a
  copy from the host equal, bit for bit, what the former expressions
  (``torch.as_tensor(x, device=...)``, a host list of step indices) build,
  in float32 and float64, and so do whole rollouts through the wrappers.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ics_wt_physicsengine_torch import __main__ as M
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.models import make_monte_carlo_batch
from ics_wt_physicsengine_torch.models import plant as PL
from ics_wt_physicsengine_torch.ops import fused_plant as FP
from ics_wt_physicsengine_torch.ops import fused_rollout as F
from ics_wt_physicsengine_torch.ops import kernel_checks as K

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float64]
# inexact in float32, subnormal, signed zero, non-finite, past float32's
# range, an integer float32 cannot hold, NumPy scalars of either width
FLOATS = [0.1, 1.0 / 3.0, 1e-40, -0.0, math.nan, math.inf, 3.5e38,
          2 ** 25 + 1, np.float64(0.1), np.float32(0.1), np.float64(1e-310)]
INTS = [0, 7, -3, 2 ** 31 - 1, True, False, np.int64(5)]


def as_tensor_on(x, device, dtype=None):
    """The former copy from the host."""
    return torch.as_tensor(x, dtype=dtype, device=device)


def bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype.is_floating_point:
        t = t.contiguous().view({4: torch.int32, 8: torch.int64}[
            t.element_size()])
    return t


def assert_bits(a: torch.Tensor, b: torch.Tensor):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(bits(a), bits(b)), (a, b)


def _with_delays(params, shape, delay_s=(5.0, 30.0, 11.0, 22.0)):
    """``params`` with each sample line's delays a fresh tensor of its own
    (so that an in-place change reaches one line only)."""
    return dataclasses.replace(params, **{
        attr: K._with_base(getattr(params, attr), line_delay_s=torch.full(
            shape, d))
        for attr, d in zip(FP._LINE_ATTRS, delay_s)})


@pytest.fixture
def fresh_cache():
    FP._STATICS.clear()
    yield
    FP._STATICS.clear()


def counts():
    return dict(FP.STATICS_CACHE)


def delta(before):
    return {k: FP.STATICS_CACHE[k] - before[k] for k in before}


def test_statics_cache_hits_misses_and_counts(fresh_cache):
    params, _ = PL.make_plant_batch(R.ReactorConfiguration(n_zones=5), 3,
                                    seed=1, device="cpu")
    params = _with_delays(params, (3,))
    before = counts()
    first = FP.sensor_statics(params, 1.0)
    assert first == FP._sensor_statics(params, 1.0)
    assert FP.sensor_statics(params, 1.0) is first
    assert delta(before) == {"hits": 1, "misses": 1}

    other_dt = FP.sensor_statics(params, 2.0)
    assert other_dt == FP._sensor_statics(params, 2.0) != first
    assert FP.sensor_statics(params, 2.0) is other_dt
    assert delta(before) == {"hits": 2, "misses": 2}

    # an in-place change of the delays: a miss that reads the new delays
    params.ph_outlet.base.line_delay_s.mul_(2.0)
    changed = FP.sensor_statics(params, 1.0)
    assert changed == FP._sensor_statics(params, 1.0) != first
    assert dict((s[0], s[4]) for s in changed)["ph_outlet"] == 60
    assert FP.sensor_statics(params, 1.0) is changed
    assert delta(before) == {"hits": 3, "misses": 3}

    # the same delay tensors under another tap zone: a miss
    moved = dataclasses.replace(params, chlorine_outlet=dataclasses.replace(
        params.chlorine_outlet, zone_index=2))
    assert dict((s[0], s[1]) for s in FP.sensor_statics(moved, 1.0))[
        "chlorine_outlet"] == 2
    assert FP.sensor_statics(params, 1.0) is changed
    assert delta(before) == {"hits": 4, "misses": 4}


def test_statics_of_inference_tensors_are_read_every_call(fresh_cache):
    with torch.inference_mode():
        params, _ = PL.make_plant(R.ReactorConfiguration(n_zones=5),
                                  device="cpu")
        params = _with_delays(params, ())
    before = counts()
    assert FP.sensor_statics(params, 1.0) == FP.sensor_statics(params, 1.0) \
        == FP._sensor_statics(params, 1.0)
    assert delta(before) == {"hits": 0, "misses": 2}


def test_served_chunks_miss_once_then_hit(fresh_cache):
    params, plant = PL.make_plant(R.ReactorConfiguration(n_zones=5),
                                  device="cpu")
    sched, _ = M.build_chunk_schedule(K.BC, K.BC, 4, 1.0, 0.0, device="cpu")
    before = counts()
    for k in range(3):
        plant = PL.plant_serve_chunk(params, plant, sched, dt=1.0,
                                     substeps=2, seed=5, step0=4 * k).plant
    assert delta(before) == {"hits": 5, "misses": 1}


# every value and host array with no target type, each float type, and
# int32 for the integers (the tables' integer columns)
ON_DEVICE_CASES = [
    (x, dtype) for x in FLOATS + INTS + [[0.1, 0.2, 1e-40],
                                         np.array([1 / 3, 2.5]), [3, 4]]
    for dtype in [None] + DTYPES + [torch.int32]
    if dtype != torch.int32 or all(
        isinstance(v, int) for v in np.atleast_1d(x).tolist())]


@pytest.mark.parametrize("x,dtype", ON_DEVICE_CASES, ids=repr)
def test_on_device_equals_the_copy_from_the_host(x, dtype):
    assert_bits(F.on_device(x, "cpu", dtype), as_tensor_on(x, "cpu", dtype))
    t = torch.arange(3.0)
    assert F.on_device(t, "cpu") is t


@pytest.mark.parametrize("dtype", DTYPES)
def test_scalar_columns_equal_the_former_ones(dtype):
    for x in FLOATS + INTS:
        # B3's: a Python float rounded through the default dtype
        assert_bits(FP._column(x, 4, dtype, "cpu"),
                    as_tensor_on(x, "cpu").to(dtype).reshape(-1).expand(4))
        # B1's: through NumPy, float64 until the cast
        assert_bits(F._column(x, 4, dtype, "cpu"),
                    as_tensor_on(np.asarray(x), "cpu").to(dtype).expand(4))
        # _finish's flow rate
        assert_bits(F.on_device(x, "cpu", dtype),
                    as_tensor_on(x, "cpu", dtype))
    for x in INTS:
        assert_bits(FP._column(x, 4, torch.int32, "cpu"),
                    as_tensor_on(x, "cpu").to(torch.int32).reshape(-1)
                    .expand(4))


def former_rebuild_rings(hist, old_carry, d_max, n_steps, t0, dt, batch,
                         dtype):
    """``_rebuild_rings`` as it was: the kept steps as a host list."""
    device = hist.device
    cap = d_max + 1
    C = int(old_carry.line_values.shape[-1])
    k = min(n_steps, cap, C)
    gs = list(range(n_steps - k, n_steps))
    vals = torch.stack([hist[g % cap] for g in gs]) if gs else \
        hist.new_empty((0, batch))
    t0b = torch.as_tensor(t0, device=device).to(dtype).reshape(-1) \
        .expand(batch)
    times = t0b[None, :] + (torch.tensor(gs, dtype=dtype, device=device)
                            [:, None] + 1.0) * dt
    ref_v, ref_t = old_carry.line_values, old_carry.line_times
    single = ref_v.ndim == 1
    new_v = torch.zeros((batch, C), dtype=ref_v.dtype, device=device)
    new_t = torch.full((batch, C), -math.inf, dtype=ref_t.dtype,
                       device=device)
    new_v[:, :k] = vals.T.to(ref_v.dtype)
    new_t[:, :k] = times.T.to(ref_t.dtype)
    if single:
        new_v, new_t = new_v[0], new_t[0]
    shape = () if single else (batch,)
    count = torch.full(shape, k, dtype=torch.int32, device=device)
    ptr = torch.full(shape, k % C, dtype=torch.int32, device=device)
    return {"line_values": new_v, "line_times": new_t,
            "line_count": count, "line_ptr": ptr}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("n_steps,capacity", [
    (0, 64), (5, 64), (31, 64), (40, 64), (1000, 64), (40, 16), (3, 16),
    (2 ** 25 + 3, 64)])
def test_rebuilt_rings_equal_the_former_ones(dtype, batch, n_steps,
                                             capacity):
    d_max, dt = 30, 0.7
    gen = torch.Generator().manual_seed(n_steps + batch)
    hist = torch.randn((d_max + 1, batch), generator=gen, dtype=dtype)
    shape = (capacity,) if batch == 1 else (batch, capacity)
    old = SimpleNamespace(line_values=torch.zeros(shape, dtype=dtype),
                          line_times=torch.zeros(shape, dtype=dtype))
    t0 = 1e5 * torch.rand((batch,), generator=gen, dtype=dtype) \
        if batch > 1 else torch.tensor(123.25, dtype=dtype)
    got = FP._rebuild_rings(hist, old, d_max, n_steps, t0, dt, batch, dtype)
    want = former_rebuild_rings(hist, old, d_max, n_steps, t0, dt, batch,
                                dtype)
    assert sorted(got) == sorted(want)
    for name in want:
        assert_bits(got[name], want[name])


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in _leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


def _former(monkeypatch):
    """The wrappers as they were: copies from the host, the rings from a
    host list, the statics read every call."""
    monkeypatch.setattr(F, "on_device", as_tensor_on)
    monkeypatch.setattr(FP, "_rebuild_rings", former_rebuild_rings)
    monkeypatch.setattr(FP, "sensor_statics", FP._sensor_statics)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tables_equal_the_former_ones(dtype, monkeypatch, fresh_cache):
    params, plant = K.plant_case(5, 3, dtype, "cpu", delays=True)

    def tables():
        return [FP.build_tables(params, plant, boundary, dt=1.0, n_steps=12)
                for boundary in (K.BC, K.bench_schedule(12),
                                 K.fleet_schedule(12, 3))]

    got = tables()
    _former(monkeypatch)
    want = tables()
    for a, b in zip(got, want):
        assert a.statics == b.statics and a.scheduled == b.scheduled
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want) > 40
    for a, b in zip(got, want):
        assert_bits(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_give_the_former_rollouts(dtype, monkeypatch, fresh_cache):
    """Chained B3 calls, a served chunk shorter than its sample lines and
    a B1 call, through the plain path: bit-equal to the former wrappers."""
    cfg = R.ReactorConfiguration(n_zones=5)
    params, plant = K.plant_case(5, 3, dtype, "cpu", delays=True)
    one_params, one = PL.make_plant(cfg, dtype=dtype, device="cpu")
    sched, _ = M.build_chunk_schedule(
        K.BC, dataclasses.replace(K.BC, acid_flow_rate=0.3), 6, 1.0, 30.0,
        device="cpu")
    mc, state = make_monte_carlo_batch(cfg, 4, seed=2, dtype=dtype,
                                       device="cpu")

    def run():
        a = FP.plant_rollout_fused(params, plant, K.BC, dt=1.0, substeps=2,
                                   n_steps=8, record_every=4, seed=3)
        b = FP.plant_rollout_fused(params, a[0], K.BC, dt=1.0, substeps=2,
                                   n_steps=8, record_every=4, seed=3,
                                   step0=8)
        c = PL.plant_serve_chunk(one_params, one, sched, dt=1.0, substeps=2,
                                 seed=3, step0=6)
        return a, b, c, F.rollout_fused(mc, state, K.BC, dt=1.0,
                                        substeps=2, n_steps=8)

    got = _leaves(run())
    _former(monkeypatch)
    want = _leaves(run())
    assert len(got) == len(want) > 40
    for a, b in zip(got, want):
        assert_bits(a, b)
