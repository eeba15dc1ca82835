"""The port's fused plant rollout (``ops/fused_plant.py``: registries,
``rand_from_words``, Philox, lead-in and ring rebuild, and the plain PyTorch
version of kernel B3) against the JAX package's, on the CPU.

The plain version runs in float32 against the JAX Pallas kernel in interpret
mode, ``plant_rollout_fused(rng="bits", interpret=True)``, on identical
per-plant words: the JAX side gets ``[n, 76, rows, 128]`` planes made with
NumPy from a seed, the port the words that JAX's own ``_unpack_state`` reads
for each plant's zone-0 lane. The cases follow ``tests/test_fused_plant.py``.

Tolerances (float32, observed errors in brackets; the JAX tests themselves
allow physics 2e-5, readings 5e-4, accumulators 1e-5): physics ``PHYS``,
readings and carried values ``READ``, slow accumulators ``ACC``. NaN must
sit in the same places and every status, fault and ring index must be
equal. The lead-in and ring-rebuild helpers must equal JAX's exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL
from ics_wt_physicsengine_tpu.ops import fused_plant as JFP
from ics_wt_physicsengine_tpu.ops.fused_rollout import (_LANES,
                                                        _unpack_state)

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models import plant as TPL
from ics_wt_physicsengine_torch.ops import fused_plant as TFP
from ics_wt_physicsengine_torch.sensors import base as TB

from torch_port_util import assert_tree_close, to_numpy, tree_to_numpy

torch.set_num_threads(1)

F32 = torch.float32
PHYS = 2e-5     # pH, chlorine, temperature after <= 50 steps [0 with RK4
                # and one shared delay, <= 7.7e-6 with RKC2]
READ = 1e-4     # readings, current/last values, ring values [<= 3.5e-5]
ACC = 1e-10     # fouling, wear, potency, drift accumulators [<= 2.2e-12]

BC = dict(inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
          inlet_temperature=26.0, acid_flow_rate=0.1, acid_concentration=0.1,
          ambient_temperature=15.0, heat_loss_coefficient=50.0)
ACCUMULATORS = ("membrane_fouling", "glass_etching", "days_since_cleaning",
                "reference_contamination", "membrane_age_days",
                "reagent_potency", "reagent_age_days", "light_exposure_hours",
                "bearing_wear_days", "electrode_fouling",
                "cold_junction_drift")


# ---------------------------------------------------------------------------
# registries, words, Philox
# ---------------------------------------------------------------------------


def test_registries_equal_jax():
    assert (TFP.N_WORDS, TFP.N_PCOLS, TFP.N_CCOLS) == (76, 98, 122)
    assert (JFP.N_WORDS, JFP.N_PCOLS, JFP.N_CCOLS) == (76, 98, 122)
    for name in ("SENSORS", "_RAND", "_WORD_OFFSET", "_BASE_P", "_OVERLAY_P",
                 "_BASE_C", "_OVERLAY_C", "_PCOLS", "_CCOLS", "_PCOL",
                 "_CCOL", "_LINE_ATTRS"):
        assert getattr(TFP, name) == getattr(JFP, name), name
    for kind in ("ph", "cl", "flow", "temp"):
        assert TFP.words_per_sensor(kind) == JFP.words_per_sensor(kind)
    # the two struct-of-arrays carry tables partition the 122 columns
    assert TFP.N_FLOAT_CCOLS + TFP.N_INT_CCOLS == TFP.N_CCOLS
    assert set(TFP._FLOAT_CCOLS + TFP._INT_CCOLS) == set(TFP._CCOLS)


@pytest.mark.parametrize("n_normals,n_uniforms", [(8, 3), (7, 3), (6, 4),
                                                  (5, 3)])
def test_rand_from_words_matches_jax(n_normals, n_uniforms):
    """Random words and the edges 0, -1 (all ones), INT32_MIN and
    INT32_MAX: uniforms exact (24 bits times 2^-24), normals to a float32
    ulp of the libraries' log/cos/sin."""
    n_words = 2 * ((n_normals + 1) // 2) + n_uniforms
    rng = np.random.default_rng(n_words)
    words = rng.integers(-2 ** 31, 2 ** 31, size=(n_words, 64),
                         dtype=np.int32)
    words[:, :4] = np.array([0, -1, -2 ** 31, 2 ** 31 - 1], np.int32)
    words[1::2, 4:8] = np.array([0, -1, -2 ** 31, 2 ** 31 - 1], np.int32)
    jn, ju = JFP.rand_from_words([jnp.asarray(w) for w in words], n_normals,
                                 n_uniforms)
    tn, tu = TFP.rand_from_words(torch.from_numpy(words), n_normals,
                                 n_uniforms)
    assert tn.shape == (64, n_normals) and tu.shape == (64, n_uniforms)
    np.testing.assert_array_equal(tu.numpy(), np.stack(ju.cols, -1))
    assert 0.0 <= float(tu.min()) and float(tu.max()) < 1.0
    np.testing.assert_allclose(tn.numpy(), np.stack(jn.cols, -1), rtol=0,
                               atol=2e-6)
    assert bool(torch.isfinite(tn).all())     # u1 = 0 clamps to 1e-12
    assert float(tn.abs().max()) < 7.5


def _philox_reference(counter, key):
    """Philox4x32-10 in Python integers, from the published algorithm
    (Salmon et al., SC'11): ten rounds of two 32x32 -> 64 bit multiplies,
    the key bumped by the Weyl constants between rounds."""
    m0, m1, w0, w1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    c, k = list(counter), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + w0) & 0xFFFFFFFF, (k[1] + w1) & 0xFFFFFFFF]
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
    return c


KNOWN_ANSWERS = [       # Random123's kat_vectors for philox4x32 10
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS)
def test_philox_known_answers(counter, key, want):
    assert tuple(_philox_reference(counter, key)) == want
    got = TFP.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(x) for x in got) == want


def test_philox_words_match_the_python_reference():
    """The plain version's word stream: counter (step, plant, block, 0),
    key the 64-bit seed, int32 storage, in ``_WORD_OFFSET`` order."""
    seed, step0, n_steps, batch = 0x123456789ABCDEF, 5, 3, 4
    words = TFP.philox_words(seed, step0, n_steps, batch, "cpu")
    assert words.shape == (n_steps, 76, batch) and words.dtype == torch.int32
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for g in range(n_steps):
        for plant in range(batch):
            want = [w for block in range(19) for w in
                    _philox_reference((step0 + g, plant, block, 0), key)]
            got = [int(w) & 0xFFFFFFFF for w in words[g, :, plant]]
            assert got == want
    # a later chunk continues the same stream; seeds and plants differ
    again = TFP.philox_words(seed, step0 + 1, 2, batch, "cpu")
    assert torch.equal(again, words[1:])
    assert not torch.equal(TFP.philox_words(seed + 1, step0, 1, batch, "cpu"),
                           words[:1])
    assert len({tuple(words[0, :, p].tolist()) for p in range(batch)}) == 4


# ---------------------------------------------------------------------------
# lead-in and ring rebuild: exact
# ---------------------------------------------------------------------------


def _ring_carry(rng, batch, cap, count, ptr, t0):
    """A JAX base carry whose ring holds ``count`` samples ending at
    ``t0``, written in ring order from slot ``ptr - count``."""
    values = np.zeros((batch, cap), np.float32)
    times = np.full((batch, cap), -np.inf, np.float32)
    for b in range(batch):
        for j in range(count[b]):
            slot = (ptr[b] - count[b] + j) % cap
            values[b, slot] = rng.normal(7.0, 0.2)
            times[b, slot] = t0[b] - (count[b] - 1 - j)
    jp = JPL.make_plant(JR.ReactorConfiguration(n_zones=2), seed=0,
                        dtype=jnp.float32)[1].ph_inlet.base
    return dataclasses.replace(
        jp, line_values=values, line_times=times,
        line_count=np.asarray(count, np.int32),
        line_ptr=np.asarray(ptr, np.int32))


@pytest.mark.parametrize("dt", [1.0, 2.0])
def test_resolve_lead_in_equals_jax_exactly(dt):
    """Per-plant delays, rings that are empty, young, wrapped and full, and
    a tie between an incoming and an in-rollout sample."""
    rng = np.random.default_rng(3)
    batch, cap = 6, 100
    count = [0, 8, 40, 100, 100, 3]
    ptr = [0, 8, 40, 37, 0, 3]
    t0 = np.array([50.0, 8.0, 40.0, 500.0, 200.0, 3.0], np.float32)
    delay_s = np.array([30.0, 30.0, 12.0, 30.0, 7.0, 6.0], np.float32)
    jc = _ring_carry(rng, batch, cap, count, ptr, t0)
    tc = convert.sensor_carry_from_numpy(TB.SensorCarry, tree_to_numpy(jc),
                                         dtype=F32, device="cpu")
    d_arr = np.maximum(np.round(delay_s / dt), 0).astype(np.int32)
    d_max = int(d_arr.max())
    want = np.asarray(JFP._resolve_lead_in(
        jc, jnp.asarray(delay_s), jnp.asarray(d_arr), d_max,
        jnp.asarray(t0), dt, batch))
    got = TFP._resolve_lead_in(
        tc, torch.from_numpy(delay_s), torch.from_numpy(d_arr), d_max,
        torch.from_numpy(t0), dt, batch, F32)
    assert got.shape == want.shape == (d_max + 1, batch)
    np.testing.assert_array_equal(got.numpy(), want)      # NaN == NaN here
    assert np.isnan(want[:, 0]).all()                     # empty ring
    assert np.isfinite(want[:, 3]).sum() == d_arr[3]      # full lead-in


def test_resolve_lead_in_single_plant_and_no_line():
    rng = np.random.default_rng(5)
    jc = _ring_carry(rng, 1, 100, [20], [20], np.array([20.0], np.float32))
    jc1 = dataclasses.replace(
        jc, line_values=jc.line_values[0], line_times=jc.line_times[0],
        line_count=jc.line_count[0], line_ptr=jc.line_ptr[0])
    tc1 = convert.sensor_carry_from_numpy(TB.SensorCarry, tree_to_numpy(jc1),
                                          dtype=F32, device="cpu")
    want = np.asarray(JFP._resolve_lead_in(
        jc1, jnp.float32(30.0), jnp.int32(30), 30, jnp.float32(20.0), 1.0,
        1))
    got = TFP._resolve_lead_in(tc1, torch.tensor(30.0), torch.tensor(30), 30,
                               torch.tensor(20.0), 1.0, 1, F32)
    np.testing.assert_array_equal(got.numpy(), want)
    none = TFP._resolve_lead_in(tc1, torch.tensor(0.0), torch.tensor(0), 0,
                                torch.tensor(20.0), 1.0, 1, F32)
    assert none.shape == (1, 1) and bool(torch.isnan(none).all())


@pytest.mark.parametrize("n_steps,d_max", [(35, 30), (12, 30), (250, 30),
                                           (40, 120)])
def test_rebuild_rings_equals_jax_exactly(n_steps, d_max):
    """Rollouts longer and shorter than the delay, and a history larger
    than the ring (capacity 100)."""
    rng = np.random.default_rng(n_steps)
    batch = 3
    jc = _ring_carry(rng, batch, 100, [5, 5, 5], [5, 5, 5],
                     np.zeros(3, np.float32))
    tc = convert.sensor_carry_from_numpy(TB.SensorCarry, tree_to_numpy(jc),
                                         dtype=F32, device="cpu")
    hist = rng.normal(7.0, 0.3, (d_max + 1, batch)).astype(np.float32)
    want = JFP._rebuild_rings(jnp.asarray(hist), jc, d_max, n_steps,
                              jnp.float32(17.0), 1.0, batch, lambda x: x,
                              jnp.float32)
    got = TFP._rebuild_rings(torch.from_numpy(hist), tc, d_max, n_steps,
                             torch.tensor(17.0), 1.0, batch, F32)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
        assert got[name].numpy().dtype == np.asarray(want[name]).dtype


def test_sensor_statics_equal_jax():
    jcfg = JR.ReactorConfiguration(n_zones=5)
    jp, _ = JPL.make_plant_batch(jcfg, 4, seed=1, dtype=jnp.float32)
    jp = dataclasses.replace(
        jp, ph_inlet=dataclasses.replace(
            jp.ph_inlet, zone_index=2, base=dataclasses.replace(
                jp.ph_inlet.base,
                line_delay_s=np.array([3.0, 10.5, 0.0, 24.5], np.float32))))
    tp = convert.plant_params_from_numpy(tree_to_numpy(jp), dtype=F32,
                                         device="cpu")
    for dt in (1.0, 2.0):       # 10.5 and 24.5 round half to even
        assert TFP.sensor_statics(tp, dt) == JFP.sensor_statics(jp, dt)
    bad = dataclasses.replace(tp, temp_outlet=dataclasses.replace(
        tp.temp_outlet, zone_index=5))
    with pytest.raises(ValueError, match="zone_index"):
        TFP.sensor_statics(bad, 1.0)


# ---------------------------------------------------------------------------
# the plain version against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------


def _planes(seed, n_steps):
    rng = np.random.default_rng(seed)
    return rng.integers(-2 ** 31, 2 ** 31,
                        size=(n_steps, JFP.N_WORDS, 8, _LANES),
                        dtype=np.int32)


def _plant_words(planes, batch, n_zones):
    """``[n_steps, 76, B]`` per-plant words: what the JAX kernel reads on
    each plant's zone-0 lane, by its own unpacking."""
    per_row = _LANES // n_zones
    unpack = jax.vmap(jax.vmap(
        lambda plane: _unpack_state(plane, batch, n_zones, per_row)[:, 0]))
    return torch.from_numpy(np.array(unpack(jnp.asarray(planes))))


def _to_port(jp, js):
    tp = convert.plant_params_from_numpy(tree_to_numpy(jp), dtype=F32,
                                         device="cpu")
    ts = convert.plant_state_from_numpy(tree_to_numpy(js), dtype=F32,
                                        device="cpu")
    return tp, ts


def _err(port, ref):
    """Largest absolute difference; NaN must sit in the same places."""
    a, b = to_numpy(port), np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
        return 0.0
    with np.errstate(invalid="ignore"):
        d = np.where(np.isnan(a) | (a == b), 0.0, np.abs(a - b))
    return float(d.max()) if d.size else 0.0


def _compare(got, want):
    """``(plant, readings)`` of the port against JAX's: the worst physics,
    reading and accumulator errors, with every integer, boolean and ring
    index equal."""
    (tplant, treadings), (jplant, jreadings) = got, want
    phys = max(_err(getattr(tplant.reactor, f), getattr(jplant.reactor, f))
               for f in ("pH", "chlorine", "temperature"))
    assert _err(tplant.reactor.time, jplant.reactor.time) == 0.0
    assert _err(tplant.reactor.flow_rate, jplant.reactor.flow_rate) <= 1e-6
    read = max(_err(treadings[name], jreadings[name])
               for name, _, _ in TFP.SENSORS)
    acc = 0.0
    for _, attr, _ in TFP.SENSORS:
        tc, jc = getattr(tplant, attr), getattr(jplant, attr)
        for f in dataclasses.fields(tc):
            if f.name == "base":
                continue
            e = _err(getattr(tc, f.name), getattr(jc, f.name))
            if f.name in ACCUMULATORS:
                acc = max(acc, e)
            else:
                assert e == 0.0, (attr, f.name)     # constants pass through
        for f in dataclasses.fields(tc.base):
            e = _err(getattr(tc.base, f.name), getattr(jc.base, f.name))
            if f.name in ("current_value", "last_value", "supply_voltage",
                          "line_values"):
                read = max(read, e)
            else:
                assert e == 0.0, (attr, f.name)     # times, codes, indices
    return dict(phys=phys, read=read, acc=acc)


def _check(errs):
    assert errs["phys"] <= PHYS and errs["read"] <= READ \
        and errs["acc"] <= ACC, errs


def _both(jp, js, tp, ts, jbc, tbc, planes, n_zones, batch, *, dt=1.0,
          substeps, n_steps, **kw):
    want = JFP.plant_rollout_fused(jp, js, jbc, dt=dt, substeps=substeps,
                                   n_steps=n_steps, rng="bits", bits=planes,
                                   interpret=True, **kw)
    got = TFP.plant_rollout_fused(
        tp, ts, tbc, dt=dt, substeps=substeps, n_steps=n_steps, rng="bits",
        bits=_plant_words(planes, batch, n_zones), **kw)
    return got, want


@pytest.mark.parametrize("batch", [None, 5])
def test_slice_as_a_whole_matches_jax_kernel(batch):
    """make_plant / make_plant_batch -> plant_rollout_fused -> readings,
    each side with its own constructors (single plant and a batch of 5)."""
    jcfg, tcfg = JR.ReactorConfiguration(n_zones=5), \
        TR.ReactorConfiguration(n_zones=5)
    substeps = JR.default_substeps(jcfg, 1.0)
    if batch is None:
        jp, js = JPL.make_plant(jcfg, seed=3, dtype=jnp.float32)
        tp, ts = TPL.make_plant(tcfg, dtype=F32, device="cpu")
    else:
        jp, js = JPL.make_plant_batch(jcfg, batch, seed=3, dtype=jnp.float32)
        tp, ts = TPL.make_plant_batch(tcfg, batch, seed=3, dtype=F32,
                                      device="cpu")
    got, want = _both(jp, js, tp, ts, JR.BoundaryConditions(**BC),
                      TR.BoundaryConditions(**BC), _planes(0, 12), 5,
                      batch or 1, substeps=substeps, n_steps=12)
    _check(_compare(got, want))
    shape = (12,) if batch is None else (12, batch)
    assert got[1]["pH_outlet"].shape == shape
    assert list(got[1]) == [name for name, _, _ in TFP.SENSORS]


CASES = {
    # crosses the 30-step pH and temperature line delay
    "line-delay": dict(n_zones=4, n_steps=40, seed=4),
    # RKC2 physics inside the fused step
    "rkc-fast": dict(n_zones=5, n_steps=12, seed=7, rkc=True),
    # dt = 2 s: round(30 / 2) = 15 steps of delay
    "nonunit-dt": dict(n_zones=4, n_steps=40, seed=6, dt=2.0),
    # per-plant line delays, whole multiples of dt
    "hetero-delays": dict(n_zones=4, n_steps=30, seed=17, batch=5, delays={
        "ph_inlet": [3.0, 10.0, 0.0, 25.0, 7.0],
        "ph_outlet": [12.0, 12.0, 5.0, 1.0, 0.0],
        "temp_inlet": [0.0, 4.0, 9.0, 2.0, 18.0]}),
    # sensors on interior zones
    "zone-taps": dict(n_zones=5, n_steps=12, seed=23, taps={
        "ph_inlet": 2, "chlorine_inlet": 3, "temp_outlet": -4}),
    # the bench schedule, recorded every step
    "scheduled": dict(n_zones=4, n_steps=50, seed=9, scheduled=True),
    # decimated recording
    "record-every-4": dict(n_zones=5, n_steps=12, seed=2, record_every=4),
}


def _case_plant(spec):
    jcfg = JR.ReactorConfiguration(n_zones=spec["n_zones"])
    batch = spec.get("batch")
    if batch is None:
        jp, js = JPL.make_plant(jcfg, seed=11, dtype=jnp.float32)
    else:
        jp, js = JPL.make_plant_batch(jcfg, batch, seed=21,
                                      dtype=jnp.float32)
    for attr, delays in spec.get("delays", {}).items():
        sp = getattr(jp, attr)
        jp = dataclasses.replace(jp, **{attr: dataclasses.replace(
            sp, base=dataclasses.replace(
                sp.base, line_delay_s=np.asarray(delays, np.float32)))})
    for attr, zone in spec.get("taps", {}).items():
        jp = dataclasses.replace(jp, **{attr: dataclasses.replace(
            getattr(jp, attr), zone_index=zone)})
    return jcfg, jp, js


def _bench_schedule(n_steps):
    t = np.arange(n_steps)
    return dict(
        inlet_flow_rate=(5.0 + 2.0 * np.sin(2 * np.pi * t / 17.0)
                         ).astype(np.float32),
        inlet_pH=7.2,
        inlet_chlorine=np.where(t % 10 < 5, 0.5, 1.5).astype(np.float32),
        acid_flow_rate=np.where(t % 8 < 4, 0.0, 0.3).astype(np.float32),
        ambient_temperature=15.0, heat_loss_coefficient=50.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_kernel(case):
    spec = CASES[case]
    jcfg, jp, js = _case_plant(spec)
    tp, ts = _to_port(jp, js)
    dt, n_steps = spec.get("dt", 1.0), spec["n_steps"]
    if spec.get("rkc"):
        substeps, stages = JR.default_rkc_plan(jcfg, dt, mode="fast")
    else:
        substeps, stages = JR.default_substeps(jcfg, dt), None
    bc = _bench_schedule(n_steps) if spec.get("scheduled") else BC
    got, want = _both(
        jp, js, tp, ts, JR.BoundaryConditions(**bc),
        TR.BoundaryConditions(**bc), _planes(spec["seed"], n_steps),
        spec["n_zones"], spec.get("batch") or 1, dt=dt, substeps=substeps,
        n_steps=n_steps, stages=stages,
        record_every=spec.get("record_every", 1))
    _check(_compare(got, want))
    n_rec = n_steps // spec.get("record_every", 1)
    assert got[1]["flow_main"].shape[0] == n_rec
    if spec.get("scheduled"):       # flow_rate from the last schedule row
        assert float(got[0].reactor.flow_rate) == pytest.approx(
            float(bc["inlet_flow_rate"][-1] + bc["acid_flow_rate"][-1]))


@pytest.fixture(scope="module")
def populated():
    """Eight ``plant_step`` steps of the JAX package fill the sample-line
    rings of a three-plant batch with per-plant delays."""
    spec = dict(n_zones=4, batch=3, delays={
        "ph_inlet": [4.0, 20.0, 11.0], "temp_outlet": [0.0, 7.0, 25.0]})
    jcfg, jp, js = _case_plant(spec)
    substeps = JR.default_substeps(jcfg, 1.0)
    words = _plant_words(_planes(29, 8), 3, 4).numpy()
    jbc = JR.BoundaryConditions(**BC)

    def rand_of(w):
        rand = {}
        for rname, attr, kind in JFP.SENSORS:
            w0 = JFP._WORD_OFFSET[attr]
            normals, uniforms = JFP.rand_from_words(
                [jnp.asarray(w[w0 + k])
                 for k in range(JFP.words_per_sensor(kind))], *JFP._RAND[kind])
            rand[rname] = (jnp.stack(normals.cols, -1),
                           jnp.stack(uniforms.cols, -1))
        return rand

    step = jax.jit(jax.vmap(
        lambda p, s, r: JPL.plant_step(p, s, jbc, 1.0, substeps, rand=r)))
    for w in words:
        js, _ = step(jp, js, rand_of(w))
    assert np.asarray(js.ph_inlet.base.line_count).tolist() == [8, 8, 8]
    return jcfg, jp, js, substeps


def test_incoming_ring_is_consumed_as_in_jax(populated):
    """The hard corner of the JAX tests: a schedule, per-plant delays and
    lead-in from rings that ``plant_step`` filled; then
    ``consume_line=False`` starts every line afresh on both sides."""
    jcfg, jp, js, substeps = populated
    tp, ts = _to_port(jp, js)
    n_steps = 40
    t = np.arange(n_steps)
    sched = dict(
        inlet_flow_rate=(5.0 + 2.0 * np.sin(2 * np.pi * t / 13.0)
                         ).astype(np.float32),
        inlet_pH=7.2,
        inlet_chlorine=np.where(t % 9 < 4, 0.5, 1.2).astype(np.float32),
        acid_flow_rate=np.where(t % 7 < 3, 0.0, 0.2).astype(np.float32))
    args = (jp, js, tp, ts, JR.BoundaryConditions(**sched),
            TR.BoundaryConditions(**sched), _planes(37, n_steps), 4, 3)
    got, want = _both(*args, substeps=substeps, n_steps=n_steps)
    _check(_compare(got, want))
    fresh, jfresh = _both(*args, substeps=substeps, n_steps=n_steps,
                          consume_line=False)
    _check(_compare(fresh, jfresh))
    assert not torch.allclose(torch.nan_to_num(fresh[1]["pH_inlet"]),
                              torch.nan_to_num(got[1]["pH_inlet"]))


def test_rings_are_written_back_for_the_step_loop():
    """35 fused steps, then 20 ``plant_step`` steps on the rebuilt rings,
    equal 55 ``plant_step`` steps on the same words (the port's own chain;
    the fused line's documented differences cannot show without a fault,
    so the fault rolls are held off)."""
    cfg = TR.ReactorConfiguration(n_zones=4)
    tp, ts = TPL.make_plant(cfg, dtype=torch.float64, device="cpu")
    substeps = TR.default_substeps(cfg, 1.0)
    k1, k2 = 35, 20
    words = _plant_words(_planes(41, k1 + k2), 1, 4)
    for _, attr, kind in TFP.SENSORS:       # fault roll: u = 0.5
        n_normals, _ = TFP._RAND[kind]
        words[:, TFP._WORD_OFFSET[attr] + 2 * ((n_normals + 1) // 2) + 1] = \
            2 ** 30
        words[:, TFP._WORD_OFFSET[attr]] = 2 ** 30    # calm supply voltage
    bc = TR.BoundaryConditions(**BC)

    def loop(plant, block):
        rows = []
        for w in block:
            rand = {}
            for rname, attr, kind in TFP.SENSORS:
                w0 = TFP._WORD_OFFSET[attr]
                n, u = TFP.rand_from_words(
                    w[w0:w0 + TFP.words_per_sensor(kind)], *TFP._RAND[kind],
                    dtype=torch.float64)
                rand[rname] = (n[0], u[0])
            plant, out = TPL.plant_step(tp, plant, bc, 1.0, substeps,
                                        rand=rand)
            rows.append({k: v.value for k, v in out.items()})
        return plant, rows

    fused, _ = TFP.plant_rollout_fused(tp, ts, bc, dt=1.0, substeps=substeps,
                                       n_steps=k1, rng="bits",
                                       bits=words[:k1].contiguous())
    assert int(fused.ph_inlet.base.line_count) == 31
    _, tail_fused = loop(fused, words[k1:])
    looped, _ = loop(ts, words[:k1])
    _, tail_loop = loop(looped, words[k1:])
    for a, b in zip(tail_fused, tail_loop):
        for name in a:
            np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                       rtol=0, atol=1e-9, err_msg=name)


def test_ring_write_back_matches_jax():
    """35 fused steps on both sides: the rebuilt rings (values, times,
    count, pointer) of all four lines agree, ``_compare`` holding times
    and indices to equality."""
    spec = dict(n_zones=4, n_steps=35, seed=41)
    jcfg, jp, js = _case_plant(spec)
    tp, ts = _to_port(jp, js)
    got, want = _both(jp, js, tp, ts, JR.BoundaryConditions(**BC),
                      TR.BoundaryConditions(**BC), _planes(41, 35), 4, 1,
                      substeps=JR.default_substeps(jcfg, 1.0), n_steps=35)
    _check(_compare(got, want))
    base = got[0].ph_outlet.base
    assert int(base.line_count) == 31 and int(base.line_ptr) == 31
    assert float(base.line_times[30]) == 35.0


def test_philox_mode_runs_and_is_reproducible():
    """``rng="philox"`` (the default) equals ``rng="bits"`` on the words
    ``philox_words`` gives for that seed, and differs for another seed."""
    cfg = TR.ReactorConfiguration(n_zones=5)
    tp, ts = TPL.make_plant_batch(cfg, 3, seed=2, device="cpu")
    kw = dict(dt=1.0, substeps=2, n_steps=8, record_every=2)
    bc = TR.BoundaryConditions(**BC)
    a = TFP.plant_rollout_fused(tp, ts, bc, seed=9, **kw)
    b = TFP.plant_rollout_fused(
        tp, ts, bc, rng="bits", bits=TFP.philox_words(9, 0, 8, 3, "cpu"),
        **kw)
    c = TFP.plant_rollout_fused(tp, ts, bc, seed=10, **kw)
    assert_tree_close(a[0], b[0], atol=0.0)
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name])
    assert not torch.equal(a[1]["pH_inlet"], c[1]["pH_inlet"])
    assert TFP.LAUNCHES == {"plant_rollout_fused": 0,     # no card, no launch
                            "pack_tables": 0}


# ---------------------------------------------------------------------------
# rejection contracts
# ---------------------------------------------------------------------------


def test_rejection_contracts():
    cfg = TR.ReactorConfiguration(n_zones=5)
    tp, ts = TPL.make_plant(cfg, device="cpu")
    bc = TR.BoundaryConditions(**BC)
    kw = dict(dt=1.0, substeps=2, n_steps=6)
    words = torch.zeros((6, 76, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        TFP.plant_rollout_fused(tp, ts, bc, record_every=4, **kw)
    with pytest.raises(ValueError, match="multiple"):
        TFP.plant_rollout_fused(tp, ts, bc, record_every=0, **kw)
    with pytest.raises(ValueError, match="unknown rng"):
        TFP.plant_rollout_fused(tp, ts, bc, rng="hw", **kw)
    with pytest.raises(ValueError, match="bits"):
        TFP.plant_rollout_fused(tp, ts, bc, rng="bits", **kw)
    with pytest.raises(ValueError, match="bits"):
        TFP.plant_rollout_fused(tp, ts, bc, bits=words, **kw)
    with pytest.raises(ValueError, match="int32"):
        TFP.plant_rollout_fused(tp, ts, bc, rng="bits", bits=words[:5], **kw)
    with pytest.raises(ValueError, match="int32"):
        TFP.plant_rollout_fused(tp, ts, bc, rng="bits", bits=words.long(),
                                **kw)
    sched = TR.BoundaryConditions(**dict(BC, inlet_pH=np.full(5, 7.0)))
    with pytest.raises(ValueError, match="n_steps=6"):
        TFP.plant_rollout_fused(tp, ts, sched, **kw)
    for axis in TR.EXTENSION_AXES:
        ext = dataclasses.replace(tp, reactor=dataclasses.replace(
            tp.reactor, **{axis: object()}))
        assert "extensions" in TFP.unsupported_reason(ext)
        with pytest.raises(ValueError, match="extensions"):
            TFP.plant_rollout_fused(ext, ts, bc, **kw)
    ext = dataclasses.replace(tp, ammonia_outlet=object())
    with pytest.raises(ValueError, match="extensions"):
        TFP.plant_rollout_fused(ext, ts, bc, **kw)
    wide = dataclasses.replace(tp, reactor=dataclasses.replace(
        tp.reactor, n_zones=129))
    with pytest.raises(ValueError, match="128"):
        TFP.plant_rollout_fused(wide, ts, bc, **kw)
    assert TFP.unsupported_reason(tp) is None
    off = dataclasses.replace(tp, ph_inlet=dataclasses.replace(
        tp.ph_inlet, zone_index=-6))
    with pytest.raises(ValueError, match="zone_index"):
        TFP.plant_rollout_fused(off, ts, bc, **kw)
    # the kernel launcher takes CUDA tables only
    tables = TFP.build_tables(tp, ts, bc, dt=1.0, n_steps=6)
    with pytest.raises(ValueError, match="CUDA"):
        TFP.plant_kernel(tables, dt=1.0, substeps=2, n_steps=6)
    with pytest.raises(ValueError, match="CUDA"):
        TFP.philox_words_kernel(0, 1, 1, "cpu")
