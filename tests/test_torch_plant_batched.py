"""The port's ``models.plant.plant_rollout_batched`` against the JAX
package's on the CPU, in float64.

- ``line_mode="exact"`` with ``rng_mode="per-sensor"`` is, step for step,
  a loop of the port's ``plant_step_batched``: bit-equal with generators
  seeded alike.
- With the same draws on both sides, the ``"tap"``, ``"exact"`` and
  ``"auto"`` readings (NaN positions included) and the final plant equal
  the JAX package's within ``ATOL`` 1e-10, with constant forcing and with a
  schedule. The draws are NumPy's from a seed, with an open or short
  circuit in about one read in 25 so that faults and NaN latches occur.
  The port takes them as ``rand=``, a list of per-step dicts; the JAX
  package's rollout is run as written, with ``draw_packed_rand`` replaced
  by a lookup of the step's draws from its per-step key (the JAX rollout
  folds the step index into one root key: ``models/plant.py:687-696``).
- Every ``ValueError`` of the argument checks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models import plant as TPL

from torch_port_util import assert_tree_close, to_numpy, tree_to_numpy

torch.set_num_threads(1)

ATOL = 1e-10
F64 = torch.float64
DT = 10.0          # a 30 s sample line is a 3-step tap
N_STEPS = 8
BATCH = 3
BC = dict(inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
          inlet_temperature=26.0, acid_flow_rate=0.1,
          ambient_temperature=15.0, heat_loss_coefficient=50.0)
LAYOUT = JPL._RAND_LAYOUT


def plants(n_zones=5, seed=1):
    kw = dict(n_zones=n_zones, enable_thermal_stratification=True)
    jp, js = JPL.make_plant_batch(JR.ReactorConfiguration(**kw), BATCH,
                                  seed=seed, dtype=jnp.float64)
    tp = convert.plant_params_from_numpy(tree_to_numpy(jp), dtype=F64,
                                         device="cpu")
    ts = convert.plant_state_from_numpy(tree_to_numpy(js), dtype=F64,
                                        device="cpu")
    substeps = JR.default_substeps(JR.ReactorConfiguration(**kw), DT)
    return (jp, js), (tp, ts), substeps


def step_draws(seed):
    """``N_STEPS`` steps of packed draws for the seven instruments as NumPy
    arrays, ``[N_STEPS, BATCH, k]`` per sensor."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, n_normals, n_uniforms in LAYOUT:
        u = rng.random((N_STEPS, BATCH, n_uniforms))
        u[..., 1] = np.where(rng.random((N_STEPS, BATCH)) < 0.04, 0.0, 0.5)
        out[name] = (rng.standard_normal((N_STEPS, BATCH, n_normals)), u)
    return out


def port_rand(draws):
    return [{name: tuple(torch.from_numpy(x[j]) for x in v)
             for name, v in draws.items()} for j in range(N_STEPS)]


def jax_rollout(monkeypatch, jp, js, draws, substeps, **kw):
    """JAX's ``plant_rollout_batched`` with each step's packed draws taken
    from ``draws``: the step is found by matching the key the rollout
    passes with the keys it derives (``fold_in(root, j)``)."""
    key0 = js.ph_inlet.base.key.reshape(-1)[0]
    root = jax.random.fold_in(jax.random.fold_in(key0, N_STEPS), 0)
    table = jnp.stack([jax.random.key_data(jax.random.fold_in(root, j))
                       for j in range(N_STEPS)])
    stacked = {name: tuple(jnp.asarray(x) for x in v)
               for name, v in draws.items()}

    def lookup(key, batch_shape, dtype):
        j = jnp.argmax(jnp.all(jax.random.key_data(key) == table, axis=-1))
        return {name: (n[j], u[j]) for name, (n, u) in stacked.items()}

    monkeypatch.setattr(JPL, "draw_packed_rand", lookup)
    return JPL.plant_rollout_batched(jp, js, JR.BoundaryConditions(**BC),
                                     DT, substeps, N_STEPS, **kw)


def assert_readings_close(got, want):
    assert set(got) == set(want)
    for name in want:
        a, b = to_numpy(got[name]), np.asarray(want[name])
        assert a.shape == b.shape == (N_STEPS, BATCH), name
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, equal_nan=True,
                                   err_msg=name)


def schedule(lib):
    """A dosing program: acid stepped up, chlorine pulsed."""
    acid = np.where(np.arange(N_STEPS) < 4, 0.05, 0.3)
    chlorine = np.where(np.arange(N_STEPS) % 3 == 0, 0.2, 0.0)
    kw = dict(BC, acid_flow_rate=acid, chlorine_flow_rate=chlorine)
    if lib == "jax":
        return JR.BoundaryConditions(**{
            k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()})
    return TR.BoundaryConditions(**{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})


def test_exact_per_sensor_is_a_loop_of_plant_step_batched():
    _, (tp, ts), substeps = plants()
    bc = TR.BoundaryConditions(**BC)
    got, readings = TPL.plant_rollout_batched(
        tp, ts, bc, DT, substeps, N_STEPS, line_mode="exact",
        rng_mode="per-sensor", generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    plant, rows = ts, []
    for _ in range(N_STEPS):
        plant, out = TPL.plant_step_batched(tp, plant, bc, DT, substeps,
                                            generator=gen)
        rows.append({k: v.value for k, v in out.items()})
    assert_tree_close(got, plant, atol=0.0)
    for name in readings:
        want = torch.stack([r[name] for r in rows])
        assert torch.equal(readings[name].nan_to_num(7.0),
                           want.nan_to_num(7.0)), name


@pytest.mark.parametrize("line_mode", ["tap", "exact", "auto"])
@pytest.mark.parametrize("forcing", ["constant", "schedule"])
def test_readings_match_jax_with_the_same_draws(monkeypatch, line_mode,
                                                forcing):
    (jp, js), (tp, ts), substeps = plants(seed=2)
    draws = step_draws(7)
    kw = dict(line_mode=line_mode, rng_mode="packed")
    jkw = dict(kw, schedule=schedule("jax")) if forcing == "schedule" \
        else kw
    tkw = dict(kw, schedule=schedule("torch")) if forcing == "schedule" \
        else kw
    jplant, jread = jax_rollout(monkeypatch, jp, js, draws, substeps, **jkw)
    plant, readings = TPL.plant_rollout_batched(
        tp, ts, TR.BoundaryConditions(**BC), DT, substeps, N_STEPS,
        rand=port_rand(draws), **tkw)
    assert_readings_close(readings, jread)
    # every field of the plant (the port has no PRNG keys to compare)
    assert_tree_close(plant, jplant, atol=ATOL)
    nan = sum(int(torch.isnan(v).sum()) for v in readings.values())
    assert nan > 0          # the faults the draws roll reach the readings


def test_tap_and_exact_differ_only_where_the_line_does():
    (_, _), (tp, ts), substeps = plants(seed=3)
    rand = port_rand(step_draws(8))
    bc = TR.BoundaryConditions(**BC)
    out = {mode: TPL.plant_rollout_batched(tp, ts, bc, DT, substeps,
                                           N_STEPS, line_mode=mode,
                                           rand=rand)[1]
           for mode in ("tap", "exact")}
    taps = TPL._static_line_taps(tp, DT)
    assert taps == {"pH_inlet": 3, "pH_outlet": 3, "temp_inlet": 3,
                    "temp_outlet": 3}
    for name in ("chlorine_inlet", "chlorine_outlet", "flow_main"):
        assert torch.equal(out["tap"][name].nan_to_num(7.0),
                           out["exact"][name].nan_to_num(7.0)), name
    explicit = TPL.plant_rollout_batched(tp, ts, bc, DT, substeps, N_STEPS,
                                         line_mode="tap", line_taps=taps,
                                         rand=rand)[1]
    for name in explicit:
        assert torch.equal(explicit[name].nan_to_num(7.0),
                           out["tap"][name].nan_to_num(7.0)), name
    plant, none = TPL.plant_rollout_batched(tp, ts, bc, DT, substeps,
                                            N_STEPS, record=False,
                                            rand=rand)
    assert none is None and plant.reactor.pH.shape == (BATCH, 5)


def test_argument_checks():
    _, (tp, ts), substeps = plants()
    bc = TR.BoundaryConditions(**BC)

    def run(**kw):
        args = dict(params=tp, plant=ts, boundary=bc, dt=DT,
                    substeps=substeps, n_steps=N_STEPS)
        args.update(kw)
        return TPL.plant_rollout_batched(**args)

    with pytest.raises(ValueError, match="unknown line_mode"):
        run(line_mode="ring")
    with pytest.raises(ValueError, match="unknown rng_mode"):
        run(rng_mode="threefry")
    with pytest.raises(ValueError, match="unknown line_taps names"):
        run(line_taps={"chlorine_outlet": 2})
    with pytest.raises(ValueError, match="rand holds 2 steps"):
        run(rand=port_rand(step_draws(1))[:2])
    with pytest.raises(ValueError, match="disagree with n_steps"):
        run(schedule=TR.BoundaryConditions(
            acid_flow_rate=torch.zeros(N_STEPS + 1, dtype=F64)))
    # delays that differ across the batch: no tap ("auto" keeps the ring)
    base = tp.ph_inlet.base
    delays = base.line_delay_s * torch.arange(1.0, BATCH + 1, dtype=F64)

    def varied(sp):
        return dataclasses.replace(sp, base=dataclasses.replace(
            sp.base, line_delay_s=delays))

    tv = dataclasses.replace(tp, **{f: varied(getattr(tp, f)) for _, f in
                                    TPL._LINE_SENSORS})
    assert TPL._static_line_taps(tv, DT) == {}
    with pytest.raises(ValueError, match="same for every plant"):
        run(params=tv, line_mode="tap")
    rand = port_rand(step_draws(2))
    auto = run(params=tv, rand=rand)[1]
    exact = run(params=tv, line_mode="exact", rand=rand)[1]
    for name in auto:
        assert torch.equal(auto[name].nan_to_num(7.0),
                           exact[name].nan_to_num(7.0)), name
