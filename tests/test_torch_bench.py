"""The port's repository bench (``ics_wt_physicsengine_torch/bench.py``) on
the CPU.

Each row's inputs (its ``*_inputs``) against ``bench.py``'s own lines
(copied here) in the JAX package, both in float64: the inputs bit-equal where both build
them in NumPy, and 20 steps through JAX's plain ``rollout`` /
``rollout_scheduled`` / ``rollout_closed_loop`` and the port's within
1e-10 (the reactor parity tests' tolerance). The wide ensembles step a
slice of their plants. No interpret-mode Pallas. Then ``main`` at
``--quick`` on the CPU: one JSON line carrying every key of
``bench.py``'s ``extra`` (``philox_prng_*`` for ``hw_prng_*``); the card
asked for where there is none; and the budget rule of ``_timed_chained``."""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu import control as JC
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL
from ics_wt_physicsengine_tpu.models.monte_carlo import (
    make_monte_carlo_batch as j_make_monte_carlo_batch)

from ics_wt_physicsengine_torch import bench as B
from ics_wt_physicsengine_torch import control as TC
from ics_wt_physicsengine_torch.core import reactor as TR

from torch_port_util import tree_to_numpy

torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")
DT = 1.0
ATOL = 1e-10
N = 20                      # steps of every parity run
FIELDS = ("pH", "chlorine", "temperature")

# bench.py:760-791's extra keys, hw_prng_* as philox_prng_*
BENCH_PY_EXTRA = (
    "single_plant_steps_per_sec_rkc_fast", "rkc_fast_vs_baseline",
    "batched_plant_steps_per_sec", "batched_plant_steps_per_sec_rkc_fast",
    "batched_n_plants", "batched_n_plants_rkc",
    "full_chemistry_plant_steps_per_sec", "full_chemistry_n_plants",
    "full_chemistry_axes", "integrated_plant_steps_per_sec",
    "integrated_n_plants", "integrated_single_steps_per_sec",
    "integrated_single_steps_per_sec_rkc_fast",
    "integrated_hil_scheduled_steps_per_sec",
    "scheduled_forcing_steps_per_sec", "closed_loop_plant_steps_per_sec",
    "closed_loop_n_gains", "ekf_filter_steps_per_sec", "ekf_n_filters",
    "ekf_state_dim", "enkf_member_steps_per_sec", "enkf_n_members",
    "surrogate_steps_per_sec", "surrogate_n_batch",
    "surrogate_train_steps_per_sec", "surrogate_compute_dtype", "backend",
    "device", "philox_prng_reads", "philox_prng_value_mean_delta_vs_oracle",
    "philox_prng_value_std", "oracle_value_std",
    "philox_prng_nan_fault_rate", "oracle_nan_fault_rate", "philox_prng_ok",
    "noise_sigma_config")
NEW_KEYS = ("batched_plant_steps_per_sec_kernel",
            "batched_plant_steps_per_sec_rkc_fast_kernel",
            "integrated_plant_steps_per_sec_kernel", "reduced", "rows")


def assert_states_close(port, ref, fields=FIELDS):
    for name in fields:
        np.testing.assert_allclose(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=0, atol=ATOL, err_msg=name)


def assert_same_arrays(port, ref, path="", atol=0.0):
    """Every field of a port dataclass equal to the JAX one's NumPy value
    (bit for bit unless ``atol``; None and Python values equal)."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), ref[f.name]
        where = f"{path}.{f.name}"
        if dataclasses.is_dataclass(a):
            assert_same_arrays(a, b, where, atol)
        elif isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=atol, err_msg=where)
        else:
            assert a == b, where


def head_port(tree, n, k):
    """The first ``k`` plants of a port dataclass batch of ``n``."""
    def cut(x):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: cut(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        if isinstance(x, torch.Tensor) and x.ndim and x.shape[0] == n:
            return x[:k]
        return x
    return cut(tree)


def head_jax(tree, n, k):
    return jax.tree_util.tree_map(
        lambda x: x[:k] if getattr(x, "ndim", 0) and x.shape[0] == n else x,
        tree)


@pytest.mark.parametrize("integrator", ["rk4", "rkc_fast"])
def test_single_plant_inputs_match_bench_py(integrator):
    # bench.py:57-67
    config = JR.ReactorConfiguration(
        volume=1000, height=2.0, diameter=0.798, n_zones=20,
        flow_rate=5.0, initial_pH=7.0, initial_chlorine=2.0, temperature=20.0)
    substeps = JR.default_substeps(config, DT)
    params, state = (JR.make_params(config, dtype=jnp.float64),
                     JR.make_initial_state(config, dtype=jnp.float64))
    bc = JR.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
        inlet_temperature=26.0, acid_flow_rate=0.1,
        ambient_temperature=15.0, heat_loss_coefficient=50.0)
    m, s = JR.default_rkc_plan(config, DT, mode="fast")

    tcfg, tp, ts, tbc = B.single_plant_inputs(dtype=F64, device=CPU)
    assert TR.default_substeps(tcfg, DT) == substeps
    assert TR.default_rkc_plan(tcfg, DT, mode="fast") == (m, s)
    assert dataclasses.asdict(tbc) == dataclasses.asdict(bc)
    sub, st = (substeps, None) if integrator == "rk4" else (m, s)
    want = JR.rollout(params, state, bc, DT, sub, N, record=False,
                      stages=st)[0]
    got = TR.rollout(tp, ts, tbc, DT, sub, N, record=False, stages=st)[0]
    assert_states_close(got, want)


def jax_bench_schedule(n_steps, **constant):
    # bench.py:292-299 (and, without the constants, :248-256)
    t = np.arange(n_steps)
    return JR.BoundaryConditions(
        inlet_flow_rate=(5.0 + 2.0 * np.sin(2 * np.pi * t / 17.0)
                         ).astype(np.float32),
        inlet_pH=7.2,
        inlet_chlorine=np.where(t % 10 < 5, 0.5, 1.5).astype(np.float32),
        acid_flow_rate=np.where(t % 8 < 4, 0.0, 0.3).astype(np.float32),
        **constant)


def as_float64(schedule):
    """A schedule's float32 arrays as float64 (exactly), so that both
    packages step it in float64 alone."""
    return type(schedule)(**{
        f.name: (np.asarray(getattr(schedule, f.name), np.float64)
                 if np.ndim(getattr(schedule, f.name)) else
                 getattr(schedule, f.name))
        for f in dataclasses.fields(schedule)})


def test_scheduled_inputs_match_bench_py():
    # bench.py:287-299
    config = JR.ReactorConfiguration(volume=1000, height=2.0,
                                     diameter=0.798, n_zones=20)
    m, s = JR.default_rkc_plan(config, DT, mode="fast")
    params = JR.make_params(config, dtype=jnp.float64)
    state = JR.make_initial_state(config, dtype=jnp.float64)
    sched = jax_bench_schedule(N, ambient_temperature=15.0,
                               heat_loss_coefficient=50.0)

    tcfg, tp, ts, tsched = B.scheduled_inputs(N, dtype=F64, device=CPU)
    assert TR.default_rkc_plan(tcfg, DT, mode="fast") == (m, s)
    for f in dataclasses.fields(tsched):
        np.testing.assert_array_equal(getattr(tsched, f.name),
                                      getattr(sched, f.name))
    want = JR.rollout_scheduled(params, state, as_float64(sched), DT, m,
                                record=False, stages=s)[0]
    got = TR.rollout_scheduled(tp, ts, as_float64(tsched), DT, m,
                               record=False, stages=s)[0]
    assert_states_close(got, want)


def test_integrated_single_inputs_and_hil_schedule_match_bench_py():
    """bench.py:207-213 and :248-256: the instrumented plant equal to JAX's
    (its PRNG key aside: the port's sensors draw from a generator), the
    boundary equal, and the HIL schedule through the plant's physics."""
    config = JR.ReactorConfiguration(volume=1000, height=2.0,
                                     diameter=0.798, n_zones=20)
    params, plant = JPL.make_plant(config, seed=1, dtype=jnp.float64)
    bc = JR.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                               inlet_chlorine=0.5, acid_flow_rate=0.1)
    sched = jax_bench_schedule(N)

    tcfg, tparams, tplant, tbc, tsched = B.integrated_single_inputs(
        N, dtype=F64, device=CPU)
    assert TR.default_substeps(tcfg, DT) == JR.default_substeps(config, DT)
    assert_same_arrays(tparams, tree_to_numpy(params))
    assert_same_arrays(tplant, tree_to_numpy(plant))
    assert dataclasses.asdict(tbc) == dataclasses.asdict(bc)
    substeps = JR.default_substeps(config, DT)
    want = JR.rollout_scheduled(params.reactor, plant.reactor,
                                as_float64(sched), DT, substeps,
                                record=False)[0]
    got = TR.rollout_scheduled(tparams.reactor, tplant.reactor,
                               as_float64(tsched), DT, substeps,
                               record=False)[0]
    assert_states_close(got, want)


@pytest.mark.parametrize("n_plants,substeps,stages", [
    (32768, 3, None), (65536, 1, 4)])
def test_batched_inputs_match_bench_py(n_plants, substeps, stages):
    """bench.py:95-103 and :118-119: the whole ensemble equal to JAX's, and
    its first 64 plants through 20 steps of the plain rollout."""
    base = JR.ReactorConfiguration(n_zones=20)
    params, state = j_make_monte_carlo_batch(base, n_plants, seed=0,
                                             dtype=jnp.float64)
    bc = JR.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.5,
                               inlet_chlorine=0.3)

    tp, ts, tbc = B.batched_inputs(n_plants, dtype=F64, device=CPU)
    assert_same_arrays(tp, tree_to_numpy(params))
    assert_same_arrays(ts, tree_to_numpy(state))
    assert dataclasses.asdict(tbc) == dataclasses.asdict(bc)
    want = JR.rollout(head_jax(params, n_plants, 64),
                      head_jax(state, n_plants, 64), bc, DT, substeps, N,
                      record=False, stages=stages)[0]
    got = TR.rollout(head_port(tp, n_plants, 64), head_port(ts, n_plants, 64),
                     tbc, DT, substeps, N, record=False, stages=stages)[0]
    assert_states_close(got, want)


def test_integrated_inputs_match_bench_py():
    """bench.py:176-182: the instrumented ensemble equal to JAX's."""
    config = JR.ReactorConfiguration(volume=1000, height=2.0,
                                     diameter=0.798, n_zones=20)
    params, plant = JPL.make_plant_batch(config, 65536, seed=1,
                                         dtype=jnp.float64)
    tcfg, tparams, tplant, tbc = B.integrated_inputs(65536, dtype=F64,
                                                     device=CPU)
    assert TR.default_rkc_plan(tcfg, DT, mode="fast") == \
        JR.default_rkc_plan(config, DT, mode="fast")
    assert_same_arrays(tparams, tree_to_numpy(params))
    assert_same_arrays(tplant, tree_to_numpy(plant))
    assert dataclasses.asdict(tbc) == dataclasses.asdict(
        JR.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5, acid_flow_rate=0.1))


def test_full_chemistry_inputs_match_bench_py():
    """bench.py:136-153: the six-axis ensemble equal to JAX's, and its
    first 8 plants through 20 steps of the plain rollout, every field."""
    base = JR.ReactorConfiguration(
        n_zones=20, enable_nitrogen=True, enable_gas=True,
        enable_particles=True, initial_ammonia=1.0, initial_tss=20.0,
        enable_disinfection=True, initial_pathogens=1e4,
        enable_biofilm=True, initial_bacteria=1e-3, initial_bdoc=0.5,
        enable_phase=True)
    params, state = j_make_monte_carlo_batch(base, 8192, seed=0,
                                             dtype=jnp.float64)
    bc = JR.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.5, inlet_chlorine=0.3,
        inlet_ammonia=1.0, aeration_kla=1e-3, inlet_tss=20.0,
        coagulant_dose=20.0, filter_flow_rate=10.0,
        inlet_pathogens=1e4, uv_intensity=10.0,
        inlet_bacteria=1e-3, inlet_bdoc=0.5,
        ambient_temperature=2.0, ambient_humidity=0.4, wind_speed=3.0,
        heat_loss_coefficient=100.0)

    tp, ts, tbc = B.full_chemistry_inputs(8192, dtype=F64, device=CPU)
    assert_same_arrays(tp, tree_to_numpy(params))
    assert_same_arrays(ts, tree_to_numpy(state))
    assert dataclasses.asdict(tbc) == dataclasses.asdict(bc)
    want = JR.rollout(head_jax(params, 8192, 8), head_jax(state, 8192, 8),
                      bc, DT, 3, N, record=False)[0]
    got = TR.rollout(head_port(tp, 8192, 8), head_port(ts, 8192, 8), tbc,
                     DT, 3, N, record=False)[0]
    fields = [f.name for f in dataclasses.fields(got)
              if isinstance(getattr(got, f.name), torch.Tensor)]
    assert len(fields) > 20
    assert_states_close(got, want, fields)


def test_closed_loop_inputs_match_bench_py():
    """bench.py:323-346: the 4096-lane gain grid, lane states, carries and
    per-lane boundary, and 20 closed-loop steps of every lane."""
    config = JR.ReactorConfiguration(volume=1000, height=2.0,
                                     diameter=0.798, n_zones=20,
                                     initial_chlorine=0.5)
    m, s = JR.default_rkc_plan(config, DT, mode="fast")
    k = int(round((4096 / 16) ** 0.5))
    gains = JC.make_gain_grid(
        kp_cl=jnp.linspace(0.05, 3.0, k), ki_cl=jnp.linspace(0.0, 0.25, k),
        kp_ph=jnp.linspace(-2.0, -0.1, 4), ki_ph=jnp.linspace(-0.2, 0.0, 4),
        dtype=jnp.float64)
    n = JC.n_gains(gains)
    params = JR.make_params(config, dtype=jnp.float64)
    state = JR.make_initial_state(config, dtype=jnp.float64)
    state = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape), state)
    carry = JC.make_dual_pid_carry((n,), jnp.float64)
    bc = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x, jnp.float64), (n,)),
        JR.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5))

    tcfg, tp, ts, tgains, tcarry, tbc = B.closed_loop_inputs(
        4096, dtype=F64, device=CPU)
    assert TC.n_gains(tgains) == n == 4096
    assert TR.default_rkc_plan(tcfg, DT, mode="fast") == (m, s)
    # NumPy's linspace and jnp.linspace differ by an ulp here and there
    assert_same_arrays(tgains, tree_to_numpy(gains), atol=1e-15)
    assert_same_arrays(tcarry, tree_to_numpy(carry))
    assert_same_arrays(tbc, tree_to_numpy(bc))
    want = JC.rollout_closed_loop(params, state, bc, JC.dual_pid_controller,
                                  gains, carry, dt=DT, substeps=m, stages=s,
                                  n_steps=N, record=False)
    got = TC.rollout_closed_loop(tp, ts, tbc, TC.dual_pid_controller, tgains,
                                 tcarry, DT, m, N, stages=s, record=False)
    assert_states_close(got[0], want[0])
    for name in ("acid_flow_rate", "chlorine_flow_rate"):
        np.testing.assert_allclose(getattr(got[2], name).numpy(),
                                   np.asarray(getattr(want[2], name)),
                                   rtol=0, atol=ATOL, err_msg=name)


def test_quick_cpu_run_prints_one_line_with_every_key(capsys, tmp_path):
    out = tmp_path / "bench.json"
    rc = B.main(["--device", "cpu", "--quick", "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert json.loads(out.read_text()) == result
    assert rc == 0 and result["ok"] is True
    assert result["metric"] == B.METRIC and result["unit"] == "steps/s"
    extra = result["extra"]
    missing = [k for k in BENCH_PY_EXTRA + NEW_KEYS if k not in extra]
    assert not missing, missing
    assert not any(k.startswith("hw_prng") for k in extra)
    rates = [result["value"]] + [extra[k] for k in B.RATES[1:]]
    assert all(np.isfinite(r) and r > 0 for r in rates)
    assert result["vs_baseline"] == result["value"] / 31.0
    assert extra["device"]["platform"] == "cpu"
    assert extra["backend"] == "cpu" and extra["quick"] is True
    assert extra["closed_loop_n_gains"] == 4096
    # every row is there, and at --quick every cut says so
    assert set(extra["rows"]) == {row.__name__ for row in B.ROWS}
    cut = {(c["row"], c["cut"]) for c in extra["reduced"]}
    assert cut == {(row, what) for row, kw in B.QUICK.items() for what in kw}
    assert all(c["value"] < c["bench_py"] for c in extra["reduced"])
    # the plain paths on the CPU launch no kernel
    assert all(not r["launches"] and not r["calls"]
               for r in extra["rows"].values())


def test_asking_for_the_card_without_one_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = B.main(["--device", "cuda", "--quick"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and result["ok"] is False
    assert "no CUDA device" in result["reason"]


def test_timed_chained_cuts_steps_then_reps_to_its_budget():
    """A call at bench.py's n_steps longer than the call limit is cut to
    fit it, the reps that overrun the budget are dropped, and both cuts are
    recorded; every call is fed the last one's output."""
    run = B.BenchRun(CPU, budget_s=0.05, call_limit_s=0.05,
                     log=lambda msg: None)

    def fn(x, n):
        time.sleep(1e-3 * n)
        return x + n

    sec, n, x = B._timed_chained(run, "row", fn, 0, 1000, 3)
    assert 15 <= n < 1000
    assert x == 15 + 15 + n          # two warm-up calls of 1000 // 64, one
    assert sec >= 1e-3 * n
    assert run.reduced == [
        dict(row="row", cut="n_steps", value=n, bench_py=1000),
        dict(row="row", cut="reps", value=1, bench_py=3)]
    assert run.calls == {}


def test_timed_chained_keeps_bench_py_depth_within_budget():
    run = B.BenchRun(CPU, log=lambda msg: None)
    calls = []

    def fn(x, n):
        calls.append(n)
        return x + 1

    sec, n, x = B._timed_chained(run, "row", fn, 0, 128, 3, "rollout_fused")
    assert n == 128 and x == 5 and calls == [2, 2, 128, 128, 128]
    assert run.reduced == [] and sec >= 0
    # one call longer than the reps budget but inside the call limit: one
    # call at bench.py's n_steps, the reps cut
    run = B.BenchRun(CPU, budget_s=0.02, call_limit_s=60.0,
                     log=lambda msg: None)

    def slow(x, n):
        time.sleep(1e-3 * n)
        return x + 1

    sec, n, x = B._timed_chained(run, "row", slow, 0, 64, 3)
    assert n == 64 and x == 3 and sec >= 0.064
    assert run.reduced == [dict(row="row", cut="reps", value=1, bench_py=3)]
    assert run.calls == {}           # kernel calls count on the card only
