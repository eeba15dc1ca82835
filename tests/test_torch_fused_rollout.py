"""The port's fused-rollout wrappers (plain versions of kernels B1 and B2 on
CPU tensors) against the JAX package's Pallas kernels in interpret mode, in
float64 at atol 1e-10; the wrappers' rejection contracts; and the whole
slice (batch -> fused rollout -> ensemble statistics) against the JAX
chain."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models.monte_carlo import (
    make_monte_carlo_batch as j_make_batch)
from ics_wt_physicsengine_tpu.ops import fused_rollout as JF
from ics_wt_physicsengine_tpu.parallel import statistics as JS

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models.monte_carlo import (
    make_monte_carlo_batch as t_make_batch)
from ics_wt_physicsengine_torch.ops import fused_rollout as TF
from ics_wt_physicsengine_torch.parallel import statistics as TS

torch.set_num_threads(1)

ATOL = 1e-10
F64 = torch.float64

BC = dict(inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
          inlet_temperature=26.0, acid_flow_rate=0.1, acid_concentration=0.1,
          chlorine_flow_rate=0.2, chlorine_concentration=50.0,
          ambient_temperature=15.0, heat_loss_coefficient=50.0)
JBC, TBC = JR.BoundaryConditions(**BC), TR.BoundaryConditions(**BC)


def _single(n_zones, dtype=jnp.float64):
    cfg = dict(n_zones=n_zones)
    tdt = F64 if dtype == jnp.float64 else torch.float32
    return (JR.make_params(JR.ReactorConfiguration(**cfg), dtype=dtype),
            JR.make_initial_state(JR.ReactorConfiguration(**cfg), dtype=dtype),
            TR.make_params(TR.ReactorConfiguration(**cfg), dtype=tdt,
                           device="cpu"),
            TR.make_initial_state(TR.ReactorConfiguration(**cfg), dtype=tdt,
                                  device="cpu"))


def _batch(n_zones, n_plants, seed):
    jp, js = j_make_batch(JR.ReactorConfiguration(n_zones=n_zones), n_plants,
                          seed=seed, dtype=jnp.float64)
    tp, ts = t_make_batch(TR.ReactorConfiguration(n_zones=n_zones), n_plants,
                          seed=seed, dtype=F64, device="cpu")
    return jp, js, tp, ts


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def _state_close(port, ref):
    for name in ("pH", "chlorine", "temperature", "H_concentration",
                 "density", "chlorine_decay_rate", "flow_rate", "time"):
        _close(getattr(port, name), getattr(ref, name))


@pytest.mark.parametrize("n_zones", [2, 5, 20])
def test_fused_matches_jax_single(n_zones):
    jp, js, tp, ts = _single(n_zones)
    substeps = TR.default_substeps(TR.ReactorConfiguration(n_zones=n_zones),
                                   1.0)
    ref = JF.rollout_fused(jp, js, JBC, dt=1.0, substeps=substeps,
                           n_steps=20, interpret=True)
    got = TF.rollout_fused(tp, ts, TBC, dt=1.0, substeps=substeps,
                           n_steps=20)
    _state_close(got, ref)
    assert got.pH.shape == (n_zones,) and float(got.time) == 20.0


def test_fused_matches_jax_batched():
    jp, js, tp, ts = _batch(5, 11, 7)
    ref = JF.rollout_fused(jp, js, JBC, dt=1.0, substeps=4, n_steps=15,
                           interpret=True)
    got = TF.rollout_fused(tp, ts, TBC, dt=1.0, substeps=4, n_steps=15)
    _state_close(got, ref)


@pytest.mark.parametrize("mode", ["strict", "fast"])
def test_fused_rkc_matches_jax(mode):
    jp, js, tp, ts = _single(20)
    m, s = TR.default_rkc_plan(TR.ReactorConfiguration(n_zones=20), 1.0,
                               mode=mode)
    ref = JF.rollout_fused(jp, js, JBC, dt=1.0, substeps=m, stages=s,
                           n_steps=20, interpret=True)
    got = TF.rollout_fused(tp, ts, TBC, dt=1.0, substeps=m, stages=s,
                           n_steps=20)
    _state_close(got, ref)


def test_fused_recorded_trajectory_single():
    jp, js, tp, ts = _single(20)
    ref, ref_traj = JF.rollout_fused(jp, js, JBC, dt=1.0, substeps=2,
                                     n_steps=20, record_every=4,
                                     interpret=True)
    got, traj = TF.rollout_fused(tp, ts, TBC, dt=1.0, substeps=2, n_steps=20,
                                 record_every=4)
    for key in ("pH", "chlorine", "temperature"):
        assert traj[key].shape == (5, 20)
        _close(traj[key], ref_traj[key])
    assert torch.equal(traj["pH"][-1], got.pH)


def test_fused_recorded_trajectory_batched_matches_xla_rollout():
    jp, js, tp, ts = _batch(5, 7, 3)
    _, ref_traj = JF.rollout_fused(jp, js, JBC, dt=1.0, substeps=4,
                                   n_steps=10, record_every=5,
                                   interpret=True)
    _, traj = TF.rollout_fused(tp, ts, TBC, dt=1.0, substeps=4, n_steps=10,
                               record_every=5)
    assert traj["chlorine"].shape == (2, 7, 5)
    _close(traj["chlorine"], ref_traj["chlorine"])
    # and against the port's own step-by-step rollout
    _, xla_traj = TR.rollout(tp, ts, TBC, 1.0, 4, 10)
    _close(traj["chlorine"], xla_traj["chlorine"][4::5].numpy())


def _square_wave(n_steps):
    t = np.arange(n_steps)
    return dict(
        inlet_flow_rate=5.0 + 2.0 * np.sin(2 * np.pi * t / 17.0),
        inlet_pH=7.2,
        inlet_chlorine=np.where(t % 10 < 5, 0.5, 1.5).astype(float),
        inlet_temperature=26.0 - 0.05 * t,
        acid_flow_rate=np.where(t % 8 < 4, 0.0, 0.3).astype(float),
        acid_concentration=0.1, chlorine_flow_rate=0.2,
        chlorine_concentration=50.0, ambient_temperature=15.0,
        heat_loss_coefficient=50.0)


@pytest.mark.parametrize("n_zones,stages", [(5, None), (20, None), (20, 6)])
def test_scheduled_fused_matches_jax(n_zones, stages):
    jp, js, tp, ts = _single(n_zones)
    substeps = TR.default_substeps(TR.ReactorConfiguration(n_zones=n_zones),
                                   1.0)
    sched = _square_wave(24)
    ref, ref_traj = JF.rollout_scheduled_fused(
        jp, js, JR.BoundaryConditions(**sched), dt=1.0, substeps=substeps,
        stages=stages, record_every=1, interpret=True)
    got, traj = TF.rollout_scheduled_fused(
        tp, ts, convert.boundary_from_numpy(sched, dtype=F64, device="cpu"),
        dt=1.0, substeps=substeps, stages=stages, record_every=1)
    _state_close(got, ref)
    _close(traj["pH"], ref_traj["pH"])
    assert float(got.flow_rate) == pytest.approx(
        sched["inlet_flow_rate"][-1] + sched["acid_flow_rate"][-1] + 0.2)


def test_scheduled_fused_batched_matches_jax():
    jp, js, tp, ts = _batch(5, 13, 4)
    sched = _square_wave(15)
    ref = JF.rollout_scheduled_fused(jp, js, JR.BoundaryConditions(**sched),
                                     dt=1.0, substeps=4, interpret=True)
    got = TF.rollout_scheduled_fused(
        tp, ts, convert.boundary_from_numpy(sched, dtype=F64, device="cpu"),
        dt=1.0, substeps=4)
    _state_close(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stages", [None, 4])
def test_constant_schedule_reproduces_rollout_fused_exactly(dtype, stages):
    tp = TR.make_params(TR.ReactorConfiguration(n_zones=20), dtype=dtype,
                        device="cpu")
    ts = TR.make_initial_state(TR.ReactorConfiguration(n_zones=20),
                               dtype=dtype, device="cpu")
    sched = TR.BoundaryConditions(**{k: np.full(12, v) for k, v in
                                     BC.items()})
    const = TF.rollout_fused(tp, ts, TBC, dt=1.0, substeps=3, stages=stages,
                             n_steps=12)
    scheduled = TF.rollout_scheduled_fused(tp, ts, sched, dt=1.0, substeps=3,
                                           stages=stages)
    for key in ("pH", "chlorine", "temperature"):
        assert torch.equal(getattr(const, key), getattr(scheduled, key))


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    before = dict(TF.LAUNCHES)
    _, _, tp, ts = _single(5)
    TF.rollout_fused(tp, ts, TBC, dt=1.0, substeps=1, n_steps=2)
    TF.rollout_scheduled_fused(tp, ts, TR.BoundaryConditions(
        inlet_pH=np.full(2, 7.0)), dt=1.0, substeps=1)
    assert TF.LAUNCHES == before


def test_kernel_launchers_refuse_cpu_tensors():
    _, _, tp, ts = _single(5)
    ptab = TF.param_table(tp, 1, F64, "cpu")
    btab = TF.boundary_table(TBC, 1, F64, "cpu")
    x = ts.pH[None, :]
    with pytest.raises(ValueError, match="CUDA"):
        TF.rollout_kernel(ptab, btab, x, x, x, dt=1.0, substeps=1, n_steps=1)
    with pytest.raises(ValueError, match="CUDA"):
        TF.scheduled_kernel(ptab, btab.T.contiguous(), x, x, x, dt=1.0,
                            substeps=1)


# ---------------------------------------------------------------------------
# Rejection contracts (both wrappers)
# ---------------------------------------------------------------------------


def _both(tp, ts, **kw):
    sched = TR.BoundaryConditions(inlet_pH=np.full(10, 7.0))
    yield lambda: TF.rollout_fused(tp, ts, TBC, dt=1.0, substeps=1,
                                   n_steps=10, **kw)
    yield lambda: TF.rollout_scheduled_fused(tp, ts, sched, dt=1.0,
                                             substeps=1, **kw)


@pytest.mark.parametrize("axis", TR.EXTENSION_AXES)
def test_fused_rejects_extension_axes(axis):
    _, _, tp, ts = _single(5)
    tp = dataclasses.replace(tp, **{axis: object()})
    for call in _both(tp, ts):
        with pytest.raises(ValueError, match="extensions"):
            call()


def test_fused_rejects_too_many_zones():
    _, _, tp, ts = _single(5)
    tp = dataclasses.replace(tp, n_zones=200)
    for call in _both(tp, ts):
        with pytest.raises(ValueError, match="n_zones <= 128"):
            call()


def test_fused_record_every_must_divide():
    _, _, tp, ts = _single(5)
    for call in _both(tp, ts, record_every=3):
        with pytest.raises(ValueError, match="multiple of"):
            call()


def test_scheduled_fused_rejects_bad_schedules():
    _, _, tp, ts = _single(5)
    with pytest.raises(ValueError, match="no \\[n_steps\\]"):
        TF.rollout_scheduled_fused(tp, ts, TBC, dt=1.0, substeps=1)
    with pytest.raises(ValueError, match="disagree"):
        TF.rollout_scheduled_fused(tp, ts, TR.BoundaryConditions(
            inlet_pH=np.full(4, 7.0), inlet_chlorine=np.zeros(5)),
            dt=1.0, substeps=1)


def test_rollout_ops_counts():
    rk4 = TF.rollout_ops(2, 5, 10, 3, None)
    assert rk4 == 2 * 5 * 10 * (3 * (4 * TF.DERIV_OPS + TF.RK4_UPDATE_OPS)
                                + TF.BOUND_OPS)
    rkc = TF.rollout_ops(1, 20, 7, 1, 4)
    assert rkc == 20 * 7 * (4 * TF.DERIV_OPS + TF.RKC_FIRST_OPS
                            + 3 * TF.RKC_STAGE_OPS + TF.BOUND_OPS)


# ---------------------------------------------------------------------------
# The whole slice: batch -> fused rollout -> ensemble statistics
# ---------------------------------------------------------------------------


def test_slice_end_to_end_matches_jax():
    base = dict(n_zones=5)
    jp, js = j_make_batch(JR.ReactorConfiguration(**base), 16, seed=0,
                          dtype=jnp.float64)
    tp, ts = t_make_batch(TR.ReactorConfiguration(**base), 16, seed=0,
                          dtype=F64, device="cpu")
    policy = dict(inlet_flow_rate=5.0, inlet_pH=7.4, inlet_chlorine=0.2,
                  chlorine_flow_rate=0.15, chlorine_concentration=50.0,
                  acid_flow_rate=0.05)
    jfinal = JF.rollout_fused(jp, js, JR.BoundaryConditions(**policy),
                              dt=1.0, substeps=3, n_steps=20, interpret=True)
    tfinal = TF.rollout_fused(tp, ts, TR.BoundaryConditions(**policy),
                              dt=1.0, substeps=3, n_steps=20)
    _state_close(tfinal, jfinal)

    jstats = jax.jit(JS.ensemble_statistics)(jfinal)
    tstats = TS.ensemble_statistics(tfinal)
    assert tstats["n_plants"] == jstats["n_plants"] == 16
    for var in ("pH", "chlorine", "temperature"):
        for key in ("mean", "std", "quantiles", "min", "max"):
            _close(tstats[var][key], jstats[var][key])
    jprob = jax.jit(JS.exceedance_probability)(jfinal)
    tprob = TS.exceedance_probability(tfinal)
    assert tprob.keys() == jprob.keys()
    for key in jprob:
        assert float(tprob[key]) == float(jprob[key])
