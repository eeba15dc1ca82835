"""The plain reference agrees with the port's CPU path at a tiny size:
bit for bit in float64 (the same formulas in the same order), and through
the whole harness in float32 (the check comes out correct)."""

import json
from time import perf_counter

import numpy as np
import pytest
import torch

from benchmark import run as RUN
from benchmark.harness import cells
from benchmark.harness import state as S
from benchmark.reference import instruments as I
from benchmark.reference import params as P
from benchmark.reference import physics as PH
from benchmark.reference.arith import F64

SEED = 2 ** 31 + 99


def _configs():
    return (cells.load_json(cells.ROOT / "benchmark/configs/"
                            "ctr20-physics.json"),
            cells.load_json(cells.ROOT / "benchmark/configs/"
                            "ctr20-instrumented.json"))


def test_tank_equals_the_ports_plain_rollout_in_float64():
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.models.monte_carlo import (
        make_monte_carlo_batch)
    from ics_wt_physicsengine_torch.ops import fused_rollout as F

    cfg, _ = _configs()
    boundary = cells.cell("mc4096.b1").traffic["boundary"]
    params, state = make_monte_carlo_batch(
        R.ReactorConfiguration(**cfg["reactor"]), 4, seed=SEED,
        dtype=torch.float64, device="cpu")
    out = F.rollout_fused(params, state, R.BoundaryConditions(**boundary),
                          dt=1.0, substeps=3, n_steps=40)
    plants = P.sample_plants(cfg, 4, SEED)
    ref = PH.rollout(P.reactor_params(cfg, plants),
                     P.initial_state(cfg, plants), boundary,
                     integ=PH.integrator(cfg), n_steps=40, xp=F64)
    for name in PH.FIELDS:
        np.testing.assert_array_equal(S.host(getattr(out, name)), ref[name])


def test_rkc_tank_equals_the_ports_plain_rollout_in_float64():
    """An RKC2 configuration is a file: its integrator reaches the port's
    call and the reference alike."""
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.models.monte_carlo import (
        make_monte_carlo_batch)
    from ics_wt_physicsengine_torch.ops import fused_rollout as F
    from ics_wt_physicsengine_torch.ops.integrators import _rkc2_coefficients

    for stages in range(2, 9):
        ours = PH.rkc2_coefficients(stages)
        for a, b in zip(ours, _rkc2_coefficients(stages)):
            np.testing.assert_allclose(a, b, rtol=1e-15, atol=0)
    cfg, _ = _configs()
    cfg = dict(cfg, integrator=dict(method="rkc", substeps=1,
                                    stages_per_substep=4, dt_s=1.0))
    integ = PH.integrator(cfg)
    boundary = cells.cell("mc4096.b1").traffic["boundary"]
    params, state = make_monte_carlo_batch(
        R.ReactorConfiguration(**cfg["reactor"]), 4, seed=SEED,
        dtype=torch.float64, device="cpu")
    out = F.rollout_fused(params, state, R.BoundaryConditions(**boundary),
                          dt=1.0, substeps=1, stages=4, n_steps=40)
    plants = P.sample_plants(cfg, 4, SEED)
    ref = PH.rollout(P.reactor_params(cfg, plants),
                     P.initial_state(cfg, plants), boundary, integ=integ,
                     n_steps=40, xp=F64)
    for name in PH.FIELDS:
        np.testing.assert_array_equal(S.host(getattr(out, name)), ref[name])


def test_instrumented_plant_equals_the_ports_plain_rollout_in_float64():
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.models.plant import make_plant_batch
    from ics_wt_physicsengine_torch.ops import fused_plant as FP

    _, cfg = _configs()
    boundary = cells.cell("plant4096.b3").traffic["boundary"]
    bc = R.BoundaryConditions(**boundary)
    params, plant = make_plant_batch(R.ReactorConfiguration(**cfg["reactor"]),
                                     3, seed=SEED, dtype=torch.float64,
                                     device="cpu")
    n, key = 45, 2 ** 40 + 3
    plants = P.sample_plants(cfg, 3, SEED)
    rp = P.reactor_params(cfg, plants)
    d = int(round(I.line_delay_s(cfg)))
    start = P.initial_state(cfg, plants)
    carries = I.initial_carries(cfg, I.sensor_params(cfg), 3)
    leads = [None] * 7
    for call in range(2):                # the second from the port's state
        new, readings = FP.plant_rollout_fused(
            params, plant, bc, dt=1.0, substeps=3, n_steps=n,
            record_every=1, seed=key, step0=call * n)
        ref = I.plant_rollout(cfg, rp, start, carries, leads, boundary,
                              integ=PH.integrator(cfg), n_steps=n, seed=key,
                              step0=np.full(3, call * n),
                              plant_ids=np.arange(3), record_every=1, xp=F64)
        values = np.stack([S.host(readings[i["name"]])
                           for i in cfg["instruments"]], axis=1)
        np.testing.assert_array_equal(np.isnan(values),
                                      np.isnan(ref["values"]))
        np.testing.assert_allclose(values, ref["values"], rtol=0,
                                   atol=1e-12)
        for i, ins in enumerate(cfg["instruments"]):
            flat, ring = S.carry(getattr(new, ins["attr"]), slice(None))
            for f in ("status", "fault"):
                np.testing.assert_array_equal(flat[f],
                                              ref["carries"][i][f])
        for name in PH.FIELDS:
            np.testing.assert_array_equal(
                S.host(getattr(new.reactor, name)), ref["state"][name])
        plant = new
        start = S.reactor(new.reactor, slice(None))
        carries, leads = [], []
        for ins in cfg["instruments"]:
            flat, ring = S.carry(getattr(new, ins["attr"]), slice(None))
            carries.append(flat)
            leads.append(I.lead_in(ring, I.line_delay_s(cfg), d,
                                   start["time"], 1.0)
                         if ins["sample_line"] else None)


# long enough that the state moves past the cells' limits in a call (the
# served plant under the dosing program's acid pulse and chlorine boost)
TINY = {"mc4096.b1": dict(plants=6, steps_per_call=300),
        "plant4096.b3": dict(plants=4, steps_per_call=200, record_every=10),
        "plant1.serve3600": dict(steps_per_chunk=200, commands=dict(
            acid_flow_rate={"choices": [0.25], "weights": [1]},
            chlorine_flow_rate={"choices": [0.3], "weights": [1]},
            inlet_flow_rate={"sine": [5.0, 2.0]}))}


def tiny_run(workload, seed=SEED, control=None, seconds=1.5):
    traffic = dict(cells.cell(workload).traffic, **TINY[workload])
    return RUN.run(workload, seed, seconds, False, device="cpu",
                   traffic=traffic, control=control, t_start=perf_counter())


@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_cpu_run_of_the_port_comes_out_correct(workload):
    result = tiny_run(workload)
    assert result["correct"], json.dumps(result["checks"])
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("workload", ["plant4096.b3", "plant1.serve3600"])
def test_maintained_instruments_are_checked_from_the_references_own(
        workload, monkeypatch):
    """With maintenance after every call, a maintained call is kept, the
    reference makes its fresh instruments itself, and the run comes out
    correct."""
    from benchmark.harness import base

    steps = 40
    size = "steps_per_call" if workload == "plant4096.b3" \
        else "steps_per_chunk"
    traffic = dict(cells.cell(workload).traffic, **TINY[workload])
    traffic.update({size: steps, "maintenance_s": float(steps)})
    kept = {}
    real = base.Driver.keep

    def spy(self, k, fresh=False, **items):
        real(self, k, fresh=fresh, **items)
        kept.update(self.kept)

    monkeypatch.setattr(base.Driver, "keep", spy)
    result = RUN.run(workload, SEED + 1, 2.5, False, device="cpu",
                     traffic=traffic, t_start=perf_counter())
    assert result["attempted"] >= 3 and sorted(map(str, kept)) == [
        "0", "fresh", "later"]
    assert result["correct"], json.dumps(result["checks"])
