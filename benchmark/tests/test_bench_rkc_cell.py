"""The RKC2-fast cell ``mc32768.b1_rkc`` on the port's CPU path at a tiny
size (6 plants, 300 steps a call, the check sampling every plant), with
nothing but the harness's look for a card skipped: the sound run comes
out correct; the control (the reference computed in bfloat16 in the
program's place) and a timed path broken underneath (a call that returns
its state unchanged, half of the batch left out, a chlorine value
altered) do not."""

import json
from time import perf_counter

import pytest

from benchmark import run as RUN
from benchmark.harness import cells
from test_bench_faults import _rollout
from test_bench_reference import SEED

CELL = "mc32768.b1_rkc"


def tiny_run(control=None, seed=SEED):
    traffic = dict(cells.cell(CELL).traffic, plants=6, steps_per_call=300)
    return RUN.run(CELL, seed, 1.5, False, device="cpu", traffic=traffic,
                   control=control, t_start=perf_counter())


def test_the_cell_runs_rkc2_fast_on_the_ports_cpu_path():
    cell = cells.cell(CELL)
    assert cell.config["integrator"] == dict(
        method="rkc", substeps=1, stages_per_substep=4, dt_s=1.0)
    assert (cell.traffic["plants"], cell.traffic["steps_per_call"]) \
        == (32768, 2000)
    result = tiny_run()
    assert result["correct"], json.dumps(result["checks"])
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(cell.limits)
    assert {"plant_steps_per_s", "setup_s"} <= set(result["metrics"])


def test_the_bfloat16_control_is_not_correct():
    result = tiny_run(control="bfloat16")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _rollout(monkeypatch, fault)
    result = tiny_run()
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1
