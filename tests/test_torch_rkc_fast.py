"""The RKC2-fast Monte-Carlo configuration of B1 on the CPU: the count of
derivative evaluations a launch asks for (``ops/fused_rollout.py::
evaluations``, what ``EVALUATIONS`` adds up), and the benchmark's
``ctr20-physics-rkc`` configuration, read as plain JSON, stable for every
plant its ranges sample."""

import dataclasses
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.ops import fused_rollout as F
from ics_wt_physicsengine_torch.ops import integrators

CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" \
    / "ctr20-physics-rkc.json"


@pytest.mark.parametrize("batch,n_steps,substeps,stages,want", [
    (1, 1, 1, None, 4),
    (4096, 7200, 3, None, 4096 * 7200 * 12),
    (32768, 2000, 1, 4, 32768 * 2000 * 4),
    (7, 10, 2, 3, 7 * 10 * 6),
    (3, 5, 1, 16, 3 * 5 * 16)])
def test_evaluations_count_four_a_substep_for_rk4_and_the_stages_for_rkc(
        batch, n_steps, substeps, stages, want):
    assert F.evaluations(batch, n_steps, substeps, stages) == want


@pytest.mark.parametrize("substeps,stages", [(3, None), (1, 4), (2, 3),
                                             (1, 16)])
def test_evaluations_are_the_derivative_part_of_the_operation_count(
        substeps, stages):
    """``rollout_ops`` less ``DERIV_OPS`` for each zone's evaluation leaves
    only the stage updates and the bounds, which no evaluation holds."""
    batch, zones, steps = 5, 20, 30
    ops = F.rollout_ops(batch, zones, steps, substeps, stages)
    evals = F.evaluations(batch, steps, substeps, stages)
    if stages is None:
        update = F.RK4_UPDATE_OPS
    else:
        update = F.RKC_FIRST_OPS + (stages - 1) * F.RKC_STAGE_OPS
    assert ops - zones * F.DERIV_OPS * evals \
        == batch * zones * steps * (substeps * update + F.BOUND_OPS)


def test_reset_clears_the_evaluations_with_the_launches(monkeypatch):
    monkeypatch.setitem(F.LAUNCHES, "rollout_fused", 3)
    monkeypatch.setitem(F.EVALUATIONS, "rollout_fused", 12)
    monkeypatch.setitem(F.EVALUATIONS, "rollout_scheduled_fused", 5)
    F.reset_launch_counts()
    assert F.EVALUATIONS == F.LAUNCHES == {"rollout_fused": 0,
                                           "rollout_scheduled_fused": 0}


def test_a_cpu_rkc_call_counts_no_evaluation():
    """The plain version launches nothing, so it asks the card for no
    evaluation."""
    before = dict(F.EVALUATIONS)
    params = R.make_params(R.ReactorConfiguration(n_zones=5), device="cpu")
    state = R.make_initial_state(R.ReactorConfiguration(n_zones=5),
                                 device="cpu")
    F.rollout_fused(params, state, R.BoundaryConditions(), dt=1.0,
                    substeps=1, stages=4, n_steps=3)
    assert F.EVALUATIONS == before


def _corners(config: dict):
    """The configuration's ``ReactorConfiguration`` at every corner of its
    sampled ranges."""
    base = R.ReactorConfiguration(**config["reactor"])
    ranges = config["monte_carlo"]["ranges"]
    names = sorted(ranges)
    for values in itertools.product(*(ranges[n] for n in names)):
        yield dataclasses.replace(base, **dict(zip(names, values)))


def test_the_rkc_configuration_is_stable_for_every_sampled_plant():
    """``default_rkc_plan(..., mode="fast")`` at the stiffest corner of the
    sampled ranges needs no more than the configuration's substeps and
    stages at its ``dt_s``, and every corner's stiffness lies inside the
    configuration's stable span."""
    config = json.loads(CONFIG.read_text())
    integ = config["integrator"]
    assert integ["method"] == "rkc" and config["reduced"] == []
    dt, substeps = integ["dt_s"], integ["substeps"]
    stages = integ["stages_per_substep"]
    corners = list(_corners(config))
    assert len(corners) == 2 ** len(config["monte_carlo"]["ranges"])
    stiffest = max(corners, key=R._lambda_max)
    plan = R.default_rkc_plan(stiffest, dt, mode="fast")
    assert plan[0] <= substeps and plan[0] * plan[1] <= substeps * stages
    span = integrators.RKC_SAFETY * integrators.RKC_STABILITY_PER_S2 \
        * stages ** 2
    lam = np.array([R._lambda_max(c) for c in corners])
    assert np.all(lam * dt / substeps <= span)
    # the stiffest corner is the fastest impeller: 90 rpm
    assert stiffest.impeller_speed == max(
        config["monte_carlo"]["ranges"]["impeller_speed"])
