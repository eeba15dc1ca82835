"""The frozen operation and byte counts of ``harness/roofline.py`` equal
the port's own (``fused_rollout.rollout_ops``, ``fused_plant.plant_ops``
and ``plant_bytes``) at the three cells' shapes today."""

import pytest

from benchmark.harness import cells
from benchmark.harness import roofline as RL
from benchmark.reference import instruments as I


def _shapes():
    out = []
    for w in cells.spec()["workloads"]:
        cell = cells.cell(w["name"])
        t, cfg = cell.traffic, cell.config
        steps = t.get("steps_per_call", t.get("steps_per_chunk"))
        out.append((w["name"], t["entry"], t.get("plants", 1),
                    cfg["reactor"]["n_zones"], steps,
                    cfg["integrator"]["substeps"], t.get("record_every", 1),
                    cfg))
    return out


@pytest.mark.parametrize("shape", _shapes(), ids=lambda s: s[0])
def test_counts_equal_the_ports(shape):
    from ics_wt_physicsengine_torch.ops import fused_plant as FP
    from ics_wt_physicsengine_torch.ops import fused_rollout as F

    _, entry, batch, z, steps, m, rec, cfg = shape
    assert RL.rollout_ops(batch, z, steps, m) \
        == F.rollout_ops(batch, z, steps, m, None)
    if entry == "rollout_fused":
        return
    assert RL.plant_ops(batch, z, steps, m) \
        == FP.plant_ops(batch, z, steps, m, None)
    d = int(round(I.line_delay_s(cfg)))
    hist = sum(bool(i["sample_line"]) for i in cfg["instruments"]) * (d + 1)
    scheduled = 1 if entry == "serve_chunk" else 0
    faults = entry == "serve_chunk"
    assert RL.plant_bytes(batch, z, steps, rec, hist, scheduled,
                          faults=faults) \
        == FP.plant_bytes(batch, z, steps, rec, hist, scheduled, False,
                          faults=faults)
    assert (RL.SENSOR_OPS, RL.PHILOX_OPS) == (FP.SENSOR_OPS, FP.PHILOX_OPS)
    assert (RL.SENSOR_PARAM_COLS, RL.CARRY_FLOAT_COLS, RL.CARRY_INT_COLS) \
        == (FP.N_PCOLS, FP.N_FLOAT_CCOLS, FP.N_INT_CCOLS)


@pytest.mark.parametrize("substeps,stages", [(1, 4), (2, 3), (1, 16)])
def test_rkc_counts_equal_the_ports(substeps, stages):
    from ics_wt_physicsengine_torch.ops import fused_plant as FP
    from ics_wt_physicsengine_torch.ops import fused_rollout as F

    assert RL.rollout_ops(32768, 20, 2000, substeps, stages) \
        == F.rollout_ops(32768, 20, 2000, substeps, stages)
    assert RL.plant_ops(4096, 20, 2000, substeps, stages) \
        == FP.plant_ops(4096, 20, 2000, substeps, stages)


def test_the_bound_names_what_bounds_it():
    ops = RL.rollout_ops(4096, 20, 7200, 3)
    seconds, by = RL.bound_s(ops, RL.rollout_bytes(4096, 20))
    assert by == "operations" and abs(seconds - 9.842e-3) < 1e-5
    seconds, by = RL.bound_s(RL.plant_ops(4096, 20, 2000, 3),
                             RL.plant_bytes(4096, 20, 2000, 100, 124, 0))
    assert by == "operations" and abs(seconds - 3.106e-3) < 1e-5
