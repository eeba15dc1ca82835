"""A run with the timed path broken underneath comes out not correct:
skipping only the harness's look for a card, each cell's run on the
port's CPU path at a tiny size, once for each fault the cell can have
(a call that returns its state unchanged; half of the batch left out; an
answer altered where it is produced, a chlorine value; one chip, so no
exchange to leave out), and with the control, the reference computed in
bfloat16, in the program's place."""

from dataclasses import replace

import pytest

from test_bench_reference import TINY, tiny_run


def _rollout(monkeypatch, fault):
    from ics_wt_physicsengine_torch.ops import fused_rollout as F

    real = F.rollout_plain

    def broken(ptab, btab, ph, cl, t, **kw):
        out = real(ptab, btab, ph, cl, t, **kw)
        if fault == "unchanged":
            return ph, cl, t, out[3]
        ph2, cl2, t2 = (x.clone() for x in out[:3])
        if fault == "half":
            half = ph.shape[0] // 2
            for new, old in ((ph2, ph), (cl2, cl), (t2, t)):
                new[half:] = old[half:]
        else:
            cl2[0, -1] += 0.5
        return ph2, cl2, t2, out[3]

    monkeypatch.setattr(F, "rollout_plain", broken)


def _plant(monkeypatch, fault):
    from ics_wt_physicsengine_torch.ops import fused_plant as FP

    real = FP.plant_plain

    def broken(tables, **kw):
        out = real(tables, **kw)
        if fault == "unchanged":
            return replace(out, ph=tables.ph, cl=tables.cl, t=tables.t)
        if fault == "half":
            half = tables.ph.shape[0] // 2
            kept = {}
            for name in ("ph", "cl", "t"):
                x = getattr(out, name).clone()
                x[half:] = getattr(tables, name)[half:]
                kept[name] = x
            return replace(out, **kept)
        readings = out.readings.clone()
        readings[-1, 3, 0] += 1.0          # chlorine_outlet
        return replace(out, readings=readings)

    monkeypatch.setattr(FP, "plant_plain", broken)


def _serve(monkeypatch, fault):
    from ics_wt_physicsengine_torch.models import plant as PL

    real = PL.plant_serve_chunk

    def broken(params, plant, schedule, **kw):
        out = real(params, plant, schedule, **kw)
        if fault == "unchanged":
            return replace(out, plant=plant)
        value, status, code = out.last["chlorine_outlet"]
        return replace(out, last=dict(
            out.last, chlorine_outlet=(value + 1.0, status, code)))

    monkeypatch.setattr(PL, "plant_serve_chunk", broken)


FAULTS = [("mc4096.b1", _rollout, "unchanged"), ("mc4096.b1", _rollout,
                                                  "half"),
          ("mc4096.b1", _rollout, "altered"),
          ("plant4096.b3", _plant, "unchanged"),
          ("plant4096.b3", _plant, "half"),
          ("plant4096.b3", _plant, "altered"),
          ("plant1.serve3600", _serve, "unchanged"),
          ("plant1.serve3600", _serve, "altered")]


@pytest.mark.parametrize("workload,patch,fault", FAULTS,
                         ids=[f"{w}-{f}" for w, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, patch,
                                            fault):
    patch(monkeypatch, fault)
    result = tiny_run(workload)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_bfloat16_control_is_not_correct(workload):
    result = tiny_run(workload, control="bfloat16")
    assert not result["correct"], result["checks"]
