"""The port's own spans (``utils/profiling.py``: ``span``, ``spanned``,
``recording``, ``trace``) on the CPU.

- Off (outside ``recording()``), ``span`` is one shared object that does
  nothing, and a recording opened later has seen nothing.
- On, a served chunk (20 zones, 64 steps, B3's plain version), a
  ``plant_rollout_fused`` call and a ``rollout_fused`` call each record
  the tree of their wrapper's parts: parents, one root a call, the four
  sample lines' lead-ins, the statics twice in a served chunk.
- Outputs with spans on equal those with spans off, bit for bit.
- A span's interval and ``torch.profiler``'s events share one clock: an
  operation run inside a span lies inside it on the profiler's timeline,
  and ``trace()`` writes the spans into its ``trace.json``.
"""

import dataclasses
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ics_wt_physicsengine_torch import __main__ as M
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.models import plant as PL
from ics_wt_physicsengine_torch.ops import fused_plant as FP
from ics_wt_physicsengine_torch.ops import fused_rollout as F
from ics_wt_physicsengine_torch.utils import profiling as P

N_STEPS = 64
SUBSTEPS = 3
BC = R.BoundaryConditions(acid_flow_rate=0.25, chlorine_flow_rate=0.3)


@pytest.fixture(scope="module")
def plant():
    return PL.make_plant(R.ReactorConfiguration(n_zones=20), device="cpu")


def serve(plant):
    """One served chunk as the serving loop runs it: the schedule, the
    chunk, the register snapshot."""
    params, state = plant
    sched, _ = M.build_chunk_schedule(BC, BC, N_STEPS, 1.0, 0.0,
                                      device="cpu")
    chunk = PL.plant_serve_chunk(params, state, sched, dt=1.0,
                                 substeps=SUBSTEPS, seed=5, step0=N_STEPS)
    readings = M._readings_from_chunk(chunk, 2.0 * N_STEPS)
    return chunk, {n: dataclasses.astuple(r) for n, r in readings.items()}


def fused_plant(plant):
    params, state = plant
    return FP.plant_rollout_fused(params, state, BC, dt=1.0,
                                  substeps=SUBSTEPS, n_steps=16,
                                  record_every=4, seed=5)


def fused_rollout(plant):
    params, state = plant
    return F.rollout_fused(params.reactor, state.reactor, BC, dt=1.0,
                           substeps=SUBSTEPS, n_steps=16)


def tree(spans):
    """Each span as ``(name, its parent's name or None)``, and the roots'
    names."""
    named = [(n, spans[p][0] if p >= 0 else None) for n, _, _, p, _ in spans]
    roots = [n for i, (n, _, _, _, r) in enumerate(spans) if r == i]
    return named, roots


def leaves(x):
    """The tensors and plain values of an output, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x)
                for v in leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in [k] + leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in leaves(item)]
    return [x]


def test_off_span_is_one_shared_object_and_records_nothing(plant):
    assert P.span("wt.a.b") is P.span("wt.c.d")
    serve(plant)
    with P.recording() as spans:
        pass
    assert list(spans) == [] and spans.dropped == 0
    assert P._recording is None


def test_a_served_chunk_records_its_parts(plant):
    with P.recording() as spans:
        serve(plant)
    named, roots = tree(spans)
    assert roots == ["wt.serve.schedule", "wt.serve.chunk",
                     "wt.serve.readings"]
    assert named == [
        ("wt.serve.schedule", None),
        ("wt.serve.chunk", None),
        ("wt.b3.wrapper", "wt.serve.chunk"),
        ("wt.b3.tables", "wt.b3.wrapper"),
        ("wt.b3.statics", "wt.b3.tables"),
        *[("wt.b3.lead_in", "wt.b3.tables")] * 4,
        ("wt.b3.launch", "wt.b3.wrapper"),
        ("wt.b3.unpack", "wt.b3.wrapper"),
        *[("wt.b3.rings", "wt.b3.unpack")] * 4,
        ("wt.b3.statics", "wt.serve.chunk"),
        ("wt.serve.codes", "wt.serve.chunk"),
        ("wt.serve.readings", None)]
    chunk = spans[1]
    for name, start, end, parent, root in spans[2:-1]:
        assert root == 1 and chunk[1] <= start <= end <= chunk[2]
    assert all(s[1] <= s[2] for s in spans)


def test_a_fused_plant_call_records_its_parts(plant):
    with P.recording() as spans:
        fused_plant(plant)
    named, roots = tree(spans)
    assert roots == ["wt.b3.wrapper"]
    assert [n for n, _ in named] == [
        "wt.b3.wrapper", "wt.b3.tables", "wt.b3.statics",
        *["wt.b3.lead_in"] * 4, "wt.b3.launch", "wt.b3.unpack",
        *["wt.b3.rings"] * 4]
    assert all(r == 0 for *_, r in spans)


def test_a_fused_rollout_call_records_its_parts(plant):
    with P.recording() as spans:
        fused_rollout(plant)
    assert tree(spans) == ([("wt.b1.wrapper", None),
                            ("wt.b1.tables", "wt.b1.wrapper"),
                            ("wt.b1.launch", "wt.b1.wrapper")],
                           ["wt.b1.wrapper"])


@pytest.mark.parametrize("entry", [serve, fused_plant, fused_rollout])
def test_outputs_are_bit_equal_with_spans_on_and_off(plant, entry):
    off = leaves(entry(plant))
    with P.recording() as spans:
        on = leaves(entry(plant))
    assert len(spans) > 0 and len(on) == len(off)
    for a, b in zip(on, off):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        else:
            assert a == b or (a != a and b != b)


def test_spans_past_the_cap_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(P, "SPAN_CAP", 3)
    with P.recording() as spans:
        with P.span("wt.t.outer"):
            for _ in range(4):
                with P.span("wt.t.inner"):
                    pass
    assert [s[0] for s in spans] == ["wt.t.outer"] + ["wt.t.inner"] * 2
    assert spans.dropped == 2 and [s[3] for s in spans] == [-1, 0, 0]


def test_an_inner_recording_takes_its_block():
    with P.recording() as outer:
        with P.span("wt.t.a"):
            with P.recording() as inner:
                with P.span("wt.t.b"):
                    pass
        with P.span("wt.t.c"):
            pass
    assert [s[:1] + s[3:] for s in outer] == [("wt.t.a", -1, 0),
                                              ("wt.t.c", -1, 1)]
    assert [s[:1] + s[3:] for s in inner] == [("wt.t.b", -1, 0)]


def test_spanned_keeps_the_function_and_records_its_calls():
    @P.spanned("wt.t.fn")
    def twice(x):
        """Doc."""
        return 2 * x

    assert twice.__name__ == "twice" and twice.__doc__ == "Doc."
    with P.recording() as spans:
        assert twice(3) == 6
    assert [s[0] for s in spans] == ["wt.t.fn"]


def test_an_operation_in_a_span_lies_inside_it_on_the_profilers_clock():
    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.recording() as spans:
            with P.span("wt.t.part"):
                x.cumsum(0)
    (_, start, end, _, _), = spans
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::cumsum"]
    assert len(ops) == 1
    op_start = ops[0].start_ns()
    assert start <= op_start <= op_start + ops[0].duration_ns() <= end


def test_trace_writes_the_programs_spans(tmp_path):
    with P.trace(str(tmp_path / "tr")) as d:
        with P.span("wt.t.part"):
            torch.ones(64).cumsum(0)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    part, = [e for e in events if e.get("name") == "wt.t.part"]
    op, = [e for e in events if e.get("name") == "aten::cumsum"]
    assert part["ph"] == "X" and part["pid"] == op["pid"]
    assert part["tid"] == op["tid"]
    assert part["ts"] <= op["ts"] <= op["ts"] + op["dur"] \
        <= part["ts"] + part["dur"] + 1e-3
    assert P._recording is None
