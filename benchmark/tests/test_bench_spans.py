"""``harness/spans.py`` on hand-made windows (nested program spans, runtime
calls inside and outside them, the benchmark's spans, the device's
activity), and ``trace_parts.py``'s runs of the two B3 cells on the
port's CPU path at a tiny size: every number of the spans reported, none
negative; a ``--trace 0`` run still reports the cell's end-to-end metrics
and nothing else, with the spans off."""

from time import perf_counter

import pytest

from benchmark import run as RUN
from benchmark import trace_parts as TP
from benchmark.harness import cells
from benchmark.harness import spans as SP
from benchmark.harness import trace as T
from test_bench_reference import TINY

# (name, start, end, parent, root) in seconds: a call [0, 10] holding a
# part [1, 4] (which holds [2, 3]) and a part [5, 9]; a second call [20, 21]
SPANS = [("wt.b3.wrapper", 0.0, 10.0, -1, 0),
         ("wt.b3.tables", 1.0, 4.0, 0, 0),
         ("wt.b3.statics", 2.0, 3.0, 1, 0),
         ("wt.b3.launch", 5.0, 9.0, 0, 0),
         ("wt.b3.wrapper", 20.0, 21.0, -1, 4),
         ("wt.b3.unpack", 20.2, 20.6, 4, 4)]
RUNTIME = [("cudaStreamSynchronize", 2.2, 2.8),     # in statics
           ("cudaLaunchKernel", 5.5, 5.6),          # in launch
           ("cudaMemcpyAsync", 6.0, 7.0),           # in launch
           ("cudaLaunchKernel", 11.0, 11.1),        # outside every span
           ("cudaDeviceSynchronize", 12.0, 13.0),   # outside
           ("cudaLaunchKernel", 20.1, 20.15),       # in the second call
           ("cudaEventSynchronize", 20.3, 20.4)]    # in unpack


def program():
    return SP.Program(SPANS, RUNTIME)


def test_names_of_blocking_calls_and_launches():
    assert all(SP.blocking(n) for n in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy"))
    assert not any(SP.blocking(n) for n in (
        "cudaLaunchKernel", "cudaMalloc", "cudaStreamWaitEvent"))
    assert SP.launch("cudaLaunchKernel") and SP.launch("cuLaunchKernelEx")
    assert SP.launch("cudaLaunchKernelExC") and not SP.launch("cudaMalloc")


def test_each_runtime_call_lies_in_its_innermost_span():
    prog = program()
    assert prog.inside == [2, 3, 3, None, None, 4, 5]
    assert prog.innermost(4.5) == 0 and prog.innermost(15.0) is None
    assert prog.innermost(-1.0) is None and prog.innermost(20.5) == 5


def test_self_time_leaves_out_children_and_waits():
    own = program().self_s()
    assert own["wt.b3.statics"] == pytest.approx(1.0 - 0.6)
    assert own["wt.b3.tables"] == pytest.approx(3.0 - 1.0)
    assert own["wt.b3.launch"] == pytest.approx(4.0 - 1.0)
    assert own["wt.b3.unpack"] == pytest.approx(0.4 - 0.1)
    assert own["wt.b3.wrapper"] == pytest.approx(10.0 - 7.0 + 1.0 - 0.4)


def test_per_call_metrics_count_only_inside_the_programs_spans():
    got = program().metrics(2, ".x")
    assert got == pytest.approx({
        "b3_statics_ms.x": 200.0, "b3_tables_ms.x": 1000.0,
        "b3_lead_in_ms.x": 0.0, "b3_launch_ms.x": 1500.0,
        "b3_rings_ms.x": 0.0, "b3_unpack_ms.x": 150.0,
        "sync_wait_ms.x": 1e3 * (0.6 + 1.0 + 0.1) / 2,
        "host_syncs_per_call.x": 1.5, "launches_per_call.x": 1.0})
    assert set(program().metrics(2, parts=False)) == {
        "sync_wait_ms", "host_syncs_per_call", "launches_per_call"}


def test_waits_are_named_with_their_span_and_its_parent():
    assert program().wait_s() == pytest.approx({
        "wt.b3.tables > wt.b3.statics": 0.6,
        "wt.b3.wrapper > wt.b3.launch": 1.0,
        "wt.b3.wrapper > wt.b3.unpack": 0.1})


def test_the_parts_and_their_waits_account_for_the_outermost_span():
    got = program().outermost("wt.b3.wrapper")
    # the parts' self time with their waits: all but the wrapper's own
    # (tables 2, statics 0.4 + 0.6, launch 3 + 1, unpack 0.3 + 0.1)
    assert got["count"] == 2 and got["span_ms"] == pytest.approx(5500.0)
    assert got["parts_and_waits_ms"] == pytest.approx(1e3 * 7.4 / 2)
    assert got["share"] == pytest.approx(7.4 / 11.0)


def test_spans_are_put_on_the_windows_timeline_by_one_instant():
    spans = [("wt.t.a", 1_000_000_000, 1_500_000_000, -1, 0)]
    assert SP.on_timeline(spans, 1_200_000_000, 3.0) == [
        ("wt.t.a", pytest.approx(2.8), pytest.approx(3.3), -1, 0)]


def test_idle_gaps_are_named_by_the_benchmark_the_program_and_the_runtime():
    device = [("k", 0.0, 2.1), ("k", 3.0, 6.2), ("k", 6.8, 10.05),
              ("k", 10.15, 10.5), ("k", 11.05, 30.0)]
    host = [("bench.call", 0.0, 10.2)] + RUNTIME
    trace = T.Trace(device, host, 30.0)
    gaps = dict(SP.idle_gaps(trace, program()))
    assert gaps == pytest.approx({
        "bench.call / wt.b3.statics / cudaStreamSynchronize": 0.9,
        "bench.call / wt.b3.launch / cudaMemcpyAsync": 0.6,
        "bench.call": 0.1, "host idle": 0.55})
    assert SP.named_share(list(gaps.items())) == pytest.approx(1.5 / 1.6)
    assert SP.named_share([["bench.call / cudaMalloc", 1.0],
                           ["bench.call / wt.b3.launch", 3.0],
                           ["host idle", 5.0]]) == pytest.approx(0.75)


@pytest.mark.parametrize("workload,outer", [
    ("plant1.serve3600", "wt.serve.chunk"),
    ("plant4096.b3", "wt.b3.wrapper")])
def test_a_cpu_traced_run_reports_every_number_of_the_spans(workload, outer):
    real = T.profiled
    traffic = dict(cells.cell(workload).traffic, **TINY[workload])
    result = TP.traced(workload, 2 ** 31 + 17, 2.0, device="cpu",
                       traffic=traffic, t_start=perf_counter())
    assert T.profiled is real
    assert result["correct"] and result["traced_calls"] >= 1
    suffix = TP.suffix(workload)
    assert suffix in (".serve", ".instrumented")
    names = [b + suffix for b in SP.PARTS] + [
        b + suffix for b in ("sync_wait_ms", "host_syncs_per_call",
                             "launches_per_call")]
    assert sorted(result["parts"]) == sorted(names)
    assert all(v >= 0.0 for v in result["parts"].values())
    assert result["parts"]["b3_launch_ms" + suffix] > 0.0
    assert result["dropped"] == 0 and result["spans"] >= 12
    assert result["outermost"][outer]["share"] > 0.95
    assert 0.0 <= result["named_idle_share"] <= 1.0


def test_a_run_without_trace_reports_what_it_did_with_the_spans_off():
    from ics_wt_physicsengine_torch.utils import profiling

    workload = "plant4096.b3"
    traffic = dict(cells.cell(workload).traffic, **TINY[workload])
    result = RUN.run(workload, 2 ** 31 + 19, 1.0, False, device="cpu",
                     traffic=traffic, t_start=perf_counter())
    assert set(result["metrics"]) == {
        m["name"] for m in cells.cell(workload).end_to_end}
    assert "breakdown" not in result and profiling._recording is None
