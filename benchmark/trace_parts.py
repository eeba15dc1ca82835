"""
One cell's ``--trace 1`` run with the program's own spans recorded in its
traced half: what each part of the B3 and B1 wrappers and of the served
chunk costs a call, and what the device's idle gaps were spent on.

    python3 benchmark/trace_parts.py --workload plant4096.b3 --seed 7 \\
        --seconds 20

The run is ``run.py``'s own (set-up, an untraced first half timing the
parts on the host clock, the profiled second half, the check), with
``ics_wt_physicsengine_torch.utils.profiling.recording()`` open around the
profiled half only, so the first half and every metric ``run.py`` reports
read as they do there. The last line of standard output is one JSON
object: ``run.py``'s result, and besides ``parts`` (from
``harness/spans.py``: the B3 parts' self times a call where B3 runs, the
waits, host syncs and launches inside the program's spans a call),
``self_ms`` and ``wait_ms`` by span a call, ``outermost`` (each outermost
span against its parts), ``launch_check``, ``named_idle_share`` and
``idle_gaps_by_part``. Needs a CUDA card, as ``run.py``.
"""

from time import perf_counter

T_START = perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as RUN  # noqa: E402
from benchmark.harness import cells  # noqa: E402
from benchmark.harness import spans as SP  # noqa: E402
from benchmark.harness import trace as T  # noqa: E402

ANCHOR = "anchor"       # a mark at one instant on both clocks


def suffix(workload: str) -> str:
    """The cell's split of a per-layer metric (``.instrumented``), as its
    ``idle_share`` metric has it."""
    for m in cells.cell(workload).per_layer:
        if m["name"].startswith("idle_share."):
            return m["name"][len("idle_share"):]
    return ""


def traced(workload: str, seed: int, seconds: float, device: str = "cuda",
           traffic: dict = None, t_start: float = None) -> dict:
    """``run.run(..., trace=True)`` with the program's spans recorded in
    its profiled half; returns its result with the spans' numbers added."""
    from ics_wt_physicsengine_torch.utils import profiling

    got = {}
    real = T.profiled

    def profiled(run, marks):
        def recorded():
            t = time.time_ns()
            marks.append((ANCHOR, t, t))
            with profiling.recording() as spans:
                out = run()
            got.update(spans=spans, anchor_ns=t, calls=out[0])
            return out

        result, tr = real(recorded, marks)
        anchor = [h for h in tr.host if h[0] == ANCHOR]
        tr.host.remove(anchor[0])
        got.update(trace=tr, anchor_s=anchor[0][1])
        return result, tr

    T.profiled = profiled
    try:
        result = RUN.run(workload, seed, seconds, True, device=device,
                         traffic=traffic,
                         t_start=T_START if t_start is None else t_start)
    finally:
        T.profiled = real
    tr, calls = got["trace"], got["calls"]
    prog = SP.Program(
        SP.on_timeline(got["spans"], got["anchor_ns"], got["anchor_s"]),
        [h for h in tr.host if not h[0].startswith("bench.")])
    b3 = any(s[0].startswith("wt.b3.") for s in prog.spans)
    per_call = max(calls, 1) / 1e3
    kernels = sum(1 for n, _, _ in tr.device
                  if not n.startswith(("Memcpy", "Memset")))
    gaps = SP.idle_gaps(tr, prog, top=None)
    roots = Counter(s[0] for i, s in enumerate(prog.spans) if s[4] == i)
    result.update(
        traced_calls=calls, spans=len(prog.spans),
        dropped=got["spans"].dropped,
        parts=prog.metrics(calls, suffix(workload), parts=b3),
        self_ms={n: v / per_call for n, v in sorted(prog.self_s().items())},
        wait_ms={n: v / per_call for n, v in sorted(prog.wait_s().items())},
        outermost={n: prog.outermost(n) for n in sorted(roots)},
        launch_check={
            "launches_in_spans_per_call": prog.metrics(calls, parts=False)[
                "launches_per_call"],
            "launches_per_call": sum(1 for n, _, _ in prog.runtime
                                     if SP.launch(n)) / max(calls, 1),
            "kernels_per_call": kernels / max(calls, 1)},
        named_idle_share=SP.named_share(gaps), idle_gaps_by_part=gaps[:12])
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(traced(args.workload, args.seed, args.seconds)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
