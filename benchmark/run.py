"""
Run one cell of the benchmark: set up (build the kernels, make the inputs
from the seed, warm up the cell's one shape), measure for ``--seconds``,
then check what the timed path produced against the plain reference.

    python3 benchmark/run.py --workload mc4096.b1 --seed 7 --seconds 20 \\
        --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
also printed as the last lines of standard error. Needs a CUDA card; exits
with another code than 0 and prints no result without one, or if JAX or
the JAX package was loaded.
"""

from time import perf_counter

T_START = perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread: the load comes from one process, which shares its
# host's cores with nothing of its own
os.environ.setdefault("OMP_NUM_THREADS", "1")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "ics_wt_physicsengine_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: the port's name shares a prefix)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def measure(driver, seconds: float, spans=None, k0: int = 0):
    """The window: calls until ``seconds`` have passed, then wait for the
    device. From the start (``k0`` 0) or on from call ``k0``. Returns
    ``(calls, work, wall seconds)``."""
    if k0 == 0:
        driver.begin()
    t0 = perf_counter()
    k, work = k0, 0.0
    while perf_counter() - t0 < seconds:
        work += driver.call(k, spans)
        k += 1
    driver.finish()
    return k - k0, work, perf_counter() - t0


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", traffic: dict = None, control: str = None,
        t_start: float = None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``traffic`` replaces the cell's traffic (smaller mixes for tests on
    the CPU); ``control`` puts the reference, computed in that precision,
    in the program's place for the check."""
    import torch

    from benchmark.harness import cells, drivers
    from benchmark.harness import trace as T

    t_start = T_START if t_start is None else t_start
    cell = cells.cell(workload)
    if traffic is not None:
        cell.traffic = traffic
    driver = drivers.load(cell.traffic["entry"])(
        cell.config, cell.traffic, seed, device, control=control)
    driver.warm()
    gc.collect()                  # the window starts from a swept heap
    setup_s = perf_counter() - t_start

    spans, tr, traced_calls = {}, None, 0
    if trace:
        # first half: each part timed on the host clock, ending
        # synchronized; second half, on from there: the profiler's trace
        # of the device, with the parts only labelled
        calls, work, wall = measure(driver, seconds / 2, spans)
        (traced_calls, _, _), tr = T.profiled(
            lambda: measure(driver, seconds / 2, driver.LABEL, k0=calls),
            driver.marks)
        calls += traced_calls
    else:
        calls, work, wall = measure(driver, seconds)
    cuda = device != "cpu"
    peak = torch.cuda.max_memory_allocated(torch.device(device)) \
        if cuda else 0
    ctx = cells.Context(cell=cell, setup_s=setup_s, calls=calls, work=work,
                        unit=driver.unit, wall_s=wall,
                        call_s=list(getattr(driver, "chunk_s", [])),
                        kernels=driver.KERNELS, wrapper=driver.WRAPPER,
                        spans=spans, trace=tr, traced_calls=traced_calls)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = perf_counter()
    numbers = driver.check()
    print(f"set-up {setup_s:.2f} s, window {wall:.2f} s ({calls} calls), "
          f"check {perf_counter() - t_check:.2f} s", file=sys.stderr)
    checks = {}
    for name, value in numbers.items():
        if name in cell.limits:       # the others are read, not compared
            checks[name] = {"value": value,
                            "limit": cell.limits[name]["limit"]}
        else:
            print(f"reading {name} {value!r}", file=sys.stderr)
    correct = all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(torch.device(device))
           if cuda else "cpu",
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power"] = power_limit()
    result = {"correct": correct, "attempted": calls,
              "failed": 0 if correct else len(driver.host),
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cells

    torch.set_num_threads(1)
    chips = int(cells.cell(args.workload).workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded in the measuring process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
