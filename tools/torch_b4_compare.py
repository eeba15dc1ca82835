#!/usr/bin/env python3
"""Kernel B4 (the Newton pH solve) of an earlier commit beside the current
one, in one call on one CUDA card.

    mkdir -p dist/probe/old
    git archive d7eaa0a ics_wt_physicsengine_torch/csrc \\
        | tar -x -C dist/probe/old
    python3 tools/torch_b4_compare.py \\
        dist/probe/old/ics_wt_physicsengine_torch/csrc [--ablate] [--probe] \\
        [--sweep] [--stats]

The argument is a csrc directory whose ``ph_solver.cu`` has the C interface
of commit d7eaa0a (one thread per element, every element through all
iterations; no grid or counter arguments). It is built beside the current
sources (one nvcc process per source, all started together), and each
build's -Xptxas -v registers and spills are printed.

Then, at PH-EQ-65536 and PH-TITR-4096x256 (``kernel_checks.ph_cell_args``)
in float32 and float64: the builds in turns after a warm-up of each
(old, new, ..., then reversed, ``ROUNDS`` times; ``REPS`` launches a
turn), their mean CUDA-event times, whether every result is bit-equal to
the old build's and to the plain version's (NaN in the same places), the
cell's mean live iterations and both bounds (``kernel_checks.ph_bounds``:
every iteration, and the live ones); a time below the live bound is
flagged, since it would mean the count is wrong. ``--ablate`` also times
copies of the current sources with one part of the design taken out or
changed (string replacements in ``ABLATIONS``): the block's compaction of
unfinished elements, and the refill rule of both types set to each of
the rules the kernel chooses from (a refill as soon as one lane is idle,
at 8 idle lanes, or only when all 32 are: an exit per warp).
``--sweep`` times the current build over launch geometries: 128 and 256
threads a block, and 1 to the card's occupancy of blocks an SM.

``--stats`` builds the current sources with counters in the kernel's
loop (``STATS_EDITS``) and runs each cell once in its shipped geometry
and on one block an SM, with the default tolerance and with 0 (every
element through all iterations): per warp its loop turns, the share of
active lanes, and the cycles spent refilling and iterating. It also
prints the SASS instruction counts of the shipped kernels.

``--probe`` builds ``tools/torch_b4_probe.cu`` and runs B4's iteration on
the same cells, with one lane a warp and with all 32: the cycles of one
live iteration (median, quartiles) and, for each of the seven IEEE
divisions, its cycles and the share of its calls that take the slow path
(more than ``SLOW_FACTOR`` times the division's median). Its pH and live
iterations are held against ``ph_live_iters``'s.

Prints the card's name and power limit; writes
chiprun_out/torch_b4_compare.json. Exits non-zero without a CUDA card or
when a result differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_b3_compare import nvcc_build, registers, timed  # noqa: E402
from torch_rollout_compare import ablated_sources  # noqa: E402

ROUNDS = 3
REPS = {"PH-EQ-65536": 20, "PH-TITR-4096x256": 10}
SLOW_FACTOR = 2.0
DIVISIONS = ("kw / h", "ka1 h / d", "ka1 ka2 / d", "kw / h^2",
             "da1_dh: ka1 (d - h dd_dh) / d^2", "da2_dh: -ka1 ka2 dd_dh / d^2",
             "-f / df")

# One part of the design taken out of a copy of the current sources, or
# changed: {name: [(file, text, replacement), ...]}.
SHIPPED_REFILL = "  return sizeof(S) == sizeof(double) ? kWarp : 8;"
ABLATIONS = {
    # no parking: each warp finishes its own elements
    "compaction-off": [
        ("ph_solver.cu", "constexpr int kCompactAt = 16;",
         "constexpr int kCompactAt = 1 << 30;"),
    ],
    # both types: a warp takes new elements as soon as one lane is idle
    "refill-any": [("ph_solver.cu", SHIPPED_REFILL, "  return 1;")],
    # both types: at 8 idle lanes (float32's rule)
    "refill-at-8": [("ph_solver.cu", SHIPPED_REFILL, "  return 8;")],
    # both types: only when all its lanes are done, an exit per warp
    # (float64's rule)
    "refill-off": [("ph_solver.cu", SHIPPED_REFILL, "  return kWarp;")],
}

# The shipped sources with counters in the kernel's loop (``--stats``):
# per warp its cycles, loop turns that iterate, active lanes at those
# turns, turns that refill a lane, and cycles spent refilling and
# iterating. Read back by wt_b4_stats_read.
STATS_EDITS = [
    ("ph_solver.cu", '#include "ph_newton.cuh"\n',
     '#include "ph_newton.cuh"\n\n'
     "__device__ unsigned long long wt_b4_stats[8];\n"),
    ("ph_solver.cu", "  const unsigned below = (1u << lane) - 1u;\n",
     "  const unsigned below = (1u << lane) - 1u;\n"
     "  const long long st_t0 = clock64();\n"
     "  unsigned long long st_iters = 0, st_lanes = 0, st_refills = 0;\n"
     "  long long st_refill = 0, st_compute = 0;\n"),
    ("ph_solver.cu", "    unsigned need = __ballot_sync(kFullMask, !active);\n",
     "    const long long st_r0 = clock64();\n"
     "    unsigned need = __ballot_sync(kFullMask, !active);\n"
     "    st_refills += __popc(need) >= refill_at<S>() && more;\n"),
    ("ph_solver.cu", "    if (active) step();\n  }\n\n  // Every warp",
     "    st_refill += clock64() - st_r0;\n"
     "    const long long st_c0 = clock64();\n    ++st_iters;\n"
     "    st_lanes += __popc(__ballot_sync(kFullMask, active));\n"
     "    if (active) step();\n"
     "    st_compute += clock64() - st_c0;\n  }\n\n  // Every warp"),
    ("ph_solver.cu",
     "  while (__any_sync(kFullMask, active)) {\n    if (active) step();\n",
     "  while (__any_sync(kFullMask, active)) {\n"
     "    const long long st_c0 = clock64();\n    ++st_iters;\n"
     "    st_lanes += __popc(__ballot_sync(kFullMask, active));\n"
     "    if (active) step();\n"
     "    st_compute += clock64() - st_c0;\n"),
    ("ph_solver.cu",
     "  // the launch's last warp sets the counter back for the next launch\n",
     "  if (lane == 0) {\n"
     "    const unsigned long long t = clock64() - st_t0;\n"
     "    atomicAdd(&wt_b4_stats[0], 1ull);\n"
     "    atomicAdd(&wt_b4_stats[1], t);\n"
     "    atomicAdd(&wt_b4_stats[2], st_iters);\n"
     "    atomicAdd(&wt_b4_stats[3], st_lanes);\n"
     "    atomicAdd(&wt_b4_stats[4], st_refills);\n"
     "    atomicAdd(&wt_b4_stats[5], (unsigned long long)st_refill);\n"
     "    atomicAdd(&wt_b4_stats[6], (unsigned long long)st_compute);\n"
     "    atomicMax(&wt_b4_stats[7], t);\n  }\n"
     "  // the launch's last warp sets the counter back for the next launch\n"),
    ("ph_solver.cu", 'extern "C" {\n',
     'extern "C" {\n\n'
     "int wt_b4_stats_read(unsigned long long* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, wt_b4_stats,\n"
     "                                               sizeof(wt_b4_stats)));\n"
     "}\n\n"
     "int wt_b4_stats_clear() {\n"
     "  const unsigned long long zero[8] = {};\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(wt_b4_stats, zero,\n"
     "                                             sizeof(zero)));\n"
     "}\n"),
]
STATS = ("warps", "warp_cycles", "turns", "active_lanes", "refill_turns",
         "refill_cycles", "iterate_cycles", "max_warp_cycles")


def bind_old(path):
    """The B4 library of commit d7eaa0a."""
    lib = ctypes.CDLL(str(path))
    ptr = ctypes.c_void_p
    lib.wt_solve_ph.argtypes = ([ctypes.c_int] + [ptr] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_double, ptr])
    lib.wt_solve_ph.restype = ctypes.c_int
    return lib


def old_kernel(lib, args, iters: int = 100, tolerance: float = 1e-6):
    from ics_wt_physicsengine_torch.ops import ph_solver as PS

    ph0 = args[-1]
    out = torch.empty_like(ph0)
    caps = PS._cap_table(iters, ph0.dtype, ph0.device)
    err = lib.wt_solve_ph(int(ph0.dtype == torch.float64),
                          *(x.data_ptr() for x in args), caps.data_ptr(),
                          out.data_ptr(), ph0.numel(), iters, tolerance,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old B4 launch failed ({err})")
    return out


def build_probe(out_dir: Path):
    from ics_wt_physicsengine_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libwt_b4_probe.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(lib), str(Path(ROOT) / "tools" / "torch_b4_probe.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probe:\n{proc.stdout}"
                           f"{proc.stderr}")
    probe_lib = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    probe_lib.wt_b4_probe.argtypes = [
        i32, i32, i32, ctypes.POINTER(ctypes.c_void_p), ptr,
        ctypes.c_longlong, i32, ctypes.c_double, ptr, ptr, ptr, ptr, ptr,
        i32, i32, ptr]
    probe_lib.wt_b4_probe.restype = i32
    return probe_lib


def quantile(hist, width: int, q: float) -> float:
    """The ``q`` quantile of a histogram of ``width``-cycle bins (bin
    centre)."""
    cum = torch.cumsum(hist.double(), 0)
    k = int(torch.searchsorted(cum, q * float(cum[-1])))
    return (k + 0.5) * width


# probe modes (tools/torch_b4_probe.cu)
MODE_ITERATION, MODE_DIVISIONS = 0, 1


def probe(lib, args, live_ref, ph_ref, dev) -> dict:
    """B4's iteration over ``args`` with one lane a warp and with all 32:
    cycles of a live iteration, and each division's cycles and slow-path
    share."""
    from ics_wt_physicsengine_torch.ops import ph_solver as PS

    bins, div_bin, iter_bin = 256, 8, 16
    n = args[0].numel()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads = sms, 128          # four warps an SM, one a scheduler
    caps = PS._cap_table(PS.DEFAULT_ITERS, args[0].dtype, dev)
    pointers = (ctypes.c_void_p * 6)(*(x.data_ptr() for x in args))
    out = {"equal_to_plain": True}
    for mode, all_lanes in ((MODE_ITERATION, 0), (MODE_ITERATION, 1),
                            (MODE_DIVISIONS, 0)):
        div_hist = torch.zeros((7, bins), dtype=torch.int64, device=dev)
        iter_hist = torch.zeros(bins, dtype=torch.int64, device=dev)
        live = torch.zeros(n, dtype=torch.int32, device=dev)
        ph = torch.empty_like(args[0])
        sink = torch.zeros(blocks * threads, dtype=args[0].dtype, device=dev)
        err = lib.wt_b4_probe(
            int(args[0].dtype == torch.float64), mode, all_lanes, pointers,
            caps.data_ptr(), n, PS.DEFAULT_ITERS, PS.PH_TOLERANCE,
            div_hist.data_ptr(), iter_hist.data_ptr(), live.data_ptr(),
            ph.data_ptr(), sink.data_ptr(), blocks, threads,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"probe launch failed ({err})")
        torch.cuda.synchronize()
        out["equal_to_plain"] &= torch.equal(live.long(), live_ref) and \
            torch.equal(torch.nan_to_num(ph, 0.0),
                        torch.nan_to_num(ph_ref, 0.0))
        if mode == MODE_ITERATION:
            h = iter_hist.cpu()
            key = "32_lanes" if all_lanes else "1_lane"
            out[f"iteration_cycles_{key}"] = dict(
                median=quantile(h, iter_bin, 0.5),
                p25=quantile(h, iter_bin, 0.25),
                p75=quantile(h, iter_bin, 0.75),
                p99=quantile(h, iter_bin, 0.99), count=int(h.sum()))
            continue
        rows = []
        centres = (torch.arange(bins, dtype=torch.float64) + 0.5) * div_bin
        for k, name in enumerate(DIVISIONS):
            h = div_hist[k].cpu()
            median = quantile(h, div_bin, 0.5)
            slow = centres > SLOW_FACTOR * median
            count = int(h.sum())
            rows.append(dict(
                division=name, count=count, median_cycles=median,
                mean_cycles=float((h.double() * centres).sum()) / count,
                slow_share=float(h[slow].sum()) / count,
                slow_mean_cycles=float((h[slow].double()
                                        * centres[slow]).sum())
                / max(int(h[slow].sum()), 1),
                excess_cycles_per_iteration=float(
                    (h[slow].double() * (centres[slow] - median)).sum())
                / count))
        out["divisions"] = rows
    return out


def sweep(PS, K, dev, timed) -> list:
    """The current build over launch geometries, in turns (each geometry,
    then in reverse order), at every cell and type."""
    rows = []
    shipped = PS.ph_geometry
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        for cell in K.PH_CELLS:
            cell_args = K.ph_cell_args(cell, dtype, dev)
            n = cell_args[0].numel()
            configs = []
            for threads in (128, 256):
                most = PS._blocks_per_sm(dev.index or 0,
                                         dtype == torch.float64, threads)
                configs += [(b, threads) for b in (1, 2, 3, 4, 6, 8)
                            if b <= most]
            times = {c: [] for c in configs}
            for c in configs + configs[::-1]:
                PS.ph_geometry = lambda *a, c=c, **kw: shipped(
                    n, sms, c[0], c[1])
                try:
                    PS.ph_kernel(*cell_args)                # warm-up
                    times[c].append(timed(lambda: PS.ph_kernel(*cell_args),
                                          REPS[cell])[0])
                finally:
                    PS.ph_geometry = shipped
            for (b, threads), ms in times.items():
                g = shipped(n, sms, b, threads)
                rows.append(dict(cell=cell, dtype=tag, blocks_per_sm=b,
                                 threads=threads, blocks=g.blocks,
                                 ms=sum(ms) / len(ms), runs_ms=ms))
                print(f"sweep {cell} {tag}: {b} blocks of {threads} an SM "
                      f"({g.blocks} x {g.threads}): {sum(ms) / len(ms):.4f} "
                      "ms", flush=True)
    return rows


def loop_stats(lib, PS, K, dev, timed) -> list:
    """The instrumented build (``STATS_EDITS``) once a cell, type,
    geometry and tolerance: what its warps did."""
    from ics_wt_physicsengine_torch.ops import _build

    read = (ctypes.c_ulonglong * len(STATS))()
    lib.wt_b4_stats_read.argtypes = [ctypes.c_void_p]
    shipped_lib = _build.load("ph_solver")
    shipped = PS.ph_geometry
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    _build.use({"ph_solver": lib})
    try:
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype)[6:]
            for cell in K.PH_CELLS:
                cell_args = K.ph_cell_args(cell, dtype, dev)
                n = cell_args[0].numel()
                for label, geometry in (
                        ("shipped", shipped),
                        ("1 block an SM", lambda *a, **kw: shipped(
                            n, sms, 1))):
                    for tol in (PS.PH_TOLERANCE, 0.0):
                        PS.ph_geometry = geometry
                        PS.ph_kernel(*cell_args, tolerance=tol)
                        lib.wt_b4_stats_clear()
                        ms, _ = timed(lambda: PS.ph_kernel(
                            *cell_args, tolerance=tol), 1)
                        lib.wt_b4_stats_read(read)
                        PS.ph_geometry = shipped
                        st = dict(zip(STATS, read))
                        turns = max(st["turns"], 1)
                        row = dict(
                            cell=cell, dtype=tag, geometry=label,
                            tolerance=tol, ms=ms, **st,
                            turns_per_warp=st["turns"] / st["warps"],
                            lane_use=st["active_lanes"] / (32 * turns),
                            refill_share_of_turns=st["refill_turns"] / turns,
                            cycles_per_turn=st["warp_cycles"] / turns,
                            iterate_cycles_per_turn=st["iterate_cycles"]
                            / turns,
                            cycles_per_refill=st["refill_cycles"]
                            / max(st["refill_turns"], 1))
                        rows.append(row)
                        print(f"stats {cell} {tag} {label} tolerance {tol:g}"
                              f": {ms:.4f} ms (instrumented); "
                              f"{st['warps']} warps, "
                              f"{row['turns_per_warp']:.1f} turns a warp "
                              f"(longest warp {st['max_warp_cycles']} "
                              f"cycles), lanes in use "
                              f"{row['lane_use']:.3f}, refills in "
                              f"{row['refill_share_of_turns']:.3f} of turns "
                              f"at {row['cycles_per_refill']:.0f} cycles, "
                              f"{row['cycles_per_turn']:.0f} cycles a turn "
                              f"of which iterating "
                              f"{row['iterate_cycles_per_turn']:.0f}",
                              flush=True)
    finally:
        PS.ph_geometry = shipped
        _build.use({"ph_solver": shipped_lib})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("old", type=Path)
    parser.add_argument("--ablate", action="store_true")
    parser.add_argument("--probe", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--stats", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_b4_compare: no CUDA device is available",
              file=sys.stderr)
        return 2
    from ics_wt_physicsengine_torch.ops import _build
    from ics_wt_physicsengine_torch.ops import kernel_checks as K
    from ics_wt_physicsengine_torch.ops import ph_solver as PS

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    # ---- builds ---------------------------------------------------------
    probe_dir = Path(ROOT) / "dist" / "probe"
    ablations = {
        name: ablated_sources(_build.CSRC, probe_dir / "ablate_b4" / name,
                              edits)
        for name, edits in (ABLATIONS.items() if args.ablate else ())}
    if args.stats:
        ablations["stats"] = ablated_sources(
            _build.CSRC, probe_dir / "ablate_b4" / "stats", STATS_EDITS)
    with ThreadPoolExecutor(3 + len(ablations)) as pool:
        new = pool.submit(_build.build)
        ablated = {name: pool.submit(nvcc_build, src, ("ph_solver",),
                                     probe_dir / "builds_b4" / name,
                                     _build.NVCC_FLAGS)
                   for name, src in ablations.items()}
        probe_lib = pool.submit(build_probe, probe_dir / "b4_probe") \
            if args.probe else None
        old = nvcc_build(args.old, ("ph_solver",),
                         probe_dir / "builds_b4" / "old", _build.NVCC_FLAGS)
        new_path = new.result()["ph_solver"]
        ablated = {name: f.result()["ph_solver"] for name, f in
                   ablated.items()}
        probe_lib = probe_lib.result() if probe_lib else None
    logs = {"old": old["ph_solver"][1],
            "new": _build.build_info["ph_solver"]["log"]}
    logs.update({name: log for name, (_, log) in ablated.items()})
    report = dict(card=card, torch=torch.__version__, rounds=ROUNDS,
                  reps=REPS, registers={}, cells=[])
    for build, log in logs.items():
        rows = registers(log)
        report["registers"][build] = rows
        for kernel, regs, spills, stack in rows:
            print(f"  {build:>11} {kernel[:60]:<60} {regs:4d} registers, "
                  f"{spills} bytes spilled, {stack} bytes stack")
    old_lib = bind_old(old["ph_solver"][0])
    libs = {"new": _build.bind("ph_solver", new_path)}
    libs.update({name: _build.bind("ph_solver", path)
                 for name, (path, _) in ablated.items()})
    stats_lib = libs.pop("stats", None)
    _build.use({"ph_solver": libs["new"]})

    def on(name, cell_args):
        def run():
            _build.use({"ph_solver": libs[name]})
            try:
                return PS.ph_kernel(*cell_args)
            finally:
                _build.use({"ph_solver": libs["new"]})
        return run

    dev = torch.device("cuda")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    ok = True
    probe_rows = []
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        for cell in K.PH_CELLS:
            cell_args = K.ph_cell_args(cell, dtype, dev)
            ref, live = PS.ph_live_iters(*cell_args)
            bounds = K.ph_bounds(cell_args, live)
            runs = {"old": lambda a=cell_args: old_kernel(old_lib, a)}
            runs.update({name: on(name, cell_args) for name in libs})
            times = {name: [] for name in runs}
            results = {}
            order = (list(runs) + list(runs)[::-1]) * ROUNDS
            for name in order:
                if name not in results:
                    results[name] = runs[name]()            # warm-up
                ms, _ = timed(runs[name], REPS[cell])
                times[name].append(ms)
            mean = {name: sum(v) / len(v) for name, v in times.items()}
            diffs = {name: K.ph_diff(x, results["old"])
                     for name, x in results.items()}
            equal = {name: d["bit_equal"] and d["nan_equal"]
                     for name, d in diffs.items()}
            plain = K.ph_diff(results["new"], ref)
            equal_plain = plain["bit_equal"] and plain["nan_equal"]
            under = {name: ms < bounds["live_ms"]
                     for name, ms in mean.items() if name != "old"}
            ok &= all(equal.values()) and equal_plain \
                and not any(under.values())
            report["cells"].append(dict(
                cell=cell, dtype=tag, ms=mean, runs_ms=times,
                equal_to_old=equal, new_equal_to_plain=equal_plain,
                under_live_bound=under, **bounds))
            text = ", ".join(f"{name} {ms:.4f} ms" for name, ms in
                             mean.items())
            print(f"{cell} {tag}: {text}; new / old "
                  f"{mean['new'] / mean['old']:.4f}; bit-equal to old: "
                  f"{all(equal.values())}, new to plain: {equal_plain}; "
                  f"mean live iterations {bounds['mean_live']:.3f}; bound "
                  f"{bounds['fixed_ms']:.5f} ms all iterations "
                  f"({bounds['fixed_by']}), {bounds['live_ms']:.5f} ms live "
                  f"({bounds['live_by']}); new / live bound "
                  f"{mean['new'] / bounds['live_ms']:.2f}", flush=True)
            if probe_lib is not None:
                row = probe(probe_lib, cell_args, live, ref, dev)
                row.update(cell=cell, dtype=tag)
                probe_rows.append(row)
                ok &= row["equal_to_plain"]
                print(f"  probe {cell} {tag}: pH and live iterations equal "
                      f"to plain: {row['equal_to_plain']}", flush=True)
                for key, c in row.items():
                    if key.startswith("iteration_cycles_"):
                        print(f"    one live iteration, "
                              f"{key[17:].replace('_', ' ')}: median "
                              f"{c['median']:.0f} cycles (p25 {c['p25']:.0f},"
                              f" p75 {c['p75']:.0f}, p99 {c['p99']:.0f}; "
                              f"{c['count']} iterations)", flush=True)
                for d in row["divisions"]:
                    print(f"    {d['division']:<32} median "
                          f"{d['median_cycles']:.0f} cycles, mean "
                          f"{d['mean_cycles']:.1f}; slow share "
                          f"{d['slow_share']:.5f} (mean "
                          f"{d['slow_mean_cycles']:.0f} cycles), excess "
                          f"{d['excess_cycles_per_iteration']:.2f} cycles "
                          "an iteration", flush=True)
            del cell_args, ref, live, results
    if probe_rows:
        report["probe"] = probe_rows
    if args.sweep:
        report["sweep"] = sweep(PS, K, dev, timed)
    if stats_lib is not None:
        report["stats"] = loop_stats(stats_lib, PS, K, dev, timed)
        from torch_rollout_probe import sass_summary
        report["sass"] = sass_summary(new_path, Path(out_dir) / "ph.sass")
        for name, s in report["sass"].items():
            print(f"SASS {name[:60]}: {s['instructions']} instructions, "
                  f"MUFU {s['mufu']}, CALL {s['call']}, LDL/STL "
                  f"{s['local']}, FP32 {s['fp32']}, FP64 {s['fp64']}; top "
                  f"{s['top'][:8]}", flush=True)

    with open(os.path.join(out_dir, "torch_b4_compare.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
