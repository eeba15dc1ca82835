#!/usr/bin/env python3
"""Kernels B1, B2 and B3 of an earlier commit beside the current ones, in
one call on one CUDA card.

    mkdir -p dist/probe/old
    git archive 41a20d1 ics_wt_physicsengine_torch/csrc \\
        | tar -x -C dist/probe/old
    python3 tools/torch_rollout_compare.py \\
        dist/probe/old/ics_wt_physicsengine_torch/csrc [--variant]

The argument is a csrc directory whose ``fused_rollout.cu`` has the C
interface of commit 41a20d1 (no geometry arguments: 256 / Z plants a
block) and whose ``fused_plant.cu`` has the current one. Both libraries are
built from there and from the current sources at once (one nvcc process
per source), and each build's -Xptxas -v registers and spills are printed.

Then, in float32, each cell with the builds in turns (old, new, then
reversed, after a warm-up of each; two launches a turn), their mean
CUDA-event times, and whether every build's result is bit-equal to the old
one's: B1 at MC-4096 x 7200 and MC-32768 x 2000 (RK4 3 x 4, RKC-fast
1 x 4, ``make_monte_carlo_batch(seed=0)``, chip_smoke.py's dosing policy),
B2 at SCHED-1 x 32768 (RKC-fast, the bench schedule), B3 at PLANT-4096 x
2000 (RK4, recorded every 100) and PLANT-1 x 16384 (RK4, RKC-fast; Philox).
``--variant`` adds, for B1/B2, the current build in the layout that
``rollout_geometry`` does not pick ("new-packed" or "new-warp"; cells whose
zones do not fit a warp have none). ``--ablate`` builds three copies of
the current sources, each with one part of the design taken out (string
replacements in ``ABLATIONS``), and times their B1/B2 beside the shipped
build at MC-4096 and SCHED-1. ``--sweep`` then times the current B1
in both layouts, in turns, at RK4 3 x 4 over batches of 20-zone plants
from 1 to 4096 (1000 steps) and over zone counts that fit a warp at 4096
and 32768 plants: the numbers ``rollout_geometry``'s rule rests on. Prints the card's name and power limit;
writes chiprun_out/torch_rollout_compare.json. Exits non-zero without a
CUDA card or when a result differs.
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

REPS = 2
DT = 1.0

# One part of the design taken out of a copy of the current sources:
# {name: [(file, text, replacement), ...]}.
ABLATIONS = {
    # B2 loads its row and builds its source terms at the top of each step
    "row-at-step": [
        ("fused_rollout.cu",
         """        // the next step's row, loaded while this step's evaluations run
        const int next = i + 1 < a.n_steps ? i + 1 : i;
        const S* row = a.forcing + static_cast<int64_t>(next) * kBoundaryCols;
#pragma unroll
        for (int k = 0; k < kBoundaryCols; ++k) row_next[k] = __ldg(row + k);""",
         """        const S* row = a.forcing + static_cast<int64_t>(i) * kBoundaryCols;
        b = boundary_terms(p, [&](int k) { return __ldg(row + k); });"""),
        ("fused_rollout.cu",
         """      if (kScheduled) {
        b = boundary_terms(p, [&](int k) { return row_next[k]; });
      }""", ""),
    ],
    # the warp layout computes both interface rates in every zone
    "k-iface-twice": [
        ("fused_rollout.cuh",
         "    const S k_dn = __shfl_up_sync(kFullWarp, k_up, 1);",
         "    const S k_dn = k_iface(p, __shfl_up_sync(kFullWarp, rho, 1),"
         " rho);"),
    ],
    # zero dividends take the IEEE division's slow path again
    "zero-slow-path": [
        ("fused_rollout.cuh",
         "  const bool zero = a == S(0.0);\n"
         "  const S q = opaque(zero ? S(1.0) : a) / b;",
         "  const bool zero = false;\n  const S q = a / b;"),
        ("fused_rollout.cuh", "  const bool flat = num == S(0.0);",
         "  const bool flat = false;"),
        ("fused_rollout.cuh", "opaque(flat ? S(1.0) : num)", "num"),
    ],
}


def ablated_sources(csrc: Path, out: Path, edits) -> Path:
    """A copy of ``csrc`` in ``out`` with ``edits`` applied (each must
    match once)."""
    out.mkdir(parents=True, exist_ok=True)
    for src in csrc.iterdir():
        (out / src.name).write_text(src.read_text())
    for name, text, replacement in edits:
        body = (out / name).read_text()
        if body.count(text) != 1:
            raise RuntimeError(f"ablation text not found once in {name}: "
                               f"{text[:60]!r}")
        (out / name).write_text(body.replace(text, replacement))
    return out


def bind_old_rollout(path):
    """The B1/B2 library of commit 41a20d1 (no geometry arguments)."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.wt_rollout_fused, lib.wt_rollout_scheduled):
        fn.argtypes = [i32, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr,
                       ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f64, ptr]
        fn.restype = i32
    return lib


def old_rollout(lib, scheduled, ptab, forcing, ph, cl, t, *, dt, substeps,
                n_steps, stages=None):
    """B1 (or B2) through the old C interface; returns (ph, cl, t)."""
    from ics_wt_physicsengine_torch.ops import fused_rollout as F

    batch, n_zones = ph.shape
    outs = [torch.empty_like(ph) for _ in range(3)]
    h_step = dt / substeps
    rkc = F._rkc_host_table(stages, h_step) if stages is not None else None
    fn = lib.wt_rollout_scheduled if scheduled else lib.wt_rollout_fused
    err = fn(int(ph.dtype == torch.float64), ptab.data_ptr(),
             forcing.data_ptr(),
             ctypes.cast(rkc, ctypes.c_void_p) if rkc is not None else None,
             stages or 0, ph.data_ptr(), cl.data_ptr(), t.data_ptr(),
             *(x.data_ptr() for x in outs), None, None, None, batch,
             n_zones, n_steps, substeps, 0, h_step,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old B1/B2 launch failed ({err})")
    return tuple(outs)


def sweep(F, K, dev) -> list:
    """B1 (RK4 3 x 4) in the packed and the warp layout, in turns
    (packed, warp, warp, packed), by zone count and batch."""
    rows = []
    cells = [(20, b, 1000) for b in (1, 32, 132, 264, 528, 1056, 2112,
                                     4096)]
    cells += [(z, b, 1000 if b == 4096 else 250)
              for z in (5, 8, 11, 16, 32) for b in (4096, 32768)]
    for n_zones, batch, n_steps in cells:
        ptab, btab, y = K.tables(n_zones, batch, torch.float32, dev)
        times = {"packed": [], "warp": []}
        results = {}
        for name in ("packed", "warp", "warp", "packed"):
            make = F.packed_geometry if name == "packed" else F.warp_geometry
            shipped = F.rollout_geometry
            F.rollout_geometry = make
            try:
                def run():
                    return F.rollout_kernel(ptab, btab, *y, dt=DT,
                                            substeps=3, n_steps=n_steps)
                results.setdefault(name, run())                 # warm-up
                ms, _ = timed(run, REPS)
            finally:
                F.rollout_geometry = shipped
            times[name].append(ms)
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        equal = all(torch.equal(a, b) for a, b in zip(results["packed"][:3],
                                                      results["warp"][:3]))
        pick = F.rollout_geometry(n_zones, batch).layout
        rows.append(dict(n_zones=n_zones, batch=batch, n_steps=n_steps,
                         ms=mean, equal=equal,
                         rule="warp" if pick == F.WARP else "packed"))
        print(f"sweep Z={n_zones} B={batch} x{n_steps}: packed "
              f"{mean['packed']:.3f} ms, warp {mean['warp']:.3f} ms, warp / "
              f"packed {mean['warp'] / mean['packed']:.4f}; rule picks "
              f"{rows[-1]['rule']}; layouts bit-equal: {equal}", flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("old", type=Path)
    parser.add_argument("--variant", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--ablate", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_rollout_compare: no CUDA device is available",
              file=sys.stderr)
        return 2
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.models import plant as P
    from ics_wt_physicsengine_torch.ops import _build
    from ics_wt_physicsengine_torch.ops import fused_plant as FP
    from ics_wt_physicsengine_torch.ops import fused_rollout as F
    from ics_wt_physicsengine_torch.ops import kernel_checks as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    # ---- builds ---------------------------------------------------------
    names = ("fused_rollout", "fused_plant")
    probe = Path(ROOT) / "dist" / "probe"
    ablations = {
        name: ablated_sources(_build.CSRC, probe / "ablate" / name, edits)
        for name, edits in (ABLATIONS.items() if args.ablate else ())}
    with ThreadPoolExecutor(2 + len(ablations)) as pool:
        new = pool.submit(_build.build)
        ablated = {name: pool.submit(nvcc_build, src, ("fused_rollout",),
                                     probe / "builds" / name,
                                     _build.NVCC_FLAGS)
                   for name, src in ablations.items()}
        old = nvcc_build(args.old, names, probe / "builds" / "old",
                         _build.NVCC_FLAGS)
        new_paths = new.result()
        ablated = {name: f.result()["fused_rollout"][0]
                   for name, f in ablated.items()}
    logs = {"old": {n: old[n][1] for n in names},
            "new": {n: _build.build_info[n]["log"] for n in names}}
    report = dict(card=card, torch=torch.__version__, reps=REPS,
                  registers={}, cells=[])
    for build, libs in logs.items():
        for lib, log in libs.items():
            rows = registers(log)
            report["registers"][f"{build}/{lib}"] = rows
            for kernel, regs, spills, stack in rows:
                print(f"  {build:>4} {kernel[:64]:<64} {regs:4d} registers,"
                      f" {spills} bytes spilled, {stack} bytes stack")
    old_rollout_lib = bind_old_rollout(old["fused_rollout"][0])
    rollout_libs = {"new": _build.bind("fused_rollout",
                                       new_paths["fused_rollout"])}
    rollout_libs.update({name: _build.bind("fused_rollout", path)
                         for name, path in ablated.items()})
    plant_libs = {"old": _build.bind("fused_plant", old["fused_plant"][0]),
                  "new": _build.bind("fused_plant", new_paths["fused_plant"])}
    _build.use({"fused_rollout": rollout_libs["new"],
                "fused_plant": plant_libs["new"]})

    def in_turns(label, runs):
        order = list(runs) + list(runs)[::-1]
        times = {name: [] for name in runs}
        results = {}
        for name in order:
            if name not in results:
                results[name] = runs[name]()                # warm-up
            ms, _ = timed(runs[name], REPS)
            times[name].append(ms)
        mean = {name: sum(v) / len(v) for name, v in times.items()}
        if isinstance(results["old"], FP.PlantResult):
            diffs = [K.plant_diff(results[name], results["old"])
                     for name in runs if name != "old"]
            equal = all(d["max_abs_err"] == 0.0 and d["nan_equal"]
                        and d["ints_equal"] for d in diffs)
        else:
            equal = all(torch.equal(a, b) for name in runs if name != "old"
                        for a, b in zip(results[name][:3],
                                        results["old"][:3]))
        report["cells"].append(dict(cell=label, ms=mean, runs_ms=times,
                                    equal_to_old=equal))
        text = ", ".join(f"{name} {ms:.3f} ms" for name, ms in mean.items())
        print(f"{label}: {text}; new / old {mean['new'] / mean['old']:.4f};"
              f" bit-equal to old: {equal}", flush=True)
        return equal

    def with_geometry(make, fn):
        """``fn`` run with ``rollout_geometry`` replaced by ``make``."""
        def run():
            shipped = F.rollout_geometry
            F.rollout_geometry = make
            try:
                return fn()
            finally:
                F.rollout_geometry = shipped
        return run

    def with_library(name, fn):
        """``fn`` run on the B1/B2 library ``name``."""
        def run():
            _build.use({"fused_rollout": rollout_libs[name]})
            try:
                return fn()
            finally:
                _build.use({"fused_rollout": rollout_libs["new"]})
        return run

    def rollout_runs(scheduled, ptab, forcing, y, ablate=False, **kw):
        kernel = F.scheduled_kernel if scheduled else F.rollout_kernel
        new_kw = {k: v for k, v in kw.items()
                  if not (scheduled and k == "n_steps")}
        runs = {"old": lambda: old_rollout(old_rollout_lib, scheduled, ptab,
                                           forcing, *y, **kw),
                "new": lambda: kernel(ptab, forcing, *y, **new_kw)}
        if ablate:
            runs.update({name: with_library(name, runs["new"])
                         for name in ablated})
        batch, n_zones = y[0].shape
        if args.variant and n_zones <= F.WARP_SIZE:
            shipped = F.rollout_geometry(n_zones, batch).layout
            other = F.warp_geometry if shipped == F.PACKED \
                else F.packed_geometry
            tag = "new-warp" if shipped == F.PACKED else "new-packed"
            runs[tag] = with_geometry(other, runs["new"])
        return runs

    ok = True
    f32 = torch.float32
    dev = torch.device("cuda")
    policy = R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.4, inlet_chlorine=0.2,
        chlorine_flow_rate=0.15, chlorine_concentration=50.0,
        acid_flow_rate=0.05)
    for n_plants, n_steps in ((4096, 7200), (32768, 2000)):
        ptab, btab, y = K.tables(20, n_plants, f32, dev, bc=policy)
        for tag, (m, s) in (("rk4", (3, None)), ("fast", (1, 4))):
            ok &= in_turns(
                f"B1 MC-{n_plants} x{n_steps} {tag} ({m}x{s or 4})",
                rollout_runs(False, ptab, btab, y, dt=DT, substeps=m,
                             n_steps=n_steps, stages=s,
                             ablate=n_plants == 4096 and tag == "rk4"))
        del ptab, btab, y
    p1, _, y1 = K.tables(20, 1, f32, dev)
    sched = F.schedule_table(K.bench_schedule(32768), 32768, f32, dev)
    m, s = R.default_rkc_plan(R.ReactorConfiguration(n_zones=20), DT,
                              mode="fast")
    ok &= in_turns(f"B2 SCHED-1 x32768 fast ({m}x{s})",
                   rollout_runs(True, p1, sched, y1, dt=DT, substeps=m,
                                n_steps=32768, stages=s, ablate=True))

    # ---- B3: the physics it shares, old build against new ----------------
    cfg = R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                 n_zones=20)
    params, plant = P.make_plant(cfg, dtype=f32, device=dev)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5, acid_flow_rate=0.1)
    bparams, bplant = P.make_plant_batch(R.ReactorConfiguration(n_zones=20),
                                         4096, seed=1, dtype=f32, device=dev)
    m_batch = R.default_substeps(R.ReactorConfiguration(n_zones=20), DT)
    m_rk4 = R.default_substeps(cfg, DT)
    m_rkc, s_rkc = R.default_rkc_plan(cfg, DT, mode="fast")
    cells = [("B3 PLANT-4096 x2000 rk4", bparams, bplant, m_batch, None,
              2000, 100),
             ("B3 PLANT-1 x16384 rk4", params, plant, m_rk4, None, 16384,
              16384),
             ("B3 PLANT-1 x16384 fast", params, plant, m_rkc, s_rkc, 16384,
              16384)]
    for label, prm, plt, m, s, n_steps, every in cells:
        tables = FP.build_tables(prm, plt, bc, dt=DT, n_steps=n_steps)
        kw = dict(dt=DT, substeps=m, stages=s, n_steps=n_steps,
                  record_every=every, seed=7)

        def run(name, tables=tables, kw=kw):
            def go():
                _build.use({"fused_plant": plant_libs[name]})
                return FP.plant_kernel(tables, **kw)
            return go
        ok &= in_turns(label, {name: run(name) for name in plant_libs})
    _build.use({"fused_plant": plant_libs["new"]})

    if args.sweep:
        report["sweep"] = sweep(F, K, dev)

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_rollout_compare.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
