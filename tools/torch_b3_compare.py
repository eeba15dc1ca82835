#!/usr/bin/env python3
"""Kernel B3 of an earlier commit beside the current one, in one call on
one CUDA card; and where the B3 wrapper's time goes at HIL-3600.

    mkdir -p dist/probe/old
    git archive 4860970 ics_wt_physicsengine_torch/csrc \\
        | tar -x -C dist/probe/old
    python3 tools/torch_b3_compare.py \\
        dist/probe/old/ics_wt_physicsengine_torch/csrc \\
        [--variant NAME=CSRC_DIR ...]

The first argument is a csrc directory whose ``fused_plant.cu`` has the
one-sensor-thread C interface of commit 4860970 (a 46-int ``statics``
array, no geometry arguments). Each ``--variant`` is a
csrc directory with the current C interface (for example the current
sources with another register cap), timed beside the shipped build.

Everything is built at once (one nvcc process per source) and each build's
-Xptxas -v registers and spills are printed. Then, in float32 with the
Philox stream: PLANT-4096 (4096 x 20 x 2000 steps recorded every 100),
PLANT-1 rk4 / fast / sched (1 x 20 x 16384 steps) and HIL-3600 (the first
3600-step segment of chip_smoke.py's day, recorded every 60), each with
the builds in turns (old, new, variants, then reversed, after a warm-up of
each), their mean CUDA-event times, the physics alone (B1/B2 of the
current build on the same tables), and whether every build's result is
bit-equal to the old one's; where the current layout gives each sensor a
warp of its own (one plant), the current build with the sensor lanes
packed into one warp ("new-packed") runs too. Then the
wrapper at HIL-3600, two chained segments through plant_rollout_fused:
host-clock milliseconds (each part ends in a synchronize) of the tables
without and with the sample-line lead-in, the launch, and the rest (ring
rebuild and the new PlantState), and the CUDA kernels one call launches
(torch.profiler). Prints the card's name and power limit; writes
chiprun_out/torch_b3_compare.json. Exits non-zero without a CUDA card or
when a result differs.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 2
DT = 1.0


def timed(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def host_ms(fn, reps=5):
    """Mean host-clock milliseconds of ``fn`` followed by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def nvcc_build(csrc: Path, names, out_dir: Path, flags):
    """``{name: (library path, ptxas log)}`` of ``csrc/<name>.cu``."""
    from ics_wt_physicsengine_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)

    def one(name):
        lib = out_dir / f"libwt_{name}.so"
        proc = subprocess.run(
            [_build.nvcc_path(), *flags, "-o", str(lib),
             str(csrc / f"{name}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        return name, (lib, proc.stdout + proc.stderr)
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(pool.map(one, names))


def registers(log: str) -> list:
    """``(kernel, registers, spill stores, stack bytes)`` per entry."""
    rows, name, stack = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spills = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spills, stack))
            name = None
    return rows


def bind_old_plant(path):
    """The one-sensor-thread B3 library of commit 4860970."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.wt_plant_rollout.argtypes = (
        [i32, ptr, ptr, i32, ptr, i32] + [ptr] * 5 + [ctypes.c_ulonglong]
        + [ptr] * 13 + [i32] * 5 + [f64, f64, ptr])
    lib.wt_plant_rollout.restype = i32
    return lib


def old_plant_kernel(lib, tables, *, dt, substeps, n_steps, stages=None,
                     record_every=1, seed=0):
    """``fused_plant.plant_kernel`` through the old C interface."""
    from ics_wt_physicsengine_torch.ops import fused_plant as FP
    from ics_wt_physicsengine_torch.ops import fused_rollout as F

    ph = tables.ph
    batch, n_zones = ph.shape
    out = FP.PlantResult(
        ph=torch.empty_like(ph), cl=torch.empty_like(ph),
        t=torch.empty_like(ph), time=torch.empty_like(tables.time),
        carry_float=torch.empty_like(tables.carry_float),
        carry_int=torch.empty_like(tables.carry_int),
        hist=[x.clone() for x in tables.lead],
        readings=torch.empty((n_steps // record_every, len(FP.SENSORS),
                              batch), dtype=ph.dtype, device=ph.device))
    fields = FP.statics_fields(tables.statics)
    flat = [v for name in FP.STATICS_FIELDS[:6] for v in fields[name]] \
        + fields["d_max"]
    statics = (ctypes.c_int * len(flat))(*flat)
    h_step = dt / substeps
    rkc = F._rkc_host_table(stages, h_step) if stages is not None else None
    hist = (ctypes.c_void_p * 4)(*(x.data_ptr() for x in out.hist))
    err = lib.wt_plant_rollout(
        int(ph.dtype == torch.float64), tables.ptab.data_ptr(),
        tables.forcing.data_ptr(), int(tables.scheduled),
        ctypes.cast(rkc, ctypes.c_void_p) if rkc is not None else None,
        stages or 0, tables.sensor_params.data_ptr(),
        tables.carry_float.data_ptr(), tables.carry_int.data_ptr(),
        tables.delay_steps.data_ptr(), None, seed, tables.time.data_ptr(),
        tables.ph.data_ptr(), tables.cl.data_ptr(), tables.t.data_ptr(),
        out.ph.data_ptr(), out.cl.data_ptr(), out.t.data_ptr(),
        out.time.data_ptr(), out.carry_float.data_ptr(),
        out.carry_int.data_ptr(), ctypes.cast(hist, ctypes.c_void_p),
        out.readings.data_ptr(), ctypes.cast(statics, ctypes.c_void_p),
        batch, n_zones, n_steps, substeps, record_every, h_step, dt,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old B3 launch failed ({err})")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("old", type=Path)
    parser.add_argument("--variant", action="append", default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_b3_compare: no CUDA device is available",
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
    variants = dict(v.split("=", 1) for v in args.variant)
    probe = Path(ROOT) / "dist" / "probe" / "builds"
    jobs = {"old": (args.old, ("fused_plant",))}
    jobs.update({name: (Path(d), ("fused_plant",))
                 for name, d in variants.items()})
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        new = pool.submit(_build.build)
        built = dict(zip(jobs, pool.map(
            lambda item: nvcc_build(item[1][0], item[1][1],
                                    probe / item[0], _build.NVCC_FLAGS),
            jobs.items())))
        new_paths = new.result()
    logs = {"new": {"fused_plant": _build.build_info["fused_plant"]["log"]}}
    logs.update({name: {n: log for n, (_, log) in libs.items()}
                 for name, libs in built.items()})
    report = dict(card=card, torch=torch.__version__, reps=REPS,
                  registers={}, cells=[])
    for build, libs in logs.items():
        for lib, log in libs.items():
            rows = registers(log)
            report["registers"][f"{build}/{lib}"] = rows
            for kernel, regs, spills, stack in rows:
                print(f"  {build:>8} {kernel[:60]:<60} {regs:4d} registers,"
                      f" {spills} bytes spilled, {stack} bytes stack")

    plant_libs = {"old": bind_old_plant(built["old"]["fused_plant"][0]),
                  "new": _build.bind("fused_plant",
                                     new_paths["fused_plant"])}
    plant_libs.update({name: _build.bind("fused_plant",
                                         built[name]["fused_plant"][0])
                       for name in variants})
    _build.use({"fused_plant": plant_libs["new"],
                "fused_rollout": _build.bind("fused_rollout",
                                             new_paths["fused_rollout"])})

    def plant_run(name, tables, kw):
        if name == "old":
            return lambda: old_plant_kernel(plant_libs["old"], tables, **kw)
        if name == "new-packed":
            def packed():
                shipped = FP.plant_geometry
                FP.plant_geometry = lambda z, b: dataclasses.replace(
                    shipped(z, b), sensor_stride=shipped(z, b)
                    .plants_per_block)
                try:
                    _build.use({"fused_plant": plant_libs["new"]})
                    return FP.plant_kernel(tables, **kw)
                finally:
                    FP.plant_geometry = shipped
            return packed

        def run():
            _build.use({"fused_plant": plant_libs[name]})
            return FP.plant_kernel(tables, **kw)
        return run

    def in_turns(label, runs, extra=None):
        order = list(runs) + list(runs)[::-1]
        times = {name: [] for name in runs}
        results = {}
        for name in order:
            if name not in results:
                results[name] = runs[name]()                # warm-up
            ms, _ = timed(runs[name], REPS)
            times[name].append(ms)
        mean = {name: sum(v) / len(v) for name, v in times.items()}
        same = {name: K.plant_diff(results[name], results["old"])
                if isinstance(results["old"], FP.PlantResult) else
                dict(max_abs_err=max(float((a - b).abs().max()) for a, b in
                                     zip(results[name][:3],
                                         results["old"][:3])))
                for name in runs if name != "old"}
        equal = all(d["max_abs_err"] == 0.0 and d.get("nan_equal", True)
                    and d.get("ints_equal", True) for d in same.values())
        row = dict(cell=label, ms=mean, runs_ms=times,
                   equal_to_old=equal, **(extra or {}))
        report["cells"].append(row)
        text = ", ".join(f"{name} {ms:.3f} ms" for name, ms in mean.items())
        print(f"{label}: {text}; new / old {mean['new'] / mean['old']:.4f};"
              f" bit-equal to old: {equal}"
              + "".join(f"; {k} {v:.3f} ms" for k, v in (extra or {}).items()
                        if isinstance(v, float)), flush=True)
        return equal

    ok = True
    f32 = torch.float32
    dev = torch.device("cuda")
    cfg = R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                 n_zones=20)
    params, plant = P.make_plant(cfg, dtype=f32, device=dev)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5, acid_flow_rate=0.1)
    m_rk4 = R.default_substeps(cfg, DT)
    m_rkc, s_rkc = R.default_rkc_plan(cfg, DT, mode="fast")
    n = 16384
    t_axis = np.arange(n)
    sched = R.BoundaryConditions(
        inlet_flow_rate=(5.0 + 2.0 * np.sin(2 * np.pi * t_axis / 17.0)
                         ).astype(np.float32), inlet_pH=7.2,
        inlet_chlorine=np.where(t_axis % 10 < 5, 0.5, 1.5).astype(np.float32),
        acid_flow_rate=np.where(t_axis % 8 < 4, 0.0, 0.3).astype(np.float32))
    seg, rec = 3600, 60
    hours = np.arange(2 * seg, dtype=np.float64) / 3600.0
    day = dict(
        inlet_flow_rate=(5.0 + 2.0 * np.sin(2 * np.pi * (hours - 7) / 24.0)
                         ).astype(np.float32),
        inlet_pH=7.4, inlet_chlorine=0.3,
        inlet_temperature=(18.0 + 5.0 * np.sin(2 * np.pi * (hours - 14)
                                               / 24.0)).astype(np.float32),
        acid_flow_rate=np.where((hours % 1.0) < 0.1, 0.25, 0.0
                                ).astype(np.float32),
        chlorine_flow_rate=np.where((hours > 11) & (hours < 13), 0.3, 0.05
                                    ).astype(np.float32),
        ambient_temperature=15.0, heat_loss_coefficient=50.0)
    segments = [R.BoundaryConditions(**{
        k: (v[i * seg:(i + 1) * seg] if np.ndim(v) else v)
        for k, v in day.items()}) for i in range(2)]
    bparams, bplant = P.make_plant_batch(R.ReactorConfiguration(n_zones=20),
                                         4096, seed=1, dtype=f32, device=dev)
    m_batch = R.default_substeps(R.ReactorConfiguration(n_zones=20), DT)

    cells = [("PLANT-4096 x2000 rk4", bparams, bplant, bc, m_batch, None,
              2000, 100),
             ("PLANT-1 x16384 rk4", params, plant, bc, m_rk4, None, n, n),
             ("PLANT-1 x16384 fast", params, plant, bc, m_rkc, s_rkc, n, n),
             ("PLANT-1 x16384 sched", params, plant, sched, m_rk4, None, n,
              n),
             ("HIL-3600 segment rk4", params, plant, segments[0], m_rk4,
              None, seg, rec)]
    for label, prm, plt, boundary, m, s, n_steps, every in cells:
        tables = FP.build_tables(prm, plt, boundary, dt=DT, n_steps=n_steps)
        kw = dict(dt=DT, substeps=m, stages=s, n_steps=n_steps,
                  record_every=every, seed=7)
        y = (tables.ph, tables.cl, tables.t)
        if tables.scheduled:
            def physics():
                return F.scheduled_kernel(tables.ptab, tables.forcing, *y,
                                          dt=DT, substeps=m, stages=s)
        else:
            def physics():
                return F.rollout_kernel(tables.ptab, tables.forcing, *y,
                                        dt=DT, substeps=m, stages=s,
                                        n_steps=n_steps)
        physics()                                           # warm-up
        physics_ms, _ = timed(physics, REPS)
        names = list(plant_libs)
        g = FP.plant_geometry(20, tables.ph.shape[0])
        if g.sensor_stride != g.plants_per_block:
            names.append("new-packed")
        runs = {name: plant_run(name, tables, kw) for name in names}
        ok &= in_turns(label, runs, dict(physics_ms=physics_ms))
    _build.use({"fused_plant": plant_libs["new"]})

    # ---- the wrapper at HIL-3600 -------------------------------------------
    def hil():
        p = plant
        for i, boundary in enumerate(segments):
            p, _ = FP.plant_rollout_fused(params, p, boundary, dt=DT,
                                          substeps=m_rk4, n_steps=seg,
                                          record_every=rec, seed=7 + i)
        return p
    hil()
    call_ms, _ = host_ms(hil)
    call_ms /= 2
    second = hil()      # a plant whose rings hold 31 samples, as segment 2
    parts = {}
    for name, consume in (("tables without lead-in", False),
                          ("tables with lead-in", True)):
        parts[name], tables = host_ms(lambda: FP.build_tables(
            params, second, segments[1], dt=DT, n_steps=seg,
            consume_line=consume))
    kw = dict(dt=DT, substeps=m_rk4, n_steps=seg, record_every=rec, seed=8)
    launch_host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        FP.plant_kernel(tables, **kw)
        launch_host.append((time.perf_counter() - t0) * 1e3)
    parts["launch (host, enqueue)"] = sum(launch_host) / len(launch_host)
    parts["kernel (device)"], _ = timed(lambda: FP.plant_kernel(tables, **kw),
                                        REPS)
    parts["rest (ring rebuild, new state)"] = call_ms \
        - parts["tables with lead-in"] - parts["kernel (device)"]
    parts["lead-in"] = parts["tables with lead-in"] \
        - parts["tables without lead-in"]
    launches = None
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            FP.plant_rollout_fused(params, second, segments[1], dt=DT,
                                   substeps=m_rk4, n_steps=seg,
                                   record_every=rec, seed=8)
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.key in ("cudaLaunchKernel",
                                    "cudaLaunchKernelExC"))
    except Exception as exc:        # the profiler is optional here
        print(f"torch.profiler unavailable: {exc}")
    report["wrapper_hil_3600"] = dict(call_ms=call_ms, parts_ms=parts,
                                      cuda_launches_per_call=launches)
    print(f"HIL-3600 wrapper, one segment: {call_ms:.3f} ms (host clock); "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f"; CUDA kernel launches per call {launches}", flush=True)

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_b3_compare.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
