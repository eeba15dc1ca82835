#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases:
 1. the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from ics_wt_physicsengine_torch/csrc (nvcc
    time and the -Xptxas -v register/spill report);
 3. kernels B1 and B2 against their plain PyTorch versions on the card, in
    float64 and float32, for RK4, RKC-strict and RKC-fast, on a single
    20-zone plant, 1024-plant Monte-Carlo batches at 5 and 20 zones (the
    warp layout) and a 64-plant batch at 33 zones (the packed layout; 200
    steps, recorded every 10), plus the 4096 x 20 main-path shape; B2 on
    the bench's dosing schedule; a constant schedule through B2 equal to
    B1; B1 in float64 against the plain version on the CPU (the tables and
    tolerances of ics_wt_physicsengine_torch/ops/kernel_checks.py);
 3b. kernel B3 (the instrumented plant: physics warps and sensor warps,
    the sensors of a step overlapped with the next step's physics) against
    its plain version on the card over kernel_checks.B3_CASES (single plant
    and 64-plant batches, 1, 5, 20 and 128 zones, RK4 and RKC-fast,
    constant and scheduled forcing, injected words and Philox, recording
    every step and every tenth, per-plant line delays, interior zone taps,
    float32 and float64): state,
    every carry column, rebuilt rings, readings, NaN positions; a chained
    plain -> kernel -> plain run; a constant schedule equal to constant
    forcing; the kernel's Philox stream against the plain one, with its
    statistics; and the main-path shapes 4096 x 20 and 1 x 20, timed;
 3c. kernel B4 (the Newton pH solve: a lane takes a new element as soon
    as its own is done) against its plain version on the card over
    kernel_checks.B4_CASES, bit for bit (1 to 300,000 waters, 2-D shapes,
    float64 and float32, degenerate waters whose NaN must sit in the same
    places, iters 0, 1 and 7, tolerance 0 and 1e30, never-done
    elements packed into one warp or one in every 32); launches back to
    back and on two streams at once; float64 B4 against the step-by-step
    loop core.chemistry.solve_pH and against the host's scalar solver; and
    the main-path shape 4096 x 256, timed;
 4. the bare-physics main path at full size: 4096 parameter-randomized
    20-zone plants, 7200 one-second steps, RK4 (3 substeps) and RKC-fast
    (1 x 4 stages), make_monte_carlo_batch -> rollout_fused (kernel B1) ->
    ensemble_statistics / exceedance_probability; then 32768 plants x 2000
    steps;
 5. one scheduled 20-zone plant for 32768 steps of the dosing schedule,
    RKC-fast, through rollout_scheduled_fused (kernel B2);
 5b. the instrumented main path through plant_rollout_fused and
    plant_rollout_auto (kernel B3, Philox): one 20-zone plant for 16384
    steps with RK4, RKC-fast and the bench schedule; one 3600-step
    scheduled segment recorded every 60 steps, chained twice; 4096 plants
    x 20 zones x 2000 steps recorded every 100; each beside the physics
    alone (B1/B2) at the same size, and the share of B3's time spent
    beyond it; then the port's entry() on the card;
 5c. the equilibrium-pH main path through solve_pH_auto and
    pH_after_alkalinity_shift (kernel B4): PH-EQ-65536, 65,536 waters in
    float32 and float64; PH-TITR-4096x256, a 256-point titration curve
    (+-1 meq/L) for each of the 4096 Monte-Carlo plants; each with its
    solves/s over the main-path window, its mean live iterations, its
    bounds over every iteration and over the live ones, the wrapper and
    the kernel alone timed in turns beside it, and the
    step-by-step loop on the same CUDA tensors (what the kernel replaces
    on the card; no single PyTorch call computes the solve);
 5d. the object API on the card: run_all_validations and
    run_all_sensor_validations, the sensors demo (5-zone IntegratedCSTR.step
    plus seven sensor reads per tick for 180 ticks, then calibration,
    cleaning, reagent replacement), and the same loop on the 20-zone plant
    for 600 ticks. This path is per-tick plain PyTorch and launches no
    hand-written kernel;
 5e. FULLCHEM-8192, the six extension axes (nitrogen, gas, particles,
    disinfection, biofilm, phase) on bench.py's bench_full_chemistry
    configuration (models/plant.py::full_chemistry_config, 22 fields per
    zone): 8192 Monte-Carlo plants x 20 zones through core.reactor.rollout
    (RK4 x 3), float32; bench.py's 1000 steps cut to a 10 s window (the cut
    is printed); plant-steps/s, ms per step, and one step's CUDA kernel
    launches, device time and aten operations (torch.profiler, outside the
    window); the fields finite, >= 0 where clipped, temperature inside the
    phase bounds, outlet pathogens below the inlet's; no B1-B4 launch;
 5f. the same configuration at 16 plants x 20 zones x 20 steps in float64
    on the card and on the CPU: every field within rtol 1e-9 + atol 1e-12;
 5g. PLANT-EXT-1, the six-axis plant with its ten instruments
    (make_plant, 20 zones) through plant_rollout_auto for 150 steps (cut
    from 600 to make room for 5h-5m), which takes the plant_step loop:
    steps/s (host clock) and the share of finite readings per instrument;
    no B3 launch. Phases 5e-5g are plain PyTorch: no hand-written kernel
    serves the extension axes;
 5h. CL-4096, bench.py's bench_closed_loop: a 16 x 16 x 4 x 4 dual-PID
    gain grid (4096 lanes) on the 20-zone plant, RKC-fast, float32,
    record=False, through control.rollout_closed_loop; bench.py's 2048
    steps cut to a 12 s window (printed); plant-steps/s and one step's
    CUDA launches, device time and aten operations;
 5i. EKF-1024, bench.py's bench_ekf: 1024 EKFs on the 6-zone plant, 4
    taps, measurement_noise 4e-4, readings from a seeded generator,
    256 steps (or a 12 s window); filter-steps/s;
 5j. ENKF-8192, bench.py's bench_enkf: 8192 members, 6 zones, inflation
    1.02, localization radius 2.0; member-steps/s;
 5k. MPC-20, examples/mpc_dosing.py's settings (20 zones, dt 60 s, so
    121 RK4 substeps a step): one mpc_plan and one run_mpc segment, with
    horizon_moves, steps_per_move and iters cut from 6, 10 and 20
    (MPC_CUT, printed); seconds per re-plan;
 5l. TRAIN-3, examples/treatment_train.py: 3 stages of 5 zones, 15%
    recycle, delays 2 and 5, dt 5 s, RK4 x 8, its 4320 steps cut to a 12 s
    window, then its 16-dose booster sweep as one batched call;
    network-steps/s;
 5m. a closed loop, an EKF bank step (vmap of jacfwd) and an MHE step in
    float64 on the card against the CPU
    (control/device_checks.py): rtol 1e-9 + atol 1e-12. Phases 5h-5m are
    plain PyTorch and must launch none of B1-B4;
 5n. SURR-INFER-65536, bench.py's bench_surrogate inference row: the
    6-zone residual MLP (hidden (128, 128), random weights with the output
    layer un-zeroed, bfloat16 products) through surrogate_step on 65,536
    plants, 256 steps a call, each call fed the last state: plant-steps/s,
    one step's launches, device time and idle share, its GEMM work and
    bytes and the bound they set; a step and an 8-step rollout on the card
    against the CPU, float32 products within 1e-5 of x_std and bfloat16
    ones (bfloat16 operands multiplied in float32 on both) within 1e-4;
 5o. SURR-TRAIN-2048, bench.py's training row: train_surrogate on a
    synthetic 64 x 65 x 18 set, batch 2048, 200 Adam steps, bfloat16;
    Adam steps/s, the better of two calls;
 5p. SURR-MPC-6, examples/surrogate_mpc.py as written: fit_plant_surrogate
    (6 zones, dt 30 s, 512 trajectories x 48 steps, 6000 + 600 Adam
    steps), its held-out one-step skill against the identity predictor
    (< 0.5 per field), then run_mpc_surrogate on the 90-minute step
    program (horizon 4 x 15, 20 iterations): the last 15 outlet-chlorine
    values within a mean 0.15 of 2.5 mg/L. The example's physics-shooting
    run_mpc comparison is not run (printed; MPC-20 covers that path);
 5q. checkpoints on the card: the fitted SurrogateParams saved from CUDA
    tensors and reloaded into its CUDA template, bit-equal; a 5-zone
    IntegratedCSTR with its seven sensors saved, reloaded into a reactor
    and a suite seeded otherwise, and the next 20 ticks equal to those of
    the run that never stopped. Phases 5n-5q are plain PyTorch and must
    launch none of B1-B4;
 6. the 4096-plant RK4 ensemble in float64 against float32;
 7. a JSON line of per-kernel numbers, the card line, and the result line.

Launch counts are zeroed just before each run of a main-path entry point
(its warm-up and timed calls) and read just after: each call must have
launched its own kernel once and no other, and the kernels line reports
the sum over phases 4, 5, 5b and 5c. Direct kernel calls (phases 3, 3b and
3c, the kernel-only times) and phase 6 lie outside those windows; phases
5d-5q must launch none. Exits non-zero,
with no result line, when there is no CUDA card, when the package is
missing, or when any check fails. Times are CUDA-event times after a
warm-up; every number is this run's, on the card named in the output.
Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

DT = 1.0
CSRC = "ics_wt_physicsengine_torch/csrc"
TPU_OPS = "ics_wt_physicsengine_tpu/ops"
# kernel name -> (source in the repository, TPU kernel it replaces)
KERNELS = {
    "rollout_fused": (f"{CSRC}/fused_rollout.cu",
                      f"{TPU_OPS}/fused_rollout.py:272"),
    "rollout_scheduled_fused": (f"{CSRC}/fused_rollout.cu",
                                f"{TPU_OPS}/fused_rollout.py:312"),
    "plant_rollout_fused": (f"{CSRC}/fused_plant.cu",
                            f"{TPU_OPS}/fused_plant.py:293"),
    "solve_pH_kernel": (f"{CSRC}/ph_solver.cu", f"{TPU_OPS}/ph_solver.py:55"),
}

failures: list = []
report: dict = {"phases": {}}


def check(ok: bool, what: str) -> None:
    print(("  ok   " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def phase(name):
    def wrap(fn):
        def run(*args, **kw):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            except Exception:  # a phase that raises is a failed phase
                traceback.print_exc()
                failures.append(f"{name}: raised")
                return None
            finally:
                report["phases"][name] = time.perf_counter() - t0
        return run
    return wrap


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(fn, reps=1):
    """Mean CUDA-event milliseconds of ``reps`` calls, and the last result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from ics_wt_physicsengine_torch import entry as port_entry
    from ics_wt_physicsengine_torch.core import chemistry as chem
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.core import run_all_validations
    from ics_wt_physicsengine_torch.models import make_monte_carlo_batch
    from ics_wt_physicsengine_torch.models import plant as P
    from ics_wt_physicsengine_torch.ops import _build
    from ics_wt_physicsengine_torch.ops import fused_plant as FP
    from ics_wt_physicsengine_torch.ops import fused_rollout as F
    from ics_wt_physicsengine_torch.ops import kernel_checks as K
    from ics_wt_physicsengine_torch.ops import ph_solver as PS
    from ics_wt_physicsengine_torch.parallel import (
        ensemble_statistics, exceedance_probability)
    from ics_wt_physicsengine_torch.sensors import (
        run_all_sensor_validations)
    from ics_wt_physicsengine_torch.sensors.__main__ import run_demo
    from ics_wt_physicsengine_torch.sensors.types import (SensorFault,
                                                          SensorStatus)

    dev = torch.device("cuda")
    FP32_PEAK = K.PEAK_OPS[torch.float32]
    HBM_RATE = K.HBM_RATE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layouts = {F.PACKED: "packed", F.WARP: "warp"}
    kernels = {name: {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": None, "ms": None, "plain_ms": None,
                      "bound_ms": None, "bound_by": "operations",
                      "library_ms": None}
               for name, (source, replaces) in KERNELS.items()}
    card = card_line()
    report["card"] = card
    report["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"

    # ---- 1. card -------------------------------------------------------
    print(f"== card: {card}; {torch.cuda.get_device_name(0)}; "
          f"torch {report['torch']}", flush=True)

    # ---- 2. build ------------------------------------------------------
    @phase("build")
    def build():
        _build.load()                       # every library, in parallel
        info = _build.build_info
        print(f"  nvcc, all libraries together: {info['seconds']:.1f} s")
        report["build"] = {"seconds": info["seconds"]}
        for name in _build.LIBRARIES:
            lib = info[name]
            print(f"  {name}: {lib['seconds']:.1f} s (cached={lib['cached']})"
                  f" -> {lib['path']}")
            for line in lib["log"].splitlines():
                if "Compiling entry" in line:
                    print("  " + line.split("'")[1][:60])
                elif "registers" in line or "spill" in line \
                        or "error" in line:
                    print("    " + line.strip())
            report["build"][name] = {"seconds": lib["seconds"],
                                     "log": lib["log"]}
        return True

    if not build():
        return finish(kernels, card)

    policy = R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.4, inlet_chlorine=0.2,
        chlorine_flow_rate=0.15, chlorine_concentration=50.0,
        acid_flow_rate=0.05)
    f32 = torch.float32

    # ---- 3. kernels against their plain versions ------------------------
    @phase("kernel vs plain")
    def compare():
        rows = []
        for dtype in (torch.float64, f32):
            tol, tag = K.TOL[dtype], str(dtype)[6:]
            for integrator in ("rk4", "strict", "fast"):
                for n_zones, n_plants in ((20, 1), (5, 1024), (20, 1024),
                                          (33, 64)):
                    m, s = K.stiff_plan(n_zones, integrator)
                    g = F.rollout_geometry(n_zones, n_plants)
                    got, err = K.b1_vs_plain(
                        n_zones, n_plants, dtype, dev, substeps=m, stages=s,
                        n_steps=200, record_every=10)
                    rows.append(dict(kernel="rollout_fused", dtype=tag,
                                     integrator=integrator, n_zones=n_zones,
                                     n_plants=n_plants, substeps=m, stages=s,
                                     layout=layouts[g.layout],
                                     max_abs_err=err))
                    check(err <= tol and all(
                        bool(torch.isfinite(x).all()) for x in got[:3]),
                        f"B1 {tag} {integrator} ({m}x{s or 4}) "
                        f"{n_plants}x{n_zones} ({layouts[g.layout]} layout, "
                        f"{g.plants_per_block} plants on {g.block_threads} "
                        f"threads a block): max|kernel-plain| {err:.3e}"
                        f" <= {tol:.0e}")

            m, s = R.default_rkc_plan(R.ReactorConfiguration(n_zones=20), DT,
                                      mode="fast")
            _, err = K.b2_vs_plain(20, 1, dtype, dev, substeps=m, stages=s,
                                   n_steps=200, record_every=10)
            rows.append(dict(kernel="rollout_scheduled_fused", dtype=tag,
                             integrator="fast", n_zones=20, n_plants=1,
                             substeps=m, stages=s, max_abs_err=err))
            check(err <= tol, f"B2 {tag} fast ({m}x{s}) bench schedule 1x20:"
                  f" max|kernel-plain| {err:.3e} <= {tol:.0e}")

            for s in (None, 4):
                check(K.constant_schedule_equals_b1(
                    20, 1024, dtype, dev, substeps=3, stages=s, n_steps=200),
                    f"B2 constant schedule == B1 exactly, {tag} stages={s} "
                    "1024x20")
        report["compare"] = rows

        err = K.b1_vs_cpu(64, dev, substeps=3, n_steps=200)
        rows.append(dict(kernel="rollout_fused", dtype="float64 vs CPU",
                         integrator="rk4", n_zones=20, n_plants=64,
                         substeps=3, stages=None, max_abs_err=err))
        check(err <= K.CPU_TOL, f"B1 float64 on the card vs the plain "
              f"version on the CPU, 64x20 x200: max abs diff {err:.3e} <= "
              f"{K.CPU_TOL:.0e}")

        # main-path shapes, float32, timed: the numbers of the kernels line
        for integrator, (m, s) in (("rk4", (3, None)), ("fast", (1, 4))):
            ptab, btab, y = K.tables(20, 4096, f32, dev, bc=policy)
            kw = dict(dt=DT, substeps=m, n_steps=200, stages=s)
            F.rollout_kernel(ptab, btab, *y, **kw)          # warm-up
            ms, got = timed(lambda: F.rollout_kernel(ptab, btab, *y, **kw),
                            reps=5)
            plain_ms, ref = timed(lambda: F.rollout_plain(ptab, btab, *y,
                                                          **kw))
            err = K.max_err(got, ref)
            bound = F.rollout_ops(4096, 20, 200, m, s) / FP32_PEAK * 1e3
            check(err <= K.TOL[f32],
                  f"B1 float32 {integrator} ({m}x{s or 4}) 4096x20 x200: "
                  f"max|kernel-plain| {err:.3e}; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.1f} ms, bound {bound:.4f} ms")
            report[f"b1_main_shape_{integrator}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=err)
            if integrator == "rk4":
                kernels["rollout_fused"].update(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)

        m, s = R.default_rkc_plan(R.ReactorConfiguration(n_zones=20), DT,
                                  mode="fast")
        ptab, _, y = K.tables(20, 1, f32, dev)
        sched = F.schedule_table(K.bench_schedule(2000), 2000, f32, dev)
        kw = dict(dt=DT, substeps=m, stages=s)
        F.scheduled_kernel(ptab, sched, *y, **kw)           # warm-up
        ms, got = timed(lambda: F.scheduled_kernel(ptab, sched, *y, **kw),
                        reps=5)
        plain_ms, ref = timed(lambda: F.scheduled_plain(ptab, sched, *y,
                                                        **kw))
        err = K.max_err(got, ref)
        bound = F.rollout_ops(1, 20, 2000, m, s) / FP32_PEAK * 1e3
        check(err <= K.TOL[f32],
              f"B2 float32 fast ({m}x{s}) 1x20 x2000 bench schedule: "
              f"max|kernel-plain| {err:.3e}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms, bound {bound:.6f} ms (one block: "
              "latency-bound)")
        kernels["rollout_scheduled_fused"].update(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)
        return True

    compare()

    def plant_bound(batch, n_steps, substeps, stages, record_every, tables,
                    bits=False):
        """``(bound_ms, bound_by)`` of one B3 launch: its operations over
        the FP32 peak against its bytes over the memory rate."""
        ops_ms = FP.plant_ops(batch, 20, n_steps, substeps, stages,
                              philox=not bits) / FP32_PEAK * 1e3
        bytes_ms = FP.plant_bytes(
            batch, 20, n_steps, record_every,
            sum(x.shape[0] for x in tables.lead), tables.scheduled,
            bits) / HBM_RATE * 1e3
        return max(ops_ms, bytes_ms), \
            "operations" if ops_ms >= bytes_ms else "bytes"

    # ---- 3b. kernel B3 against its plain version --------------------------
    @phase("B3 vs plain")
    def compare_plant():
        rows = []

        def held(d, tol):
            return d["max_abs_err"] <= tol and d["nan_equal"] \
                and d["ints_equal"]

        for name, case in K.B3_CASES.items():
            tol = K.TOL[case.get("dtype", f32)]
            (plant, readings), d = K.b3_vs_plain(case, dev)
            values = torch.stack([v.reshape(v.shape[0], -1)
                                  for v in readings.values()])
            nan_share = float(torch.isnan(values).double().mean())
            rows.append(dict(case=name, nan_share=nan_share, **d))
            check(held(d, tol)
                  and bool(torch.isfinite(plant.reactor.pH).all()),
                  f"B3 {name} x{K.B3_STEPS}: max|kernel-plain| "
                  f"{d['max_abs_err']:.3e} <= {tol:.0e} over state, carries,"
                  f" rings, readings; NaN positions equal: {d['nan_equal']}; "
                  f"integer carries equal: {d['ints_equal']}; "
                  f"{nan_share:.3f} of readings NaN")
        d = K.b3_chained(dev)
        rows.append(dict(case="chained plain-kernel-plain", **d))
        check(held(d, K.TOL[f32]),
              "B3 chained plain -> kernel -> plain == plain x3 (8x5, 3x20 "
              f"steps, per-plant delays): max abs diff {d['max_abs_err']:.3e}"
              f" <= {K.TOL[f32]:.0e}; NaN positions equal: {d['nan_equal']}")
        for n_zones, n_plants, integrator in ((20, 1, "rk4"),
                                              (20, 64, "fast")):
            check(K.b3_constant_schedule_equals_constant(
                n_zones, n_plants, dev, integrator=integrator),
                f"B3 constant schedule == constant forcing exactly, "
                f"{integrator} {n_plants}x{n_zones}")
        stats = K.philox_statistics(dev)
        check(stats["words_equal_plain"], "Philox: the kernel's words equal "
              f"the plain integer-arithmetic stream ({stats['count']} words)")
        for name, (centre, half_width) in K.PHILOX_BOUNDS.items():
            check(abs(stats[name] - centre) <= half_width,
                  f"Philox {name} {stats[name]:.6f} within {centre:.6g} +- "
                  f"{half_width:.1e} ({stats['count']} draws)")
        report["compare_b3"] = rows
        report["philox"] = stats

        # main-path shapes, float32, Philox, timed: the kernels line
        m, s = K.plant_plan(20, "rk4")
        for n_plants, n_steps in ((1, 100), (4096, 50)):
            params, plant = K.plant_case(20, n_plants, f32, dev)
            tables = FP.build_tables(params, plant, K.BC, dt=DT,
                                     n_steps=n_steps)
            kw = dict(dt=DT, substeps=m, n_steps=n_steps, stages=s,
                      record_every=10, seed=7)
            FP.plant_kernel(tables, **kw)                   # warm-up
            ms, got = timed(lambda: FP.plant_kernel(tables, **kw), reps=5)
            plain_ms, ref = timed(lambda: FP.plant_plain(tables, **kw))
            d = K.plant_diff(got, ref)
            bound, bound_by = plant_bound(n_plants, n_steps, m, s, 10,
                                          tables)
            g = FP.plant_geometry(20, n_plants)
            check(held(d, K.TOL[f32]),
                  f"B3 float32 rk4 ({m}x4) {n_plants}x20 x{n_steps} Philox: "
                  f"max|kernel-plain| {d['max_abs_err']:.3e}; kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.5f} "
                  f"ms ({bound_by}); {g.grid(n_plants)} blocks of "
                  f"{g.plants_per_block} plants on {g.physics_threads} "
                  f"physics + {g.sensor_threads} sensor threads")
            report[f"b3_main_shape_{n_plants}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                **d)
        kernels["plant_rollout_fused"].update(
            max_abs_err=d["max_abs_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by)
        return True

    compare_plant()

    def ph_bound_text(b):
        """A B4 time's bounds (a time under the live bound fails: the
        count would be wrong)."""
        return (f"{b['mean_live']:.3f} live iterations of "
                f"{PS.DEFAULT_ITERS}; bound {b['live_ms']:.5f} ms over them "
                f"({b['live_by']}), {b['fixed_ms']:.5f} ms over all "
                f"({b['fixed_by']})")

    # ---- 3c. kernel B4 against its plain version --------------------------
    @phase("B4 vs plain")
    def compare_ph():
        rows = []
        for name, case in K.B4_CASES.items():
            got, d = K.b4_vs_plain(case, dev)
            n_nan = int(torch.isnan(got).sum())
            rows.append(dict(case=name, n_nan=n_nan, **d))
            arranged = "arrange" not in case \
                or K.b4_never_done_in_place(case, dev)
            check(d["bit_equal"] and d["nan_equal"] and arranged
                  and got.shape == case["shape"]
                  and n_nan == (2 if case.get("degenerate") else 0),
                  f"B4 {name}: bit-equal to plain: {d['bit_equal']} "
                  f"(max|kernel-plain| {d['max_abs_err']:.3e}); NaN "
                  f"positions equal: {d['nan_equal']} ({n_nan} NaN); live "
                  f"iterations mean {d['mean_live']:.3f}, max "
                  f"{d['max_live']}" + ("" if "arrange" not in case else
                                        f"; never-done in place: {arranged}"))
        d = K.b4_streams(dev)
        rows.append(dict(case="streams", **d))
        check(all(d.values()), "B4 at 4096x256 twice back to back on one "
              f"stream: bit-equal {d['back_to_back']}; on two streams at "
              f"once, twice: bit-equal {d['two_streams']}; work counters "
              f"back at zero: {d['counters_zero']}")
        err = K.b4_vs_loop(dev)
        rows.append(dict(case="float64 vs step-by-step loop, 1025",
                         max_abs_err=err))
        check(err <= K.PH_LOOP_TOL, "B4 float64 vs core.chemistry.solve_pH "
              f"(10 ** -pH form) on the card, 1025 waters: {err:.3e} <= "
              f"{K.PH_LOOP_TOL:.0e}")
        err = K.b4_vs_host(dev)
        rows.append(dict(case="float64 vs host solver, 16", max_abs_err=err))
        check(err <= K.PH_LOOP_TOL, "B4 float64 vs solve_pH_host, 16 "
              f"waters: {err:.3e} <= {K.PH_LOOP_TOL:.0e}")
        report["compare_b4"] = rows

        # main-path shape, float32, timed: the kernels line
        args = K.ph_cell_args("PH-TITR-4096x256", f32, dev)
        PS.ph_kernel(*args)                                 # warm-up
        ms, got = timed(lambda: PS.ph_kernel(*args), reps=10)
        plain_ms, ref = timed(lambda: PS.ph_plain(*args))
        d = K.ph_diff(got, ref)
        _, live = PS.ph_live_iters(*args)
        b = K.ph_bounds(args, live)
        g = PS.kernel_geometry(args[0].numel(), dev, False)
        check(d["bit_equal"] and d["nan_equal"] and ms >= b["live_ms"],
              f"B4 float32 4096x256 (titration inputs): bit-equal to plain: "
              f"{d['bit_equal']}; kernel {ms:.4f} ms, plain {plain_ms:.1f} "
              f"ms; {ph_bound_text(b)}; {g.blocks} blocks of {g.threads} "
              "threads")
        report["b4_main_shape"] = dict(ms=ms, plain_ms=plain_ms, **b, **d,
                                       blocks=g.blocks, threads=g.threads)
        kernels["solve_pH_kernel"].update(
            max_abs_err=d["max_abs_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=b["live_ms"], bound_by=b["live_by"])
        return True

    compare_ph()

    main_launches = dict.fromkeys(KERNELS, 0)

    def on_main_path(name, run, reps, launches_per_call=1):
        """A warm-up and ``reps`` timed calls of entry point ``name``, with
        every launch count zeroed just before and read just after: each
        call must have launched kernel ``name`` once (``launches_per_call``
        times where ``run`` chains calls) and no other kernel."""
        F.reset_launch_counts()
        FP.reset_launch_counts()
        PS.reset_launch_counts()
        run()                                                # warm-up
        ms, out = timed(run, reps=reps)
        counts = {**F.LAUNCHES, **FP.LAUNCHES, **PS.LAUNCHES}
        for kernel, n in counts.items():
            main_launches[kernel] += n
        calls = (1 + reps) * launches_per_call
        want = {kernel: calls * (kernel == name) for kernel in counts}
        check(counts == want, f"{name}: launches {counts} for {calls} "
              "calls")
        return ms, out

    # ---- 4. main path at full size --------------------------------------
    @phase("main path: Monte-Carlo ensemble")
    def ensemble():
        base = R.ReactorConfiguration(n_zones=20)
        out = {}
        medians = {}
        for n_plants, n_steps in ((4096, 7200), (32768, 2000)):
            t0 = time.perf_counter()
            params, state = make_monte_carlo_batch(
                base, n_plants, seed=0, dtype=f32, device=dev)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            for integrator, (m, s) in (("rk4", (3, None)), ("fast", (1, 4))):
                def run():
                    return F.rollout_fused(params, state, policy, dt=DT,
                                           substeps=m, stages=s,
                                           n_steps=n_steps)
                wrapper_ms, final = on_main_path("rollout_fused", run, 2)
                stats = ensemble_statistics(final)
                probs = exceedance_probability(final)
                q = stats["chlorine"]["quantiles"][:, -1].tolist()
                # the kernel alone on the same inputs, outside the count
                ptab = F.param_table(params, n_plants, f32, dev)
                btab = F.boundary_table(policy, n_plants, f32, dev)
                y = (state.pH, state.chlorine, state.temperature)
                kernel_ms, _ = timed(lambda: F.rollout_kernel(
                    ptab, btab, *y, dt=DT, substeps=m, stages=s,
                    n_steps=n_steps))
                bound = F.rollout_ops(n_plants, 20, n_steps, m, s) \
                    / FP32_PEAK * 1e3
                rate = n_plants * n_steps / (wrapper_ms / 1e3)
                g = F.rollout_geometry(20, n_plants)
                finite = all(bool(torch.isfinite(x).all()) for x in (
                    final.pH, final.chlorine, final.temperature,
                    stats["chlorine"]["quantiles"], stats["pH"]["std"]))
                key = f"{n_plants}x{n_steps}_{integrator}"
                out[key] = dict(
                    plants=n_plants, steps=n_steps, substeps=m, stages=s,
                    setup_s=setup_s, wrapper_ms=wrapper_ms,
                    kernel_ms=kernel_ms, bound_ms=bound,
                    layout=layouts[g.layout], blocks=g.grid(n_plants),
                    block_threads=g.block_threads, plant_steps_per_s=rate,
                    outlet_chlorine_p05_median_p95=q,
                    outlet_pH_median=float(stats["pH"]["quantiles"][1, -1]),
                    exceedance={k: float(v) for k, v in probs.items()})
                medians[key] = q[1]
                check(finite and final.pH.shape == (n_plants, 20)
                      and stats["n_plants"] == n_plants
                      and bool((final.pH >= 0).all() & (final.pH <= 14).all()
                               & (final.chlorine >= 0).all()),
                      f"{n_plants} plants x {n_steps} steps {integrator} "
                      f"({m}x{s or 4}): {rate:.4e} plant-steps/s; wrapper "
                      f"{wrapper_ms:.2f} ms, kernel {kernel_ms:.2f} ms, "
                      f"bound {bound:.3f} ms ({layouts[g.layout]} layout, "
                      f"{g.grid(n_plants)} blocks of {g.block_threads} "
                      f"threads); outlet Cl p05/median/p95 "
                      f"{q[0]:.4f}/{q[1]:.4f}/{q[2]:.4f} mg/L; "
                      "P(any violation) "
                      f"{float(probs['p_any_violation']):.4f}")
        for size in ("4096x7200", "32768x2000"):
            gap = abs(medians[f"{size}_rk4"] - medians[f"{size}_fast"])
            check(gap < 1e-2, f"{size}: RK4 and RKC-fast outlet Cl medians "
                  f"agree ({gap:.2e} mg/L < 1e-2)")
        report["ensemble"] = out
        return True

    ensemble()

    # ---- 5. scheduled single plant ---------------------------------------
    @phase("main path: scheduled single plant")
    def scheduled():
        cfg = R.ReactorConfiguration(n_zones=20)
        m, s = R.default_rkc_plan(cfg, DT, mode="fast")
        params = R.make_params(cfg, dtype=f32, device=dev)
        state = R.make_initial_state(cfg, dtype=f32, device=dev)
        sched = K.bench_schedule(32768)

        def run():
            return F.rollout_scheduled_fused(params, state, sched, dt=DT,
                                             substeps=m, stages=s)
        ms, final = on_main_path("rollout_scheduled_fused", run, 3)
        rate = 32768 / (ms / 1e3)
        bound = F.rollout_ops(1, 20, 32768, m, s) / FP32_PEAK * 1e3
        ok = all(bool(torch.isfinite(x).all()) for x in (
            final.pH, final.chlorine, final.temperature))
        check(ok and final.pH.shape == (20,),
              f"scheduled 1x20 x32768 steps fast ({m}x{s}): {rate:.4e} "
              f"steps/s ({ms:.2f} ms per rollout, bound {bound:.5f} ms); "
              f"outlet Cl {float(final.chlorine[-1]):.4f} mg/L")
        report["scheduled"] = dict(steps=32768, substeps=m, stages=s, ms=ms,
                                   bound_ms=bound, steps_per_s=rate)
        return True

    scheduled()

    # ---- 5b. the instrumented main path -------------------------------------
    @phase("main path: instrumented plant")
    def plant_main():
        name = "plant_rollout_fused"
        out = {}
        cfg = R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                     n_zones=20)
        m_rk4 = R.default_substeps(cfg, DT)
        m_rkc, s_rkc = R.default_rkc_plan(cfg, DT, mode="fast")
        params, plant = P.make_plant(cfg, dtype=f32, device=dev)
        bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                                  inlet_chlorine=0.5, acid_flow_rate=0.1)

        def finite_state(p):
            return all(bool(torch.isfinite(x).all()) for x in (
                p.reactor.pH, p.reactor.chlorine, p.reactor.temperature))

        def alone(params, plant, boundary, m, s, n_steps, record_every):
            """Kernel B3 alone, and the physics alone (B1 or B2) on the
            same tables, outside the launch-count windows: ``(B3 ms,
            physics ms, bound ms, bound by)``."""
            tables = FP.build_tables(params, plant, boundary, dt=DT,
                                     n_steps=n_steps)
            kw = dict(dt=DT, substeps=m, stages=s)
            b3_ms, _ = timed(lambda: FP.plant_kernel(
                tables, n_steps=n_steps, record_every=record_every, seed=7,
                **kw))
            y = (tables.ph, tables.cl, tables.t)
            if tables.scheduled:
                physics_ms, _ = timed(lambda: F.scheduled_kernel(
                    tables.ptab, tables.forcing, *y, **kw))
            else:
                physics_ms, _ = timed(lambda: F.rollout_kernel(
                    tables.ptab, tables.forcing, *y, n_steps=n_steps, **kw))
            batch = tables.ph.shape[0]
            bound, bound_by = plant_bound(batch, n_steps, m, s, record_every,
                                          tables)
            return b3_ms, physics_ms, bound, bound_by

        # PLANT-1: one 20-zone plant, 16384 steps, final readings only
        n = 16384
        t_axis = np.arange(n)
        sched = R.BoundaryConditions(
            inlet_flow_rate=(5.0 + 2.0 * np.sin(2 * np.pi * t_axis / 17.0)
                             ).astype(np.float32),
            inlet_pH=7.2,
            inlet_chlorine=np.where(t_axis % 10 < 5, 0.5, 1.5
                                    ).astype(np.float32),
            acid_flow_rate=np.where(t_axis % 8 < 4, 0.0, 0.3
                                    ).astype(np.float32))
        for tag, boundary, m, s in (("rk4", bc, m_rk4, None),
                                    ("fast", bc, m_rkc, s_rkc),
                                    ("sched", sched, m_rk4, None)):
            def run():
                return FP.plant_rollout_fused(
                    params, plant, boundary, dt=DT, substeps=m, stages=s,
                    n_steps=n, record_every=n, seed=7)
            ms, (final, readings) = on_main_path(name, run, 2)
            b3_ms, physics_ms, bound, bound_by = alone(
                params, plant, boundary, m, s, n, n)
            n_finite = sum(bool(torch.isfinite(v).all())
                           for v in readings.values())
            out[f"PLANT-1_{tag}"] = dict(
                steps=n, substeps=m, stages=s, wrapper_ms=ms,
                kernel_ms=b3_ms, physics_ms=physics_ms, bound_ms=bound,
                bound_by=bound_by, steps_per_s=n / (ms / 1e3),
                beyond_physics_share=1.0 - physics_ms / b3_ms,
                finite_final_readings=n_finite)
            check(finite_state(final) and final.reactor.pH.shape == (20,)
                  and float(final.reactor.time) == float(n)
                  and readings["pH_outlet"].shape == (1,),
                  f"PLANT-1 {tag} ({m}x{s or 4}) 1x20 x{n}: "
                  f"{n / (ms / 1e3):.4e} steps/s; wrapper {ms:.2f} ms, "
                  f"kernel {b3_ms:.2f} ms, physics alone {physics_ms:.2f} ms"
                  f" (beyond it {1.0 - physics_ms / b3_ms:.1%}), bound "
                  f"{bound:.5f} ms ({bound_by}; one block: latency-bound); "
                  f"{n_finite}/7 final readings finite")

        def run_auto():
            return P.plant_rollout_auto(params, plant, bc, DT, m_rkc, n,
                                        record=False, stages=s_rkc, seed=7)
        ms, (final, none) = on_main_path(name, run_auto, 1)
        out["PLANT-1_fast_auto"] = dict(steps=n, wrapper_ms=ms,
                                        steps_per_s=n / (ms / 1e3))
        check(none is None and finite_state(final),
              f"PLANT-1 fast through plant_rollout_auto: {n / (ms / 1e3):.4e}"
              f" steps/s ({ms:.2f} ms)")

        # HIL-3600: hourly scheduled segments recorded every minute, chained
        seg, rec = 3600, 60
        hours = np.arange(2 * seg, dtype=np.float64) / 3600.0
        day = dict(
            inlet_flow_rate=(5.0 + 2.0 * np.sin(2 * np.pi * (hours - 7)
                                                / 24.0)).astype(np.float32),
            inlet_pH=7.4, inlet_chlorine=0.3,
            inlet_temperature=(18.0 + 5.0 * np.sin(
                2 * np.pi * (hours - 14) / 24.0)).astype(np.float32),
            acid_flow_rate=np.where((hours % 1.0) < 0.1, 0.25, 0.0
                                    ).astype(np.float32),
            chlorine_flow_rate=np.where((hours > 11) & (hours < 13), 0.3,
                                        0.05).astype(np.float32),
            ambient_temperature=15.0, heat_loss_coefficient=50.0)
        segments = [R.BoundaryConditions(**{
            k: (v[i * seg:(i + 1) * seg] if np.ndim(v) else v)
            for k, v in day.items()}) for i in range(2)]

        def run_hil():
            p, series = plant, []
            for i, boundary in enumerate(segments):
                p, readings = FP.plant_rollout_fused(
                    params, p, boundary, dt=DT, substeps=m_rk4, n_steps=seg,
                    record_every=rec, seed=7 + i)
                series.append(readings)
            return p, series
        ms, (final, series) = on_main_path(name, run_hil, 2,
                                           launches_per_call=2)
        b3_ms, physics_ms, bound, bound_by = alone(
            params, plant, segments[0], m_rk4, None, seg, rec)
        finite = float(torch.isfinite(torch.stack(
            [v for r in series for v in r.values()])).double().mean())
        out["HIL-3600"] = dict(
            segment_steps=seg, record_every=rec, substeps=m_rk4,
            segment_wrapper_ms=ms / 2, kernel_ms=b3_ms,
            physics_ms=physics_ms, bound_ms=bound, bound_by=bound_by,
            beyond_physics_share=1.0 - physics_ms / b3_ms,
            steps_per_s=2 * seg / (ms / 1e3), finite_reading_share=finite)
        check(finite_state(final) and float(final.reactor.time) == 2.0 * seg
              and series[1]["temp_outlet"].shape == (seg // rec,)
              and int(final.ph_outlet.base.line_count) == 31,
              f"HIL-3600 rk4 ({m_rk4}x4) 1x20, 2 chained segments x{seg} "
              f"recorded every {rec}: {2 * seg / (ms / 1e3):.4e} steps/s; "
              f"{ms / 2:.2f} ms per segment, kernel {b3_ms:.2f} ms, physics "
              f"alone {physics_ms:.2f} ms (beyond it "
              f"{1.0 - physics_ms / b3_ms:.1%}), bound {bound:.5f} ms "
              f"({bound_by});"
              f" {finite:.3f} of readings finite")

        # PLANT-4096: the instrumented ensemble
        n_plants, n_steps, rec = 4096, 2000, 100
        base = R.ReactorConfiguration(n_zones=20)
        m = R.default_substeps(base, DT)
        t0 = time.perf_counter()
        bparams, bplant = P.make_plant_batch(base, n_plants, seed=1,
                                             dtype=f32, device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        def run_batch():
            return FP.plant_rollout_fused(
                bparams, bplant, bc, dt=DT, substeps=m, n_steps=n_steps,
                record_every=rec, seed=7)
        ms, (final, readings) = on_main_path(name, run_batch, 2)
        b3_ms, physics_ms, bound, bound_by = alone(
            bparams, bplant, bc, m, None, n_steps, rec)
        share = torch.isfinite(readings["pH_outlet"]).double().mean(dim=1)
        rate = n_plants * n_steps / (ms / 1e3)
        out["PLANT-4096"] = dict(
            plants=n_plants, steps=n_steps, record_every=rec, substeps=m,
            setup_s=setup_s, wrapper_ms=ms, kernel_ms=b3_ms,
            physics_ms=physics_ms, bound_ms=bound, bound_by=bound_by,
            plant_steps_per_s=rate,
            beyond_physics_share=1.0 - physics_ms / b3_ms,
            finite_ph_outlet_share_by_record=share.tolist())
        check(finite_state(final)
              and readings["pH_outlet"].shape == (n_steps // rec, n_plants)
              and float(share[0]) > 0.9
              and bool((share[1:] <= share[:-1]).all()),
              f"PLANT-4096 rk4 ({m}x4) 4096x20 x{n_steps} recorded every "
              f"{rec}: {rate:.4e} plant-steps/s; set-up {setup_s:.3f} s, "
              f"wrapper {ms:.2f} ms, kernel {b3_ms:.2f} ms, physics alone "
              f"{physics_ms:.2f} ms (beyond it "
              f"{1.0 - physics_ms / b3_ms:.1%}), bound {bound:.3f} ms "
              f"({bound_by}); finite pH_outlet readings {float(share[0]):.4f}"
              f" at step {rec} falling to {float(share[-1]):.4f} at step "
              f"{n_steps} (faults latch)")
        report["plant"] = out

        # the port's entry(): one plant step on the card
        fn, args = port_entry.entry()
        ph, cl_out, ph_in = fn(*args)
        torch.cuda.synchronize()
        check(ph.is_cuda and ph.shape == (20,) and all(
            bool(torch.isfinite(x).all()) for x in (ph, cl_out, ph_in)),
            f"entry(): one plant_step on the card, pH[20] finite, chlorine "
            f"outlet reading {float(cl_out):.4f} mg/L, pH inlet reading "
            f"{float(ph_in):.4f}")
        return True

    plant_main()

    # ---- 5c. the equilibrium-pH main path ----------------------------------
    @phase("main path: equilibrium pH")
    def ph_main():
        name = "solve_pH_kernel"
        out = {}

        def alone(constants, guess, wrapper, reps):
            """Outside the launch-count windows: the wrapper and kernel B4
            alone in turns (wrapper, kernel, kernel, wrapper; ``reps``
            calls a turn), the live iterations and bounds, and the
            step-by-step loop on the same CUDA tensors."""
            args, _ = PS.broadcast_inputs(constants, guess)
            runs = {"wrapper": wrapper, "kernel": lambda: PS.ph_kernel(*args)}
            times = {"wrapper": [], "kernel": []}
            for turn in ("wrapper", "kernel", "kernel", "wrapper"):
                times[turn].append(timed(runs[turn], reps=reps)[0])
            loop_ms, _ = timed(lambda: chem.solve_pH(constants, guess))
            _, live = PS.ph_live_iters(*args)
            return dict(wrapper_ms=sum(times["wrapper"]) / 2,
                        kernel_ms=sum(times["kernel"]) / 2,
                        loop_ms=loop_ms, **K.ph_bounds(args, live))

        # PH-EQ-65536: one batch of waters, both working types
        n = 65536
        results = {}
        for dtype in (f32, torch.float64):
            tag = str(dtype)[6:]
            k = K.ph_waters((n,), dtype, dev)
            ph0 = torch.full((n,), 7.0, dtype=dtype, device=dev)

            def run():
                return PS.solve_pH_auto(k, ph0)
            ms, ph = on_main_path(name, run, 10)
            a = alone(k, ph0, run, 20)
            results[dtype] = ph
            out[f"PH-EQ-65536_{tag}"] = dict(
                waters=n, iters=PS.DEFAULT_ITERS, main_path_ms=ms, **a,
                solves_per_s=n / (ms / 1e3),
                pH_min=float(ph.min()), pH_max=float(ph.max()))
            check(bool(torch.isfinite(ph).all()) and ph.shape == (n,)
                  and bool(((ph > 0.0) & (ph < 14.0)).all())
                  and a["kernel_ms"] >= a["live_ms"],
                  f"PH-EQ-65536 {tag}: {n / (ms / 1e3):.4e} solves/s "
                  f"(main path {ms:.4f} ms); in turns wrapper "
                  f"{a['wrapper_ms']:.4f} ms, kernel {a['kernel_ms']:.4f} "
                  f"ms; {ph_bound_text(a)}; the "
                  f"step-by-step loop it replaces {a['loop_ms']:.1f} ms; pH "
                  f"{float(ph.min()):.3f}..{float(ph.max()):.3f}")
        gap = (results[f32].double() - results[torch.float64]).abs()
        share = float((gap < 1e-5).double().mean())
        out["PH-EQ-65536_float32"].update(
            share_within_1e_5_of_float64=share, max_gap=float(gap.max()))
        check(share > 0.9, f"PH-EQ-65536: {share:.4f} of float32 solves "
              f"within 1e-5 of float64 (largest gap {float(gap.max()):.2e}: "
              "elements that cannot meet 1e-6 in float32)")

        # PH-TITR-4096x256: a titration curve per Monte-Carlo plant
        for dtype in (f32, torch.float64):
            tag = str(dtype)[6:]
            k, shifts = K.titration_waters(4096, 256, dtype, dev)
            base = PS.solve_pH_auto(k, 7.0)

            def run():
                return chem.pH_after_alkalinity_shift(k, shifts, base)
            ms, curve = on_main_path(name, run, 5)
            shifted = dataclasses.replace(k, alk_eq=k.alk_eq + shifts)
            a = alone(shifted, base, run, 5)
            verdict = K.titration_check(k, shifts, curve)
            n = curve.numel()
            out[f"PH-TITR-4096x256_{tag}"] = dict(
                solves=n, iters=PS.DEFAULT_ITERS, main_path_ms=ms, **a,
                solves_per_s=n / (ms / 1e3), **verdict)
            check(curve.shape == (4096, 256) and verdict["finite"]
                  and verdict["in_range"] and verdict["rising"]
                  and verdict["enough"] and a["kernel_ms"] >= a["live_ms"],
                  f"PH-TITR-4096x256 {tag}: {n / (ms / 1e3):.4e} solves/s "
                  f"(main path {ms:.4f} ms); in turns wrapper "
                  f"{a['wrapper_ms']:.4f} ms, kernel "
                  f"{a['kernel_ms']:.4f} ms; {ph_bound_text(a)}; the "
                  f"step-by-step loop it replaces {a['loop_ms']:.1f} ms; "
                  f"charge balance closed for {verdict['closed_share']:.4f} "
                  f"of the solves; curves rise with the shift on all "
                  f"{verdict['pair_share']:.4f} of neighbour pairs closed "
                  f"below pH {K.TITRATION_PH_TOP} (least step "
                  f"{verdict['min_step']:.2e})")
        report["ph"] = out
        return True

    ph_main()

    # ---- 5d. the object API on the card -----------------------------------
    @phase("object API on the card")
    def object_api():
        F.reset_launch_counts()
        FP.reset_launch_counts()
        PS.reset_launch_counts()
        out = {}
        run_all_validations(dev)
        run_all_sensor_validations(dev)
        check(True, "run_all_validations and run_all_sensor_validations "
              "ran on the card")

        dark = (SensorStatus.FAILED, SensorStatus.POWER_FAULT,
                SensorStatus.WARMING_UP)

        def sound(history) -> bool:
            """Every field of every reading finite, or NaN only where the
            status says so: a dark status or a fault code, or, for the
            value, after an open or short circuit of the same sensor (the
            model's NaN latch: the first-order lag keeps the NaN while the
            status moves on)."""
            latched = False
            for r in history:
                always = all(np.isfinite(x) for x in (
                    r.timestamp, r.noise, r.drift, r.uncertainty))
                value_ok = np.isfinite(r.value) or r.status in dark \
                    or r.fault is not SensorFault.NONE or latched
                raw_ok = np.isfinite(r.raw_value) or r.status in dark[1:]
                if not (always and value_ok and raw_ok):
                    return False
                latched = latched or r.status is SensorStatus.FAILED
            return True

        for tag, n_zones, n_ticks, verbose in (("demo-5", 5, 180, True),
                                               ("plant-20", 20, 600, False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reactor, suite = run_demo(dev, n_zones=n_zones, n_ticks=n_ticks,
                                      verbose=verbose)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            readings = [r for s in suite.values() for r in s.reading_history]
            finite = float(np.mean([np.isfinite(r.value) for r in readings]))
            out[tag] = dict(n_zones=n_zones, ticks=n_ticks, seconds=seconds,
                            ticks_per_s=n_ticks / seconds,
                            readings=len(readings), finite_share=finite)
            check(len(suite) == 7
                  and all(sound(x.reading_history) for x in suite.values())
                  and len(readings) == 7 * n_ticks + 1
                  and reactor.state.pH.is_cuda
                  and float(reactor.state.time) == float(n_ticks)
                  and bool(torch.isfinite(reactor.state.pH).all()),
                  f"object API {tag}: {n_zones}-zone IntegratedCSTR.step + 7 "
                  f"reads per tick, {n_ticks} ticks in {seconds:.2f} s: "
                  f"{n_ticks / seconds:.2f} ticks/s (host clock; per-tick "
                  f"plain PyTorch, no hand-written kernel); {len(readings)} "
                  f"readings sound, {finite:.4f} finite")
        reactor.print_diagnostics()
        counts = {**F.LAUNCHES, **FP.LAUNCHES, **PS.LAUNCHES}
        check(not any(counts.values()),
              f"object API: no hand-written kernel launched ({counts})")
        report["object_api"] = out
        return True

    object_api()

    # ---- 5e-5g. the six extension axes (plain PyTorch, no kernel) ---------
    full_cfg = P.full_chemistry_config(n_zones=20)
    full_bc = P.full_chemistry_boundary()
    # the six-axis plant's primary fields: 22 values a zone (tss and
    # pathogens carry 3 classes each; sludge is per class, not per zone)
    primary = ("pH", "chlorine", "temperature") \
        + sum(R.EXTENSION_STATE.values(), ())

    def kernel_counts():
        return {**F.LAUNCHES, **FP.LAUNCHES, **PS.LAUNCHES}

    def reset_kernel_counts():
        F.reset_launch_counts()
        FP.reset_launch_counts()
        PS.reset_launch_counts()

    @phase("path: full-chemistry ensemble")
    def full_chemistry():
        n_plants, m = 8192, 3
        t0 = time.perf_counter()
        params, state = make_monte_carlo_batch(full_cfg, n_plants, seed=0,
                                               dtype=f32, device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        def run(s, n_steps):
            return R.rollout(params, s, full_bc, DT, m, n_steps,
                             record=False)[0]

        # one step profiled, outside the timed window: kernels launched,
        # their device time, and the aten operations dispatched
        prof = step_profile(lambda: run(state, 1))
        # a 2-step warm-up, then 2 steps on the host clock size the timed
        # window to FULLCHEM_WINDOW_S
        warm = run(state, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = run(warm, 2)
        torch.cuda.synchronize()
        warm_step_s = (time.perf_counter() - t0) / 2
        n_steps = int(min(1000, max(20, FULLCHEM_WINDOW_S / warm_step_s)))
        print(f"  FULLCHEM-8192: n_steps cut from bench.py's 1000 to "
              f"{n_steps} (a {FULLCHEM_WINDOW_S:.0f} s window at "
              f"{warm_step_s * 1e3:.1f} ms per step after the warm-up)")
        reset_kernel_counts()
        ms, final = timed(lambda: run(warm, n_steps))
        counts = kernel_counts()
        step_ms = ms / n_steps
        rate = n_plants * n_steps / (ms / 1e3)
        fields_ = {f.name: getattr(final, f.name)
                   for f in dataclasses.fields(final)
                   if getattr(final, f.name) is not None}
        finite = all(bool(torch.isfinite(x).all())
                     for x in fields_.values())
        # every field the step clips at 0 (all but temperature, time)
        nonneg = all(bool((x >= 0).all()) for name, x in fields_.items()
                     if name not in ("temperature", "time"))
        ph = params.phase
        t_ok = bool((final.temperature >= ph.t_min[:, None]).all()
                    & (final.temperature
                       <= (ph.t_boil + ph.delta_boil)[:, None]).all())
        outlet = final.pathogens[..., -1]                  # [B, P]
        uv_ok = bool((outlet < full_bc.inlet_pathogens).all())
        per_zone = sum(int(np.prod(fields_[n].shape[1:-1]))
                       for n in primary if n != "sludge")
        ice = float((final.temperature < 0.0).double().mean())
        busy = prof["device_ms"]
        idle = None if busy is None else 1.0 - busy / step_ms
        report["full_chemistry"] = dict(
            plants=n_plants, zones=20, fields_per_zone=per_zone,
            substeps=m, n_steps=n_steps, cut_from=1000, setup_s=setup_s,
            warm_step_ms=warm_step_s * 1e3, window_ms=ms, ms_per_step=step_ms,
            plant_steps_per_s=rate, launches_per_step=prof["launches"],
            aten_ops_per_step=prof["aten_ops"],
            device_ms_per_step=busy, device_idle_share=idle,
            profiled_step_wall_ms=prof["wall_ms"],
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            share_of_zones_below_0C=ice,
            outlet_pathogens_max=float(outlet.max()),
            kernel_launches=counts)
        check(finite and nonneg and t_ok and uv_ok
              and set(primary) <= set(fields_) and per_zone == 22
              and final.tss.shape == (n_plants, 3, 20),
              f"FULLCHEM-8192 (8192 plants x 20 zones x {per_zone} fields, "
              f"RK4 x{m}"
              f", {n_steps} steps): {rate:.4e} plant-steps/s, "
              f"{step_ms:.2f} ms per step; one step launches "
              f"{prof['launches']} CUDA kernels ({prof['aten_ops']} aten "
              f"ops), {fmt(busy, '.2f')} ms of device time "
              f"(idle share {fmt(idle, '.3f')}); all 22 fields finite, "
              f">= 0 where clipped, T in the phase bounds, outlet pathogens "
              f"max {float(outlet.max()):.1f} < inlet 1e4 org/L; "
              f"{ice:.3f} of zones below 0 C")
        check(not any(counts.values()),
              f"FULLCHEM-8192: no B1-B4 launch in the window ({counts})")
        return True

    full_chemistry()

    @phase("path: full-chemistry on the card vs the CPU")
    def full_chemistry_cpu():
        finals = [R.rollout(*make_monte_carlo_batch(
            full_cfg, 16, seed=0, dtype=torch.float64, device=d), full_bc,
            DT, 3, 20, record=False)[0]
            for d in (dev, torch.device("cpu"))]
        worst = {}
        for f in dataclasses.fields(finals[1]):
            a, b = getattr(finals[0], f.name), getattr(finals[1], f.name)
            if b is None:
                continue
            a = a.cpu()
            # each field's largest error as a share of rtol |b| + atol
            worst[f.name] = float(((a - b).abs()
                                   / (1e-9 * b.abs() + 1e-12)).max())
        report["full_chemistry_card_vs_cpu"] = worst
        top = max(worst, key=worst.get)
        check(max(worst.values()) <= 1.0 and len(worst) >= 22,
              "16 plants x 20 zones x 20 steps in float64, card vs CPU: "
              f"every field within rtol 1e-9 + atol 1e-12 (largest share "
              f"of the tolerance {worst[top]:.3g}, in {top})")
        return True

    full_chemistry_cpu()

    @phase("path: instrumented full-chemistry plant")
    def plant_ext():
        params, plant = P.make_plant(full_cfg, dtype=f32, device=dev)
        m = R.default_substeps(full_cfg, DT)
        reset_kernel_counts()
        P.plant_rollout_auto(params, plant, full_bc, DT, m, 2, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, readings = P.plant_rollout_auto(params, plant, full_bc, DT, m,
                                               PLANT_EXT_STEPS, record=True,
                                               seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernel_counts()
        shares = {name: float(torch.isfinite(v).double().mean())
                  for name, v in readings.items()}
        report["plant_ext"] = dict(
            zones=20, steps=PLANT_EXT_STEPS, cut_from=600, substeps=m,
            seconds=seconds, steps_per_s=PLANT_EXT_STEPS / seconds,
            finite_share=shares, kernel_launches=counts)
        extra = ("ammonia_outlet", "oxygen_outlet", "turbidity_outlet")
        check(len(readings) == 10 and all(n in readings for n in extra)
              and all(v.shape == (PLANT_EXT_STEPS,)
                      for v in readings.values())
              and FP.unsupported_reason(params) is not None
              and not any(counts.values())
              and bool(torch.isfinite(final.reactor.pathogens).all()),
              f"PLANT-EXT-1 (1 plant x 20 zones, 10 instruments, "
              f"plant_rollout_auto -> the plant_step loop): {PLANT_EXT_STEPS} "
              f"steps (cut from 600) in {seconds:.2f} s, "
              f"{PLANT_EXT_STEPS / seconds:.2f} steps/s (host clock); "
              "finite readings "
              + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
              + f"; no B1-B4 launch ({counts})")
        return True

    plant_ext()


    # ---- 5h-5m. the control slice (plain PyTorch, no kernel) -------------
    from ics_wt_physicsengine_torch import control as C
    from ics_wt_physicsengine_torch.control import device_checks as DC
    from ics_wt_physicsengine_torch.core import network as NW

    def windowed(run, carry, max_steps, window_s, what):
        """Warm ``run(carry, n) -> carry`` up for 2 steps, size the step
        count to ``window_s`` on the host clock from 2 more, print the cut,
        then time that many steps (CUDA events) with the launch counts
        zeroed just before and read just after. Returns (ms, n_steps,
        carry, counts)."""
        carry = run(carry, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = run(carry, 2)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 2
        n_steps = int(min(max_steps, max(4, window_s / step_s)))
        if n_steps < max_steps:
            print(f"  {what}: n_steps cut from {max_steps} to {n_steps} (a "
                  f"{window_s:.0f} s window at {step_s * 1e3:.2f} ms per "
                  "step after the warm-up)")
        reset_kernel_counts()
        ms, carry = timed(lambda: run(carry, n_steps))
        return ms, n_steps, carry, kernel_counts()

    def no_kernel(what, counts):
        check(not any(counts.values()),
              f"{what}: no B1-B4 launch in the window ({counts})")

    # CL-4096: bench.py's bench_closed_loop
    @phase("path: closed-loop gain sweep")
    def closed_loop():
        cfg = R.ReactorConfiguration(volume=1000, height=2.0,
                                     diameter=0.798, n_zones=20,
                                     initial_chlorine=0.5)
        m, s = R.default_rkc_plan(cfg, DT, mode="fast")
        gains = C.make_gain_grid(
            kp_cl=np.linspace(0.05, 3.0, 16),
            ki_cl=np.linspace(0.0, 0.25, 16),
            kp_ph=np.linspace(-2.0, -0.1, 4),
            ki_ph=np.linspace(-0.2, 0.0, 4), dtype=f32, device=dev)
        n = C.n_gains(gains)
        params = R.make_params(cfg, dtype=f32, device=dev)
        state = R.make_initial_state(cfg, dtype=f32, device=dev)
        state = R.ReactorState(**{
            k: (None if v is None else v.expand((n,) + tuple(v.shape)))
            for k, v in vars(state).items()})
        bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                                  inlet_chlorine=0.5)

        def run(c, n_steps):
            st, cc, b = c
            with torch.no_grad():
                return C.rollout_closed_loop(
                    params, st, b, C.dual_pid_controller, gains, cc, DT, m,
                    n_steps, stages=s, record=False)[:3]

        carry = (state, C.make_dual_pid_carry((n,), f32, dev), bc)
        prof = step_profile(lambda: run(carry, 1))
        ms, n_steps, (st, cc, b), counts = windowed(
            run, carry, 2048, CONTROL_WINDOW_S, "CL-4096")
        rate = n * n_steps / (ms / 1e3)
        busy = prof["device_ms"]
        step_ms = ms / n_steps
        idle = None if busy is None else 1.0 - busy / step_ms
        cmds = (b.chlorine_flow_rate, b.acid_flow_rate)
        ok = (n == 4096 and bool(torch.isfinite(st.chlorine).all())
              and bool(torch.isfinite(st.pH).all())
              and all(bool(((x >= 0) & (x <= lim)).all())
                      for x, lim in zip(cmds, (1.0, 2.0))))
        report["CL-4096"] = dict(
            lanes=n, zones=20, plan=(m, s), n_steps=n_steps, cut_from=2048,
            window_ms=ms, ms_per_step=step_ms, plant_steps_per_s=rate,
            launches_per_step=prof["launches"],
            aten_ops_per_step=prof["aten_ops"], device_ms_per_step=busy,
            device_idle_share=idle, kernel_launches=counts)
        check(ok, f"CL-4096 ({n} gain lanes x 20 zones, RKC-fast {m}x{s}, "
              f"float32, {n_steps} steps): {rate:.4e} plant-steps/s, "
              f"{step_ms:.2f} ms per step; one step launches "
              f"{prof['launches']} CUDA kernels ({prof['aten_ops']} aten "
              f"ops), {fmt(busy, '.3f')} ms of device time (idle share "
              f"{fmt(idle, '.3f')}); states finite, commands inside "
              "[0, 1] and [0, 2] L/min")
        no_kernel("CL-4096", counts)
        return True

    closed_loop()

    taps = [("pH", 0), ("pH", -1), ("chlorine", -1), ("temperature", -1)]
    cfg6 = R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                  n_zones=6)
    bc6 = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                               inlet_chlorine=0.5)
    base6 = torch.tensor([7.2, 7.2, 2.0, 20.0], dtype=f32, device=dev)

    # EKF-1024: bench.py's bench_ekf
    @phase("path: EKF bank")
    def ekf_bank():
        n_filters, max_steps = 1024, 256
        params = R.make_params(cfg6, dtype=f32, device=dev)
        m = R.default_substeps(cfg6, DT)
        step = C.make_ekf(params, 6, taps, DT, m, measurement_noise=4e-4)
        one = C.make_ekf_carry(R.make_initial_state(cfg6, dtype=f32,
                                                    device=dev),
                               p0=(0.05, 1.0, 4.0), n_zones=6)
        carry = C.EKFCarry(x=one.x.expand(n_filters, -1).clone(),
                           P=one.P.expand(n_filters, -1, -1).clone())
        g = torch.Generator(device=dev).manual_seed(0)
        zs = base6 + 0.02 * torch.randn((max_steps + 4, n_filters, 4),
                                        generator=g, device=dev)
        seen = [0]

        def run(c, n_steps):
            for _ in range(n_steps):
                c, _ = step(c, zs[seen[0] % zs.shape[0]], bc6)
                seen[0] += 1
            return c

        prof = step_profile(lambda: run(carry, 1))
        ms, n_steps, c, counts = windowed(run, carry, max_steps,
                                          CONTROL_WINDOW_S, "EKF-1024")
        rate = n_filters * n_steps / (ms / 1e3)
        diag = torch.diagonal(c.P, dim1=-2, dim2=-1)
        ok = (bool(torch.isfinite(c.x).all())
              and bool(torch.isfinite(c.P).all())
              and bool((diag > 0).all())
              and float((c.P - c.P.transpose(-1, -2)).abs().max()) == 0.0)
        report["EKF-1024"] = dict(
            filters=n_filters, zones=6, state=18, taps=4, substeps=m,
            n_steps=n_steps, cut_from=max_steps, window_ms=ms,
            ms_per_step=ms / n_steps, filter_steps_per_s=rate,
            launches_per_step=prof["launches"],
            aten_ops_per_step=prof["aten_ops"],
            device_ms_per_step=prof["device_ms"], kernel_launches=counts)
        check(ok, f"EKF-1024 ({n_filters} filters x 18 states, 4 taps, "
              f"vmap(jacfwd(step)), float32, {n_steps} steps): {rate:.4e} "
              f"filter-steps/s, {ms / n_steps:.2f} ms per step; one step "
              f"launches {prof['launches']} CUDA kernels "
              f"({prof['aten_ops']} aten ops, {fmt(prof['device_ms'], '.3f')}"
              " ms of device time); estimates finite, covariances symmetric "
              "with a positive diagonal")
        no_kernel("EKF-1024", counts)
        return True

    ekf_bank()

    # ENKF-8192: bench.py's bench_enkf
    @phase("path: EnKF")
    def enkf():
        n_members, max_steps = 8192, 256
        params = R.make_params(cfg6, dtype=f32, device=dev)
        m = R.default_substeps(cfg6, DT)
        step = C.make_enkf(params, 6, taps, DT, m, measurement_noise=4e-4,
                           inflation=1.02, localization_radius=2.0)
        carry = C.make_enkf_carry(
            R.make_initial_state(cfg6, dtype=f32, device=dev),
            p0=(0.05, 1.0, 4.0), n_zones=6, n_ensemble=n_members,
            generator=torch.Generator(device=dev).manual_seed(0))
        g = torch.Generator(device=dev).manual_seed(1)
        zs = base6 + 0.02 * torch.randn((max_steps + 4, 4), generator=g,
                                        device=dev)
        seen = [0]

        def run(c, n_steps):
            for _ in range(n_steps):
                c, _ = step(c, zs[seen[0] % zs.shape[0]], bc6)
                seen[0] += 1
            return c

        prof = step_profile(lambda: run(carry, 1))
        ms, n_steps, c, counts = windowed(run, carry, max_steps,
                                          CONTROL_WINDOW_S, "ENKF-8192")
        rate = n_members * n_steps / (ms / 1e3)
        spread = C.ensemble_spread(c)
        ok = bool(torch.isfinite(c.ensemble).all()) \
            and bool((spread > 0).all())
        report["ENKF-8192"] = dict(
            members=n_members, zones=6, inflation=1.02,
            localization_radius=2.0, n_steps=n_steps, cut_from=max_steps,
            window_ms=ms, ms_per_step=ms / n_steps,
            member_steps_per_s=rate, launches_per_step=prof["launches"],
            aten_ops_per_step=prof["aten_ops"],
            device_ms_per_step=prof["device_ms"], kernel_launches=counts)
        check(ok, f"ENKF-8192 ({n_members} members x 18 states, inflation "
              f"1.02, localization 2.0, float32, {n_steps} steps): "
              f"{rate:.4e} member-steps/s, {ms / n_steps:.2f} ms per step; "
              f"one step launches {prof['launches']} CUDA kernels "
              f"({prof['aten_ops']} aten ops, "
              f"{fmt(prof['device_ms'], '.3f')} ms of device time); "
              "members finite, spread > 0")
        no_kernel("ENKF-8192", counts)
        return True

    enkf()

    # MPC-20: examples/mpc_dosing.py's settings
    @phase("path: shooting MPC")
    def mpc():
        cfg = R.ReactorConfiguration(n_zones=20, initial_chlorine=0.5,
                                     flow_rate=20.0)
        bc = R.BoundaryConditions(inlet_flow_rate=20.0)
        dt = 60.0
        m = R.default_substeps(cfg, dt)
        moves, per_move, iters = MPC_CUT
        cuts = [f"{name} cut from {full} to {value}" for name, full, value
                in (("horizon_moves", 6, moves),
                    ("steps_per_move", 10, per_move), ("iters", 20, iters))
                if value != full]
        print(f"  MPC-20: {', '.join(cuts)} ({m} RK4 substeps a 60 s step)")
        program = torch.cat([torch.full((60,), 2.0, dtype=f32, device=dev),
                             torch.full((60,), 1.0, dtype=f32, device=dev)])
        params = R.make_params(cfg, dtype=f32, device=dev)
        state = R.make_initial_state(cfg, dtype=f32, device=dev)
        horizon = moves * per_move
        reset_kernel_counts()
        plan_ms, (plan, costs) = timed(lambda: C.mpc_plan(
            params, state, bc, program[:horizon],
            torch.full((moves,), 0.2, dtype=f32, device=dev), dt=dt,
            substeps=m, steps_per_move=per_move, iters=iters))
        seg_ms, res = timed(lambda: C.run_mpc(
            cfg, program[:per_move], dt, horizon_moves=moves,
            steps_per_move=per_move, iters=iters, boundary=bc, dtype=f32,
            device=dev))
        counts = kernel_counts()
        step_ms, _ = timed(lambda: R.step(params, state, bc, dt, m))
        prof = step_profile(lambda: R.step(params, state, bc, dt, m))
        ok = (bool(torch.isfinite(plan).all())
              and bool(((plan >= 0) & (plan <= 1.0)).all())
              and bool(torch.isfinite(costs).all())
              and bool(torch.isfinite(res["chlorine_outlet"]).all())
              and res["commands"].shape == (per_move,))
        report["MPC-20"] = dict(
            zones=20, dt=dt, substeps=m, horizon_moves=moves,
            steps_per_move=per_move, iters=iters, cut_from=(6, 10, 20),
            replan_ms=plan_ms, segment_ms=seg_ms,
            plant_step_ms=step_ms, launches_per_plant_step=prof["launches"],
            aten_ops_per_plant_step=prof["aten_ops"],
            plan=plan.tolist(), costs=costs.tolist(),
            segment_score=res["score"], kernel_launches=counts)
        check(ok, f"MPC-20 (20 zones, dt 60 s, {m} substeps, {moves} move "
              f"x {per_move} steps, {iters} Adam iteration(s), float32): "
              f"{plan_ms / 1e3:.2f} s per re-plan; one run_mpc segment "
              f"(a re-plan + {per_move} steps) {seg_ms / 1e3:.2f} s; one "
              f"plant step {step_ms:.1f} ms, {prof['launches']} CUDA "
              "kernels; moves in [0, 1] L/min, costs and trajectory finite")
        no_kernel("MPC-20", counts)
        return True

    mpc()

    # TRAIN-3: examples/treatment_train.py
    @phase("path: treatment train")
    def train():
        def stage(volume):
            height = volume / 1000.0 / (math.pi * (0.798 / 2) ** 2)
            return R.ReactorConfiguration(n_zones=5, volume=volume,
                                          height=height,
                                          initial_chlorine=0.2)

        W = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.15], [0.0, 1.0, 0.0]])
        D = np.array([[1, 1, 1], [2, 1, 5], [1, 5, 1]])
        topo = NW.NetworkTopology(routing=W, delay_steps=D)
        params, ns0 = NW.make_network(
            [stage(800.0), stage(4000.0), stage(2500.0)], topo, dtype=f32,
            device=dev)
        ta = NW.topology_arrays(topo, f32, dev)
        dt, m, max_steps = 5.0, 8, 4320

        def boundary(booster):
            return R.BoundaryConditions(
                inlet_flow_rate=torch.tensor([8.0, 0.0, 0.0], device=dev),
                inlet_pH=7.6, inlet_chlorine=0.05, inlet_temperature=18.0,
                chlorine_flow_rate=torch.tensor([0.25, 0.0, 0.0],
                                                device=dev)
                + booster * torch.tensor([0.0, 0.0, 1.0], device=dev),
                chlorine_concentration=50.0)

        one_bc = boundary(0.1)

        def run(ns, n_steps):
            with torch.no_grad():
                return NW.rollout_network(params, ta, ns, one_bc, dt, m,
                                          n_steps, record=False)[0]

        prof = step_profile(lambda: run(ns0, 1))
        ms, n_steps, fs, counts = windowed(run, ns0, max_steps,
                                           CONTROL_WINDOW_S, "TRAIN-3")
        rate = n_steps / (ms / 1e3)
        doses = torch.linspace(0.0, 0.5, 16, device=dev)
        sweep_bc = boundary(doses[:, None])
        batched = NW.NetworkState(
            reactor=R.ReactorState(**{
                k: (None if v is None else v.expand((16,) + tuple(v.shape)))
                for k, v in vars(ns0.reactor).items()}),
            ring=ns0.ring.expand((16,) + tuple(ns0.ring.shape)),
            ring_index=ns0.ring_index.expand((16,)))

        def run_sweep(ns, n):
            with torch.no_grad():
                return NW.rollout_network(params, ta, ns, sweep_bc, dt, m, n,
                                          record=False)[0]

        s_ms, s_steps, fs_all, s_counts = windowed(
            run_sweep, batched, max_steps, CONTROL_WINDOW_S,
            "TRAIN-3 dose sweep")
        s_rate = 16 * s_steps / (s_ms / 1e3)
        finished = fs_all.reactor.chlorine[:, 2, -1].cpu()
        # the booster doses the clearwell's zone 0
        dosed = fs_all.reactor.chlorine[:, 2, 0].cpu()
        ok = (bool(torch.isfinite(fs.reactor.chlorine).all())
              and bool(torch.isfinite(fs_all.reactor.chlorine).all())
              and bool((dosed[1:] > dosed[:-1]).all())
              and int(fs.ring_index) == n_steps + 4)
        report["TRAIN-3"] = dict(
            stages=3, zones=5, dt=dt, substeps=m, n_steps=n_steps,
            cut_from=max_steps, window_ms=ms, network_steps_per_s=rate,
            sweep_doses=16, sweep_steps=s_steps, sweep_window_ms=s_ms,
            sweep_network_steps_per_s=s_rate,
            launches_per_step=prof["launches"],
            aten_ops_per_step=prof["aten_ops"],
            device_ms_per_step=prof["device_ms"],
            stage_outlet_chlorine=fs.reactor.chlorine[:, -1].tolist(),
            finished_water_by_dose=finished.tolist(),
            dosed_zone_by_dose=dosed.tolist(),
            kernel_launches={**counts, **{f"sweep {k}": v
                                          for k, v in s_counts.items()}})
        check(ok, f"TRAIN-3 (3 stages x 5 zones, 15% recycle, delays 2 "
              f"and 5, dt 5 s, RK4 x{m}, float32): {n_steps} steps at "
              f"{rate:.1f} network-steps/s; the 16-dose sweep as one "
              f"batched call, {s_steps} steps at {s_rate:.1f} "
              f"network-steps/s; one step launches {prof['launches']} CUDA "
              f"kernels ({prof['aten_ops']} aten ops); finished water "
              f"{float(finished.min()):.3f}..{float(finished.max()):.3f} "
              "mg/L; the clearwell's dosed zone rises with the booster "
              "dose")
        no_kernel("TRAIN-3", {**counts, **s_counts})
        return True

    train()

    @phase("path: control on the card vs the CPU")
    def control_cpu():
        reset_kernel_counts()
        worst = {}
        for name, case in DC.CASES.items():
            card, host = case(dev), case(torch.device("cpu"))
            for key, b in host.items():
                a = card[key].cpu()
                worst[f"{name}: {key}"] = float(
                    ((a - b).abs() / (1e-9 * b.abs() + 1e-12)).max())
        counts = kernel_counts()
        report["control_card_vs_cpu"] = worst
        top = max(worst, key=worst.get)
        check(max(worst.values()) <= 1.0 and len(worst) >= 10,
              "closed loop, EKF bank step and MHE step in float64, card vs "
              "CPU: every output within rtol 1e-9 + atol 1e-12 (largest "
              f"share of the tolerance {worst[top]:.3g}, in {top})")
        no_kernel("control card vs CPU", counts)
        return True

    control_cpu()

    # ---- 5n-5q. the surrogate and the utilities (plain PyTorch, no kernel)
    from ics_wt_physicsengine_torch.control.ekf import flatten_state
    from ics_wt_physicsengine_torch.models import surrogate as SG
    from ics_wt_physicsengine_torch.models import surrogate_checks as SC
    from ics_wt_physicsengine_torch.sensors import (
        create_realistic_sensor_suite)
    from ics_wt_physicsengine_torch.utils import checkpoint as CK

    bf16 = torch.bfloat16

    # SURR-INFER-65536: bench.py's bench_surrogate, inference row
    @phase("path: surrogate inference")
    def surr_infer():
        n_batch, n_steps = SURR_INFER
        sp = SC.bench_params(device=dev)
        x0, us = SC.bench_inputs(sp, n_batch, n_steps, device=dev)
        held = [x0]

        def roll():
            x = held[0]
            with torch.no_grad():
                for t in range(n_steps):
                    x = SG.surrogate_step(sp, x, us[t], compute_dtype=bf16)
            held[0] = x            # each call starts from the last state
            return x

        roll()
        reset_kernel_counts()
        ms, x = timed(roll, reps=3)
        counts = kernel_counts()
        rate = n_batch * n_steps / (ms / 1e3)
        step_ms = ms / n_steps
        with torch.no_grad():
            prof = step_profile(lambda: SG.surrogate_step(sp, x, us[0], bf16))
            by_kernel = kernel_breakdown(
                lambda: SG.surrogate_step(sp, x, us[0], bf16))
        busy = prof["device_ms"]
        idle = None if busy is None else 1.0 - busy / step_ms
        flops = SC.step_flops(sp, n_batch)
        moved = 2 * x.numel() * x.element_size()       # x in, x out
        ops_ms = flops / K.PEAK_OPS[bf16] * 1e3
        bytes_ms = moved / HBM_RATE * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        worst = SC.card_vs_cpu(dev)
        ok = (x.shape == x0.shape and bool(torch.isfinite(x).all())
              and bool(((x >= sp.lo) & (x <= sp.hi)).all()))
        report["SURR-INFER-65536"] = dict(
            batch=n_batch, n_steps=n_steps, zones=6, state=x.shape[1],
            hidden=(128, 128), compute="bfloat16 operands, float32 products",
            ms_per_call=ms, ms_per_step=step_ms, plant_steps_per_s=rate,
            launches_per_step=prof["launches"],
            aten_ops_per_step=prof["aten_ops"], device_ms_per_step=busy,
            device_idle_share=idle, gemm_flop_per_step=flops,
            bytes_per_step=moved, bound_ms_per_step=bound_ms,
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            device_ms_by_kernel=by_kernel, card_vs_cpu=worst,
            kernel_launches=counts)
        check(ok, f"SURR-INFER-65536 ({n_batch} plants x 6 zones, (128, "
              f"128) MLP, bfloat16 products, {n_steps} steps a call, 3 "
              f"chained calls): {rate:.4e} plant-steps/s, "
              f"{step_ms * 1e3:.1f} us per step; one step launches "
              f"{prof['launches']} CUDA kernels ({prof['aten_ops']} aten "
              f"ops), {fmt(busy and busy * 1e3, '.1f')} us of device time "
              f"(idle share {fmt(idle, '.3f')}); a step's GEMM work "
              f"{flops / 1e9:.3f} GFLOP and {moved / 1e6:.2f} MB of x in "
              f"and out, bound {bound_ms * 1e3:.2f} us; states finite and "
              "inside the physical bounds")
        check(all(err <= SC.TOLERANCE[getattr(torch, name.split()[1])]
                  for name, err in worst.items()),
              "surrogate step (a residual at the state's full spread) and "
              "8-step rollout (bench.py's network) of 4096 states, card "
              "against CPU: float32 products within 1e-5 of x_std, "
              "bfloat16 ones (the CPU's float32 emulation) within 1e-4 ("
              + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + ")")
        no_kernel("SURR-INFER-65536", counts)
        return True

    surr_infer()

    # SURR-TRAIN-2048: bench.py's bench_surrogate, training row
    @phase("path: surrogate training")
    def surr_train():
        sp = SC.bench_params()
        n = sp.x_mean.shape[0]
        g = torch.Generator().manual_seed(3)
        X = (sp.x_mean + sp.x_std * torch.randn((64, 65, n), generator=g)
             ).to(dev)
        U = torch.rand((64, 64, 1), generator=g).to(dev)

        def train(seed, n_steps):
            out = SG.train_surrogate(X, U, 6, seed=seed, hidden=(128, 128),
                                     n_steps=n_steps, batch_size=2048,
                                     rollout_steps=0, compute_dtype=bf16)
            torch.cuda.synchronize()
            return out

        reset_kernel_counts()
        seconds, runs = [], []
        for seed in (1, 2):
            t0 = time.perf_counter()
            runs.append(train(seed, SURR_TRAIN_STEPS))
            seconds.append(time.perf_counter() - t0)
        counts = kernel_counts()
        rate = SURR_TRAIN_STEPS / min(seconds)
        # one Adam step: the difference of an 11-step and a 1-step call
        p1, p11 = step_profile(lambda: train(1, 1)), \
            step_profile(lambda: train(1, 11))
        per = {k: (None if p1[k] is None or p11[k] is None
                   else (p11[k] - p1[k]) / 10)
               for k in ("launches", "device_ms", "aten_ops")}
        step_ms = min(seconds) / SURR_TRAIN_STEPS * 1e3
        idle = None if per["device_ms"] is None \
            else 1.0 - per["device_ms"] / step_ms
        # forward and backward products: 3 x a forward's
        flops = 3 * SC.step_flops(sp, 2048)
        sp1, info = runs[0]
        losses = info["one_step_loss"]
        ok = (losses.shape == (SURR_TRAIN_STEPS,)
              and bool(torch.isfinite(losses).all())
              and all(bool(torch.isfinite(w).all()) for w in sp1.weights)
              and float(sp1.weights[-2].abs().max()) > 0)
        report["SURR-TRAIN-2048"] = dict(
            X=(64, 65, n), batch=2048, adam_steps=SURR_TRAIN_STEPS,
            seconds=seconds, adam_steps_per_s=rate, ms_per_step=step_ms,
            launches_per_step=per["launches"],
            aten_ops_per_step=per["aten_ops"],
            device_ms_per_step=per["device_ms"], device_idle_share=idle,
            gemm_flop_per_step=flops,
            bound_ms_per_step=flops / K.PEAK_OPS[bf16] * 1e3,
            first_last_loss=(float(losses[0]), float(losses[-1])),
            kernel_launches=counts)
        check(ok, f"SURR-TRAIN-2048 (X 64 x 65 x {n}, batch 2048, "
              f"{SURR_TRAIN_STEPS} Adam steps, bfloat16 products): "
              f"{rate:.1f} Adam steps/s (the better of 2 calls: "
              f"{seconds[0]:.2f} s, {seconds[1]:.2f} s); one step launches "
              f"{fmt(per['launches'], '.0f')} CUDA kernels "
              f"({fmt(per['aten_ops'], '.0f')} aten ops), "
              f"{fmt(per['device_ms'], '.3f')} ms of device time (idle "
              f"share {fmt(idle, '.3f')}); losses and weights finite")
        no_kernel("SURR-TRAIN-2048", counts)
        return True

    surr_train()

    # SURR-MPC-6: examples/surrogate_mpc.py as written, without its
    # physics-shooting comparison
    @phase("path: surrogate-planned MPC")
    def surr_mpc():
        cfg = R.ReactorConfiguration(
            volume=1000.0, n_zones=6, flow_rate=5.0, initial_pH=7.2,
            initial_chlorine=2.0, temperature=20.0)
        dt, Z = 30.0, 6
        print("  SURR-MPC-6: the example's physics-shooting run_mpc "
              "comparison is not run (about 10^8 launches at this horizon; "
              "MPC-20 covers that path)")
        reset_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp, info = SG.fit_plant_surrogate(cfg, dt=dt, seed=0, device=dev,
                                          **SURR_FIT)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        params = R.make_params(cfg, dtype=f32, device=dev)
        substeps = R.default_substeps(cfg, dt)
        Xv, Uv = SG.make_surrogate_dataset(
            params, Z, R.BoundaryConditions(), 123, 32, SURR_FIT["n_steps"],
            dt, substeps)
        with torch.no_grad():
            err = SG.surrogate_step(sp, Xv[:, :-1], Uv) - Xv[:, 1:]
            res = Xv[:, 1:] - Xv[:, :-1]
            drift = SG.surrogate_rollout(sp, Xv[:, 0], Uv.transpose(0, 1)) \
                - Xv[:, 1:].transpose(0, 1)
        skill = {f: float(err[..., i * Z:(i + 1) * Z].std(correction=0)
                          / res[..., i * Z:(i + 1) * Z].std(correction=0))
                 for i, f in enumerate(("pH", "chlorine", "temperature"))}
        drift_cl = float(drift[..., Z:2 * Z].std(correction=0))
        n_steps = SURR_MINUTES * 2
        n_steps -= n_steps % 15
        half = (n_steps // 2) - ((n_steps // 2) % 15)
        program = torch.cat([
            torch.full((half,), 1.5, device=dev),
            torch.full((n_steps - half,), 2.5, device=dev)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sur = SG.run_mpc_surrogate(cfg, sp, program, dt=dt,
                                   horizon_moves=4, steps_per_move=15,
                                   iters=20, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        x0 = flatten_state(R.make_initial_state(cfg, dtype=f32, device=dev))
        plan_ms, (moves, costs) = timed(lambda: SG.surrogate_mpc_plan(
            sp, x0, {("chlorine", -1): program[:60]},
            torch.full((4, 1), 0.2, device=dev), dt, Z, 15, iters=20))
        counts = kernel_counts()
        cl = sur["chlorine_outlet"]
        track = float((cl[-15:] - 2.5).abs().mean())
        n_plans = n_steps // 15
        ok = (bool(torch.isfinite(cl).all()) and cl.shape == (n_steps,)
              and bool(torch.isfinite(costs).all())
              and bool(((moves >= 0) & (moves <= 1.0)).all()))
        report["SURR-MPC-6"] = dict(
            zones=Z, dt=dt, substeps=substeps, fit=dict(SURR_FIT),
            fit_seconds=fit_s,
            val_rmse={k: float(v) for k, v in info["val_rmse"].items()},
            one_step_skill_vs_identity=skill,
            open_loop_drift_chlorine_mgL=drift_cl, program_steps=n_steps,
            horizon_moves=4, steps_per_move=15, iters=20,
            run_seconds=run_s, replans=n_plans,
            run_seconds_per_replan=run_s / n_plans, replan_ms=plan_ms,
            score_ISE=sur["score"], last_segment_mean_abs_error=track,
            cut="the physics-shooting run_mpc comparison is not run",
            kernel_launches=counts)
        check(ok and all(v < 0.5 for v in skill.values()),
              f"SURR-MPC-6 fit (6 zones, dt 30 s, {substeps} substeps, "
              f"{SURR_FIT['n_traj']} trajectories x {SURR_FIT['n_steps']} "
              f"steps, {SURR_FIT['train_steps']} + "
              f"{SURR_FIT['rollout_steps']} Adam steps): {fit_s:.1f} s; "
              "held-out one-step skill against the identity predictor "
              + ", ".join(f"{k} {v:.3f}" for k, v in skill.items())
              + f" (< 0.5); open-loop chlorine drift {drift_cl:.4f} mg/L")
        check(ok and track < 0.15,
              f"SURR-MPC-6 run_mpc_surrogate ({SURR_MINUTES} min program, "
              f"horizon 4 x 15, 20 iterations, {n_plans} re-plans): "
              f"{run_s:.1f} s ({run_s / n_plans:.2f} s per re-plan with its "
              f"15 plant steps; one re-plan alone {plan_ms / 1e3:.2f} s); "
              f"score {sur['score']:.2f}; last 15 outlet-chlorine values "
              f"within a mean {track:.3f} of 2.5 mg/L (< 0.15)")
        no_kernel("SURR-MPC-6", counts)
        return sp

    fitted = surr_mpc()

    @phase("path: checkpoints on the card")
    def checkpoints():
        reset_kernel_counts()
        sp = fitted if fitted is not None else SC.bench_params(device=dev)
        cfg = R.ReactorConfiguration()
        bc = R.BoundaryConditions(acid_flow_rate=0.2,
                                  chlorine_flow_rate=0.05)

        def suite(seed):
            sensors = create_realistic_sensor_suite(cfg, seed=seed,
                                                    device=dev)
            for s in sensors.values():
                s.calibrate(7.0, 0.0)
            return sensors

        def ticks(r, sensors, t0, n):
            out = []
            for i in range(n):
                r.step(1.0, bc)
                out.append([s.read(r.state, t0 + i).value
                            for s in sensors.values()])
            return np.asarray(out), r.state

        with tempfile.TemporaryDirectory() as d:
            CK.save_pytree(os.path.join(d, "sp.npz"), sp)
            back = CK.load_pytree(os.path.join(d, "sp.npz"), sp)
            sp_ok = all(a.device == b.device and torch.equal(a, b)
                        for a, b in zip(CK.tree_leaves(back),
                                        CK.tree_leaves(sp)))
            r1 = R.IntegratedCSTR(cfg, device=dev)
            s1 = suite(3)
            ticks(r1, s1, 2000.0, 10)
            CK.save_simulation(os.path.join(d, "sim.npz"), r1, sensors=s1)
            want, st1 = ticks(r1, s1, 2010.0, 20)
            r2 = R.IntegratedCSTR(cfg, device=dev)
            s2 = suite(999)
            CK.load_simulation(os.path.join(d, "sim.npz"), r2, sensors=s2)
            got, st2 = ticks(r2, s2, 2010.0, 20)
        counts = kernel_counts()
        sim_ok = (bool(np.isfinite(got).all())
                  and np.array_equal(got, want) and all(
            torch.equal(getattr(st1, k), getattr(st2, k))
            for k in ("pH", "chlorine", "temperature", "time"))
            and st2.pH.device.type == dev.type)
        report["checkpoints_on_the_card"] = dict(
            surrogate_leaves=len(CK.tree_leaves(sp)), surrogate_equal=sp_ok,
            simulation_resumed_equal=sim_ok, sensors=len(s1),
            kernel_launches=counts)
        check(sp_ok, f"the fitted SurrogateParams ({len(CK.tree_leaves(sp))}"
              " CUDA tensors) saved and reloaded into its CUDA template: "
              "every leaf bit-equal, on the card")
        check(sim_ok, "IntegratedCSTR (5 zones) and its seven sensors on "
              "the card, saved after 10 ticks and reloaded into a reactor "
              "and a suite seeded otherwise: the next 20 ticks' states and "
              "readings equal those of the run that never stopped")
        no_kernel("checkpoints on the card", counts)
        return True

    checkpoints()

    # ---- 6. float32 against float64 on the ensemble ----------------------
    @phase("float32 vs float64 ensemble")
    def precision():
        # how far float32 rounding, amplified by the stratification switch,
        # carries the 2 h result of the float64 run (the CPU suite's type)
        finals = {}
        for dtype in (f32, torch.float64):
            params, state = make_monte_carlo_batch(
                R.ReactorConfiguration(n_zones=20), 4096, seed=0,
                dtype=dtype, device=dev)
            finals[dtype] = F.rollout_fused(params, state, policy, dt=DT,
                                            substeps=3, n_steps=7200)
        lo, hi = finals[f32], finals[torch.float64]
        drift = {name: float((getattr(lo, name).double()
                              - getattr(hi, name)).abs().max())
                 for name in ("pH", "chlorine", "temperature")}
        q32 = ensemble_statistics(lo)["chlorine"]["quantiles"][:, -1]
        q64 = ensemble_statistics(hi)["chlorine"]["quantiles"][:, -1]
        qgap = float((q32.double() - q64).abs().max())
        dph = (lo.pH.double() - hi.pH).abs()
        worst = divmod(int(dph.argmax()), 20)
        worst_ph = (float(lo.pH[worst]), float(hi.pH[worst]))
        share = float((dph > 1e-3).double().mean())
        report["f32_vs_f64_4096x7200_rk4"] = dict(
            max_abs_state_diff=drift, outlet_cl_quantile_gap=qgap,
            worst_ph_plant_zone=worst, worst_ph_f32_f64=worst_ph,
            share_of_zones_ph_diff_over_1e_3=share)
        check(qgap < 1e-2, "4096x7200 RK4 float32 vs float64: outlet Cl "
              f"p05/median/p95 within {qgap:.2e} mg/L (< 1e-2); max abs "
              f"state diff pH {drift['pH']:.2e} (plant {worst[0]} zone "
              f"{worst[1]}: {worst_ph[0]:.4f} vs {worst_ph[1]:.4f}; "
              f"{share:.2e} of zones differ by > 1e-3), Cl "
              f"{drift['chlorine']:.2e} mg/L, T {drift['temperature']:.2e} C")
        return True

    precision()

    # ---- 7. launches on the main path -------------------------------------
    for name, n in main_launches.items():
        kernels[name]["launches"] = n
        check(n > 0, f"{name}: {n} launches on the main path")
    return finish(kernels, card)


# FULLCHEM-8192's timed window [s]: its step count is cut to fit it
FULLCHEM_WINDOW_S = 10.0
# PLANT-EXT-1's steps (cut from 600 to keep the script inside its time)
PLANT_EXT_STEPS = 150
# CL-4096, EKF-1024, ENKF-8192 and TRAIN-3's timed windows [s]
CONTROL_WINDOW_S = 12.0
# MPC-20's horizon_moves, steps_per_move and Adam iterations (cut from 6,
# 10, 20: a 60 s step takes 121 RK4 substeps of plain PyTorch)
MPC_CUT = (1, 10, 1)
# SURR-INFER-65536's batch and steps a call (bench.py's)
SURR_INFER = (65536, 256)
# SURR-TRAIN-2048's Adam steps a call (bench.py's)
SURR_TRAIN_STEPS = 200
# SURR-MPC-6's fit and program (examples/surrogate_mpc.py's defaults)
SURR_FIT = dict(n_traj=512, n_steps=48, train_steps=6000, rollout_steps=600)
SURR_MINUTES = 90


def fmt(x, spec):
    return "not measured" if x is None else format(x, spec)


def step_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler (CUDA kernels launched and
    their summed device time) and under a dispatch counter (aten
    operations); the kernel numbers are None when the profiler records no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if getattr(e.device_type, "name", "") == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return dict(aten_ops=Count.n, wall_ms=wall_ms,
                launches=len(kernels) if kernels else None,
                device_ms=device_ms if kernels else None)


def kernel_breakdown(fn, top: int = 8) -> dict:
    """Device milliseconds of one call of ``fn`` by CUDA kernel name (the
    ``top`` largest, and the rest summed), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    sums: dict = {}
    for e in prof.events():
        if getattr(e.device_type, "name", "") == "CUDA":
            sums[e.name] = sums.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    names = sorted(sums, key=sums.get, reverse=True)
    out = {n[:80]: sums[n] for n in names[:top]}
    if len(names) > top:
        out["(the rest)"] = sum(sums[n] for n in names[top:])
    return out


def finish(kernels, card) -> int:
    report["kernels"] = list(kernels.values())
    report["failures"] = failures
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
