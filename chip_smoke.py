#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases:
 1. the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from ics_wt_physicsengine_torch/csrc (nvcc
    time and the -Xptxas -v register/spill report);
 3. each kernel against its plain PyTorch version on the card, in float64
    and float32, for RK4, RKC-strict and RKC-fast, on a single 20-zone plant
    and 1024-plant Monte-Carlo batches at 5 and 20 zones (200 steps,
    recorded every 10), plus the 4096 x 20 main-path shape; B2 on the
    bench's dosing schedule; a constant schedule through B2 equal to B1;
    B1 in float64 against the plain version on the CPU (the tables and
    tolerances of ics_wt_physicsengine_torch/ops/kernel_checks.py);
 4. the main path at full size: 4096 parameter-randomized 20-zone plants,
    7200 one-second steps, RK4 (3 substeps) and RKC-fast (1 x 4 stages),
    make_monte_carlo_batch -> rollout_fused (kernel B1) ->
    ensemble_statistics / exceedance_probability; then 32768 plants x 2000
    steps;
 5. one scheduled 20-zone plant for 32768 steps of the dosing schedule,
    RKC-fast, through rollout_scheduled_fused (kernel B2);
 6. the 4096-plant RK4 ensemble in float64 against float32;
 7. a JSON line of per-kernel numbers, the card line, and the result line.

Launch counts are zeroed just before each run of a main-path entry point
(its warm-up and timed calls) and read just after: each call must have
launched its own kernel once and no other, and the kernels line reports
the sum over phases 4 and 5. Direct kernel calls (phase 3, the kernel-only
times of phase 4) and phase 6 lie outside those windows. Exits non-zero,
with no result line, when there is no CUDA card, when the package is
missing, or when any check fails. Times are CUDA-event times after a
warm-up; every number is this run's, on the card named in the output.
Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FP32_PEAK = 67e12       # H100 SXM, non-tensor FP32 [operation/s]
DT = 1.0
SOURCE = "ics_wt_physicsengine_torch/csrc/fused_rollout.cu"
TPU_KERNELS = "ics_wt_physicsengine_tpu/ops/fused_rollout.py"
REPLACES = {"rollout_fused": f"{TPU_KERNELS}:272",
            "rollout_scheduled_fused": f"{TPU_KERNELS}:312"}

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
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.models import make_monte_carlo_batch
    from ics_wt_physicsengine_torch.ops import _build
    from ics_wt_physicsengine_torch.ops import fused_rollout as F
    from ics_wt_physicsengine_torch.ops import kernel_checks as K
    from ics_wt_physicsengine_torch.parallel import (
        ensemble_statistics, exceedance_probability)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {name: {"name": name, "route": "cuda", "source": SOURCE,
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": None, "ms": None, "plain_ms": None,
                      "bound_ms": None, "bound_by": "operations",
                      "library_ms": None}
               for name in F.LAUNCHES}
    card = card_line()
    report["card"] = card
    report["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"

    # ---- 1. card -------------------------------------------------------
    print(f"== card: {card}; {torch.cuda.get_device_name(0)}; "
          f"torch {report['torch']}", flush=True)

    # ---- 2. build ------------------------------------------------------
    @phase("build")
    def build():
        _build.load()
        info = _build.build_info
        print(f"  nvcc {info['seconds']:.1f} s (cached={info['cached']}) "
              f"-> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  " + line.strip())
        report["build"] = {"seconds": info["seconds"], "log": info["log"]}
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
                for n_zones, n_plants in ((20, 1), (5, 1024), (20, 1024)):
                    m, s = K.stiff_plan(n_zones, integrator)
                    got, err = K.b1_vs_plain(
                        n_zones, n_plants, dtype, dev, substeps=m, stages=s,
                        n_steps=200, record_every=10)
                    rows.append(dict(kernel="rollout_fused", dtype=tag,
                                     integrator=integrator, n_zones=n_zones,
                                     n_plants=n_plants, substeps=m, stages=s,
                                     max_abs_err=err))
                    check(err <= tol and all(
                        bool(torch.isfinite(x).all()) for x in got[:3]),
                        f"B1 {tag} {integrator} ({m}x{s or 4}) "
                        f"{n_plants}x{n_zones}: max|kernel-plain| {err:.3e}"
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

    main_launches = dict.fromkeys(F.LAUNCHES, 0)

    def on_main_path(name, run, reps):
        """A warm-up and ``reps`` timed calls of entry point ``name``, with
        every launch count zeroed just before and read just after: each
        call must have launched kernel ``name`` once and no other kernel."""
        F.reset_launch_counts()
        run()                                                # warm-up
        ms, out = timed(run, reps=reps)
        counts = dict(F.LAUNCHES)
        for kernel, n in counts.items():
            main_launches[kernel] += n
        want = {kernel: (1 + reps) * (kernel == name) for kernel in counts}
        check(counts == want, f"{name}: launches {counts} for {1 + reps} "
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
                finite = all(bool(torch.isfinite(x).all()) for x in (
                    final.pH, final.chlorine, final.temperature,
                    stats["chlorine"]["quantiles"], stats["pH"]["std"]))
                key = f"{n_plants}x{n_steps}_{integrator}"
                out[key] = dict(
                    plants=n_plants, steps=n_steps, substeps=m, stages=s,
                    setup_s=setup_s, wrapper_ms=wrapper_ms,
                    kernel_ms=kernel_ms, bound_ms=bound,
                    plant_steps_per_s=rate,
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
                      f"bound {bound:.3f} ms; outlet Cl p05/median/p95 "
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
