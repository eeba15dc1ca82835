#!/usr/bin/env python3
"""What building kernels B1, B2, B3 and B4 without FMA contraction costs,
on one CUDA card.

    python3 tools/torch_fma_cost.py

The port's kernels (ics_wt_physicsengine_torch/csrc/*.cu) are built with
-fmad=false so that they round every operation as their plain PyTorch
versions do. This script builds them a second time with nvcc's default
contraction (-fmad=true), the two builds in parallel, and times both on
the main path's float32 shapes: 4096 and 32768 Monte-Carlo plants of the
20-zone reactor (examples/monte_carlo_uq.py's dosing policy) with RK4 3
substeps and RKC-fast 1 x 4, one 20-zone plant through bench.py's dosing
schedule, and the instrumented plant (kernel B3, Philox): one 20-zone plant
for 16384 steps with RK4 and RKC-fast, and 4096 plants for 2000 steps
recorded every 100; and the Newton pH solve (kernel B4) on 65,536 waters
and on the 4096 x 256 titration of chip_smoke.py. Each cell runs the two builds in
the order shipped, FMA, FMA, shipped after a warm-up of each, and reports
their mean CUDA-event times, their ratio, and how far the FMA build's final
state and outlet chlorine p05/median/p95 lie from the shipped build's
(for B4: how far its pH lies, and its 5/50/95% quantiles).
Prints the card's name and power limit and one line per cell; writes
chiprun_out/torch_fma_cost.json. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 2
PH_REPS = 50        # the pH solve takes well under a millisecond
QUANTILES = (0.05, 0.5, 0.95)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fma_cost: no CUDA device is available", file=sys.stderr)
        return 2
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.ops import _build
    from ics_wt_physicsengine_torch.ops import fused_plant as FP
    from ics_wt_physicsengine_torch.ops import fused_rollout as F
    from ics_wt_physicsengine_torch.ops import kernel_checks as K
    from ics_wt_physicsengine_torch.ops import ph_solver as PS

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    variants = {"shipped": _build.NVCC_FLAGS,
                "fma": tuple("-fmad=true" if f == "-fmad=false" else f
                             for f in _build.NVCC_FLAGS)}
    with ThreadPoolExecutor(len(variants)) as pool:
        paths = dict(zip(variants, pool.map(_build.build, variants.values())))
    libs = {variant: {name: _build.bind(name, path)
                      for name, path in built.items()}
            for variant, built in paths.items()}

    dev, f32 = torch.device("cuda"), torch.float32
    policy = R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.4, inlet_chlorine=0.2,
        chlorine_flow_rate=0.15, chlorine_concentration=50.0,
        acid_flow_rate=0.05)
    fast = R.default_rkc_plan(R.ReactorConfiguration(n_zones=20), 1.0,
                              mode="fast")
    cells = []
    for n_plants, n_steps in ((4096, 7200), (32768, 2000)):
        ptab, btab, y = K.tables(20, n_plants, f32, dev, bc=policy)
        for tag, (m, s) in (("rk4", (3, None)), ("fast", (1, 4))):
            cells.append((f"MC-{n_plants} x{n_steps} {tag} ({m}x{s or 4})",
                          lambda ptab=ptab, btab=btab, y=y, m=m, s=s,
                          n=n_steps: F.rollout_kernel(
                              ptab, btab, *y, dt=1.0, substeps=m, stages=s,
                              n_steps=n)))
    ptab, _, y = K.tables(20, 1, f32, dev)
    sched = F.schedule_table(K.bench_schedule(32768), 32768, f32, dev)
    cells.append((f"SCHED-1 x32768 fast ({fast[0]}x{fast[1]})",
                  lambda: F.scheduled_kernel(ptab, sched, *y, dt=1.0,
                                             substeps=fast[0],
                                             stages=fast[1])))

    # kernel B3 on chip_smoke.py's instrumented cells
    def plant_cell(n_plants, n_steps, record_every, m, s):
        params, plant = K.plant_case(20, n_plants, f32, dev)
        tables = FP.build_tables(params, plant, K.BC, dt=1.0,
                                 n_steps=n_steps)

        def run():
            out = FP.plant_kernel(tables, dt=1.0, substeps=m, stages=s,
                                  n_steps=n_steps,
                                  record_every=record_every, seed=7)
            return out.ph, out.cl, out.t
        return run

    rk4 = K.plant_plan(20, "rk4")
    for tag, (m, s) in (("rk4", rk4), ("fast", fast)):
        cells.append((f"PLANT-1 x16384 {tag} ({m}x{s or 4})",
                      plant_cell(1, 16384, 16384, m, s)))
    cells.append((f"PLANT-4096 x2000 rk4 ({rk4[0]}x4)",
                  plant_cell(4096, 2000, 100, *rk4)))

    # kernel B4 on chip_smoke.py's equilibrium-pH cells; the result is
    # shaped [n, 1] three times so that the comparison below reads it as it
    # reads a state
    def ph_cell(constants, guess):
        args, _ = PS.broadcast_inputs(constants, guess)

        def run():
            ph = PS.ph_kernel(*args)[:, None]
            return ph, ph, ph
        return run

    waters = K.ph_waters((65536,), f32, dev)
    cells.append(("PH-EQ-65536 x100", ph_cell(
        waters, torch.full((65536,), 7.0, dtype=f32, device=dev)),
        PH_REPS))
    k, shifts = K.titration_waters(4096, 256, f32, dev)
    cells.append(("PH-TITR-4096x256 x100", ph_cell(
        dataclasses.replace(k, alk_eq=k.alk_eq + shifts),
        PS.solve_pH_plain(k, 7.0)), PH_REPS))

    rows = []
    for label, run, *reps in cells:
        reps = reps[0] if reps else REPS
        times = {name: [] for name in libs}
        finals = {}
        for name in ("shipped", "fma", "fma", "shipped"):
            _build.use(libs[name])      # the libraries the wrappers launch
            if name not in finals:
                finals[name] = run()                         # warm-up
            ms, _ = timed(run, reps)
            times[name].append(ms)
        ms = {name: sum(v) / len(v) for name, v in times.items()}
        a, b = finals["shipped"], finals["fma"]
        diff = max(float((x - z).abs().max()) for x, z in zip(a[:3], b[:3]))
        q = torch.tensor(QUANTILES, device=dev)
        qgap = float((torch.quantile(a[1][:, -1], q)
                      - torch.quantile(b[1][:, -1], q)).abs().max())
        row = dict(cell=label, reps=reps, shipped_ms=ms["shipped"], fma_ms=ms["fma"],
                   shipped_over_fma=ms["shipped"] / ms["fma"],
                   runs_ms=times, max_abs_state_diff=diff,
                   outlet_cl_quantile_gap=qgap)
        rows.append(row)
        print(f"{label}: -fmad=false {ms['shipped']:.3f} ms, -fmad=true "
              f"{ms['fma']:.3f} ms, ratio {row['shipped_over_fma']:.4f}; "
              f"max |state diff| {diff:.3e}, p05/median/p95 gap "
              f"{qgap:.3e}", flush=True)

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_fma_cost.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, reps=REPS,
                       cells=rows), f, indent=1)
    print(json.dumps({"card": card, "cells": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
