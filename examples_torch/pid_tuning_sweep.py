"""
PID commissioning on the card with the PyTorch port (the port of
``examples/pid_tuning_sweep.py``): a 4096-gain closed-loop sweep in one
batched loop.

Over the Modbus socket each candidate costs a full HIL session (minutes of
wall clock per gain at realistic pacing). Here the whole grid is one
batched closed-loop rollout over ``[n_gains, n_zones]`` tensors:

  1. sweep a (kp, ki) x (kp, ki) grid of dual-loop candidates
     (``control.gain_sweep``),
  2. refine the winner by multi-start gradient descent through the
     differentiable plant (``control.tune_pid_gradient``, autograd and the
     port's Adam),
  3. report the commissioning table.

The eight starts of step 2 are the winner jittered by 20%: one
``torch.Generator`` seeded 0, 1, 2, 3 for the four gains. Plain PyTorch: no
hand-written kernel lies on this path.

Usage:
  python examples_torch/pid_tuning_sweep.py [--gains 4096] [--steps 240]
      [--refine-iters 30] [--device {cuda,cpu}]

The card is the default; ``--device cpu`` runs on the CPU. Prints its
progress, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ics_wt_physicsengine_torch import control as C  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402

DT = 60.0
N_STARTS = 8
JITTER = 0.2


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def jitter_draws(device, dtype=torch.float32) -> torch.Tensor:
    """``[4, N_STARTS]`` standard normal draws, row ``k`` from a generator
    seeded ``k`` (chlorine kp, ki; pH kp, ki)."""
    return torch.stack([
        torch.randn(N_STARTS, generator=torch.Generator(
            device=device).manual_seed(k), dtype=dtype, device=device)
        for k in range(4)])


def main(argv=None, jitter=None) -> dict:
    """The sweep, the refinement and the report (returned). ``jitter``
    (``[4, 8]`` standard normal draws) replaces ``jitter_draws``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--gains", type=int, default=4096,
                        help="grid size (rounded to a k*k*m*m grid)")
    parser.add_argument("--steps", type=int, default=240,
                        help="closed-loop steps per candidate (dt=60s)")
    parser.add_argument("--refine-iters", type=int, default=30)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default; no fallback) or cpu")
    args = parser.parse_args(argv)
    device = cli_device(args.device)
    f32 = torch.float32

    # grid: n = k^2 * m^2; pick k, m to land near the request
    m = 4
    k = max(2, int(round((args.gains / m ** 2) ** 0.5)))
    config = R.ReactorConfiguration(n_zones=20, initial_chlorine=0.5,
                                    flow_rate=20.0)
    boundary = R.BoundaryConditions(inlet_flow_rate=20.0)
    grid = C.make_gain_grid(
        kp_cl=np.linspace(0.05, 3.0, k, dtype=np.float32),
        ki_cl=np.linspace(0.0, 0.25, k, dtype=np.float32),
        kp_ph=np.linspace(-2.0, -0.1, m, dtype=np.float32),
        ki_ph=np.linspace(-0.2, 0.0, m, dtype=np.float32),
        cl_setpoint=2.0, ph_setpoint=7.2, dtype=f32, device=device)
    n = C.n_gains(grid)
    print(f"sweeping {n} gain candidates x {args.steps} closed-loop steps "
          f"({n * args.steps:,} plant-steps, 20 zones) ...", flush=True)

    _sync(device)
    t0 = time.time()
    res = C.gain_sweep(config, grid, dt=DT, n_steps=args.steps,
                       boundary=boundary, effort_weight=0.1, dtype=f32,
                       device=device)
    _sync(device)
    t_sweep = time.time() - t0
    best = res["best"]
    scores = res["scores"].cpu().numpy()
    print(f"sweep: {t_sweep:.2f}s "
          f"({n * args.steps / t_sweep:,.0f} closed-loop plant-steps/s)")
    print(f"best #{res['best_index']}: "
          f"cl(kp={float(best.chlorine.kp):.3f}, "
          f"ki={float(best.chlorine.ki):.4f})  "
          f"ph(kp={float(best.ph.kp):.3f}, ki={float(best.ph.ki):.4f})  "
          f"score={float(scores[res['best_index']]):.2f}", flush=True)

    # gradient refinement: 8 jittered starts around the sweep winner
    draws = jitter_draws(device) if jitter is None else torch.as_tensor(
        jitter, dtype=f32, device=device)

    def starts(gains, row):
        return dataclasses.replace(
            C.PIDGains(**{f.name: getattr(gains, f.name).expand(N_STARTS)
                          for f in dataclasses.fields(gains)}),
            kp=gains.kp * (1.0 + JITTER * draws[row]),
            ki=gains.ki * (1.0 + JITTER * draws[row + 1]))

    g0 = C.DualPIDGains(chlorine=starts(best.chlorine, 0),
                        ph=starts(best.ph, 2))
    _sync(device)
    t0 = time.time()
    ref = C.tune_pid_gradient(config, g0, dt=DT, n_steps=args.steps,
                              iters=args.refine_iters, learning_rate=0.02,
                              boundary=boundary, effort_weight=0.1,
                              dtype=f32, device=device)
    _sync(device)
    t_ref = time.time() - t0
    tuned = ref["best"]
    print(f"gradient refine ({N_STARTS} starts x {args.refine_iters} "
          f"iters): {t_ref:.2f}s")
    report = {
        "n_gains": n,
        "sweep_seconds": round(t_sweep, 3),
        "closed_loop_steps_per_sec": round(n * args.steps / t_sweep, 1),
        "sweep_best_score": round(float(scores[res["best_index"]]), 3),
        "refined_score": round(float(
            ref["final_scores"].detach().cpu().numpy().min()), 3),
        "tuned": {
            "cl_kp": round(float(tuned.chlorine.kp), 4),
            "cl_ki": round(float(tuned.chlorine.ki), 5),
            "ph_kp": round(float(tuned.ph.kp), 4),
            "ph_ki": round(float(tuned.ph.ki), 5),
        }}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
