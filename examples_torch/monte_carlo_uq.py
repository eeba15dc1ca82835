"""
Monte-Carlo uncertainty quantification with the PyTorch port (the port of
``examples/monte_carlo_uq.py``, BASELINE config 4).

Runs thousands of parameter-randomized plants in lockstep on the card (one
launch of the fused rollout kernel B1, ``ops.fused_rollout.rollout_fused``),
then reduces to the ensemble statistics a dosing engineer actually uses:
outlet quantile bands and regulatory exceedance probabilities under a fixed
dosing policy. ``--with-sensors`` quantifies the *measured* values instead
(every plant with its seven instruments, ``plant_rollout_batched``), and
``--dosing-program`` drives that ensemble through 15-minute chlorine
pulses every hour.

Usage:
  python examples_torch/monte_carlo_uq.py [--plants 4096] [--hours 2]
      [--device {cuda,cpu}] [--with-sensors [--dosing-program]]

The card is the default; ``--device cpu`` runs the plain PyTorch paths.
Prints one JSON document.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ics_wt_physicsengine_torch.bench import device_info  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.models import (  # noqa: E402
    make_monte_carlo_batch)
from ics_wt_physicsengine_torch.models.plant import (  # noqa: E402
    make_plant_batch, plant_rollout_batched)
from ics_wt_physicsengine_torch.ops.fused_rollout import (  # noqa: E402
    rollout_fused)
from ics_wt_physicsengine_torch.parallel import (  # noqa: E402
    ensemble_statistics, exceedance_probability)

# the fixed dosing policy under evaluation
POLICY = R.BoundaryConditions(
    inlet_flow_rate=5.0, inlet_pH=7.4, inlet_chlorine=0.2,
    chlorine_flow_rate=0.15, chlorine_concentration=50.0,
    acid_flow_rate=0.05)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dosing_program(n_steps: int, dt: float) -> R.BoundaryConditions:
    """``POLICY`` with 15-minute chlorine pulses (0.45 L/min) at the start
    of every hour, 0.05 L/min between them, one row a step."""
    t_ax = np.arange(n_steps, dtype=np.float32) * dt
    return replace(POLICY, chlorine_flow_rate=np.where(
        t_ax % 3600.0 < 900.0, 0.45, 0.05).astype(np.float32))


def measured_values(args, device, substeps, stages, n_steps) -> dict:
    """``--with-sensors``: the instrumented ensemble's outlet chlorine as
    its instruments report it after ``n_steps``."""
    base = R.ReactorConfiguration(n_zones=20)
    params, plant = make_plant_batch(base, args.plants, seed=args.seed,
                                     dtype=torch.float32, device=device)
    schedule = (dosing_program(n_steps, args.dt) if args.dosing_program
                else None)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    plant, traj = plant_rollout_batched(
        params, plant, POLICY, args.dt, substeps, n_steps, stages=stages,
        schedule=schedule, generator=generator)
    cl = traj["chlorine_outlet"][-1].cpu().numpy()
    wall = time.perf_counter() - t0
    finite = cl[np.isfinite(cl)]
    return {
        "mode": ("measured-values+dosing-program"
                 if args.dosing_program else "measured-values"),
        "plants": args.plants,
        "simulated_hours": args.hours,
        "wall_seconds_including_compile": round(wall, 2),
        "measured_outlet_chlorine_mg_L": {
            "p05": round(float(np.quantile(finite, 0.05)), 3),
            "median": round(float(np.quantile(finite, 0.5)), 3),
            "p95": round(float(np.quantile(finite, 0.95)), 3),
        },
        "sensor_dropout_fraction": round(1.0 - len(finite) / len(cl), 4),
        "backend": device.type,
        "device": device_info(device),
    }


def true_state(args, device, substeps, stages, n_steps) -> dict:
    """The bare-physics ensemble through ``rollout_fused`` (B1 on the
    card): quantile bands and exceedance probabilities of the true
    state."""
    base = R.ReactorConfiguration(n_zones=20)
    params, state = make_monte_carlo_batch(base, args.plants, seed=args.seed,
                                           dtype=torch.float32,
                                           device=device)
    _sync(device)
    t0 = time.perf_counter()
    final = rollout_fused(params, state, POLICY, dt=args.dt,
                          substeps=substeps, stages=stages, n_steps=n_steps)
    _sync(device)
    wall = time.perf_counter() - t0   # includes the kernel's first load

    stats = ensemble_statistics(final)
    probs = exceedance_probability(final)
    q = stats["chlorine"]["quantiles"].cpu().numpy()   # [3, Z]
    return {
        "plants": args.plants,
        "simulated_hours": args.hours,
        "wall_seconds_including_compile": round(wall, 2),
        "plant_steps_per_s_including_compile": round(
            args.plants * n_steps / wall, 0),
        "outlet_chlorine_mg_L": {
            "p05": round(float(q[0, -1]), 3),
            "median": round(float(q[1, -1]), 3),
            "p95": round(float(q[2, -1]), 3),
        },
        "outlet_pH": {
            "median": round(float(stats["pH"]["quantiles"][1, -1]), 3),
        },
        "exceedance": {k: round(float(v), 4) for k, v in probs.items()},
        "backend": device.type,
        "device": device_info(device),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--plants", type=int, default=4096)
    parser.add_argument("--hours", type=float, default=2.0)
    parser.add_argument("--dt", type=float, default=1.0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default; no fallback) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--with-sensors", action="store_true",
                        help="quantify uncertainty over *measured* values "
                             "(full instrument suites per plant) instead of "
                             "true state")
    parser.add_argument("--dosing-program", action="store_true",
                        help="with --with-sensors: drive the whole ensemble "
                             "through a scripted chlorine dosing program "
                             "(square-wave pulses) instead of constant "
                             "forcing")
    parser.add_argument("--integrator", choices=["rk4", "rkc-fast"],
                        default="rk4",
                        help="rkc-fast: Chebyshev-stabilized integrator")
    args = parser.parse_args(argv)
    if args.dosing_program and not args.with_sensors:
        parser.error("--dosing-program requires --with-sensors (the "
                     "true-state fused path runs constant forcing)")
    device = cli_device(args.device)

    n_steps = int(args.hours * 3600 / args.dt)
    # substeps/stages for the stiffest sampled plant (90 rpm impeller)
    substeps, stages = (1, 4) if args.integrator == "rkc-fast" else (3, None)
    run = measured_values if args.with_sensors else true_state
    report = run(args, device, substeps, stages, n_steps)
    print(json.dumps(report, indent=2), flush=True)
    return report


if __name__ == "__main__":
    main()
