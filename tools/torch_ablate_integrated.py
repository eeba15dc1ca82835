#!/usr/bin/env python3
"""
Where the plain batched instrumented plant's time goes: the port of
``tools/ablate_integrated.py``.

    python tools/torch_ablate_integrated.py [--plants 16384] [--steps 64]
        [--reps 3] [--device cuda]

``models/plant.py::plant_rollout_batched`` (plain PyTorch on the plants'
device, no kernel) on ``--plants`` 20-zone plants (``make_plant_batch``,
seed 1), RKC-fast (``default_rkc_plan(config, 1.0, mode="fast")``),
float32, ``record=False``, in plant-steps/s for:

  physics   the bare reactor rollout (``core.reactor.rollout``)
  full      physics and the 7 instruments, the exact sample-line ring
            (``line_mode="exact"``), draws from a seeded generator
  norand    ``plant_step_batched`` in a loop fed zero normals and 0.5
            uniforms (the widths of ``_RAND_LAYOUT``): the draws' cost
  noline    full with every sample line off (``line_capacity=0``): the
            ring's cost
  tap       full with the fixed-dt line taps (``line_mode="tap"``)

Each variant is timed on the host clock around whole calls that end in a
synchronize, each call fed the last one's state, after a warm-up (the
JAX tool's output chaining). Prints the JAX tool's lines, the header
naming the device (the card's name and power limit); ``main`` returns
the rates with the final state of each variant. The card is the default;
``--device cpu`` runs the same plain path on the CPU (there is no fallback
to it: asking for a missing card exits non-zero).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ics_wt_physicsengine_torch.bench import device_info  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.models import plant as P  # noqa: E402
from ics_wt_physicsengine_torch.sensors import base as SB  # noqa: E402

VARIANTS = ("physics", "full", "norand", "noline", "tap")
SEED = 1           # the plants' parameters and the instruments' generator
# One source of truth for per-sensor randomness widths: the model's table.
SENSOR_DIMS = {name: (nn, nu) for name, nn, nu in P._RAND_LAYOUT}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, carry, reps, device):
    """A warm-up call, then ``reps`` calls each fed the last one's carry:
    mean host-clock seconds a call (synchronized) and the last carry."""
    carry = fn(carry)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        carry = fn(carry)
    _sync(device)
    return (time.perf_counter() - t0) / reps, carry


def no_lines(params):
    """``params`` with every sensor's sample line off (``line_capacity``
    0); a sensor's params wrap the base ``SensorParams`` in ``.base``."""
    def kill_line(sp):
        return dataclasses.replace(sp, base=dataclasses.replace(
            sp.base, line_capacity=0))

    return dataclasses.replace(
        params,
        **{f.name: kill_line(getattr(params, f.name))
           for f in dataclasses.fields(params)
           if isinstance(getattr(getattr(params, f.name), "base", None),
                         SB.SensorParams)})


def ablate(device, n_plants=16384, steps=64, reps=3, dtype=torch.float32):
    """``({variant: plant-steps/s}, {variant: final state})``: the final
    reactor state of ``physics``, the final ``PlantState`` of the rest."""
    config = R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                    n_zones=20)
    m, s = R.default_rkc_plan(config, 1.0, mode="fast")
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5, acid_flow_rate=0.1)
    denom = n_plants * steps
    params, plant = P.make_plant_batch(config, n_plants, seed=SEED,
                                       dtype=dtype, device=device)
    generator = torch.Generator(device=device).manual_seed(SEED)
    results, finals = {}, {}

    def run(name, fn, carry):
        secs, finals[name] = timed(fn, carry, reps, device)
        results[name] = denom / secs

    # --- physics only ------------------------------------------------------
    run("physics", lambda st: R.rollout(
        params.reactor, st, bc, dt=1.0, substeps=m, stages=s, n_steps=steps,
        record=False)[0], plant.reactor)

    # --- full shipping path ------------------------------------------------
    run("full", lambda p: P.plant_rollout_batched(
        params, p, bc, 1.0, m, steps, record=False, stages=s,
        line_mode="exact", generator=generator)[0], plant)

    # --- no PRNG: constant injected randomness -----------------------------
    like = plant.reactor.pH
    rand = {k: (like.new_zeros((n_plants, nn)),
                like.new_full((n_plants, nu), 0.5))
            for k, (nn, nu) in SENSOR_DIMS.items()}

    def roll_norand(p):
        for _ in range(steps):
            p = P.plant_step_batched(params, p, bc, 1.0, m, stages=s,
                                     rand=rand)[0]
        return p

    run("norand", roll_norand, plant)

    # --- no sample lines ---------------------------------------------------
    params_nl = no_lines(params)
    run("noline", lambda p: P.plant_rollout_batched(
        params_nl, p, bc, 1.0, m, steps, record=False, stages=s,
        generator=generator)[0], plant)

    # --- O(1) fixed-dt line taps -------------------------------------------
    run("tap", lambda p: P.plant_rollout_batched(
        params, p, bc, 1.0, m, steps, record=False, stages=s,
        line_mode="tap", generator=generator)[0], plant)
    return results, finals


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="tools/torch_ablate_integrated.py",
                                 description=__doc__.strip().split("\n")[0])
    ap.add_argument("--plants", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; no "
                         "fallback)")
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    info = device_info(device)
    results, finals = ablate(device, args.plants, args.steps, args.reps)
    n = args.plants
    where = info["name"] if info["power_limit_w"] is None \
        else f"{info['name']}, {info['power_limit_w']} W"
    print(f"# {n} plants x {args.steps} steps, 20 zones, RKC2-fast, "
          f"{device.type} ({where})")
    for k, v in results.items():
        print(f"{k:8s} {v / 1e6:8.1f}M plant-steps/s   "
              f"({1e9 / v:6.1f} ns/plant-step)")
    return {"plants": n, "steps": args.steps, "reps": args.reps,
            "dtype": "float32", "device": info,
            "plant_steps_per_s": results, "final": finals}


if __name__ == "__main__":
    main()
