"""
Spatial decomposition with the PyTorch port: one very-high-resolution
plant split over a zone mesh (the port of
``examples/zone_sharded_highres.py``).

A 256-zone contactor (cm-scale vertical resolution) is split along its zone
axis (``parallel/spatial.py``): each shard owns a contiguous block of zones
and takes one ghost zone a side from its neighbours at every integrator
stage. The shards are the visible cards (``--device cuda``) or the CPU,
each listed as often as ``--shards`` needs: one card may hold several
shards, which is how the halo path runs without a second card.

    python examples_torch/zone_sharded_highres.py [--zones 256]
        [--steps 500] [--shards N] [--integrator {rk4,rkc-fast}]
        [--device {cuda,cpu}]

The zone-sharded trajectory is checked against the unsharded engine at
the end (the same arithmetic, split).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.parallel import (  # noqa: E402
    gather_zones, make_zone_mesh, shard_state_zones, zone_sharded_rollout)

HEIGHT = 4.0            # m
VOLUME = 2000.0         # L
# a warm inflow over a cold tank
COLUMN_BC = R.BoundaryConditions(
    inlet_flow_rate=8.0, inlet_pH=7.6, inlet_chlorine=0.8,
    inlet_temperature=24.0, ambient_temperature=8.0,
    heat_loss_coefficient=120.0)


def column_config(zones: int) -> R.ReactorConfiguration:
    """The tall contactor: 2000 L, 4 m high, ``zones`` zones."""
    diameter = 2 * math.sqrt((VOLUME / 1000) / (math.pi * HEIGHT))
    return R.ReactorConfiguration(
        volume=VOLUME, height=HEIGHT, diameter=diameter, n_zones=zones,
        flow_rate=8.0, initial_pH=7.3, initial_chlorine=1.5,
        temperature=18.0)


def column_state(config: R.ReactorConfiguration, dtype, device):
    """The initial state: 6 C warmer at the top than at the bottom of the
    column, so the stratification switch is active."""
    s0 = R.make_initial_state(config, dtype=dtype, device=device)
    s0 = replace(s0, temperature=s0.temperature + torch.linspace(
        6.0, 0.0, config.n_zones, dtype=dtype, device=device))
    return R._update_derived(s0)


def shard_devices(device: torch.device, shards: int, zones: int) -> list:
    """``shards`` (cut down until it divides ``zones``) devices: the
    visible cards in turn, or the CPU, each as often as needed."""
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [device])
    while zones % shards:
        shards -= 1
    return [visible[k % len(visible)] for k in range(shards)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--zones", type=int, default=256)
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--dt", type=float, default=1.0)
    parser.add_argument("--shards", type=int, default=None,
                        help="zone shards (default: one a visible card, "
                             "one on the CPU)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default; no fallback) or cpu")
    parser.add_argument("--integrator", choices=["rk4", "rkc-fast"],
                        default="rk4",
                        help="rkc-fast: Chebyshev-stabilized integrator: "
                             "at high zone counts the exchange stiffness "
                             "grows ~n^2, so the stability span cuts the "
                             "sequential evaluations ~5-8x")
    args = parser.parse_args(argv)
    device = cli_device(args.device)
    n_visible = torch.cuda.device_count() if device.type == "cuda" else 1
    devices = shard_devices(device, args.shards or n_visible, args.zones)
    print(f"{n_visible} {device.type} device(s) visible; using "
          f"{len(devices)} shard(s) ({args.zones // len(devices)} zones "
          f"each)", flush=True)

    cfg = column_config(args.zones)
    if args.integrator == "rkc-fast":
        substeps, stages = R.default_rkc_plan(cfg, args.dt, mode="fast",
                                              max_stages=16)
    else:
        substeps, stages = R.default_substeps(cfg, args.dt), None
    params = R.make_params(cfg, dtype=torch.float32, device=device)
    state = column_state(cfg, torch.float32, device)

    mesh = make_zone_mesh(devices=devices)
    roll = zone_sharded_rollout(mesh, n_zones=args.zones, dt=args.dt,
                                substeps=substeps, stages=stages,
                                n_steps=args.steps)
    out = roll(params, shard_state_zones(state, mesh), COLUMN_BC)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    out = roll(params, out, COLUMN_BC)
    _sync(device)
    elapsed = time.perf_counter() - t0
    out = gather_zones(out, device=device)
    evals = substeps * (4 if stages is None else stages)
    print(f"{args.steps} steps x {args.zones} zones x {substeps} substeps "
          f"({args.integrator}, {evals} derivative evals/step): "
          f"{elapsed:.3f}s ({args.steps / elapsed:,.0f} steps/s)",
          flush=True)

    ref, _ = R.rollout(params, state, COLUMN_BC, dt=args.dt,
                       substeps=substeps, stages=stages,
                       n_steps=2 * args.steps, record=False)
    err = float((out.pH - ref.pH).abs().max())
    print(f"max |pH(sharded) - pH(single-device)| = {err:.2e}")
    print(f"outlet: pH={float(out.pH[-1]):.3f} "
          f"Cl={float(out.chlorine[-1]):.3f} mg/L "
          f"T={float(out.temperature[-1]):.2f} C", flush=True)
    return {"shards": len(devices), "steps": args.steps,
            "seconds": elapsed, "steps_per_s": args.steps / elapsed,
            "max_abs_ph_err": err}


if __name__ == "__main__":
    main()
