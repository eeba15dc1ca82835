"""
Treatment train with the PyTorch port (the port of
``examples/treatment_train.py``): a connected 3-stage reactor network with
booster chlorination (``core/network.py``).

    raw water --> [0] rapid-mix contact tank (primary chlorine dose)
                   |  pipe, 2-step delay
                   v
                  [1] baffled contact basin (large, no dosing)
                   |  pipe, 5-step delay          ^
                   v                              | 15% recycle
                  [2] clearwell (booster dose) ---+

All three stages advance as one ``[3, Z]`` batched step; the routing is a
3x3 matmul; the pipe delays are a ring buffer. A second pass sweeps the
booster dose: every candidate dose is a realization of the network, the
dose a ``[doses, 1]`` boundary leaf, and the whole sweep one batched
rollout. Plain PyTorch: no hand-written kernel lies on this path.

Usage:
  python examples_torch/treatment_train.py [--hours 6] [--doses 16]
      [--device {cuda,cpu}]

The card is the default; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ics_wt_physicsengine_torch.core import network as N  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402

DT, SUBSTEPS = 5.0, 8
TARGET = 1.0                      # finished-water residual [mg/L]
STAGES = ["contact tank", "contact basin", "clearwell"]


def stage_config(volume: float) -> R.ReactorConfiguration:
    height = volume / 1000.0 / (math.pi * (0.798 / 2) ** 2)
    return R.ReactorConfiguration(n_zones=5, volume=volume, height=height,
                                  initial_chlorine=0.2)


def make_train(dtype, device):
    """The three stages, their routing (15% clearwell recycle) and pipe
    delays: ``(params, initial network state, topology arrays)``."""
    #            from:  0     1     2
    W = np.array([[0.0, 0.0, 0.0],     # to 0 (head of train)
                  [1.0, 0.0, 0.15],    # to 1 (plus 15% clearwell recycle)
                  [0.0, 1.0, 0.0]])    # to 2
    D = np.array([[1, 1, 1],
                  [2, 1, 5],
                  [1, 5, 1]])
    topo = N.NetworkTopology(routing=W, delay_steps=D)
    params, ns0 = N.make_network(
        [stage_config(800.0), stage_config(4000.0), stage_config(2500.0)],
        topo, dtype=dtype, device=device)
    return params, ns0, N.topology_arrays(topo, dtype, device)


def boundary(booster, device) -> R.BoundaryConditions:
    """The train's forcing with the clearwell's booster dose [L/min]: a
    number, or a ``[doses, 1]`` tensor for one realization a dose."""
    return R.BoundaryConditions(
        inlet_flow_rate=torch.tensor([8.0, 0.0, 0.0], device=device),
        inlet_pH=7.6, inlet_chlorine=0.05, inlet_temperature=18.0,
        chlorine_flow_rate=torch.tensor([0.25, 0.0, 0.0], device=device)
        + booster * torch.tensor([0.0, 0.0, 1.0], device=device),
        chlorine_concentration=50.0)


def realizations(nstate: N.NetworkState, n: int) -> N.NetworkState:
    """``n`` copies of a network state along a new leading axis."""
    def tile(x):
        return None if x is None else x.expand((n,) + tuple(x.shape))
    return N.NetworkState(
        reactor=R.ReactorState(**{k: tile(v)
                                  for k, v in vars(nstate.reactor).items()}),
        ring=tile(nstate.ring), ring_index=tile(nstate.ring_index))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hours", type=float, default=6.0)
    ap.add_argument("--doses", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; no fallback) or cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)

    lines = []

    def say(line=""):
        print(line, flush=True)
        lines.append(line)

    params, ns0, ta = make_train(torch.float32, device)
    n_steps = int(args.hours * 3600 / DT)

    with torch.no_grad():
        fs, _ = N.rollout_network(params, ta, ns0, boundary(0.1, device),
                                  DT, SUBSTEPS, n_steps, record=False)
    cl = fs.reactor.chlorine[:, -1].cpu().numpy()
    say(f"after {args.hours:.1f} h (single train, booster 0.1 L/min):")
    for i, name in enumerate(STAGES):
        say(f"  stage {i} ({name:13s}) outlet residual: {cl[i]:6.3f} mg/L")

    # --- booster dose sweep: one batched rollout over the realizations ---
    doses = torch.linspace(0.0, 0.5, args.doses, device=device)
    with torch.no_grad():
        fs_all, _ = N.rollout_network(
            params, ta, realizations(ns0, args.doses),
            boundary(doses[:, None], device), DT, SUBSTEPS, n_steps,
            record=False)
    finished = fs_all.reactor.chlorine[:, 2, -1].cpu().numpy()
    best = int(np.argmin(np.abs(finished - TARGET)))
    say()
    say(f"booster sweep ({args.doses} doses, one batched call):")
    say(f"  finished-water residual range: "
        f"{finished.min():.3f} .. {finished.max():.3f} mg/L")
    say(f"  closest to {TARGET:.1f} mg/L target: "
        f"{float(doses[best]):.3f} L/min -> {finished[best]:.3f} mg/L")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
