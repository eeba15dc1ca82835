"""
Clarifier train with the PyTorch port (the port of
``examples/clarifier_train.py``): class-resolved solids through a connected
3-stage network (``core/network.py`` + ``core/particles.py``).

    raw water (60 mg/L TSS) --> [0] rapid-mix coagulation basin
                                 |  coagulant dose shifts mass fine->coarse
                                 v  pipe, 1-step delay
                                [1] clarifier (large, gently stirred)
                                 |  coarse flocs settle to sludge
                                 v  pipe, 3-step delay
                                [2] filter/contact tank (recirculating
                                 |  granular-media filter polishes fines)
                                 v  finished water

The pipes carry the per-class composition (``BoundaryConditions.
inlet_tss_classes``): the clarifier's effluent is whatever escaped settling,
and the filter stage sees that real split. A final sweep finds the
coagulant dose meeting a finished-water turbidity target: every candidate
dose is a realization of the network, the dose a ``[doses, 1]`` boundary
leaf, and the sweep one batched rollout. Plain PyTorch: no hand-written
kernel lies on this path.

Usage:
  python examples_torch/clarifier_train.py [--hours 8] [--doses 12]
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
from ics_wt_physicsengine_torch.core import particles as P  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from examples_torch.treatment_train import realizations  # noqa: E402

DT, SUBSTEPS = 10.0, 8
TARGET = 1.0                      # finished-water turbidity [NTU]
STAGES = ["coag basin", "clarifier", "filter stage"]


def stage_config(volume: float, rpm: float) -> R.ReactorConfiguration:
    height = volume / 1000.0 / (math.pi * (0.798 / 2) ** 2)
    return R.ReactorConfiguration(
        n_zones=5, volume=volume, height=height, impeller_speed=rpm,
        enable_particles=True, initial_tss=2.0, initial_chlorine=0.0)


def make_train(dtype, device):
    """The three stages in series and their pipe delays: ``(params,
    initial network state, topology arrays)``."""
    #            from:  0     1     2
    W = np.array([[0.0, 0.0, 0.0],      # to 0 (head of train)
                  [1.0, 0.0, 0.0],      # to 1
                  [0.0, 1.0, 0.0]])     # to 2
    D = np.array([[1, 1, 1],
                  [1, 1, 1],
                  [1, 3, 1]])
    topo = N.NetworkTopology(routing=W, delay_steps=D)
    configs = [stage_config(600.0, 120.0),   # rapid mix: small, hard stirred
               stage_config(2500.0, 8.0),    # clarifier: big, quiescent
               stage_config(1000.0, 45.0)]   # filter/contact stage
    params, ns0 = N.make_network(configs, topo, dtype=dtype, device=device)
    return params, ns0, N.topology_arrays(topo, dtype, device)


def boundary(dose, device) -> R.BoundaryConditions:
    """The train's forcing with the basin's coagulant dose [mg/L]: a
    number, or a ``[doses, 1]`` tensor for one realization a dose."""
    def per_stage(*v):
        return torch.tensor(v, device=device)
    return R.BoundaryConditions(
        inlet_flow_rate=per_stage(8.0, 0.0, 0.0),
        inlet_pH=7.6, inlet_temperature=18.0,
        inlet_tss=per_stage(60.0, 0.0, 0.0),
        coagulant_dose=dose * per_stage(1.0, 0.0, 0.0),
        filter_flow_rate=per_stage(0.0, 0.0, 10.0),
        sludge_blowdown=per_stage(0.0, 2e-5, 0.0))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hours", type=float, default=8.0)
    ap.add_argument("--doses", type=int, default=12)
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

    def roll(ns, bc):
        with torch.no_grad():
            return N.rollout_network(params, ta, ns, bc, DT, SUBSTEPS,
                                     n_steps, record=False)[0]

    for dose, label in [(0.0, "no coagulant"), (25.0, "25 mg/L coagulant")]:
        fs = roll(ns0, boundary(dose, device))
        tss = fs.reactor.tss.cpu().numpy()                    # [3, C, Z]
        ntu = P.turbidity_ntu(fs.reactor.tss,
                              params.particles).cpu().numpy()
        say()
        say(f"after {args.hours:.1f} h, {label}:")
        for i, name in enumerate(STAGES):
            split = tss[i, :, -1] / max(tss[i, :, -1].sum(), 1e-12)
            say(f"  stage {i} ({name:12s}) outlet: "
                f"{tss[i, :, -1].sum():6.2f} mg/L TSS, "
                f"{ntu[i, -1]:6.2f} NTU, "
                f"class split {np.round(split, 2)}")
        sl = fs.reactor.sludge.cpu().numpy().sum(axis=-1)
        say(f"  sludge inventories [mg/L-of-bottom-zone]: "
            f"{np.round(sl, 1)}")

    # --- coagulant dose sweep: one batched rollout over the dose axis ---
    doses = torch.linspace(0.0, 40.0, args.doses, device=device)
    fs_all = roll(realizations(ns0, args.doses),
                  boundary(doses[:, None], device))
    ntu_fin = P.turbidity_ntu(fs_all.reactor.tss,
                              params.particles)[:, 2, -1].cpu().numpy()
    ok = np.nonzero(ntu_fin < TARGET)[0]
    say()
    say(f"coagulant sweep ({args.doses} doses, one batched call):")
    say(f"  finished-water turbidity range: "
        f"{ntu_fin.min():.2f} .. {ntu_fin.max():.2f} NTU")
    if ok.size:
        say(f"  lowest dose under {TARGET:.1f} NTU: "
            f"{float(doses[ok[0]]):.1f} mg/L -> {ntu_fin[ok[0]]:.2f} NTU")
    else:
        best = int(np.argmin(ntu_fin))
        say(f"  no dose met {TARGET:.1f} NTU; best "
            f"{float(doses[best]):.1f} mg/L -> {ntu_fin[best]:.2f} NTU")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
