"""
Chlorine-ammonia dose curve with the PyTorch port (the port of
``examples/chloramine_curve.py``): free vs combined residual over a batched
dose sweep, the nitrogen chemistry (``core/nitrogen.py``) on the native
batch axis.

Given source-water ammonia, what free residual does each chlorine dose
leave after contact time? Below the ~5.06:1 Cl2:N stoichiometric ratio the
dose converts to combined chlorine (monochloramine) and free residual stays
~0; above it, free chlorine appears. One batched rollout evaluates every
dose at once (the doses are lanes of the ensemble). Plain PyTorch: the
fused kernels refuse the nitrogen axis.

Usage:
  python examples_torch/chloramine_curve.py [--doses 64] [--ammonia 1.0]
      [--contact-min 30] [--device {cuda,cpu}]

The card is the default; ``--device cpu`` runs on the CPU. Prints one JSON
document.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ics_wt_physicsengine_torch.core import nitrogen as N  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.utils.dispatch import (  # noqa: E402
    map_tensors)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--doses", type=int, default=64)
    ap.add_argument("--ammonia", type=float, default=1.0,
                    help="source-water total ammonia nitrogen [mg N/L]")
    ap.add_argument("--max-dose", type=float, default=10.0)
    ap.add_argument("--contact-min", type=float, default=30.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; no fallback) or cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)

    config = R.ReactorConfiguration(
        n_zones=4, enable_nitrogen=True, flow_rate=0.0,
        initial_ammonia=args.ammonia, initial_chlorine=0.0)
    params = R.make_params(config, dtype=torch.float32, device=device)
    state = R.make_initial_state(config, dtype=torch.float32, device=device)

    doses = torch.linspace(0.0, args.max_dose, args.doses,
                           dtype=torch.float32, device=device)
    batched = map_tensors(
        lambda x: x.expand((args.doses,) + tuple(x.shape)), state)
    # each lane starts with its own chlorine dose
    batched = dataclasses.replace(
        batched, chlorine=doses[:, None].expand(args.doses, config.n_zones))

    n_steps = int(args.contact_min * 60)
    bc = R.BoundaryConditions(inlet_flow_rate=0.0)
    with torch.no_grad():
        final, _ = R.rollout(params, batched, bc, dt=1.0,
                             substeps=R.default_substeps(config, 1.0),
                             n_steps=n_steps, record=False)

    free = final.chlorine[:, 0].cpu().numpy()
    combined = final.chloramine[:, 0].cpu().numpy()
    tan = final.ammonia[:, 0].cpu().numpy()
    d_np = doses.cpu().numpy()
    ratio = d_np / max(args.ammonia, 1e-9)
    # the stoichiometric knee: last dose whose free residual is still ~0
    knee = float(ratio[free < 0.05][-1]) if (free < 0.05).any() else 0.0
    step = max(1, args.doses // 16)
    report = {
        "ammonia_mgN_L": args.ammonia,
        "contact_min": args.contact_min,
        "stoich_ratio_Cl2_N": round(N.MW_CL2 / N.MW_N, 3),
        "observed_knee_ratio": round(knee, 2),
        "curve": [{"dose": round(float(d), 3),
                   "free": round(float(f), 4),
                   "combined": round(float(c), 4),
                   "ammonia_left": round(float(a), 4)}
                  for d, f, c, a in zip(d_np[::step], free[::step],
                                        combined[::step], tan[::step])],
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
