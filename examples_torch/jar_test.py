"""
Jar test with the PyTorch port (the port of ``examples/jar_test.py``):
settled turbidity vs coagulant dose over a batched dose sweep, the particle
dynamics (``core/particles.py``) on the native batch axis.

Dose a row of jars with increasing coagulant, stir, settle, and read the
supernatant turbidity. Every jar is a lane of one batched rollout:
coagulation shifts mass from the slow-settling fine class into
fast-settling flocs, so turbidity falls with dose until the dose response
saturates (Monod in dose). The sweep also reports the cheapest dose
reaching a target NTU. Plain PyTorch: the fused kernels refuse the
particle axis.

Usage:
  python examples_torch/jar_test.py [--doses 32] [--tss 50]
      [--settle-min 60] [--target-ntu 5] [--device {cuda,cpu}]

The card is the default; ``--device cpu`` runs on the CPU. Prints one JSON
document.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ics_wt_physicsengine_torch.core import particles as P  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.utils.dispatch import (  # noqa: E402
    map_tensors)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--doses", type=int, default=32)
    ap.add_argument("--max-dose", type=float, default=80.0)
    ap.add_argument("--tss", type=float, default=50.0,
                    help="raw-water total suspended solids [mg/L]")
    ap.add_argument("--settle-min", type=float, default=60.0,
                    help="stir+settle contact time [min]")
    ap.add_argument("--target-ntu", type=float, default=5.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; no fallback) or cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)

    config = R.ReactorConfiguration(
        n_zones=4, enable_particles=True, flow_rate=0.0,
        initial_tss=args.tss, initial_chlorine=0.0,
        impeller_speed=10.0)   # gentle flocculation stirring
    params = R.make_params(config, dtype=torch.float32, device=device)
    state = R.make_initial_state(config, dtype=torch.float32, device=device)

    doses = torch.linspace(0.0, args.max_dose, args.doses,
                           dtype=torch.float32, device=device)
    batched = map_tensors(
        lambda x: x.expand((args.doses,) + tuple(x.shape)), state)

    # each jar gets its own dose: the dose is a [doses]-lane boundary leaf
    bc = R.BoundaryConditions(inlet_flow_rate=0.0, coagulant_dose=doses)

    n_steps = int(args.settle_min * 60)
    with torch.no_grad():
        final, _ = R.rollout(params, batched, bc, dt=1.0,
                             substeps=R.default_substeps(config, 1.0),
                             n_steps=n_steps, record=False)

    # supernatant = top zone (the clarified water a jar test samples)
    ntu = P.turbidity_ntu(final.tss, params.particles)[:, -1].cpu().numpy()
    tss_top = P.total_solids_mgl(final.tss)[:, -1].cpu().numpy()
    settled = torch.sum(final.sludge, dim=-1).cpu().numpy()

    d_np = doses.cpu().numpy()
    hit = d_np[ntu <= args.target_ntu]
    optimal = float(hit[0]) if hit.size else None

    step = max(1, args.doses // 16)
    report = {
        "raw_tss_mgL": args.tss,
        "settle_min": args.settle_min,
        "target_ntu": args.target_ntu,
        "optimal_dose_mgL": optimal,
        "curve": [{"dose": round(float(d), 2),
                   "supernatant_ntu": round(float(n), 3),
                   "supernatant_tss": round(float(t), 3),
                   "settled_mgL": round(float(s), 3)}
                  for d, n, t, s in zip(d_np[::step], ntu[::step],
                                        tss_top[::step], settled[::step])],
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
