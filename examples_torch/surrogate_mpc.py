"""
Learn a plant surrogate from the physics engine, then control the exact
plant with MPC that plans through the learned model, with the PyTorch port
(the port of ``examples/surrogate_mpc.py``).

The workflow a production deployment runs:

  1. roll randomized physics trajectories (the "historian data");
  2. fit the residual-MLP surrogate (``models/surrogate.py``): dataset
     generation, Adam training and multi-step fine-tuning;
  3. validate it: held-out one-step skill against the identity predictor,
     and open-loop drift over a 24-minute horizon;
  4. commission a dosing program with receding-horizon MPC whose re-plans
     shoot through the surrogate while the exact physics applies the
     moves, and score it against physics-shooting MPC on the same program.

The surrogate plans at matmul cost, which is what makes scenario screening
and long-horizon planning cheap; re-planning from the true state each cycle
keeps model error from accumulating beyond one horizon.

The fit's draws come from a ``torch.Generator`` seeded 0, the held-out
set's from one seeded 123 (the JAX example's ``PRNGKey(0)`` and
``PRNGKey(123)``). Both MPC runs use the fixed settings of the JAX example
(4 moves of 15 steps, 20 Adam iterations a re-plan). Plain PyTorch: no
hand-written kernel lies on this path.

Usage:
  python examples_torch/surrogate_mpc.py [--minutes 90] [--zones 6]
      [--traj 512] [--train-steps 6000] [--rollout-steps 600]
      [--device {cuda,cpu}]

The card is the default; ``--device cpu`` runs on the CPU. Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ics_wt_physicsengine_torch.control.mpc import run_mpc  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.models import surrogate as SG  # noqa: E402

DT = 30.0
# horizon_moves, steps_per_move, Adam iterations a re-plan (both MPC runs)
MPC = (4, 15, 20)
# the held-out set: generator seed, trajectories, steps
HELD_OUT = (123, 32, 48)
FIELDS = ("pH", "chlorine", "temperature")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=int, default=90,
                    help="program length (one step change at half time)")
    ap.add_argument("--zones", type=int, default=6)
    ap.add_argument("--traj", type=int, default=512,
                    help="training trajectories")
    ap.add_argument("--train-steps", type=int, default=6000)
    ap.add_argument("--rollout-steps", type=int, default=600)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; no fallback) or cpu")
    return ap.parse_args(argv)


def make_config(zones: int) -> R.ReactorConfiguration:
    return R.ReactorConfiguration(
        volume=1000.0, n_zones=zones, flow_rate=5.0, initial_pH=7.2,
        initial_chlorine=2.0, temperature=20.0)


def held_out_set(config, device):
    """The validation trajectories ``(Xv, Uv)``: fresh physics rollouts
    from a generator seeded ``HELD_OUT[0]``."""
    seed, n_traj, n_steps = HELD_OUT
    params = R.make_params(config, dtype=torch.float32, device=device)
    return SG.make_surrogate_dataset(
        params, config.n_zones, R.BoundaryConditions(), seed, n_traj,
        n_steps, DT, R.default_substeps(config, DT))


def validate(sp, Xv, Uv, n_zones: int):
    """Held-out one-step skill against the identity predictor (error std
    over residual std, per field; population std as NumPy's) and the
    open-loop chlorine drift of a surrogate rollout over each trajectory."""
    Z = n_zones
    with torch.no_grad():
        pred = SG.surrogate_step(sp, Xv[:, :-1], Uv)
        # the rollout is time-major: [n_steps, trajectories, ...]
        roll = SG.surrogate_rollout(sp, Xv[:, 0], Uv.transpose(0, 1))
    err = (pred - Xv[:, 1:]).cpu().numpy()
    res = (Xv[:, 1:] - Xv[:, :-1]).cpu().numpy()
    skill = {f: round(float(err[..., i * Z:(i + 1) * Z].std()
                            / res[..., i * Z:(i + 1) * Z].std()), 3)
             for i, f in enumerate(FIELDS)}
    drift = roll.transpose(0, 1).cpu().numpy() - Xv[:, 1:].cpu().numpy()
    return skill, float(drift[..., Z:2 * Z].std())


def step_program(minutes: int) -> np.ndarray:
    """1.5 mg/L, then 2.5 from half time, in whole 15-step moves
    (dt = 30 s)."""
    n_steps = minutes * 2
    n_steps -= n_steps % 15
    half = (n_steps // 2) - ((n_steps // 2) % 15)
    return np.concatenate([np.full(half, 1.5), np.full(n_steps - half, 2.5)
                           ]).astype(np.float32)


def compare_mpc(config, sp, program, device, mpc=None):
    """Surrogate-planned MPC and physics-shooting MPC on the same program.
    Returns both results and their seconds."""
    horizon_moves, steps_per_move, iters = MPC if mpc is None else mpc
    _sync(device)
    t0 = time.time()
    sur = SG.run_mpc_surrogate(config, sp, program, dt=DT,
                               horizon_moves=horizon_moves,
                               steps_per_move=steps_per_move, iters=iters,
                               device=device)
    _sync(device)
    t_sur = time.time() - t0
    t0 = time.time()
    phys = run_mpc(config, program, dt=DT, horizon_moves=horizon_moves,
                   steps_per_move=steps_per_move, iters=iters,
                   device=device)
    _sync(device)
    return sur, phys, t_sur, time.time() - t0


def main(argv=None, mpc=None) -> dict:
    """The fit, its validation and the two MPC runs; the report is printed
    and returned. ``mpc`` replaces the fixed ``MPC`` settings; the printed
    report does not change."""
    args = parse_args(argv)
    device = cli_device(args.device)
    config = make_config(args.zones)

    # 1-2. dataset + training (one call; loss curves in info)
    _sync(device)
    t0 = time.time()
    sp, info = SG.fit_plant_surrogate(config, dt=DT, n_traj=args.traj,
                                      train_steps=args.train_steps,
                                      rollout_steps=args.rollout_steps,
                                      seed=0, device=device)
    _sync(device)
    t_fit = time.time() - t0

    # 3. validation: held-out skill + open-loop drift
    Xv, Uv = held_out_set(config, device)
    skill, drift_cl = validate(sp, Xv, Uv, args.zones)

    # 4. surrogate-planned MPC vs physics-shooting MPC, same program
    sur, phys, t_sur, t_phys = compare_mpc(
        config, sp, step_program(args.minutes), device, mpc)

    out = {
        "fit": {"seconds": round(t_fit, 1),
                "val_rmse": {k: round(float(v), 5)
                             for k, v in info["val_rmse"].items()}},
        "one_step_skill_vs_identity": skill,
        "open_loop_drift_chlorine_mgL": round(drift_cl, 5),
        "surrogate_mpc": {"score_ISE": round(sur["score"], 2),
                          "seconds": round(t_sur, 2)},
        "physics_mpc": {"score_ISE": round(phys["score"], 2),
                        "seconds": round(t_phys, 2)},
        "surrogate_within_10pct": bool(
            sur["score"] < phys["score"] * 1.10),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
