"""
Shooting MPC against a tuned PID on a chlorine dosing program with the
PyTorch port (the port of ``examples/mpc_dosing.py``).

The reference's roadmap sequence is PID then "advanced control methods"
(reference README.md:432-439). This demo commissions a dosing program
(hold 2.0 mg/L residual, then step down to 1.0, the
examples_torch/dosing_program_hil.py shape) two ways:

  1. a PID tuned by a batched closed-loop gain sweep (``control.tuning``),
     then run against the program through a per-step gain schedule,
  2. receding-horizon shooting MPC (``control.mpc``): each re-plan is a few
     Adam steps on the move sequence, differentiated through the plant by
     autograd,

and reports both tracking scores. MPC wins because it sees the setpoint
step coming (the program is known ahead) while the PID can only react.
``--output-feedback`` adds the deployment shape: MPC planning from the EKF
estimate of the instrumented plant (``control.run_mpc_output_feedback``),
its instruments drawing from a generator seeded 11.

The MPC settings (6 moves of 10 steps, 20 Adam iterations a re-plan) are
fixed, as in the JAX example. Plain PyTorch: no hand-written kernel lies on
this path.

Usage:
  python examples_torch/mpc_dosing.py [--minutes 120] [--zones 20]
      [--output-feedback] [--device {cuda,cpu}]

The card is the default; ``--device cpu`` runs on the CPU. Prints one JSON
line.
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
from ics_wt_physicsengine_torch.utils.dispatch import map_tensors  # noqa: E402

DT = 60.0
# horizon_moves, steps_per_move, Adam iterations a re-plan
MPC = (6, 10, 20)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, mpc=None) -> dict:
    """The PID and MPC runs and their report (returned). ``mpc`` replaces
    the fixed ``MPC`` settings; the printed report does not change."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=int, default=120,
                    help="program length (one step change at half time)")
    ap.add_argument("--zones", type=int, default=20)
    ap.add_argument("--output-feedback", action="store_true",
                    help="also run the LQG-style loop: MPC planning from "
                         "the EKF estimate over the real instrument suite "
                         "(control/mpc.py run_mpc_output_feedback)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; no fallback) or cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    horizon_moves, steps_per_move, iters = MPC if mpc is None else mpc
    f32 = torch.float32

    n_steps = args.minutes
    half = n_steps // 2
    config = R.ReactorConfiguration(n_zones=args.zones,
                                    initial_chlorine=0.5, flow_rate=20.0)
    bc = R.BoundaryConditions(inlet_flow_rate=20.0)
    program = torch.cat([torch.full((half,), 2.0, dtype=f32, device=device),
                         torch.full((n_steps - half,), 1.0, dtype=f32,
                                    device=device)])

    # --- PID: sweep-tuned on the first program level, then run against
    #     the program through a setpoint schedule
    _sync(device)
    t0 = time.time()
    grid = C.make_gain_grid(kp_cl=np.linspace(0.2, 2.5, 8, dtype=np.float32),
                            ki_cl=np.linspace(0.0, 0.2, 8, dtype=np.float32),
                            kp_ph=[-0.8], ki_ph=[-0.05], cl_setpoint=2.0,
                            ph_setpoint=7.2, dtype=f32, device=device)
    best = C.gain_sweep(config, grid, dt=DT, n_steps=half, boundary=bc,
                        dtype=f32, device=device)["best"]
    sched = map_tensors(lambda x: x.expand((n_steps,) + tuple(x.shape)),
                        best)
    sched = C.DualPIDGains(
        chlorine=dataclasses.replace(sched.chlorine, setpoint=program),
        ph=sched.ph)
    params = R.make_params(config, dtype=f32, device=device)
    state = R.make_initial_state(config, dtype=f32, device=device)
    substeps = R.default_substeps(config, DT)
    with torch.no_grad():
        _, _, _, traj = C.rollout_closed_loop(
            params, state, bc, C.dual_pid_controller, best,
            C.make_dual_pid_carry((), f32, device), dt=DT,
            substeps=substeps, n_steps=n_steps, gains_schedule=sched,
            record_obs=("chlorine_outlet",))
    pid_score = float(torch.sum((traj["chlorine_outlet"] - program) ** 2)
                      * DT)
    _sync(device)
    t_pid = time.time() - t0

    # --- shooting MPC on the same program
    t0 = time.time()
    res = C.run_mpc(config, program, dt=DT, horizon_moves=horizon_moves,
                    steps_per_move=steps_per_move, iters=iters, boundary=bc,
                    dtype=f32, device=device)
    _sync(device)
    t_mpc = time.time() - t0

    out = {
        "program": {"levels": [2.0, 1.0], "minutes": n_steps},
        "pid": {"score_ISE": round(pid_score, 2),
                "kp": round(float(best.chlorine.kp), 3),
                "ki": round(float(best.chlorine.ki), 4),
                "seconds": round(t_pid, 2)},
        "mpc": {"score_ISE": round(res["score"], 2),
                "seconds": round(t_mpc, 2)},
        "mpc_beats_pid": bool(res["score"] < pid_score),
    }

    if args.output_feedback:
        # --- the deployment shape: MPC shoots from the EKF estimate, which
        #     assimilates the real instrument suite (no true state anywhere
        #     in the control path)
        t0 = time.time()
        of = C.run_mpc_output_feedback(
            config, program, dt=DT,
            taps=[("pH", 0), ("chlorine", -1), ("temperature", -1)],
            measured=["pH_inlet", "chlorine_outlet", "temp_outlet"],
            horizon_moves=horizon_moves, steps_per_move=steps_per_move,
            iters=iters, boundary=bc,
            measurement_noise=(4e-4, 2.5e-3, 1e-2), seed=11, dtype=f32,
            device=device)
        _sync(device)
        out["mpc_output_feedback"] = {
            "score_ISE_vs_truth": round(of["score"], 2),
            "final_measured_Cl": round(
                float(of["measured"]["chlorine_outlet"][-1]), 3),
            "seconds": round(time.time() - t0, 2),
        }

    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
