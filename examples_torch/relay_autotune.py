"""
Relay (Astrom-Hagglund) autotuning of the chlorine loop over Modbus,
against the PyTorch port's simulator (the port of
``examples/relay_autotune.py``).

Control stays external by design ("this is the plant, not the
controller"), so the utility lives here as a SCADA-side script: it excites
the plant with relay feedback on the chlorine dosing pump, measures the
induced limit cycle (ultimate period Tu and amplitude), derives the
ultimate gain Ku = 4d / (pi * a), converts to Ziegler-Nichols PI gains,
then closes the loop with the tuned controller and reports tracking.

Everything happens over the real Modbus/TCP interface against the
free-running simulator: the same experiment an engineer would run against
the physical plant.

Usage:
  python examples_torch/relay_autotune.py            # self-spawning, card
  python examples_torch/relay_autotune.py --device cpu
  python examples_torch/relay_autotune.py --host H --port P
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.modbus import ModbusTcpClient  # noqa: E402
from examples_torch.pid_controller import (  # noqa: E402
    PID, free_port, shutdown_sim, spawn_sim, wait_for_port)

CL_OUT_REG = 8          # chlorine_outlet input register
SIM_TIME_REG = 100      # simulation_time input register
CL_CMD_REG = 2          # chlorine_flow_rate holding register


def relay_experiment(client, setpoint, lo, hi, n_switches, poll_s=0.05,
                     timeout_s=240.0, verbose=True):
    """Drive the dosing pump as a relay around ``setpoint``; return the
    limit cycle's switch times [sim s] and the output amplitude."""
    switches = []            # sim_time at each relay flip
    values = []
    state_hi = True
    client.write_float32(CL_CMD_REG, hi)
    deadline = time.time() + timeout_s
    while len(switches) < n_switches and time.time() < deadline:
        t_sim = client.read_float32(SIM_TIME_REG)
        cl = client.read_float32(CL_OUT_REG)
        if cl > 0.0:          # past warm-up placeholder
            values.append(cl)
            if state_hi and cl > setpoint:
                state_hi = False
                client.write_float32(CL_CMD_REG, lo)
                switches.append(t_sim)
                if verbose:
                    print(f"[relay] switch LO at t={t_sim:8.0f}s "
                          f"cl={cl:.3f}", flush=True)
            elif not state_hi and cl < setpoint:
                state_hi = True
                client.write_float32(CL_CMD_REG, hi)
                switches.append(t_sim)
                if verbose:
                    print(f"[relay] switch HI at t={t_sim:8.0f}s "
                          f"cl={cl:.3f}", flush=True)
        time.sleep(poll_s)
    if len(switches) < n_switches:
        raise RuntimeError(f"relay produced only {len(switches)} switches "
                           f"within {timeout_s}s wall")
    return switches, values


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--setpoint", type=float, default=1.0,
                    help="chlorine residual setpoint [mg/L]")
    ap.add_argument("--switches", type=int, default=8,
                    help="relay switches to record (>= 6 for a stable Tu)")
    ap.add_argument("--verify-iterations", type=int, default=150,
                    help="closed-loop iterations with the tuned PI")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the spawned simulator's device (default the "
                         "card; no fallback)")
    args = ap.parse_args(argv)

    spawn = args.port is None
    sim_thread = None
    if spawn:
        cli_device(args.device)
        args.port = free_port(args.host)
        sim_thread = spawn_sim(
            ["--port", str(args.port), "--host", args.host,
             "--dt", "30", "--duration", "10000000", "--rtf", "0",
             "--seed", "2", "--zones", "5", "--recal-hours", "2"],
            args.device)

    try:
        if not wait_for_port(args.host, args.port, sim_thread):
            raise SystemExit("simulator unreachable")
        client = ModbusTcpClient(args.host, args.port, timeout=10).connect()

        # wait for the chlorine sensor to report
        while client.read_float32(CL_OUT_REG) <= 0.0:
            time.sleep(0.2)

        # --- relay experiment -> Tu, Ku ------------------------------------
        lo, hi = 0.0, 0.5                   # [L/min] dosing relay levels
        switches, values = relay_experiment(
            client, args.setpoint, lo, hi, args.switches)
        # steady cycle: use the last switches; one full period = 2 switches
        periods = np.diff(switches)[-(args.switches - 2):]
        tu = 2.0 * float(np.mean(periods))
        tail = np.array(values[len(values) // 2:])
        a = float((tail.max() - tail.min()) / 2.0)
        d = (hi - lo) / 2.0
        ku = 4.0 * d / (np.pi * a)
        # Ziegler-Nichols PI
        kp = 0.45 * ku
        ti = tu / 1.2
        ki = kp / ti

        # --- verify: close the loop with the tuned PI ----------------------
        pid = PID(kp=kp, ki=ki, kd=0.0, setpoint=args.setpoint,
                  out_min=lo, out_max=2 * hi)
        errors = []
        t_last = client.read_float32(SIM_TIME_REG)
        for _ in range(args.verify_iterations):
            t_sim = client.read_float32(SIM_TIME_REG)
            cl = client.read_float32(CL_OUT_REG)
            dt_sim = t_sim - t_last
            t_last = t_sim
            if cl > 0.0 and dt_sim > 0.0:
                client.write_float32(CL_CMD_REG, pid.update(cl, dt_sim))
                errors.append(cl - args.setpoint)
            time.sleep(0.05)
        settled = np.array(errors[len(errors) // 2:])

        print(json.dumps({
            "relay": {"lo_L_min": lo, "hi_L_min": hi,
                      "switches": len(switches)},
            "ultimate_period_Tu_s": round(tu, 1),
            "oscillation_amplitude_mg_L": round(a, 4),
            "ultimate_gain_Ku": round(ku, 4),
            "ziegler_nichols_PI": {"kp": round(kp, 4),
                                   "ki_per_s": round(ki, 6)},
            "closed_loop_settled_rms_error_mg_L": round(
                float(np.sqrt(np.mean(settled ** 2))), 4)
            if len(settled) else None,
        }, indent=2), flush=True)
        client.close()
    finally:
        if sim_thread is not None:
            shutdown_sim(sim_thread)


if __name__ == "__main__":
    main()
