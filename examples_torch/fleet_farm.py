"""
Controller regression farm over a plant fleet, against the PyTorch port's
simulator (the port of ``examples/fleet_farm.py``).

One simulator process serves N independently controlled plants from a
single Modbus/TCP endpoint (``--fleet N``: unit id u = lane u-1 of the
batched ensemble on the card, ``ics_wt_physicsengine_torch/fleet.py``). This
script plays the SCADA side: one PI chlorine-residual controller **per
unit**, each with a different setpoint, all talking to the same endpoint.
At the end it reports each unit's measured residual against its own
setpoint.

Usage:
  # self-contained: spawns the fleet simulator in-process, free-running,
  # on the card (--device cpu runs it on the CPU)
  python examples_torch/fleet_farm.py --units 6 --iterations 150

  # against an already-running fleet simulator
  python -m ics_wt_physicsengine_torch --fleet 6 --port 5020 &
  python examples_torch/fleet_farm.py --host 127.0.0.1 --port 5020 --units 6
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.modbus import ModbusTcpClient  # noqa: E402
from examples_torch.pid_controller import (  # noqa: E402
    PID, free_port, shutdown_sim, spawn_sim, wait_for_port)


def farm(host, port, n_units, iterations, period=0.2, verbose=True):
    """One PI residual controller per unit, round-robin over one endpoint.

    The controller dt is the *simulated* time elapsed since each unit's
    previous iteration (read from its simulation_time register): under
    ``--rtf 0`` the fleet free-runs, so the wall-clock period bears no
    relation to simulated elapsed time."""
    setpoints = [0.5 + 0.25 * u for u in range(n_units)]     # mg/L, distinct
    pids = [PID(kp=0.4, ki=0.004, kd=0.0, setpoint=sp,
                out_min=0.0, out_max=1.0) for sp in setpoints]
    clients = [ModbusTcpClient(host, port, unit_id=u + 1,
                               timeout=10).connect()
               for u in range(n_units)]
    last_t = [None] * n_units
    live = [False] * n_units     # first nonzero reading = sensor is live
    try:
        for i in range(iterations):
            for u, (c, pid) in enumerate(zip(clients, pids)):
                t_sim = c.read_float32(100)           # this unit's sim clock
                cl_out = c.read_float32(8)            # chlorine_outlet
                dt_sim = (t_sim - last_t[u]) if last_t[u] is not None else 0.0
                last_t[u] = t_sim
                # A register of exactly 0.0 before any nonzero reading is
                # the warm-up/NaN placeholder; once the sensor has reported
                # a real value, 0.0 is a legitimate measurement.
                live[u] = live[u] or cl_out > 0.0
                if live[u] and dt_sim > 0.0:
                    c.write_float32(2, pid.update(cl_out, dt_sim))
            if verbose and i % 25 == 0:
                print(f"[farm] iter {i:4d} t={last_t[0]:7.0f}s", flush=True)
            time.sleep(period)

        results = []
        for u, (c, sp) in enumerate(zip(clients, setpoints)):
            measured = c.read_float32(8)
            results.append({"unit": u + 1, "setpoint_mg_L": round(sp, 3),
                            "measured_mg_L": round(measured, 3),
                            "error_mg_L": round(measured - sp, 3)})
        return results
    finally:
        for c in clients:
            c.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5020)
    ap.add_argument("--units", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=150)
    ap.add_argument("--spawn", action="store_true",
                    help="run the fleet simulator in-process (implied when "
                         "no server is reachable)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the spawned simulator's device (default the "
                         "card; no fallback)")
    args = ap.parse_args(argv)

    spawn = args.spawn
    if not spawn:
        try:
            socket.create_connection((args.host, args.port),
                                     timeout=1).close()
        except OSError:
            spawn = True

    sim_thread = None
    if spawn:
        cli_device(args.device)
        args.port = free_port(args.host)
        sim_thread = spawn_sim(
            ["--port", str(args.port), "--host", args.host,
             "--dt", "15", "--duration", "1000000", "--rtf", "0",
             "--fleet", str(args.units), "--zones", "5",
             "--seed", "4", "--recal-hours", "2"], args.device)
        if not wait_for_port(args.host, args.port, sim_thread):
            raise SystemExit("the fleet simulator did not start")

    try:
        results = farm(args.host, args.port, args.units, args.iterations)
        print(json.dumps({"fleet_units": args.units,
                          "per_unit_residual_control": results}, indent=2),
              flush=True)
    finally:
        if sim_thread is not None:
            shutdown_sim(sim_thread)


if __name__ == "__main__":
    main()
