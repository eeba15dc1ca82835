"""
Event-driven SCADA controller over OPC UA subscriptions, against the
PyTorch port's simulator (the port of ``examples/opcua_scada.py``).

The OPC UA twin of ``pid_controller.py``: instead of polling Modbus
registers every period, this client subscribes to the plant's measured
values (MonitoredItems + Publish, the push path real SCADA packages use)
and runs its PI loops *on data changes*. Dosing commands are written back
over the same OPC UA session; they land in the identical validated holding
registers the Modbus path serves (``opcua/server.py`` bridges both planes
onto one store).

Two loops, same structure as the Modbus demo:
  - chlorine residual control: chlorine_outlet -> chlorine_flow_rate
  - pH control:               pH_inlet        -> acid_flow_rate

Usage:
  # against an already-running simulator
  python -m ics_wt_physicsengine_torch --opcua 4840 &
  python examples_torch/opcua_scada.py --host 127.0.0.1 --port 4840

  # self-contained demo (spawns the simulator in-process, on the card;
  # --device cpu runs it on the CPU)
  python examples_torch/opcua_scada.py --spawn --publishes 40
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.opcua import OPCUAClient  # noqa: E402
from examples_torch.pid_controller import (  # noqa: E402
    PID, START_TIMEOUT_S, free_port, shutdown_sim, spawn_sim)

H_SIM_TIME, H_CL_OUT, H_PH_IN, H_FLOW = 0, 1, 2, 3
MONITORED = {
    H_SIM_TIME: "u1.simulation_time",
    H_CL_OUT: "u1.chlorine_outlet",
    H_PH_IN: "u1.pH_inlet",
    H_FLOW: "u1.flow_rate",
}


def scada_loop(host, port, publishes, interval, cl_setpoint, ph_setpoint,
               verbose=True):
    """Subscribe to the four measured values and drive both PI loops
    from the pushed data changes; returns the (t, Cl, pH) history."""
    cl_pid = PID(kp=0.4, ki=0.02, kd=0.0, setpoint=cl_setpoint,
                 out_min=0.0, out_max=1.0)
    ph_pid = PID(kp=-0.8, ki=-0.05, kd=0.0, setpoint=ph_setpoint,
                 out_min=0.0, out_max=2.0)
    latest = {h: 0.0 for h in MONITORED}
    history = []

    with OPCUAClient(host, port, timeout=30.0) as c:
        sub_id, rev_interval = c.create_subscription(
            publishing_interval=interval, max_keepalive_count=10)
        # Absolute deadband: sensor-noise-scale jitter (< 0.005 units)
        # is suppressed at the server's sampler, so pushes carry only
        # operationally meaningful changes.
        results = c.create_monitored_items(
            sub_id, list(MONITORED.values()),
            client_handles=list(MONITORED.keys()), deadband=0.005)
        bad = [r.status for r in results if r.status != 0]
        if bad:
            raise RuntimeError(f"monitored-item failures: {bad}")
        if verbose:
            print(f"subscribed: id={sub_id} "
                  f"interval={rev_interval * 1e3:.0f} ms "
                  f"items={len(results)}", flush=True)

        acks = []
        changes_total = 0
        for i in range(publishes):
            rsp = c.publish(acks=acks, timeout=60.0)
            acks = [(sub_id, rsp.notification_message.sequence_number)]
            changes = OPCUAClient.data_changes(rsp)
            changes_total += len(changes)
            for handle, dv in changes:
                if dv.value is not None:
                    latest[handle] = float(dv.value.value)
            if not changes:
                continue            # keepalive: nothing new to act on

            # control on the freshest pushed measurements
            cl_out, ph_in = latest[H_CL_OUT], latest[H_PH_IN]
            if cl_out > 0.0:        # sensors publish 0.0 while warming up
                cl_cmd = cl_pid.update(cl_out, rev_interval)
                c.write_double("u1.chlorine_flow_rate", cl_cmd)
            else:
                cl_cmd = 0.0
            if ph_in > 0.0:
                acid_cmd = ph_pid.update(ph_in, rev_interval)
                c.write_double("u1.acid_flow_rate", acid_cmd)
            else:
                acid_cmd = 0.0
            history.append((latest[H_SIM_TIME], cl_out, ph_in))
            if verbose and i % 10 == 0:
                print(f"t={latest[H_SIM_TIME]:8.0f}s  "
                      f"Cl_out={cl_out:5.2f} mg/L (sp {cl_setpoint})  "
                      f"pH_in={ph_in:5.2f} (sp {ph_setpoint})  "
                      f"ClCmd={cl_cmd:.2f}  AcidCmd={acid_cmd:.2f}",
                      flush=True)
        c.delete_subscriptions([sub_id])
        if verbose:
            print(f"done: {publishes} publishes, "
                  f"{changes_total} pushed data changes", flush=True)
    return history


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=None,
                        help="OPC UA port (default 4840; --spawn picks a "
                             "free ephemeral port unless one is given)")
    parser.add_argument("--publishes", type=int, default=60,
                        help="number of Publish round-trips to run")
    parser.add_argument("--interval", type=float, default=0.25,
                        help="requested publishing interval [s]")
    parser.add_argument("--cl-setpoint", type=float, default=2.5)
    parser.add_argument("--ph-setpoint", type=float, default=7.0)
    parser.add_argument("--spawn", action="store_true",
                        help="spawn the simulator in-process (demo mode)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the spawned simulator's device (default the "
                             "card; no fallback)")
    args = parser.parse_args(argv)

    if args.port is None:
        args.port = free_port(args.host) if args.spawn else 4840

    sim_thread = None
    if args.spawn:
        cli_device(args.device)
        # rtf bounds simulated time per control action, as in
        # pid_controller.py --spawn
        sim_thread = spawn_sim(
            ["--port", str(free_port(args.host)), "--host", args.host,
             "--opcua", str(args.port), "--dt", "30", "--rtf", "300",
             "--seed", "1", "--recal-hours", "6"], args.device)
        deadline = time.monotonic() + START_TIMEOUT_S
        while True:
            try:
                OPCUAClient(args.host, args.port, timeout=5).connect() \
                    .close()
                break
            except OSError:
                if time.monotonic() > deadline or not sim_thread.is_alive():
                    raise SystemExit("simulator did not start")
                time.sleep(0.3)

    try:
        scada_loop(args.host, args.port, args.publishes, args.interval,
                   args.cl_setpoint, args.ph_setpoint)
    finally:
        if sim_thread is not None:
            shutdown_sim(sim_thread)


if __name__ == "__main__":
    main()
