"""
External PID controller over Modbus/TCP against the PyTorch port's
simulator (the port of ``examples/pid_controller.py``).

This script is the *controller* the plant deliberately does not contain: a
discrete PI(D) loop that reads measured values from the simulator's input
registers and writes actuator commands to its holding registers, exactly
like a PLC/SCADA master would.

Two loops:
  - chlorine residual control: chlorine_outlet -> chlorine_flow_rate
  - pH control:               pH_inlet        -> acid_flow_rate

Usage:
  # against an already-running simulator
  python -m ics_wt_physicsengine_torch --port 5020 &
  python examples_torch/pid_controller.py --host 127.0.0.1 --port 5020

  # self-contained demo: the simulator in a thread of this process, on the
  # card (--device cpu runs it on the CPU)
  python examples_torch/pid_controller.py --spawn --iterations 120

``PID``, ``free_port``, ``spawn_sim``, ``wait_for_port`` and
``shutdown_sim`` are shared by the other served examples of this directory.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.modbus import ModbusTcpClient  # noqa: E402

# seconds a spawned simulator may take to open its port (the card is
# probed in a subprocess first)
START_TIMEOUT_S = 120.0


def free_port(host: str = "127.0.0.1") -> int:
    """Bind-then-release an ephemeral port (a fixed default port collides
    with concurrent simulators)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def spawn_sim(argv, device: str) -> threading.Thread:
    """Start the port's orchestrator (``python -m
    ics_wt_physicsengine_torch``) with ``argv`` and ``--device`` in a
    daemon thread of this process."""
    import ics_wt_physicsengine_torch.__main__ as orch

    orch.running = True
    sim = threading.Thread(target=orch.main,
                           args=(list(argv) + ["--device", device],),
                           daemon=True)
    sim.start()
    return sim


def wait_for_port(host: str, port: int, sim=None,
                  timeout: float = START_TIMEOUT_S) -> bool:
    """True once ``host:port`` accepts a connection; False at the deadline
    or when the simulator thread ``sim`` has ended."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if sim is not None and not sim.is_alive():
            return False
        try:
            socket.create_connection((host, port), timeout=2).close()
            return True
        except OSError:
            time.sleep(0.3)
    return False


def shutdown_sim(sim_thread, timeout: float = 60.0) -> None:
    """Stop an in-process simulator thread and, if it will not die, end
    the interpreter without finalization.

    The daemon thread may be inside native code (a CUDA call, a kernel
    build) when the join times out; tearing it down during interpreter
    finalization can abort the process. The demo's own work is done and
    printed by the time this runs, so the safe exit is ``os._exit(0)``
    after flushing the standard streams."""
    import ics_wt_physicsengine_torch.__main__ as orch

    orch.running = False
    sim_thread.join(timeout=timeout)
    if sim_thread.is_alive():
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)


class PID:
    """Discrete PID with anti-windup clamping."""

    def __init__(self, kp, ki, kd, setpoint, out_min, out_max):
        self.kp, self.ki, self.kd = kp, ki, kd
        self.setpoint = setpoint
        self.out_min, self.out_max = out_min, out_max
        self.integral = 0.0
        self.prev_error = None

    def update(self, measurement, dt):
        error = self.setpoint - measurement
        self.integral += error * dt
        derivative = 0.0 if self.prev_error is None \
            else (error - self.prev_error) / dt
        self.prev_error = error
        out = self.kp * error + self.ki * self.integral + self.kd * derivative
        clamped = min(max(out, self.out_min), self.out_max)
        if clamped != out:                      # anti-windup
            self.integral -= error * dt
        return clamped


def control_loop(host, port, iterations, period, cl_setpoint, ph_setpoint,
                 verbose=True, feedforward=False,
                 chlorine_stock_mg_L=50.0):
    """PI(D) loops; ``feedforward=True`` adds mass-balance ratio
    compensation to the chlorine loop: the dosing needed to hold
    ``cl_setpoint`` at the measured throughput is
    Q_dose = setpoint * Q_in / C_stock, fed forward from the flow sensor so
    the PI only trims decay and measurement error."""
    cl_pid = PID(kp=0.4, ki=0.02, kd=0.0, setpoint=cl_setpoint,
                 out_min=0.0, out_max=1.0)
    if feedforward:
        # the PI handles the +/- trim around the feedforward term
        cl_pid.out_min, cl_pid.out_max = -0.5, 0.5
    ph_pid = PID(kp=-0.8, ki=-0.05, kd=0.0, setpoint=ph_setpoint,
                 out_min=0.0, out_max=2.0)

    with ModbusTcpClient(host, port, timeout=10) as client:
        history = []
        for i in range(iterations):
            sim_t = client.read_float32(100)
            cl_out = client.read_float32(8)       # chlorine_outlet
            ph_in = client.read_float32(0)        # pH_inlet

            # sensors read 0.0 while warming up: hold outputs at zero
            if cl_out > 0.0:
                cl_cmd = cl_pid.update(cl_out, period)
                if feedforward:
                    flow = client.read_float32(10)    # flow_rate register
                    if flow > 0.0:
                        cl_cmd += cl_setpoint * flow / chlorine_stock_mg_L
                cl_cmd = min(max(cl_cmd, 0.0), 1.0)
                client.write_float32(2, cl_cmd)   # chlorine_flow_rate
            else:
                cl_cmd = 0.0
            if ph_in > 0.0:
                acid_cmd = ph_pid.update(ph_in, period)
                client.write_float32(0, acid_cmd)  # acid_flow_rate
            else:
                acid_cmd = 0.0

            history.append((sim_t, cl_out, ph_in, cl_cmd, acid_cmd))
            if verbose and i % 10 == 0:
                print(f"t={sim_t:8.0f}s  Cl_out={cl_out:5.2f} mg/L "
                      f"(sp {cl_setpoint})  pH_in={ph_in:5.2f} "
                      f"(sp {ph_setpoint})  ClCmd={cl_cmd:.2f}  "
                      f"AcidCmd={acid_cmd:.2f}", flush=True)
            time.sleep(period)
        return history


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=None,
                        help="simulator port (default 5020; --spawn picks "
                             "a free ephemeral port unless one is given)")
    parser.add_argument("--iterations", type=int, default=120)
    parser.add_argument("--period", type=float, default=0.5,
                        help="controller period [wall seconds]")
    parser.add_argument("--cl-setpoint", type=float, default=2.5)
    parser.add_argument("--ph-setpoint", type=float, default=7.0)
    parser.add_argument("--spawn", action="store_true",
                        help="spawn the simulator in-process (demo mode)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the spawned simulator's device (default the "
                             "card; no fallback)")
    parser.add_argument("--feedforward", action="store_true",
                        help="mass-balance ratio feedforward on the "
                             "chlorine loop (dose = setpoint * Q / C_stock "
                             "from the measured flow; PI trims the rest)")
    args = parser.parse_args(argv)

    if args.port is None:
        args.port = free_port(args.host) if args.spawn else 5020

    sim_thread = None
    if args.spawn:
        cli_device(args.device)
        # A bounded real-time factor, so the controller's wall-clock period
        # matches a sensible number of simulation steps.
        sim_thread = spawn_sim(
            ["--port", str(args.port), "--host", args.host, "--dt", "30",
             "--rtf", "300", "--seed", "1", "--recal-hours", "6"],
            args.device)
        if not wait_for_port(args.host, args.port, sim_thread):
            raise SystemExit("the simulator did not start")

    try:
        history = control_loop(args.host, args.port, args.iterations,
                               args.period, args.cl_setpoint,
                               args.ph_setpoint,
                               feedforward=args.feedforward)
    except OSError as e:
        raise SystemExit(
            f"Could not reach the simulator at {args.host}:{args.port} "
            f"({e}). Start one with `python -m ics_wt_physicsengine_torch "
            f"--port {args.port}` or pass --spawn.") from e

    final = history[-1]
    print(f"\nfinal: Cl_out={final[1]:.2f} mg/L (setpoint "
          f"{args.cl_setpoint}), pH_in={final[2]:.2f} "
          f"(setpoint {args.ph_setpoint})", flush=True)

    if args.spawn:
        shutdown_sim(sim_thread)


if __name__ == "__main__":
    main()
