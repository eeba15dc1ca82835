"""
Soft sensor over the HIL wire, against the PyTorch port's simulator (the
port of ``examples/ekf_soft_sensor.py``): an EKF reconstructs the plant's
hidden interior from the four boundary measurements a SCADA master can
read.

The plant serves only boundary-zone instruments over Modbus (pH
inlet/outlet, chlorine outlet, temperature outlet); everything between is
invisible on the wire. This client runs the port's full-state extended
Kalman filter (``control/ekf.py``, float64) against those readings (the
physics model IS the process model) and prints the reconstructed per-zone
chlorine profile with its 1-sigma confidence, turning four instruments
into a whole-reactor soft sensor.

``--device`` places both the filter and, with ``--spawn``, the simulator
(default the card; ``--device cpu`` the CPU).

Usage:
  # against an already-running simulator
  python -m ics_wt_physicsengine_torch --zones 5 --dt 30 --port 5020 &
  python examples_torch/ekf_soft_sensor.py --host 127.0.0.1 --port 5020

  # self-contained demo (spawns the simulator in-process)
  python examples_torch/ekf_soft_sensor.py --spawn --ticks 30
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ics_wt_physicsengine_torch.control import (  # noqa: E402
    make_ekf,
    make_ekf_carry,
)
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.modbus import ModbusTcpClient  # noqa: E402
from examples_torch.pid_controller import (  # noqa: E402
    free_port, shutdown_sim, spawn_sim, wait_for_port)

# input-register addresses (modbus/register_map.py)
ADDR = {"pH_inlet": 0, "pH_outlet": 4, "chlorine_outlet": 8,
        "temperature_outlet": 14, "simulation_time": 100}
# holding-register addresses (the JAX example reads the concentrations
# from 6 and 8, which the map leaves unassigned)
HOLDING = {"acid_flow_rate": 0, "chlorine_flow_rate": 2,
           "inlet_flow_rate": 4, "acid_concentration": 10,
           "chlorine_concentration": 12}
TAPS = [("pH", 0), ("pH", -1), ("chlorine", -1), ("temperature", -1)]


def run(host, port, ticks, zones, dt, device, verbose=True):
    f64 = torch.float64
    config = R.ReactorConfiguration(
        volume=1000.0, n_zones=zones, flow_rate=5.0, initial_pH=7.2,
        initial_chlorine=2.0, temperature=20.0)
    params = R.make_params(config, dtype=f64, device=device)
    substeps = R.default_substeps(config, dt)
    ekf_step = make_ekf(params, zones, TAPS, dt, substeps,
                        measurement_noise=(4e-4, 4e-4, 2.5e-3, 1e-2))
    carry = make_ekf_carry(
        R.make_initial_state(config, dtype=f64, device=device),
        p0=(0.05, 1.0, 4.0), n_zones=zones)

    with ModbusTcpClient(host, port, timeout=10) as c:
        last_t = c.read_float32(ADDR["simulation_time"])
        done = 0
        while done < ticks:
            t = c.read_float32(ADDR["simulation_time"])
            if t <= last_t:          # no new plant tick yet
                time.sleep(0.05)
                continue
            last_t = t
            # the commands currently applied = the boundary that drives
            # the plant's next transitions (validated on both sides of the
            # wire)
            cmd = {n: c.read_float32(a, input_register=False)
                   for n, a in HOLDING.items()}
            boundary = R.BoundaryConditions(
                inlet_flow_rate=cmd["inlet_flow_rate"],
                acid_flow_rate=cmd["acid_flow_rate"],
                chlorine_flow_rate=cmd["chlorine_flow_rate"],
                acid_concentration=cmd["acid_concentration"],
                chlorine_concentration=cmd["chlorine_concentration"])
            z = torch.tensor([c.read_float32(ADDR["pH_inlet"]),
                              c.read_float32(ADDR["pH_outlet"]),
                              c.read_float32(ADDR["chlorine_outlet"]),
                              c.read_float32(ADDR["temperature_outlet"])],
                             dtype=f64, device=device)
            # warming-up instruments publish 0.0: treat as dropouts
            z = torch.where(z == 0.0, torch.full_like(z, float("nan")), z)
            carry, x = ekf_step(carry, z, boundary)
            done += 1
            if verbose:
                cl = x[zones:2 * zones].cpu().numpy()
                sig = torch.diagonal(carry.P)[zones:2 * zones].sqrt() \
                    .cpu().numpy()
                profile = " ".join(
                    f"{v:.2f}±{s:.2f}" for v, s in zip(cl, sig))
                print(f"t={t:8.0f}s  estimated Cl profile [mg/L]: "
                      f"{profile}", flush=True)
    return carry


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--ticks", type=int, default=30,
                        help="plant ticks to assimilate")
    parser.add_argument("--zones", type=int, default=5,
                        help="must match the plant's --zones")
    parser.add_argument("--dt", type=float, default=30.0,
                        help="must match the plant's --dt")
    parser.add_argument("--spawn", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the filter's and the spawned simulator's "
                             "device (default the card; no fallback)")
    args = parser.parse_args(argv)
    device = cli_device(args.device)
    if args.port is None:
        args.port = free_port(args.host) if args.spawn else 5020

    sim_thread = None
    if args.spawn:
        sim_thread = spawn_sim(
            ["--port", str(args.port), "--host", args.host,
             "--dt", str(args.dt), "--zones", str(args.zones),
             "--rtf", "300", "--seed", "2", "--recal-hours", "6"],
            args.device)
        if not wait_for_port(args.host, args.port, sim_thread):
            raise SystemExit("simulator did not start")

    try:
        run(args.host, args.port, args.ticks, args.zones, args.dt, device)
        print(f"soft sensor assimilated {args.ticks} ticks", flush=True)
    finally:
        if sim_thread is not None:
            shutdown_sim(sim_thread)


if __name__ == "__main__":
    main()
