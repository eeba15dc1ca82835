#!/usr/bin/env python3
"""
Real-time-factor sweep of the PyTorch port's HIL serving stack (the port
of ``tools/rtf_sweep.py``, BASELINE config 5).

Runs the full HIL stack (``IntegratedCSTR.step`` on the device, the seven
sensor objects read through the orchestrator's ``read_all_sensors``, the
registers published through ``update_modbus_inputs`` into a live
``ModbusSlave`` or ``NativeModbusSlave``) at a ladder of requested
real-time factors and reports the achieved RTF at each point, plus the
unpaced ceiling (``--rtfs ... 0``). Prints one JSON document: ``tools/
rtf_sweep.py``'s keys and ``device`` (the card's name and power limit).

    python tools/torch_rtf_sweep.py [--steps 120] [--dt 1.0] [--native]
        [--rtfs 1 10 100 0] [--integrator rk4] [--device {cuda,cpu}]

The card is the default; ``--device cpu`` is an explicit request.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ics_wt_physicsengine_torch import __main__ as orch  # noqa: E402
from ics_wt_physicsengine_torch.bench import device_info  # noqa: E402
from ics_wt_physicsengine_torch.core import (  # noqa: E402
    BoundaryConditions, IntegratedCSTR, ReactorConfiguration)
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.modbus import (  # noqa: E402
    ModbusRegisterMap, ModbusServerConfig, ModbusSlave, NativeModbusSlave)
from ics_wt_physicsengine_torch.sensors import (  # noqa: E402
    create_realistic_sensor_suite)
from ics_wt_physicsengine_torch.utils import StepTimer  # noqa: E402

# calibration references by the sensor name's first two letters
CALIBRATION = {"pH": 7.0, "ch": 2.0, "fl": 5.0, "te": 20.0}


def run_point(rtf: float, n_steps: int, dt: float, native: bool, device,
              seed: int = 0, integrator: str = "rk4") -> dict:
    """``n_steps`` of the HIL stack paced to ``rtf`` (0: unpaced)."""
    config = ReactorConfiguration()
    reactor = IntegratedCSTR(config, integrator=integrator, device=device)
    sensors = create_realistic_sensor_suite(config, seed=seed, device=device)
    for name, s in sensors.items():
        s.calibrate(CALIBRATION[name[:2]], 0.0)

    server = ModbusServerConfig(host="127.0.0.1", port=0)
    slave = (NativeModbusSlave if native else ModbusSlave)(
        ModbusRegisterMap(), server)
    slave.start()
    try:
        bc = BoundaryConditions(inlet_flow_rate=5.0, acid_flow_rate=0.1)
        timer = StepTimer()
        sim_time = 0.0
        t_start = time.monotonic()
        for _ in range(n_steps):
            step_start = time.monotonic()
            state = reactor.step(dt, bc)
            readings = orch.read_all_sensors(sensors, state,
                                             2000.0 + sim_time)
            orch.update_modbus_inputs(slave, readings, state, sim_time)
            sim_time += dt
            timer.tick(sim_time)
            if rtf > 0:
                sleep = dt / rtf - (time.monotonic() - step_start)
                if sleep > 0:
                    time.sleep(sleep)
        wall = time.monotonic() - t_start
    finally:
        slave.stop()
    return {
        "requested_rtf": rtf,
        "achieved_rtf": sim_time / wall,
        "steps_per_s": n_steps / wall,
    }


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="tools/torch_rtf_sweep.py")
    parser.add_argument("--steps", type=int, default=120)
    parser.add_argument("--dt", type=float, default=1.0)
    parser.add_argument("--native", action="store_true")
    parser.add_argument("--rtfs", type=float, nargs="*",
                        default=[1.0, 10.0, 100.0, 0.0])
    parser.add_argument("--integrator", choices=["rk4", "rkc-strict",
                                                 "rkc-fast"], default="rk4")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default; no fallback) or cpu")
    return parser.parse_args(argv)


def sweep(args, device) -> dict:
    results = [run_point(rtf, args.steps, args.dt, args.native, device,
                         seed=i, integrator=args.integrator)
               for i, rtf in enumerate(args.rtfs)]
    return {
        "sweep": results,
        "dt": args.dt,
        "steps_per_point": args.steps,
        "modbus": "native" if args.native else "python",
        "integrator": args.integrator,
        "device": device_info(device),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    device = cli_device(args.device)
    print(json.dumps(sweep(args, device), indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
