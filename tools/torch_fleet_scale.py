#!/usr/bin/env python3
"""
Fleet-mode scaling of the PyTorch port: serving-loop tick cost against
fleet size (the port of ``tools/fleet_scale.py``).

Measures the headless fleet tick: one batched device step
(``models.plant.plant_step_batched`` over every unit, its own boundary a
lane) and the host work of every unit (publishing 9 input registers + 3
fault bits and reading back 5 commands + 3 coils per unit through a live
``ModbusSlave``), at increasing N, and reports the largest fleet that
still meets real time at dt = 1 s from a linear fit of the tick against N.
The readings come to the host in one synchronized copy a tick
(``fleet._host_outputs``).

    python tools/torch_fleet_scale.py [--sizes 4 16 64 254] [--ticks 20]
        [--zones 5] [--device {cuda,cpu}]

Prints one JSON line: ``{"fleet_sizes": [...], "tick_ms": [...],
"max_realtime_units_dt1s": N, "backend": ..., "device": {...}}``. The card
is the default; ``--device cpu`` is an explicit request.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ics_wt_physicsengine_torch import __main__ as M  # noqa: E402
from ics_wt_physicsengine_torch.bench import device_info  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.fleet import (  # noqa: E402
    _host_outputs, _lane_readings, _stack_boundaries)
from ics_wt_physicsengine_torch.modbus import (  # noqa: E402
    ModbusRegisterMap, ModbusServerConfig, ModbusSlave)
from ics_wt_physicsengine_torch.models.plant import (  # noqa: E402
    make_plant_batch, plant_step_batched)


def measure(n: int, n_ticks: int, zones: int, device) -> float:
    """Seconds a fleet tick of ``n`` units takes (mean of ``n_ticks``,
    after one warm-up tick)."""
    units = list(range(1, n + 1))
    config = R.ReactorConfiguration(volume=1000.0, n_zones=zones,
                                    flow_rate=5.0, initial_pH=7.2,
                                    initial_chlorine=2.0, temperature=20.0)
    substeps = R.default_substeps(config, 1.0)
    params, plant = make_plant_batch(config, n, seed=1, warmed_up=True,
                                     device=device)
    dtype = plant.reactor.pH.dtype
    generator = torch.Generator(device=device).manual_seed(1)

    def step(pl, bc):
        return plant_step_batched(params, pl, bc, 1.0, substeps,
                                  boundary_axes=0, generator=generator)

    slave = ModbusSlave(ModbusRegisterMap(),
                        ModbusServerConfig(host="127.0.0.1", port=0),
                        units=units)
    slave.start(blocking=False)
    boundaries = [R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.5)
                  for _ in units]
    try:
        plant, outputs = step(plant, _stack_boundaries(boundaries, dtype,
                                                       device))
        _host_outputs([outputs])                       # warm-up
        t0 = time.perf_counter()
        for tick in range(n_ticks):
            plant, outputs = step(plant, _stack_boundaries(boundaries, dtype,
                                                           device))
            names, floats, codes = _host_outputs([outputs])
            pH = plant.reactor.pH.cpu().numpy()
            for i, u in enumerate(units):
                readings = _lane_readings(names, floats, codes, i)
                M.update_modbus_inputs(slave, readings,
                                       SimpleNamespace(pH=pH[i]),
                                       float(tick), unit=u)
            for i, u in enumerate(units):
                commands = M.read_modbus_commands(slave, unit=u)
                boundaries[i] = M.apply_boundary_conditions(boundaries[i],
                                                            commands)
        return (time.perf_counter() - t0) / n_ticks
    finally:
        slave.stop()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="tools/torch_fleet_scale.py",
                                 description=__doc__)
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[4, 16, 64, 254])   # 254 = Modbus unit-id space
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--zones", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; no fallback) or cpu")
    return ap.parse_args(argv)


def fleet_scale(args, device) -> dict:
    tick_ms = []
    for n in args.sizes:
        t = measure(n, args.ticks, args.zones, device)
        tick_ms.append(round(t * 1e3, 2))
        print(f"# {n:5d} units: {t * 1e3:8.2f} ms/tick "
              f"({t * 1e6 / n:7.1f} us/unit)", file=sys.stderr, flush=True)
    # linear fit tick(N) = a + b*N -> largest N with tick <= 1 s
    ns, ts = np.asarray(args.sizes, float), np.asarray(tick_ms) / 1e3
    b, a = np.polyfit(ns, ts, 1)
    max_rt = int((1.0 - a) / b) if b > 0 else 10 ** 6
    return {"fleet_sizes": args.sizes, "tick_ms": tick_ms,
            "max_realtime_units_dt1s": max_rt, "backend": device.type,
            "device": device_info(device)}


def main(argv=None) -> int:
    args = parse_args(argv)
    device = cli_device(args.device)
    print(json.dumps(fleet_scale(args, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
