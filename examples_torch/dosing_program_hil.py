"""
Offline HIL replay with the PyTorch port: a scripted dosing program against
the fully instrumented plant, one launch of the fused plant kernel (B3,
``ops.fused_plant.plant_rollout_fused``) per hour of plant time (the port
of ``examples/dosing_program_hil.py``).

This is the HIL loop's shape (mutate the boundary conditions every step,
advance the physics, read all seven instruments) executed offline at kernel
speed with a BoundaryConditions *schedule*: per-second forcing and
per-minute measured-value extraction.

What an operator gets out of it: what the SCADA screens *would have shown*
(delayed, noisy, drifting, occasionally faulted instrument readings) for a
candidate dosing program, before committing it to the real plant.

Usage:
  python examples_torch/dosing_program_hil.py [--hours 24]
      [--device {cuda,cpu}]

On the card each hourly segment draws kernel B3's Philox stream (seed
7 + segment). ``--device cpu`` runs B3's plain PyTorch version on the CPU,
scaled down to at most 0.05 h (one segment), with injected random words
drawn from ``numpy.random.default_rng(0)``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.models.plant import make_plant  # noqa: E402
from ics_wt_physicsengine_torch.ops.fused_plant import (  # noqa: E402
    N_WORDS, plant_rollout_fused)

# the longest replay the CPU runs (B3's plain version is a step loop)
CPU_MAX_HOURS = 0.05
# Power faults latch permanently (calibration resets the status but not
# the failed supply): field maintenance *replaces* the instrument, as the
# orchestrator's --recal-hours does.
SENSOR_ATTRS = ("ph_inlet", "ph_outlet", "chlorine_inlet",
                "chlorine_outlet", "flow_main", "temp_inlet", "temp_outlet")
NAMES = ("pH_outlet", "chlorine_outlet", "flow_main", "temp_outlet")


def plant_config() -> R.ReactorConfiguration:
    return R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                  n_zones=20)


def dosing_schedule(n_steps: int) -> R.BoundaryConditions:
    """The dosing program: a morning acid pulse train, a midday chlorine
    boost, diurnal inlet temperature, demand-driven flow; one row a
    second."""
    t = np.arange(n_steps, dtype=np.float64)
    hours = t / 3600.0
    return R.BoundaryConditions(
        inlet_flow_rate=(5.0 + 2.0 * np.sin(2 * np.pi * (hours - 7) / 24.0)
                         ).astype(np.float32),
        inlet_pH=7.4,
        inlet_chlorine=0.3,
        inlet_temperature=(18.0 + 5.0 * np.sin(2 * np.pi * (hours - 14)
                                               / 24.0)).astype(np.float32),
        acid_flow_rate=np.where((hours % 1.0) < 0.1, 0.25, 0.0
                                ).astype(np.float32),
        chlorine_flow_rate=np.where((hours > 11) & (hours < 13), 0.3, 0.05
                                    ).astype(np.float32),
        ambient_temperature=15.0, heat_loss_coefficient=50.0)


def maintain(plant, config, hour: int, device):
    """Swap any faulted instrument for a fresh calibrated unit."""
    replaced = []
    updates = {}
    _, fresh = make_plant(config, dtype=torch.float32, device=device)
    for attr in SENSOR_ATTRS:
        carry = getattr(plant, attr)
        v = float(carry.base.supply_voltage.reshape(-1)[0])
        dead = not (20.0 < v < 28.0) or \
            not bool(torch.isfinite(carry.base.current_value.reshape(-1)[0]))
        if dead:
            updates[attr] = getattr(fresh, attr)
            replaced.append(attr)
    if replaced:
        print(f"  hour {hour:>2}: replaced faulted {', '.join(replaced)}",
              flush=True)
    return replace(plant, **updates) if updates else plant


def replay(hours: float, device, words=None) -> dict:
    """Replay ``hours`` of the dosing program in hourly segments, each one
    ``plant_rollout_fused`` call, with maintenance between them. On the CPU
    the instruments draw ``words`` (int32 ``[n_steps, N_WORDS, 1]``; None:
    drawn from ``default_rng(0)``), on the card B3's Philox stream.
    Returns ``{"series": {name: values}, "record_every", "seg_steps",
    "n_segments", "steady_seconds"}``."""
    n_steps = int(hours * 3600)
    config = plant_config()
    substeps = R.default_substeps(config, 1.0)
    params, plant = make_plant(config, dtype=torch.float32, device=device)
    schedule = dosing_schedule(n_steps)

    # Hourly segments: instruments are maintained between segments (without
    # it, the fault latch takes every channel dark within hours of
    # unattended running).
    seg_steps = min(n_steps, 3600)
    n_segments = max(1, n_steps // seg_steps)
    record_every = max(1, seg_steps // 60)
    kwargs = dict(dt=1.0, substeps=substeps, n_steps=seg_steps,
                  record_every=record_every)
    if device.type == "cpu":
        if words is None:
            words = np.random.default_rng(0).integers(
                -2 ** 31, 2 ** 31, size=(seg_steps, N_WORDS, 1),
                dtype=np.int32)
        kwargs.update(rng="bits", bits=torch.as_tensor(words))

    def seg_schedule(s):
        lo, hi = s * seg_steps, (s + 1) * seg_steps
        return R.BoundaryConditions(**{
            k: (v[lo:hi] if np.ndim(v) else v)
            for k, v in vars(schedule).items()})

    series = {}
    elapsed = 0.0
    for s in range(n_segments):
        t0 = time.perf_counter()
        # a fresh Philox stream per segment (reusing one seed would replay
        # identical fault rolls)
        seed = {} if device.type == "cpu" else {"seed": 7 + s}
        plant, readings = plant_rollout_fused(params, plant, seg_schedule(s),
                                              **seed, **kwargs)
        host = {k: v.reshape(-1).cpu().numpy() for k, v in readings.items()}
        seg_elapsed = time.perf_counter() - t0
        if s == 0:
            print(f"first segment (incl. the kernel's first load): "
                  f"{seg_elapsed:.1f} s", flush=True)
        else:
            elapsed += seg_elapsed
        for k, v in host.items():
            series.setdefault(k, []).append(v)
        plant = maintain(plant, config, s + 1, device)
    return {"series": {k: np.concatenate(v) for k, v in series.items()},
            "record_every": record_every, "seg_steps": seg_steps,
            "n_segments": n_segments, "n_steps": n_steps,
            "steady_seconds": elapsed}


def report(out: dict) -> None:
    steady = out["n_steps"] - out["seg_steps"]
    if out["n_segments"] > 1:
        rate = steady / out["steady_seconds"]
        print(f"replayed {steady} further plant-seconds (physics + 7 "
              f"instruments/step, hourly maintenance checks) in "
              f"{out['steady_seconds']:.2f} s -> {rate:,.0f} steps/s")
    record_every = out["record_every"]
    series = {k: out["series"][k] for k in NAMES}
    print(f"\nmeasured-value extract (every {record_every} s):")
    header = f"{'t[min]':>7} " + " ".join(f"{k:>16}" for k in NAMES)
    print(header)
    print("-" * len(header))
    n_rec = len(series[NAMES[0]])
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        i = min(n_rec - 1, int(frac * n_rec))
        t_min = (i + 1) * record_every / 60.0
        row = " ".join(f"{series[k][i]:>16.3f}" for k in NAMES)
        print(f"{t_min:>7.1f} {row}")

    print("\ninstrument health after the program:")
    for k in NAMES:
        finite = np.isfinite(series[k])
        msg = "OK" if finite[-1] else "FAULT-LATCHED (needs recalibration)"
        print(f"  {k:<18} finite {100 * finite.mean():5.1f}% of readings"
              f"  final: {msg}")
    print("\n(power-fault latching: only instrument replacement recovers a "
          "failed supply, modeled above and by the orchestrator's "
          "--recal-hours)", flush=True)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--hours", type=float, default=24.0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default; no fallback) or cpu (B3's "
                             f"plain version, at most {CPU_MAX_HOURS} h)")
    args = parser.parse_args(argv)
    device = cli_device(args.device)
    hours = args.hours
    if device.type == "cpu" and hours > CPU_MAX_HOURS:
        hours = CPU_MAX_HOURS
        print(f"--device cpu: --hours cut from {args.hours} to {hours}",
              flush=True)
    out = replay(hours, device)
    report(out)
    return out


if __name__ == "__main__":
    main()
