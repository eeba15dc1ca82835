"""
Winter operations with the PyTorch port (the port of
``examples/winter_operations.py``): a diurnal arctic cold snap over an
outdoor tank, the phase-change axis (``core/phase.py``) end to end.

An exposed treatment tank rides a -25 C night / -5 C day sinusoid with
wind. The bulk cools to the freezing point and pins there on the latent
plateau, ice forms top-down, the growing lid throttles further heat loss
and evaporation, and a warm-water recirculation purge (hot inlet flow)
melts the lid back. The report card is the operator's: hours of ice cover,
peak ice fraction, evaporative water loss, and whether the purge kept the
outlet liquid.

The day runs as one ``[n_steps]`` boundary schedule through
``reactor.rollout_scheduled``, plain PyTorch: the fused kernels refuse the
phase axis, and the scheduled rollout never routes to them.

Usage:
  python examples_torch/winter_operations.py [--days 3] [--dt 300]
      [--purge-c 35] [--device {cuda,cpu}]

The card is the default; ``--device cpu`` runs on the CPU. Prints one JSON
document.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ics_wt_physicsengine_torch.core import phase as PH  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import (  # noqa: E402
    cli_device, numpy_dtype)

HUMIDITY = 0.6
A_CROSS = 1.0 / 2.0                 # V/H [m^2]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=3.0)
    ap.add_argument("--dt", type=float, default=300.0)
    ap.add_argument("--zones", type=int, default=8)
    ap.add_argument("--t-night", type=float, default=-25.0)
    ap.add_argument("--t-day", type=float, default=-5.0)
    ap.add_argument("--wind", type=float, default=5.0)
    ap.add_argument("--heat-loss", type=float, default=30.0,
                    help="U [W/K] for the exposed tank shell (~5 W/m2K "
                         "over the 6 m2 of an uninsulated 1 m3 tank)")
    ap.add_argument("--purge-c", type=float, default=35.0,
                    help="warm-purge inlet temperature [C] (0 disables "
                         "the purge)")
    ap.add_argument("--purge-hours", type=float, default=20.0,
                    help="purge duration at the end of the run [h]")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; no fallback) or cpu")
    return ap.parse_args(argv)


def tank_config(args) -> R.ReactorConfiguration:
    return R.ReactorConfiguration(
        volume=1000.0, height=2.0, diameter=0.798, n_zones=args.zones,
        flow_rate=1.0, temperature=4.0, enable_phase=True)


def schedule(args, dtype):
    """The run's ``[n_steps]`` schedule (every field a column, as the JAX
    example broadcasts it) and the ambient temperature series (float64)."""
    n_steps = int(args.days * 86400 / args.dt)
    t = np.arange(n_steps) * args.dt
    # diurnal sinusoid, coldest at 04:00
    t_amb = (0.5 * (args.t_day + args.t_night)
             - 0.5 * (args.t_day - args.t_night)
             * np.cos(2 * np.pi * (t / 86400.0 - 4.0 / 24.0)))
    purge_on = (args.purge_c > 0) \
        & (t >= args.days * 86400.0 - args.purge_hours * 3600.0)
    np_dtype = numpy_dtype(dtype)
    base = R.BoundaryConditions(
        inlet_flow_rate=1.0, inlet_temperature=4.0,
        heat_loss_coefficient=args.heat_loss,
        ambient_humidity=HUMIDITY, wind_speed=args.wind)
    columns = {f.name: (None if getattr(base, f.name) is None else
                        np.full(n_steps, getattr(base, f.name), np_dtype))
               for f in dataclasses.fields(base)}
    sched = dataclasses.replace(
        R.BoundaryConditions(**columns),
        ambient_temperature=t_amb.astype(np_dtype),
        inlet_temperature=np.where(purge_on, args.purge_c,
                                   4.0).astype(np_dtype),
        inlet_flow_rate=np.where(purge_on, 20.0, 1.0).astype(np_dtype))
    return sched, t_amb


def simulate(args, dtype, device):
    """The scheduled rollout: ``(phase params, temperature trajectory
    [n_steps, Z], ambient series)``."""
    cfg = tank_config(args)
    params = R.make_params(cfg, dtype=dtype, device=device)
    state = R.make_initial_state(cfg, dtype=dtype, device=device)
    sched, t_amb = schedule(args, dtype)
    substeps = max(R.default_substeps(cfg, args.dt), 16)
    with torch.no_grad():
        _, traj = R.rollout_scheduled(params, state, sched, dt=args.dt,
                                      substeps=substeps, record=True)
    return params.phase, traj["temperature"], t_amb


def report(args, pp, T, t_amb) -> dict:
    """The operator's report card from the temperature trajectory."""
    phi_t = PH.ice_fraction(T, pp)
    top_t = phi_t[:, -1]
    # evaporative loss over the open-water (not iced) hours
    m_evap = PH.evaporation_flux(
        T[:, -1], torch.as_tensor(t_amb, dtype=T.dtype, device=T.device),
        torch.tensor(HUMIDITY, dtype=T.dtype, device=T.device),
        torch.tensor(args.wind, dtype=T.dtype, device=T.device),
        pp) * (1.0 - top_t)
    m_evap = m_evap.cpu().numpy()
    T, phi, top = T.cpu().numpy(), phi_t.cpu().numpy(), top_t.cpu().numpy()
    litres_lost = float((m_evap * A_CROSS * args.dt).sum())
    ice_hours = float((top > 0.05).sum() * args.dt / 3600.0)
    n_steps = T.shape[0]
    return {
        "days": args.days,
        "min_bulk_temp_C": round(float(T.min()), 2),
        "hours_of_surface_ice": round(ice_hours, 1),
        "peak_surface_ice_fraction": round(float(top.max()), 3),
        "peak_worst_ice_fraction": round(float(phi.max()), 3),
        "evaporative_loss_L": round(litres_lost, 2),
        "purge_inlet_C": args.purge_c,
        "outlet_liquid_at_end": bool(top[-1] < 0.05),
        "plateau_note": "bulk pinned in the mushy band "
                        f"{int(((T > -0.5) & (T <= 0.0)).any(axis=1).sum())}"
                        f"/{n_steps} steps (latent heat, not a clip)",
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = cli_device(args.device)
    out = report(args, *simulate(args, torch.float32, device))
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
