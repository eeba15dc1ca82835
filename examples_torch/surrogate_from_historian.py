"""
Train the plant surrogate from historian data with the PyTorch port (the
port of ``examples/surrogate_from_historian.py``): noisy instrument
readings assimilated by an EKF bank, no true state anywhere in the training
path.

examples_torch/surrogate_mpc.py trains on exact physics states; a real
deployment only has what the instruments recorded. This demo runs the whole
pipeline end to end:

  1. commissioning: the instrument suite is realistically biased (the
     amperometric chlorine sensor's HOCl-speciation weighting reads ~0.83x
     true, DPD ~0.75x, the 2-wire RTD's lead resistance ~+5 C), so, as on a
     real site, two held dose levels are compared against lab grab samples
     (the simulator's true taps) and a per-lane, per-channel linear
     calibration is fitted;
  2. a bank of L instrumented plants (physics and seven instruments: noise,
     drift, fouling, sample-line delays) under per-lane piecewise-random
     dosing, the "historian" being written;
  3. a bank of full-state EKFs (``control/ekf.py``: one filter step over a
     ``[L]`` carry) assimilating each lane's five calibrated boundary
     readings every tick;
  4. the surrogate (``models/surrogate.py``) trained on the estimate
     transitions ``(x_hat_k, u_k) -> x_hat_{k+1}``;
  5. validation against the true states the simulator knows (a real site
     never does): one-step skill against the identity predictor on the
     excited channel (chlorine; pH and temperature barely move under
     chlorine-only forcing, so their absolute RMSE is reported), and
     surrogate-planned MPC driving the exact plant (``run_mpc_surrogate``).

The draws: the dose levels from a ``torch.Generator`` seeded 7, the plant
bank's instruments from one seeded 0, the training from one seeded 1 (the
JAX example's ``PRNGKey(7)``, ``make_plant_batch(seed=0)`` and
``PRNGKey(1)``). ``main(draws=...)`` replaces them. Plain PyTorch: no
hand-written kernel lies on this path.

Usage:
  python examples_torch/surrogate_from_historian.py [--lanes 32]
      [--steps 600] [--burn 40] [--hold 10] [--zones 6]
      [--train-steps 4000] [--rollout-steps 400] [--mpc-minutes 45]
      [--device {cuda,cpu}]

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
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ics_wt_physicsengine_torch.control import (  # noqa: E402
    flatten_state, make_ekf, make_ekf_carry, tap_index)
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from ics_wt_physicsengine_torch.models import surrogate as SG  # noqa: E402
from ics_wt_physicsengine_torch.models.plant import (  # noqa: E402
    make_plant_batch, plant_step_batched)

DT = 30.0
# chlorine is metered at both ends (as real plants do at the point of
# application): without the inlet channel the interior profile is only
# slowly observable under strong dosing excitation
TAPS = [("pH", 0), ("pH", -1), ("chlorine", 0), ("chlorine", -1),
        ("temperature", -1)]
MEASURED = ["pH_inlet", "pH_outlet", "chlorine_inlet", "chlorine_outlet",
            "temp_outlet"]
MEAS_NOISE = (4e-4, 4e-4, 2.5e-3, 2.5e-3, 1e-2)
# the commissioning's two held dose levels [L/min]
COMMISSION_LEVELS = (0.15, 0.85)
DOSE_SEED, PLANT_SEED, TRAIN_SEED = 7, 0, 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=32,
                    help="historian plant lanes")
    ap.add_argument("--steps", type=int, default=600,
                    help="historian length in dt=30s ticks")
    ap.add_argument("--burn", type=int, default=40,
                    help="EKF convergence ticks discarded from training")
    ap.add_argument("--hold", type=int, default=10,
                    help="excitation hold (ticks per random dose level)")
    ap.add_argument("--zones", type=int, default=6)
    ap.add_argument("--train-steps", type=int, default=4000)
    ap.add_argument("--rollout-steps", type=int, default=400)
    ap.add_argument("--mpc-minutes", type=int, default=45,
                    help="0 disables the closing MPC run")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; no fallback) or cpu")
    args = ap.parse_args(argv)
    if not 1 <= args.burn < args.steps:
        raise SystemExit(f"--burn must be in [1, --steps) — the slice "
                         f"Xhat[:, burn-1:] needs burn >= 1 (got "
                         f"burn={args.burn}, steps={args.steps})")
    return args


def make_config(zones: int) -> R.ReactorConfiguration:
    return R.ReactorConfiguration(
        volume=1000.0, n_zones=zones, flow_rate=5.0, initial_pH=7.2,
        initial_chlorine=2.0, temperature=20.0)


def setup(args, device, dtype=torch.float32) -> SimpleNamespace:
    """The plant bank, the EKF bank and what the ticks share. The plant
    bank's instruments draw from ``plant_generator`` (seeded
    ``PLANT_SEED``) unless a tick is given its draws."""
    L, Z = args.lanes, args.zones
    config = make_config(Z)
    substeps = R.default_substeps(config, DT)
    pparams, plant = make_plant_batch(config, L, seed=PLANT_SEED,
                                      dtype=dtype, randomize=False,
                                      warmed_up=True, device=device)
    rparams = R.make_params(config, dtype=dtype, device=device)
    # chlorine PSD sized to the excitation (dose levels jump every `hold`
    # ticks; the filter must be allowed to follow)
    ekf_step = make_ekf(rparams, Z, TAPS, DT, substeps,
                        process_noise=(1e-7, 1e-4, 1e-5),
                        measurement_noise=MEAS_NOISE)
    carry = make_ekf_carry(R.make_initial_state(config, dtype=dtype,
                                                device=device),
                           p0=(0.05, 1.0, 4.0), n_zones=Z)
    ekf_bank = dataclasses.replace(
        carry, x=carry.x.expand((L,) + carry.x.shape).clone(),
        P=carry.P.expand((L,) + carry.P.shape).clone())
    bc0 = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.5,
                               inlet_chlorine=0.5, inlet_temperature=18.0)
    bc_lanes = R.BoundaryConditions(**{
        f.name: (None if getattr(bc0, f.name) is None else torch.full(
            (L,), float(getattr(bc0, f.name)), dtype=dtype, device=device))
        for f in dataclasses.fields(bc0)})
    return SimpleNamespace(
        config=config, substeps=substeps, pparams=pparams, plant=plant,
        ekf_step=ekf_step, ekf_bank=ekf_bank, bc_lanes=bc_lanes,
        tap_cols=[tap_index(f, z, Z) for f, z in TAPS],
        ticks=max(2 * args.hold, 20), lanes=L, zones=Z, dtype=dtype,
        device=device,
        plant_generator=torch.Generator(device=device).manual_seed(
            PLANT_SEED))


def dose_levels(lanes: int, n_holds: int, device,
                dtype=torch.float32) -> torch.Tensor:
    """``[lanes, n_holds]`` dose levels, uniform in [0, 1) L/min, from a
    generator seeded ``DOSE_SEED``."""
    g = torch.Generator(device=device).manual_seed(DOSE_SEED)
    return torch.rand((lanes, n_holds), generator=g, dtype=dtype,
                      device=device)


def excitation(levels: torch.Tensor, hold: int, n_steps: int):
    """Each level held for ``hold`` ticks: ``[lanes, n_steps]``."""
    return torch.repeat_interleave(levels, hold, dim=1)[:, :n_steps]


def _plant_tick(ctx, plant, u_t, rand_t):
    """One tick of the plant bank under the per-lane dose ``u_t``: the new
    bank, the stacked readings ``[L, 5]`` and the boundary."""
    bc = dataclasses.replace(ctx.bc_lanes, chlorine_flow_rate=u_t)
    plant, readings = plant_step_batched(
        ctx.pparams, plant, bc, DT, ctx.substeps, rand=rand_t,
        boundary_axes=0, generator=ctx.plant_generator)
    return plant, torch.stack([readings[n].value for n in MEASURED],
                              dim=-1), bc


def commission(ctx, plant, rand=None):
    """The two held dose levels, ``ctx.ticks`` ticks each, and the
    per-lane, per-channel calibration ``z = a * y + b`` fitted from their
    settled halves against the true taps ``y``; channels the dose cannot
    move (pH, temperature) get a single-point offset. ``rand``: the
    ``2 * ctx.ticks`` ticks' draws. Returns ``(plant, a, b)``."""
    C = ctx.ticks
    means = []
    with torch.no_grad():
        for k, level in enumerate(COMMISSION_LEVELS):
            u = torch.full((ctx.lanes,), level, dtype=ctx.dtype,
                           device=ctx.device)
            zs, ys = [], []
            for t in range(C):
                plant, z, _ = _plant_tick(
                    ctx, plant, u, None if rand is None else rand[k * C + t])
                zs.append(z)
                ys.append(flatten_state(plant.reactor)[:, ctx.tap_cols])
            means.append((torch.mean(torch.stack(zs[C // 2:]), dim=0),
                          torch.mean(torch.stack(ys[C // 2:]), dim=0)))
    (z_lo, y_lo), (z_hi, y_hi) = means
    dy = y_hi - y_lo
    movable = torch.abs(dy) > 0.05
    a = torch.where(movable, (z_hi - z_lo) / torch.where(
        movable, dy, torch.ones_like(dy)), torch.ones_like(dy))
    b = torch.where(movable, z_lo - a * y_lo,
                    0.5 * (z_lo - y_lo + z_hi - y_hi))
    return plant, a, b


def historian(ctx, plant, u_seq, cal_a, cal_b, rand=None):
    """The historian: the plant bank under ``u_seq`` (``[L, S]``), its
    readings de-biased by the calibration and assimilated by the EKF bank
    every tick. ``rand``: each tick's draws. Returns the estimates and the
    true states, ``[L, S, n]`` each."""
    ekf = ctx.ekf_bank
    xhat, xtrue = [], []
    with torch.no_grad():
        for t in range(u_seq.shape[1]):
            plant, z_raw, bc = _plant_tick(
                ctx, plant, u_seq[:, t], None if rand is None else rand[t])
            ekf, x_hat = ctx.ekf_step(ekf, (z_raw - cal_b) / cal_a, bc)
            xhat.append(x_hat)
            xtrue.append(flatten_state(plant.reactor))
    return torch.stack(xhat, dim=1), torch.stack(xtrue, dim=1)


def train(ctx, Xhat, u_seq, args, draws=None):
    """The surrogate on the estimate transitions, the EKF's burn-in
    discarded. ``draws`` may hold ``init_weights``, ``batch_indices`` and
    ``rollout_indices`` (``train_surrogate``'s)."""
    draws = draws or {}
    B = args.burn
    X = Xhat[:, B - 1:]                          # [L, S-B+1, n]
    U = u_seq[:, B:, None]                       # [L, S-B, 1]
    return SG.train_surrogate(
        X, U, ctx.zones, seed=TRAIN_SEED, hidden=(128, 128),
        n_steps=args.train_steps, rollout_steps=args.rollout_steps,
        init_weights=draws.get("init_weights"),
        batch_indices=draws.get("batch_indices"),
        rollout_indices=draws.get("rollout_indices"))


def validate(sp, Xtrue, u_seq, burn: int, zones: int):
    """One-step predictions from the true states against the true next
    states: the chlorine skill against the identity predictor (population
    std, as NumPy's) and the absolute RMSE of pH and temperature."""
    B, Z = burn, zones
    with torch.no_grad():
        pred = SG.surrogate_step(sp, Xtrue[:, B:-1], u_seq[:, B + 1:, None])
    err = (pred - Xtrue[:, B + 1:]).cpu().numpy()
    res = (Xtrue[:, B + 1:] - Xtrue[:, B:-1]).cpu().numpy()

    def _skill(i):
        d = max(float(res[..., i * Z:(i + 1) * Z].std()), 1e-9)
        return round(float(err[..., i * Z:(i + 1) * Z].std()) / d, 3)

    def _rmse(i):
        return round(float(
            np.sqrt((err[..., i * Z:(i + 1) * Z] ** 2).mean())), 5)

    # only the excited channel (chlorine: the dose is the input) supports a
    # skill ratio; pH and temperature barely move under chlorine-only
    # forcing, so their estimate jitter would show as a huge ratio over a
    # meaningless denominator
    return {"chlorine": _skill(1)}, {"pH": _rmse(0),
                                     "temperature_C": _rmse(2)}


def main(argv=None, draws=None) -> dict:
    """The whole pipeline; the report is printed and returned. ``draws``
    replaces the generators' draws: ``dose_levels`` (``[L, n_holds]``),
    ``rand`` (each tick's ``plant_step_batched`` draws, the commissioning's
    ``2 * max(2 * hold, 20)`` ticks first) and ``train_surrogate``'s
    ``init_weights``, ``batch_indices`` and ``rollout_indices``."""
    args = parse_args(argv)
    device = cli_device(args.device)
    draws = draws or {}
    ctx = setup(args, device)
    L, S, B, Z = args.lanes, args.steps, args.burn, args.zones

    n_holds = -(-S // args.hold)
    levels = draws.get("dose_levels")
    levels = dose_levels(L, n_holds, device) if levels is None else \
        torch.as_tensor(levels, dtype=ctx.dtype, device=device)
    u_seq = excitation(levels, args.hold, S)
    rand = draws.get("rand")
    n_cal = 2 * ctx.ticks

    # --- 1-3: commissioning, then the historian: the plant bank and the
    #     EKF bank each tick, the readings de-biased by the calibration
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    plant, cal_a, cal_b = commission(
        ctx, ctx.plant, None if rand is None else rand[:n_cal])
    Xhat, Xtrue = historian(ctx, plant, u_seq, cal_a, cal_b,
                            None if rand is None else rand[n_cal:])
    t_hist = time.time() - t0

    # EKF quality on the unmeasured interior (against the truth: the
    # simulator's privilege)
    mid = Z // 2
    ekf_rmse = float(torch.sqrt(torch.mean(
        (Xhat[:, B:, Z + mid] - Xtrue[:, B:, Z + mid]) ** 2)))

    # --- 4: train on the estimate transitions
    t0 = time.time()
    sp, _ = train(ctx, Xhat, u_seq, args, draws)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_fit = time.time() - t0

    # --- 5: validate against the truth
    skill, abs_rmse = validate(sp, Xtrue, u_seq, B, Z)
    out = {
        "historian": {"lanes": L, "ticks": S,
                      "seconds": round(t_hist, 1),
                      "ekf_midzone_cl_rmse_mgL": round(ekf_rmse, 4)},
        "fit_seconds": round(t_fit, 1),
        "true_one_step_skill_vs_identity": skill,
        "true_one_step_abs_rmse": abs_rmse,
    }

    if args.mpc_minutes:
        n_mpc = (args.mpc_minutes * 2 // 15) * 15
        program = np.full(n_mpc, 2.5, np.float32)
        t0 = time.time()
        mpc = SG.run_mpc_surrogate(ctx.config, sp, program, dt=DT,
                                   horizon_moves=4, steps_per_move=15,
                                   iters=20, device=device)
        cl = mpc["chlorine_outlet"].cpu().numpy()
        out["surrogate_mpc_on_true_plant"] = {
            "target_mgL": 2.5,
            "tail_mean_abs_err_mgL": round(
                float(np.abs(cl[-15:] - 2.5).mean()), 4),
            "seconds": round(time.time() - t0, 2),
        }

    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
