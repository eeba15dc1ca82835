"""
Ensemble Kalman filter on a high-resolution full-chemistry plant with the
PyTorch port (the port of ``examples/enkf_highres.py``): state estimation
past the point where an explicit covariance scales.

A 48-zone nitrogen+gas plant carries 9 fields a zone, a 432-dim state. The
full-state EKF (``control/ekf.py``) would spend 433 plant evaluations a
tick on the Jacobian plus O(432^2) covariance algebra; the EnKF
(``control/enkf.py``) replaces both with a batch of members, at a cost that
scales with the ensemble size, not the state size.

The demo reconstructs the unmeasured interior (mid-zone chlorine and
ammonia, no instrument within 20 zones) from six boundary taps, against a
truth run the filter's wrong initial guess knows nothing about, and prints
the error trajectory next to the open-loop model rollout from the same
guess. The ensemble's draws come from a ``torch.Generator`` seeded 0; the
truth's measurement noise from NumPy's ``default_rng(1)``. Plain PyTorch:
no hand-written kernel lies on this path.

Usage:
  python examples_torch/enkf_highres.py                  # 48 zones, 64 members
  python examples_torch/enkf_highres.py --zones 96 --members 128 --steps 40
  python examples_torch/enkf_highres.py --device cpu --zones 16 \
      --members 32 --steps 10

The card is the default; ``--device cpu`` runs on the CPU. Exits 1 when the
filter does not converge.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ics_wt_physicsengine_torch.control import (  # noqa: E402
    ensemble_spread, flatten_state, make_enkf, make_enkf_carry, tap_index)
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402

N_FIELDS = 9          # pH Cl T | NH3 NO2 NO3 NH2Cl | O2 C_T
TAPS = [("pH", 0), ("pH", -1), ("chlorine", -1),
        ("temperature", -1), ("ammonia", -1), ("oxygen", -1)]
SIGMA = np.array([0.02, 0.02, 0.02, 0.05, 0.02, 0.05])
P0 = (0.04, 1.0, 4.0, 0.1, 0.01, 0.01, 0.01, 0.5, 0.05)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--zones", type=int, default=48)
    ap.add_argument("--members", type=int, default=64)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--dt", type=float, default=30.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; no fallback) or cpu")
    return ap.parse_args(argv)


def assimilate(args, device, dtype=torch.float32, pert=None, draws=None,
               say=print) -> dict:
    """The truth, open-loop and EnKF runs. ``pert`` (``[members, n]``)
    and ``draws`` (a ``(w, eps)`` pair of standard normal draws a tick, as
    ``enkf_step`` takes them) replace the generator's draws. Returns the
    analysed mean of every tick (``"x"``) and whether the filter converged
    (``"ok"``)."""
    Z, N = args.zones, args.members
    config = R.ReactorConfiguration(
        volume=2000.0, height=4.0, diameter=0.798, n_zones=Z,
        flow_rate=5.0, initial_pH=7.2, initial_chlorine=2.0,
        temperature=20.0, enable_nitrogen=True, enable_gas=True,
        initial_ammonia=0.5)
    params = R.make_params(config, dtype=dtype, device=device)
    substeps = R.default_substeps(config, args.dt)
    bc = R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.4, inlet_chlorine=0.6,
        inlet_temperature=18.0, inlet_ammonia=0.8,
        chlorine_flow_rate=0.15)

    def profile(lo, hi):
        return torch.linspace(lo, hi, Z, dtype=dtype, device=device)

    def flat(value):
        return torch.full((Z,), value, dtype=dtype, device=device)

    n_state = N_FIELDS * Z
    say(f"plant: {Z} zones x {N_FIELDS} fields = {n_state}-dim state, "
        f"{N}-member EnKF on {device.type}")
    say(f"(an EKF tick here = {n_state + 1} plant evals for the "
        f"Jacobian + O({n_state}^2) covariance algebra; "
        f"the EnKF tick = {N} plant evals, any state size)")

    # truth: a stratified transient the filter's flat guess doesn't know
    truth = R._update_derived(dataclasses.replace(
        R.make_initial_state(config, dtype=dtype, device=device),
        pH=profile(6.9, 7.5), chlorine=profile(2.8, 1.0),
        temperature=profile(22.0, 19.0), ammonia=profile(0.9, 0.2)))
    # the filter's guess is genuinely wrong: a flat cold-start profile
    guess = R._update_derived(dataclasses.replace(
        R.make_initial_state(config, dtype=dtype, device=device),
        chlorine=flat(0.4), ammonia=flat(0.05)))

    enkf_step = make_enkf(
        params, Z, TAPS, args.dt, substeps,
        process_noise=(1e-7, 1e-6, 1e-5),
        measurement_noise=SIGMA ** 2,
        inflation=1.02, localization_radius=max(4.0, Z / 3.0))
    carry = make_enkf_carry(guess, P0, Z, N, generator=0, pert=pert)

    mid = Z // 2
    i_cl = tap_index("chlorine", mid, Z, nitrogen=True, gas=True)
    i_nh = tap_index("ammonia", mid, Z, nitrogen=True, gas=True)
    tap_idx = [tap_index(f, z, Z, nitrogen=True, gas=True)
               for f, z in TAPS]

    def step(s):
        with torch.no_grad():
            return R.step(params, s, bc, args.dt, substeps)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    open_loop = guess
    rng = np.random.default_rng(1)
    # one untimed pass through each path first (the generator untouched:
    # the warm-up's draws are zeros), so the printed rate is steady state
    step(truth)
    with torch.no_grad():
        enkf_step(carry, torch.full((len(TAPS),), float("nan"),
                                    dtype=dtype, device=device), bc,
                  w=torch.zeros_like(carry.ensemble),
                  eps_all=torch.zeros((len(TAPS), N), dtype=dtype,
                                      device=device))
    x = torch.mean(carry.ensemble, dim=0)
    e0_cl = abs(float(x[i_cl]) - float(truth.chlorine[mid]))
    e0_nh = abs(float(x[i_nh]) - float(truth.ammonia[mid]))
    say(f"{'tick':>4} {'mid-Cl err (EnKF)':>18} {'(open loop)':>12} "
        f"{'mid-NH3 err':>12} {'spread-Cl':>10}")
    xs = []
    sync()
    t0 = time.perf_counter()
    for k in range(args.steps):
        truth = step(truth)
        open_loop = step(open_loop)
        zt = flatten_state(truth).cpu().numpy()[tap_idx]
        z = torch.as_tensor(zt + rng.normal(0.0, SIGMA), dtype=dtype,
                            device=device)
        w, eps = (None, None) if draws is None else draws[k]
        with torch.no_grad():
            carry, x = enkf_step(carry, z, bc, w=w, eps_all=eps)
        xs.append(x)
        if (k + 1) % 5 == 0 or k == 0:
            e_cl = abs(float(x[i_cl]) - float(truth.chlorine[mid]))
            e_nh = abs(float(x[i_nh]) - float(truth.ammonia[mid]))
            ol = abs(float(open_loop.chlorine[mid])
                     - float(truth.chlorine[mid]))
            sp = float(ensemble_spread(carry)[i_cl])
            say(f"{k + 1:>4} {e_cl:>18.4f} {ol:>12.4f} "
                f"{e_nh:>12.4f} {sp:>10.4f}")
    sync()
    wall = time.perf_counter() - t0
    e_cl = abs(float(x[i_cl]) - float(truth.chlorine[mid]))
    e_nh = abs(float(x[i_nh]) - float(truth.ammonia[mid]))
    say("")
    say(f"{args.steps} assimilation cycles in {wall:.1f}s "
        f"({args.steps * N / wall:.0f} member-steps/s incl. truth "
        f"+ open-loop runs)")
    say(f"mid-zone chlorine error: {e0_cl:.3f} -> {e_cl:.3f} mg/L; "
        f"ammonia {e0_nh:.3f} -> {e_nh:.3f} mg-N/L")
    ok = e_cl < 0.25 * e0_cl and e_nh < 0.5 * e0_nh
    say("OK" if ok else "NOT CONVERGED")
    return {"x": xs, "ok": ok}


def main(argv=None) -> str:
    """Prints the run and returns what it printed."""
    args = parse_args(argv)
    device = cli_device(args.device)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    assimilate(args, device, say=say)
    return "\n".join(lines)


if __name__ == "__main__":
    sys.exit(0 if main().splitlines()[-1] == "OK" else 1)
