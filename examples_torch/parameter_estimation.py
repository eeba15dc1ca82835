"""
Gradient-based plant calibration with the PyTorch port (the port of
``examples/parameter_estimation.py``): recover unknown physical parameters
from noisy sensor data by differentiating through the whole simulation.

The reference's physics runs inside scipy's Radau solver, a black box to
autodiff. Here the rollout (stratified transport, buffered pH chemistry,
Arrhenius chlorine decay) is a loop of plain PyTorch, so autograd of a
data-misfit loss with respect to any ``ReactorParams`` leaf is exact and
costs about one extra rollout (reverse mode).

Scenario: a commissioning engineer logs the outlet chlorine and temperature
sensors for 20 simulated minutes under a known dosing program. The plant's
true chlorine decay constant (pipe-wall demand differs site to site) and
inter-zone mixing rate are unknown. Both are recovered by Adam on the
rollout misfit, from handbook values, with the observations corrupted by
sensor noise from NumPy's ``default_rng(seed)`` (the JAX example's draws).

The optimizer is the port's Adam (``control/optim.py``, ``optax.adam``'s
order of operations) at 5e-2; there is no plain-gradient fallback, as the
port always has its Adam. float64 on the CPU (as the JAX example's ``--cpu``
turns x64 on), float32 on the card. Plain PyTorch: no hand-written kernel
lies on this path.

Usage:
  python examples_torch/parameter_estimation.py [--steps 400] [--iters 300]
      [--noise 0.02] [--seed 0] [--device {cuda,cpu}]

The card is the default; ``--device cpu`` runs on the CPU.
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

from ics_wt_physicsengine_torch.control import optim  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402

K_TRUE = 2.3e-4          # handbook value is 1e-4 (core/constants.py)
KX_SCALE_TRUE = 0.65     # actual mixing is 65% of the Corrsin estimate
LEARNING_RATE = 5e-2


def build_problem(n_steps: int, dtype=torch.float64, device="cpu"):
    """The plant, its initial state and the known dosing program (a
    chlorine dose square wave and a warm inlet), on ``device``."""
    config = R.ReactorConfiguration(
        volume=1000, height=2.0, diameter=0.798, n_zones=8,
        flow_rate=5.0, initial_pH=7.0, initial_chlorine=2.0,
        temperature=20.0)
    params = R.make_params(config, dtype=dtype, device=device)
    state = R.make_initial_state(config, dtype=dtype, device=device)
    t = np.arange(n_steps)
    schedule = R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.3,
        inlet_temperature=24.0,
        chlorine_flow_rate=torch.as_tensor(
            np.where(t % 120 < 60, 0.02, 0.0), dtype=dtype, device=device),
        chlorine_concentration=1000.0,
        ambient_temperature=15.0, heat_loss_coefficient=50.0)
    return config, params, state, schedule


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400,
                    help="observation window [s] (dt = 1 s)")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--noise", type=float, default=0.02,
                    help="sensor noise sigma on chlorine [mg/L]")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default, float32; no fallback) or cpu "
                         "(float64)")
    return ap.parse_args(argv)


def calibrate(args, device, say=print) -> dict:
    """The observations, the Adam loop and the report (through ``say``).
    Returns every step's loss and parameters before rounding
    (``"history"``: ``(loss, log10 k_ref, log mixing scale)``, the loss at
    the step's start and the parameters after it) and the recovered
    ``k_hat`` and ``kx_hat``."""
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    config, params, state, schedule = build_problem(args.steps, dtype,
                                                    device)
    substeps = R.default_substeps(config, 1.0)

    def simulate(log10_k, log_kx_scale):
        p = dataclasses.replace(
            params, cl_k_ref=10.0 ** log10_k,
            k_exchange=params.k_exchange * torch.exp(log_kx_scale))
        _, traj = R.rollout_scheduled(p, state, schedule, dt=1.0,
                                      substeps=substeps)
        # observables: outlet chlorine + outlet temperature time series
        return traj["chlorine"][:, -1], traj["temperature"][:, -1]

    def scalar(value):
        return torch.tensor(value, dtype=dtype, device=device)

    with torch.no_grad():
        cl_clean, temp_clean = simulate(torch.log10(scalar(K_TRUE)),
                                        torch.log(scalar(KX_SCALE_TRUE)))
    rng = np.random.default_rng(args.seed)
    cl_np = cl_clean.cpu().numpy()
    temp_np = temp_clean.cpu().numpy()
    cl_obs = torch.as_tensor(cl_np + rng.normal(0, args.noise, cl_np.shape),
                             dtype=dtype, device=device)
    temp_obs = torch.as_tensor(temp_np + rng.normal(0, 0.1, temp_np.shape),
                               dtype=dtype, device=device)

    def loss(theta):
        cl, temp = simulate(*theta)
        return (torch.mean((cl - cl_obs) ** 2) / (args.noise ** 2)
                + torch.mean((temp - temp_obs) ** 2) / (0.1 ** 2))

    theta = [scalar(-4.0),      # handbook k = 1e-4
             scalar(0.0)]       # Corrsin mixing as-is
    opt_state = optim.adam_init(theta)

    def update(theta, opt_state):
        theta = [t.detach().requires_grad_(True) for t in theta]
        val = loss(theta)
        grads = torch.autograd.grad(val, theta)
        with torch.no_grad():
            steps, opt_state = optim.adam_update(grads, opt_state,
                                                 LEARNING_RATE)
            theta = optim.apply_updates(theta, steps)
        return theta, opt_state, val.detach()

    say(f"observations: {args.steps} s of noisy outlet Cl + T "
        f"(sigma = {args.noise} mg/L, 0.1 C)")
    say(f"{'iter':>5} {'loss':>12} {'k_ref':>12} {'mix scale':>10}")
    history = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(args.iters):
        theta, opt_state, val = update(theta, opt_state)
        history.append((float(val), float(theta[0]), float(theta[1])))
        if i % max(1, args.iters // 10) == 0 or i == args.iters - 1:
            say(f"{i:5d} {float(val):12.4f} {10**float(theta[0]):12.3e} "
                f"{float(torch.exp(theta[1])):10.3f}")
    elapsed = time.perf_counter() - t0

    k_hat = 10.0 ** float(theta[0])
    kx_hat = float(torch.exp(theta[1]))
    say(f"\nrecovered in {elapsed:.1f}s "
        f"({args.iters} Adam steps, each = 1 rollout + 1 backward):")
    say(f"  chlorine decay k_ref: {k_hat:.3e}  (true {K_TRUE:.3e}, "
        f"error {abs(k_hat - K_TRUE) / K_TRUE * 100:.1f}%)")
    say(f"  mixing scale:         {kx_hat:.3f}      (true "
        f"{KX_SCALE_TRUE:.3f}, error "
        f"{abs(kx_hat - KX_SCALE_TRUE) / KX_SCALE_TRUE * 100:.1f}%)")
    return {"history": history, "k_hat": k_hat, "kx_hat": kx_hat}


def main(argv=None) -> str:
    """Prints the calibration and returns what it printed."""
    args = parse_args(argv)
    device = cli_device(args.device)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    calibrate(args, device, say=say)
    return "\n".join(lines)


if __name__ == "__main__":
    main()
