"""
Kernels B1 and B2 held against their plain PyTorch versions on the same
CUDA inputs: the tables, schedules and tolerances that ``chip_smoke.py``
and ``tests/test_torch_gpu.py`` share.

Tolerances: the kernels are built without FMA contraction and the plain
versions divide as the kernels do, so both round every operation alike and
agree bit for bit where PyTorch's elementwise exp is the device's. The
bounds, float64 1e-12 and float32 1e-4, leave room for a last-bit
difference carried over a few hundred evaluations and are small enough to
catch a flipped stratification switch (Ri > 0.25), which moves a state by
~1e-3. Against the plain version on the CPU (whose exp may differ from the
card's in the last bit) the float64 bound is ``CPU_TOL``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.models.monte_carlo import (
    make_monte_carlo_batch)
from ics_wt_physicsengine_torch.ops import fused_rollout as F

TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
CPU_TOL = 1e-9
DT = 1.0

# dosing on every boundary column, so every source term is exercised
BC = R.BoundaryConditions(
    inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
    inlet_temperature=26.0, acid_flow_rate=0.1, acid_concentration=0.1,
    chlorine_flow_rate=0.2, chlorine_concentration=50.0,
    ambient_temperature=15.0, heat_loss_coefficient=50.0)


def bench_schedule(n_steps: int) -> R.BoundaryConditions:
    """``bench.py``'s scripted forcing: sinusoidal inflow, square-wave inlet
    chlorine and acid dosing."""
    t = np.arange(n_steps)
    return R.BoundaryConditions(
        inlet_flow_rate=5.0 + 2.0 * np.sin(2 * np.pi * t / 17.0),
        inlet_pH=7.2,
        inlet_chlorine=np.where(t % 10 < 5, 0.5, 1.5),
        acid_flow_rate=np.where(t % 8 < 4, 0.0, 0.3),
        ambient_temperature=15.0, heat_loss_coefficient=50.0)


def stiff_plan(n_zones: int, integrator: str):
    """``(substeps, stages)`` for the stiffest sampled plant (90 rpm
    impeller at 8 L/min): RK4 (``"rk4"``) or RKC2 (``"strict"``/``"fast"``)."""
    cfg = R.ReactorConfiguration(n_zones=n_zones, impeller_speed=90.0,
                                 flow_rate=8.0)
    if integrator == "rk4":
        return R.default_substeps(cfg, DT), None
    return R.default_rkc_plan(cfg, DT, mode=integrator)


def tables(n_zones: int, n_plants: int, dtype, device, bc=BC, seed=0):
    """Kernel inputs ``(ptab, btab, (ph, cl, t))``: the default plant when
    ``n_plants == 1``, else a Monte-Carlo batch from ``seed``."""
    if n_plants == 1:
        cfg = R.ReactorConfiguration(n_zones=n_zones)
        params = R.make_params(cfg, dtype=dtype, device=device)
        state = R.make_initial_state(cfg, dtype=dtype, device=device)
    else:
        params, state = make_monte_carlo_batch(
            R.ReactorConfiguration(n_zones=n_zones), n_plants, seed=seed,
            dtype=dtype, device=device)
    ptab = F.param_table(params, n_plants, dtype, device)
    btab = F.boundary_table(bc, n_plants, dtype, device)
    y = tuple(x.reshape(n_plants, n_zones).contiguous()
              for x in (state.pH, state.chlorine, state.temperature))
    return ptab, btab, y


def max_err(a, b) -> float:
    """Largest absolute difference of two kernel results, final states and
    recorded trajectories."""
    err = max(float((x - y).abs().max()) for x, y in zip(a[:3], b[:3]))
    if a[3] is not None:
        err = max(err, max(float((x - y).abs().max())
                           for x, y in zip(a[3], b[3])))
    return err


def b1_vs_plain(n_zones, n_plants, dtype, device, *, substeps,
                stages: Optional[int], n_steps, record_every=None):
    """Kernel B1 and its plain version on one set of CUDA inputs; returns
    the kernel's result and the largest difference."""
    ptab, btab, y = tables(n_zones, n_plants, dtype, device)
    kw = dict(dt=DT, substeps=substeps, n_steps=n_steps, stages=stages,
              record_every=record_every)
    got = F.rollout_kernel(ptab, btab, *y, **kw)
    torch.cuda.synchronize()
    return got, max_err(got, F.rollout_plain(ptab, btab, *y, **kw))


def b2_vs_plain(n_zones, n_plants, dtype, device, *, substeps,
                stages: Optional[int], n_steps, record_every=None):
    """Kernel B2 and its plain version on ``bench_schedule(n_steps)``."""
    ptab, _, y = tables(n_zones, n_plants, dtype, device)
    sched = F.schedule_table(bench_schedule(n_steps), n_steps, dtype, device)
    kw = dict(dt=DT, substeps=substeps, stages=stages,
              record_every=record_every)
    got = F.scheduled_kernel(ptab, sched, *y, **kw)
    torch.cuda.synchronize()
    return got, max_err(got, F.scheduled_plain(ptab, sched, *y, **kw))


def constant_schedule_equals_b1(n_zones, n_plants, dtype, device, *,
                                substeps, stages: Optional[int],
                                n_steps) -> bool:
    """Whether B2 on a schedule that repeats B1's boundary row gives B1's
    final state bit for bit."""
    ptab, btab, y = tables(n_zones, n_plants, dtype, device)
    const = btab[:, :1].T.expand(n_steps, -1).contiguous()
    b1 = F.rollout_kernel(ptab, btab, *y, dt=DT, substeps=substeps,
                          n_steps=n_steps, stages=stages)
    b2 = F.scheduled_kernel(ptab, const, *y, dt=DT, substeps=substeps,
                            stages=stages)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(b1[:3], b2[:3]))


def b1_vs_cpu(n_plants, device, *, substeps, n_steps) -> float:
    """Largest difference of float64 B1 on the card from the plain version
    on the CPU, the path the CPU suite holds to the JAX package."""
    ptab, btab, y = tables(20, n_plants, torch.float64, device)
    kw = dict(dt=DT, substeps=substeps, n_steps=n_steps, stages=None)
    got = F.rollout_kernel(ptab, btab, *y, **kw)
    ref = F.rollout_plain(ptab.cpu(), btab.cpu(), *(x.cpu() for x in y),
                          **kw)
    return max(float((a.cpu() - b).abs().max())
               for a, b in zip(got[:3], ref[:3]))
