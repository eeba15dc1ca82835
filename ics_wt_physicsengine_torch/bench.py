"""
The repository bench of the PyTorch port: every row of the JAX package's
``bench.py`` on its own shapes, printed as one JSON line.

    python -m ics_wt_physicsengine_torch.bench [--device {cuda,cpu}]
        [--quick] [--out FILE]

The card is the default. ``--device cpu`` is an explicit request, and the
line then says ``"platform": "cpu"``; asking for the card on a host without
one prints ``{"ok": false, "reason": ...}`` and exits 1. Nothing falls back
to the CPU. The numbers count only from a CUDA card: the line names it,
with its power limit as ``nvidia-smi`` gives it.

Each row is one function under ``bench.py``'s name and keyword arguments
(plus ``device`` and ``run``), built as ``bench.py`` builds it: the same
configuration, boundary, substeps or RKC plan, schedule, seeds and widths.
Its inputs come from one function per row (``*_inputs``), which the CPU tests
hold against the JAX package. Randomness is a seeded ``torch.Generator`` or
kernel B3's Philox stream, where ``bench.py`` has PRNG keys.

Timing (``_timed_chained``): a short warm-up call (the kernels build at
first use), a second short call on the host clock that sizes the row, then
as many of ``bench.py``'s ``reps`` calls as ``BUDGET_S`` allows, at least
one, each fed the last call's output and timed with CUDA events. Only where
one call at ``bench.py``'s ``n_steps`` would take longer than
``CALL_LIMIT_S`` is ``n_steps`` cut. Widths (plants, zones, members,
gains, batch) are never cut. ``--quick`` cuts depth only (steps and reps,
``QUICK``) and keeps every row. Every cut is listed in ``extra.reduced``
with the row, what was cut and ``bench.py``'s value.

Beside ``bench.py``'s keys the line carries ``*_kernel`` rates (the same
ensembles through kernels B1 and B3, as a user of the port runs them on the
card), ``philox_prng_*`` for ``bench.py``'s ``hw_prng_*`` (B3's Philox
readings against the plain path's ``torch.Generator``), the ``bench_plant``
row (``tools/bench_plant_tpu.py``'s six instrumented-plant configurations,
``plant_*_plant_steps_per_sec`` and their ``_kernel`` rates through B3), and
per row the kernel calls made and the launches counted (``extra.rows``).
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import platform
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch import control as C
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.device import resolve_device
from ics_wt_physicsengine_torch.models import make_monte_carlo_batch
from ics_wt_physicsengine_torch.models import plant as P
from ics_wt_physicsengine_torch.models import surrogate as SG
from ics_wt_physicsengine_torch.models import surrogate_checks as SC
from ics_wt_physicsengine_torch.ops import fused_plant as FP
from ics_wt_physicsengine_torch.ops import fused_rollout as F
from ics_wt_physicsengine_torch.ops import ph_solver as PS

BASELINE_STEPS_PER_S = 31.0   # the reference, 20 zones, one CPU core
DT = 1.0
F32 = torch.float32
METRIC = "single-plant steps/sec (20 zones, dt=1s; == real-time factor)"
# seconds of timed calls one measurement may take before its reps are
# cut, and the longest one call may take before its n_steps is (so every
# row runs at least one call at bench.py's n_steps where that fits)
BUDGET_S = 60.0
CALL_LIMIT_S = 300.0
# --quick: the depth of each row (its widths stay bench.py's)
QUICK = {
    "bench_single_plant": dict(n_steps=64, reps=1),
    "bench_scheduled": dict(n_steps=64, reps=1),
    "bench_integrated_single": dict(n_steps=16, reps=1),
    "bench_batched": dict(n_steps=1, reps=1),
    "bench_integrated": dict(n_steps=1, reps=1),
    "bench_full_chemistry": dict(n_steps=1, reps=1),
    "bench_closed_loop": dict(n_steps=2, reps=1),
    "bench_ekf": dict(n_steps=2, reps=1),
    "bench_enkf": dict(n_steps=2, reps=1),
    "bench_surrogate": dict(n_steps=4, reps=1, train_steps=2),
    "bench_philox_stats": dict(n_steps=128, rounds=2),
    "bench_plant": dict(n_steps=2, reps=1),
}


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclass
class BenchRun:
    """What one bench run carries across its rows: the device, the depth,
    the cuts made (``reduced``) and the kernel calls made (``calls``)."""
    device: torch.device
    quick: bool = False
    budget_s: float = BUDGET_S
    call_limit_s: float = CALL_LIMIT_S
    reduced: List[dict] = field(default_factory=list)
    calls: Dict[str, int] = field(default_factory=dict)
    log: Callable = _log

    def cut(self, row: str, what: str, value, bench_py) -> None:
        self.reduced.append(dict(row=row, cut=what, value=value,
                                 bench_py=bench_py))
        self.log(f"{row}: {what} cut from {bench_py} to {value}")

    def call(self, fn, x, n: int, kernel: Optional[str]):
        """``fn(x, n)``, counted as one call of ``kernel`` on the card, and
        of each other kernel its wrapper launches (``WRAPPER_LAUNCHES``;
        None: a plain path, which launches none)."""
        if kernel is not None and self.device.type == "cuda":
            for name in WRAPPER_LAUNCHES.get(kernel, (kernel,)):
                self.calls[name] = self.calls.get(name, 0) + 1
        return fn(x, n)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _run(run: Optional[BenchRun], device) -> BenchRun:
    return BenchRun(resolve_device(device)) if run is None else run


# The kernels one wrapper call launches, where it launches more than its
# own: B3's wrapper packs its tables first (fused_plant.pack_tables).
WRAPPER_LAUNCHES = {"plant_rollout_fused": ("pack_tables",
                                            "plant_rollout_fused")}


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters (B1, B2, B3 and its table pack, B4),
    summed since their last reset."""
    return {**F.LAUNCHES, **FP.LAUNCHES, **PS.LAUNCHES}


def _timed_call(run: BenchRun, fn, x, n: int, kernel):
    """Seconds of one call ``fn(x, n)`` (CUDA events on the card, the host
    clock on the CPU) and its output."""
    run.sync()
    if run.device.type != "cuda":
        t0 = time.perf_counter()
        x = run.call(fn, x, n, kernel)
        return time.perf_counter() - t0, x
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    x = run.call(fn, x, n, kernel)
    end.record()
    torch.cuda.synchronize(run.device)
    return start.elapsed_time(end) / 1e3, x


def _timed_chained(run: BenchRun, row: str, fn, x, n_steps: int, reps: int,
                   kernel: Optional[str] = None):
    """Time calls ``x = fn(x, n)``, each fed the last call's output (so no
    two calls see the same inputs, and the rate is the sustained one).

    A warm-up call of a few steps, then (except at ``--quick``) a second
    short call on the host clock sizes one call at ``n_steps``: past the
    call limit, ``n_steps`` is cut to fit it. Then up to ``reps`` calls,
    while the budget lasts, at least one. Returns ``(seconds per call,
    n_steps timed, x)``."""
    warm = max(1, min(n_steps, n_steps // 64))
    x = run.call(fn, x, warm, kernel)
    run.sync()
    n = n_steps
    if not run.quick:
        t0 = time.perf_counter()
        x = run.call(fn, x, warm, kernel)
        run.sync()
        per_step = (time.perf_counter() - t0) / warm
        if per_step * n_steps > run.call_limit_s:
            n = max(warm, int(run.call_limit_s / per_step))
            run.cut(row, "n_steps", n, n_steps)
    times: List[float] = []
    while len(times) < reps:
        seconds, x = _timed_call(run, fn, x, n, kernel)
        times.append(seconds)
        if sum(times) + seconds > run.budget_s:
            break
    if len(times) < reps and not run.quick:
        run.cut(row, "reps", len(times), reps)
    return sum(times) / len(times), n, x


# ---------------------------------------------------------------------------
# Inputs, one function per row (bench.py's configurations)
# ---------------------------------------------------------------------------

def _contact_tank(**kw) -> R.ReactorConfiguration:
    """bench.py's 20-zone contact tank (1000 L, 2 m, 0.798 m across)."""
    return R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                  n_zones=kw.pop("n_zones", 20), **kw)


def bench_schedule(n_steps: int, **constant) -> R.BoundaryConditions:
    """bench.py's dosing schedule (its float32 arrays): sinusoidal inflow,
    square-wave inlet chlorine and acid; ``constant`` adds scalar fields."""
    t = np.arange(n_steps)
    return R.BoundaryConditions(
        inlet_flow_rate=(5.0 + 2.0 * np.sin(2 * np.pi * t / 17.0)
                         ).astype(np.float32),
        inlet_pH=7.2,
        inlet_chlorine=np.where(t % 10 < 5, 0.5, 1.5).astype(np.float32),
        acid_flow_rate=np.where(t % 8 < 4, 0.0, 0.3).astype(np.float32),
        **constant)


def single_plant_inputs(dtype=F32, device=None):
    """bench_single_plant's plant: ``(config, params, state, boundary)``."""
    config = _contact_tank(flow_rate=5.0, initial_pH=7.0,
                           initial_chlorine=2.0, temperature=20.0)
    bc = R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
        inlet_temperature=26.0, acid_flow_rate=0.1,
        ambient_temperature=15.0, heat_loss_coefficient=50.0)
    dev = resolve_device(device)
    return (config, R.make_params(config, dtype=dtype, device=dev),
            R.make_initial_state(config, dtype=dtype, device=dev), bc)


def scheduled_inputs(n_steps: int, dtype=F32, device=None):
    """bench_scheduled's plant and schedule: ``(config, params, state,
    schedule)``."""
    config = _contact_tank()
    dev = resolve_device(device)
    return (config, R.make_params(config, dtype=dtype, device=dev),
            R.make_initial_state(config, dtype=dtype, device=dev),
            bench_schedule(n_steps, ambient_temperature=15.0,
                           heat_loss_coefficient=50.0))


def integrated_single_inputs(n_steps: int, dtype=F32, device=None):
    """bench_integrated_single's instrumented plant, its constant boundary
    and its HIL schedule: ``(config, params, plant, boundary, schedule)``."""
    config = _contact_tank()
    params, plant = P.make_plant(config, dtype=dtype, device=device)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5, acid_flow_rate=0.1)
    return config, params, plant, bc, bench_schedule(n_steps)


def batched_inputs(n_plants: int, dtype=F32, device=None):
    """bench_batched's Monte-Carlo ensemble (seed 0): ``(params, state,
    boundary)``."""
    params, state = make_monte_carlo_batch(
        R.ReactorConfiguration(n_zones=20), n_plants, seed=0, dtype=dtype,
        device=device)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.5,
                              inlet_chlorine=0.3)
    return params, state, bc


def integrated_inputs(n_plants: int, dtype=F32, device=None):
    """bench_integrated's instrumented ensemble (seed 1): ``(config,
    params, plant, boundary)``."""
    config = _contact_tank()
    params, plant = P.make_plant_batch(config, n_plants, seed=1, dtype=dtype,
                                       device=device)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5, acid_flow_rate=0.1)
    return config, params, plant, bc


# tools/bench_plant_tpu.py's configurations: (tag, plants, steps, RKC-fast)
PLANT_CONFIGS = (("plant_single_rk4", 1, 2048, False),
                 ("plant_single_rkc", 1, 2048, True),
                 ("plant_batch1024_rk4", 1024, 256, False),
                 ("plant_batch4096_rk4", 4096, 128, False),
                 ("plant_batch4096_rkc", 4096, 128, True),
                 ("plant_batch16384_rkc", 16384, 64, True))


def plant_bench_inputs(n_plants: int, dtype=F32, device=None):
    """bench_plant's instrumented plant (``tools/bench_plant_tpu.py``: one
    plant, or a batch randomized from seed 1) and its boundary:
    ``(config, params, plant, boundary)``."""
    config = _contact_tank()
    if n_plants == 1:
        params, plant = P.make_plant(config, dtype=dtype, device=device)
    else:
        params, plant = P.make_plant_batch(config, n_plants, seed=1,
                                           dtype=dtype, device=device)
    bc = R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
        inlet_temperature=26.0, acid_flow_rate=0.1,
        ambient_temperature=15.0, heat_loss_coefficient=50.0)
    return config, params, plant, bc


def plant_bench_plan(config, rkc: bool):
    """A ``PLANT_CONFIGS`` entry's ``(substeps, stages)``: the RKC2 plan of
    mode ``fast``, or RK4's ``default_substeps``."""
    if rkc:
        return R.default_rkc_plan(config, DT, mode="fast")
    return R.default_substeps(config, DT), None


def plant_bench_plain(params, plant, bc, substeps: int, stages, n_steps: int,
                      generator=None):
    """``tools/bench_plant_tpu.py``'s plain rollout, ``record=False``:
    ``plant_rollout`` for one plant, ``plant_rollout_batched`` for a batch.
    Returns the plant."""
    if plant.reactor.pH.ndim == 1:
        return P.plant_rollout(params, plant, bc, DT, substeps, n_steps,
                               record=False, stages=stages,
                               generator=generator)[0]
    return P.plant_rollout_batched(params, plant, bc, DT, substeps, n_steps,
                                   record=False, stages=stages,
                                   generator=generator)[0]


def full_chemistry_inputs(n_plants: int, dtype=F32, device=None):
    """bench_full_chemistry's six-axis ensemble (seed 0): ``(params,
    state, boundary)``."""
    params, state = make_monte_carlo_batch(
        P.full_chemistry_config(n_zones=20), n_plants, seed=0, dtype=dtype,
        device=device)
    return params, state, P.full_chemistry_boundary()


def closed_loop_inputs(n_gains: int, dtype=F32, device=None):
    """bench_closed_loop's gain grid (k x k x 4 x 4 dual-PID lanes), its
    state, carries and boundary, every leaf per lane: ``(config, params,
    state, gains, carry, boundary)``."""
    dev = resolve_device(device)
    config = _contact_tank(initial_chlorine=0.5)
    k = int(round((n_gains / 16) ** 0.5))
    gains = C.make_gain_grid(
        kp_cl=np.linspace(0.05, 3.0, k), ki_cl=np.linspace(0.0, 0.25, k),
        kp_ph=np.linspace(-2.0, -0.1, 4), ki_ph=np.linspace(-0.2, 0.0, 4),
        dtype=dtype, device=dev)
    n = C.n_gains(gains)
    params = R.make_params(config, dtype=dtype, device=dev)
    state = R.make_initial_state(config, dtype=dtype, device=dev)
    state = R.ReactorState(**{
        k_: (None if v is None else v.expand((n,) + tuple(v.shape)).clone())
        for k_, v in vars(state).items()})
    carry = C.make_dual_pid_carry((n,), dtype, dev)
    # the closed loop returns per-lane commands, so every boundary leaf is
    # a [n] tensor from the start (bench.py:336-344)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5)
    bc = R.BoundaryConditions(**{
        k_: (None if v is None else torch.full((n,), float(v), dtype=dtype,
                                               device=dev))
        for k_, v in vars(bc).items()})
    return config, params, state, gains, carry, bc


_TAPS = [("pH", 0), ("pH", -1), ("chlorine", -1), ("temperature", -1)]


def _readings(shape, seed: int, dtype, device):
    """bench.py's measurement sequence ``[7.2, 7.2, 2.0, 20.0] + 0.02 N``,
    drawn on the CPU from ``seed`` so every device gets the same values."""
    g = torch.Generator().manual_seed(seed)
    base = torch.tensor([7.2, 7.2, 2.0, 20.0], dtype=dtype)
    return (base + 0.02 * torch.randn(shape + (len(_TAPS),), generator=g,
                                      dtype=dtype)).to(device)


def ekf_inputs(n_filters: int, n_steps: int, dtype=F32, device=None):
    """bench_ekf's bank of 6-zone EKFs: ``(step, carry, readings,
    boundary)``; the step is natively batched (``torch.func.vmap`` of the
    Jacobian over the filters)."""
    dev = resolve_device(device)
    config = _contact_tank(n_zones=6)
    params = R.make_params(config, dtype=dtype, device=dev)
    step = C.make_ekf(params, 6, _TAPS, DT, R.default_substeps(config, DT),
                      measurement_noise=4e-4)
    one = C.make_ekf_carry(R.make_initial_state(config, dtype=dtype,
                                                device=dev),
                           p0=(0.05, 1.0, 4.0), n_zones=6)
    carry = C.EKFCarry(x=one.x.expand(n_filters, -1).clone(),
                       P=one.P.expand(n_filters, -1, -1).clone())
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5)
    return step, carry, _readings((n_steps, n_filters), 0, dtype, dev), bc


def enkf_inputs(n_members: int, n_steps: int, dtype=F32, device=None):
    """bench_enkf's 8192-member EnKF on the 6-zone plant: ``(step, carry,
    readings, boundary)``; the carry holds a generator seeded 0."""
    dev = resolve_device(device)
    config = _contact_tank(n_zones=6)
    params = R.make_params(config, dtype=dtype, device=dev)
    step = C.make_enkf(params, 6, _TAPS, DT, R.default_substeps(config, DT),
                       measurement_noise=4e-4, inflation=1.02,
                       localization_radius=2.0)
    carry = C.make_enkf_carry(
        R.make_initial_state(config, dtype=dtype, device=dev),
        p0=(0.05, 1.0, 4.0), n_zones=6, n_ensemble=n_members,
        generator=torch.Generator(device=dev).manual_seed(0))
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5)
    return step, carry, _readings((n_steps,), 1, dtype, dev), bc


# ---------------------------------------------------------------------------
# The rows
# ---------------------------------------------------------------------------

def _rows(schedule: R.BoundaryConditions, n: int) -> R.BoundaryConditions:
    """The first ``n`` rows of a schedule (scalar fields kept)."""
    return R.BoundaryConditions(**{
        k: (v[:n] if np.ndim(v) >= 1 else v)
        for k, v in vars(schedule).items()})


def bench_single_plant(n_steps=200000, reps=3, device=None, run=None):
    """The headline: one 20-zone plant through ``rollout_fused`` (kernel
    B1), RK4 at ``default_substeps`` and RKC-fast."""
    run = _run(run, device)
    config, params, state, bc = single_plant_inputs(device=run.device)
    out = {}
    m, s = R.default_rkc_plan(config, DT, mode="fast")
    for key, substeps, stages in (
            ("single_plant_steps_per_sec",
             R.default_substeps(config, DT), None),
            ("single_plant_steps_per_sec_rkc_fast", m, s)):
        def fn(st, n, substeps=substeps, stages=stages):
            return F.rollout_fused(params, st, bc, dt=DT, substeps=substeps,
                                   stages=stages, n_steps=n)
        sec, n, _ = _timed_chained(run, f"bench_single_plant/{key}", fn,
                                   state, n_steps, reps, "rollout_fused")
        out[key] = n / sec
    return out


def bench_scheduled(n_steps=32768, reps=3, device=None, run=None):
    """One plant under bench.py's per-step schedule through
    ``rollout_scheduled_fused`` (kernel B2), RKC-fast."""
    run = _run(run, device)
    config, params, state, sched = scheduled_inputs(n_steps,
                                                    device=run.device)
    m, s = R.default_rkc_plan(config, DT, mode="fast")

    def fn(st, n):
        return F.rollout_scheduled_fused(params, st, _rows(sched, n), dt=DT,
                                         substeps=m, stages=s)
    sec, n, _ = _timed_chained(run, "bench_scheduled", fn, state, n_steps,
                               reps, "rollout_scheduled_fused")
    return {"scheduled_forcing_steps_per_sec": n / sec}


def bench_integrated_single(n_steps=16384, reps=3, device=None, run=None):
    """One instrumented plant through ``plant_rollout_fused`` (kernel B3,
    Philox, seed 7): RK4, RKC-fast and the HIL schedule."""
    run = _run(run, device)
    config, params, plant, bc, sched = integrated_single_inputs(
        n_steps, device=run.device)
    m4 = R.default_substeps(config, DT)
    m, s = R.default_rkc_plan(config, DT, mode="fast")
    out = {}
    for key, forcing, substeps, stages in (
            ("integrated_single_steps_per_sec", bc, m4, None),
            ("integrated_single_steps_per_sec_rkc_fast", bc, m, s),
            ("integrated_hil_scheduled_steps_per_sec", sched, m4, None)):
        def fn(p, n, forcing=forcing, substeps=substeps, stages=stages):
            return FP.plant_rollout_fused(
                params, p, _rows(forcing, n), dt=DT, substeps=substeps,
                stages=stages, n_steps=n, record_every=n, seed=7)[0]
        sec, n, _ = _timed_chained(run, f"bench_integrated_single/{key}",
                                   fn, plant, n_steps, reps,
                                   "plant_rollout_fused")
        out[key] = n / sec
    return out


def bench_batched(n_plants=32768, n_steps=2000, reps=3, device=None,
                  run=None):
    """Monte-Carlo ensembles, bench.py's plain ``rollout(record=False)``:
    32768 plants at RK4 3 x 4 and twice as many at RKC 1 x 4; and the same
    inputs through ``rollout_fused`` (kernel B1), the ``*_kernel`` keys."""
    run = _run(run, device)
    out = {}
    for n_batch, substeps, stages, key in (
            (n_plants, 3, None, "batched_plant_steps_per_sec"),
            (2 * n_plants, 1, 4, "batched_plant_steps_per_sec_rkc_fast")):
        params, state, bc = batched_inputs(n_batch, device=run.device)

        def plain(st, n, substeps=substeps, stages=stages):
            return R.rollout(params, st, bc, DT, substeps, n, record=False,
                             stages=stages)[0]

        def fused(st, n, substeps=substeps, stages=stages):
            return F.rollout_fused(params, st, bc, dt=DT, substeps=substeps,
                                   stages=stages, n_steps=n)
        for name, fn, kernel in ((key, plain, None),
                                 (key + "_kernel", fused, "rollout_fused")):
            sec, n, _ = _timed_chained(run, f"bench_batched/{name}", fn,
                                       state, n_steps, reps, kernel)
            out[name] = n_batch * n / sec
    return out


def bench_integrated(n_plants=65536, n_steps=512, reps=3, device=None,
                     run=None):
    """The instrumented ensemble, RKC-fast: bench.py's plain
    ``plant_rollout_batched(record=False)`` (tap lines, packed draws), and
    the same plants through ``plant_rollout_auto`` (kernel B3 on the card),
    the ``_kernel`` key."""
    run = _run(run, device)
    config, params, plant, bc = integrated_inputs(n_plants,
                                                  device=run.device)
    m, s = R.default_rkc_plan(config, DT, mode="fast")
    gen = torch.Generator(device=run.device).manual_seed(1)

    def plain(p, n):
        return P.plant_rollout_batched(params, p, bc, DT, m, n, record=False,
                                       stages=s, generator=gen)[0]

    def auto(p, n):
        return P.plant_rollout_auto(params, p, bc, DT, m, n, record=False,
                                    stages=s, seed=1)[0]
    out = {}
    for key, fn, k in (("integrated_plant_steps_per_sec", plain, None),
                       ("integrated_plant_steps_per_sec_kernel", auto,
                        "plant_rollout_fused")):
        sec, n, _ = _timed_chained(run, f"bench_integrated/{key}", fn, plant,
                                   n_steps, reps, k)
        out[key] = n_plants * n / sec
    return out


def bench_full_chemistry(n_plants=8192, n_steps=1000, reps=3, device=None,
                         run=None):
    """All six extension axes (22 fields a zone), RK4 x 3, plain
    ``rollout(record=False)``: no kernel serves the extension axes."""
    run = _run(run, device)
    params, state, bc = full_chemistry_inputs(n_plants, device=run.device)

    def fn(st, n):
        return R.rollout(params, st, bc, DT, 3, n, record=False)[0]
    sec, n, _ = _timed_chained(run, "bench_full_chemistry", fn, state,
                               n_steps, reps)
    return {"full_chemistry_plant_steps_per_sec": n_plants * n / sec}


def bench_closed_loop(n_gains=4096, n_steps=2048, reps=3, device=None,
                      run=None):
    """A dual-PID gain sweep, every lane a closed loop, RKC-fast,
    ``rollout_closed_loop(record=False)``. Returns the rate and the lanes."""
    run = _run(run, device)
    config, params, state, gains, carry, bc = closed_loop_inputs(
        n_gains, device=run.device)
    m, s = R.default_rkc_plan(config, DT, mode="fast")
    n_lanes = C.n_gains(gains)

    def fn(x, n):
        st, cc, b = x
        with torch.no_grad():
            return C.rollout_closed_loop(
                params, st, b, C.dual_pid_controller, gains, cc, DT, m, n,
                stages=s, record=False)[:3]
    sec, n, _ = _timed_chained(run, "bench_closed_loop", fn,
                               (state, carry, bc), n_steps, reps)
    return {"closed_loop_plant_steps_per_sec": n_lanes * n / sec,
            "closed_loop_n_gains": n_lanes}


def _filter_rows(row: str, run: BenchRun, step, carry, zs, bc, n_steps,
                 reps):
    def fn(c, n):
        for t in range(n):
            c, _ = step(c, zs[t], bc)
        return c
    sec, n, _ = _timed_chained(run, row, fn, carry, n_steps, reps)
    return n / sec


def bench_ekf(n_filters=1024, n_steps=256, reps=3, device=None, run=None):
    """A bank of full-state EKFs (18 states, 4 taps) on the 6-zone plant."""
    run = _run(run, device)
    step, carry, zs, bc = ekf_inputs(n_filters, n_steps, device=run.device)
    rate = _filter_rows("bench_ekf", run, step, carry, zs, bc, n_steps, reps)
    return {"ekf_filter_steps_per_sec": n_filters * rate}


def bench_enkf(n_members=8192, n_steps=256, reps=3, device=None, run=None):
    """One EnKF whose 8192 members are the device's work."""
    run = _run(run, device)
    step, carry, zs, bc = enkf_inputs(n_members, n_steps, device=run.device)
    rate = _filter_rows("bench_enkf", run, step, carry, zs, bc, n_steps,
                        reps)
    return {"enkf_member_steps_per_sec": n_members * rate}


def bench_surrogate(n_batch=65536, n_steps=256, reps=3, train_steps=200,
                    device=None, run=None):
    """The learned surrogate: bfloat16 inference of bench.py's random
    network (its output layer un-zeroed) on ``n_batch`` 6-zone states, and
    Adam steps of the one-step regression at batch 2048 (the better of two
    calls)."""
    run = _run(run, device)
    bf16 = torch.bfloat16
    sp = SC.bench_params(device=run.device)
    x0, us = SC.bench_inputs(sp, n_batch, n_steps, device=run.device)

    def fn(x, n):
        with torch.no_grad():
            for t in range(n):
                x = SG.surrogate_step(sp, x, us[t], compute_dtype=bf16)
        return x
    sec, n, _ = _timed_chained(run, "bench_surrogate", fn, x0, n_steps, reps)
    infer = n_batch * n / sec
    # synthetic transitions of the right shape: an Adam step's cost does
    # not depend on the data
    g = torch.Generator().manual_seed(3)
    n_state = sp.x_mean.shape[0]
    X = (sp.x_mean.cpu() + sp.x_std.cpu()
         * torch.randn((64, 65, n_state), generator=g)).to(run.device)
    U = torch.rand((64, 64, 1), generator=g).to(run.device)
    seconds = []
    for seed in (1, 2):
        run.sync()
        t0 = time.perf_counter()
        SG.train_surrogate(X, U, 6, seed=seed, hidden=(128, 128),
                           n_steps=train_steps, batch_size=2048,
                           rollout_steps=0, compute_dtype=bf16)
        run.sync()
        seconds.append(time.perf_counter() - t0)
    return {"surrogate_steps_per_sec": infer,
            "surrogate_train_steps_per_sec": train_steps / min(seconds)}


def bench_philox_stats(n_plants=1024, n_steps=1024, rounds=64, device=None,
                       run=None):
    """Kernel B3's production randomness (its Philox stream, Box-Muller and
    uniforms in the kernel) against the plain path's ``torch.Generator``
    over ``pH_inlet`` readings: ``rounds`` launches of 128 fresh plants
    (supply faults latch until maintenance, so chained rounds would compound
    the NaN share) recorded every 64 steps, against ``plant_rollout_batched``
    on ``n_plants`` plants recorded every step. The two must agree in mean
    (0.01 pH), spread (20%) and NaN share (0.03): bench.py's bounds."""
    run = _run(run, device)
    config = _contact_tank()
    substeps = R.default_substeps(config, DT)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5)
    hw_plants, rec_every = 128, 64
    chunks = []
    for r in range(rounds):
        params, plant = P.make_plant_batch(config, hw_plants, seed=3 + r,
                                           dtype=F32, randomize=False,
                                           device=run.device)

        def fn(p, n, params=params, r=r):
            return FP.plant_rollout_fused(params, p, bc, dt=DT,
                                          substeps=substeps, n_steps=n,
                                          record_every=rec_every,
                                          seed=11 + r, rng="philox")[1]
        rec = run.call(fn, plant, n_steps, "plant_rollout_fused")
        chunks.append(rec["pH_inlet"].cpu().numpy())
    philox = np.concatenate(chunks, axis=0)   # [rounds * slots, hw_plants]
    params2, plant2 = P.make_plant_batch(config, n_plants, seed=7, dtype=F32,
                                         randomize=False, device=run.device)
    gen = torch.Generator(device=run.device).manual_seed(7)
    oracle = P.plant_rollout_batched(params2, plant2, bc, DT, substeps,
                                     n_steps, generator=gen)[1]["pH_inlet"]
    oracle = oracle.cpu().numpy()                  # [n_steps, n_plants]
    ph_ok, or_ok = np.isfinite(philox), np.isfinite(oracle)
    ph_nan, or_nan = float(1.0 - ph_ok.mean()), float(1.0 - or_ok.mean())
    dmean = float(philox[ph_ok].mean() - oracle[or_ok].mean())
    ph_std, or_std = float(philox[ph_ok].std()), float(oracle[or_ok].std())
    return {
        "philox_prng_reads": int(philox.size),
        "philox_prng_value_mean_delta_vs_oracle": dmean,
        "philox_prng_value_std": ph_std,
        "oracle_value_std": or_std,
        "philox_prng_nan_fault_rate": ph_nan,
        "oracle_nan_fault_rate": or_nan,
        "philox_prng_ok": bool(abs(dmean) < 0.01
                               and abs(ph_std / max(or_std, 1e-9) - 1.0) < 0.2
                               and abs(ph_nan - or_nan) < 0.03),
        "noise_sigma_config": float(params.ph_inlet.base.precision.reshape(
            -1)[0]),
    }


def bench_plant(n_steps=2048, reps=3, device=None, run=None):
    """``tools/bench_plant_tpu.py``'s six configurations, 20 zones,
    ``record=False``: its plain rollout (``plant_bench_plain``) and the
    same plants through ``plant_rollout_auto`` (kernel B3 on the card), the
    ``_kernel`` keys. ``n_steps`` caps each configuration's own steps
    (2048, the most any has, cuts none)."""
    run = _run(run, device)
    out = {}
    for tag, n_plants, steps, rkc in PLANT_CONFIGS:
        config, params, plant, bc = plant_bench_inputs(n_plants,
                                                       device=run.device)
        m, s = plant_bench_plan(config, rkc)
        gen = torch.Generator(device=run.device).manual_seed(1)

        def plain(p, n, params=params, bc=bc, m=m, s=s, gen=gen):
            return plant_bench_plain(params, p, bc, m, s, n, generator=gen)

        def auto(p, n, params=params, bc=bc, m=m, s=s):
            return P.plant_rollout_auto(params, p, bc, DT, m, n,
                                        record=False, stages=s, seed=1)[0]
        key = f"{tag}_plant_steps_per_sec"
        for name, fn, kernel in ((key, plain, None),
                                 (key + "_kernel", auto,
                                  "plant_rollout_fused")):
            sec, n, _ = _timed_chained(run, f"bench_plant/{name}", fn, plant,
                                       min(steps, n_steps), reps, kernel)
            out[name] = n_plants * n / sec
    return out


ROWS = (bench_single_plant, bench_scheduled, bench_integrated_single,
        bench_batched, bench_integrated, bench_full_chemistry,
        bench_closed_loop, bench_ekf, bench_enkf, bench_surrogate,
        bench_philox_stats, bench_plant)
# the kernel each row launches on the card, once a call (the other rows
# run plain PyTorch and launch none)
KERNEL_ROWS = {"bench_single_plant": "rollout_fused",
               "bench_scheduled": "rollout_scheduled_fused",
               "bench_integrated_single": "plant_rollout_fused",
               "bench_batched": "rollout_fused",
               "bench_integrated": "plant_rollout_fused",
               "bench_philox_stats": "plant_rollout_fused",
               "bench_plant": "plant_rollout_fused"}
# every rate of the line (each must be finite and > 0)
RATES = ("single_plant_steps_per_sec", "single_plant_steps_per_sec_rkc_fast",
         "batched_plant_steps_per_sec", "batched_plant_steps_per_sec_rkc_fast",
         "batched_plant_steps_per_sec_kernel",
         "batched_plant_steps_per_sec_rkc_fast_kernel",
         "full_chemistry_plant_steps_per_sec",
         "integrated_plant_steps_per_sec",
         "integrated_plant_steps_per_sec_kernel",
         "integrated_single_steps_per_sec",
         "integrated_single_steps_per_sec_rkc_fast",
         "integrated_hil_scheduled_steps_per_sec",
         "scheduled_forcing_steps_per_sec", "closed_loop_plant_steps_per_sec",
         "ekf_filter_steps_per_sec", "enkf_member_steps_per_sec",
         "surrogate_steps_per_sec", "surrogate_train_steps_per_sec") + tuple(
             f"{tag}_plant_steps_per_sec{kind}" for tag, *_ in PLANT_CONFIGS
             for kind in ("", "_kernel"))


def device_info(dev: torch.device) -> dict:
    """``extra.device``: the platform, the card's name and power limit as
    ``nvidia-smi`` gives them, and the torch build."""
    build = f"{torch.__version__} cuda {torch.version.cuda}"
    if dev.type != "cuda":
        return {"platform": "cpu",
                "name": platform.processor() or platform.machine(),
                "power_limit_w": None, "torch": build}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[dev.index or 0]
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return {"platform": "gpu", "name": name,
            "power_limit_w": float(limit.split()[0]), "torch": build}


def run_rows(run: BenchRun) -> dict:
    """Every row in ``ROWS`` order on ``run``: their keys, and per row its
    seconds, the kernel calls it made and the launches counted."""
    extra: dict = {}
    rows = {}
    for row in ROWS:
        kwargs = {}
        if run.quick:
            defaults = inspect.signature(row).parameters
            for name, value in QUICK[row.__name__].items():
                kwargs[name] = value
                run.cut(row.__name__, name, value, defaults[name].default)
        calls0, launches0 = dict(run.calls), launch_counts()
        t0 = time.perf_counter()
        extra.update(row(run=run, **kwargs))
        run.sync()
        launches1 = launch_counts()
        rows[row.__name__] = dict(
            seconds=time.perf_counter() - t0,
            calls={k: v - calls0.get(k, 0) for k, v in run.calls.items()
                   if v != calls0.get(k, 0)},
            launches={k: v - launches0[k] for k, v in launches1.items()
                      if v != launches0[k]})
        run.log(f"{row.__name__} done in {rows[row.__name__]['seconds']:.1f}"
                " s")
    extra["rows"] = rows
    return extra


def bench(run: BenchRun) -> dict:
    """The whole bench on ``run``: bench.py's line, its ``extra`` keys
    (``philox_prng_*`` for ``hw_prng_*``), the ``*_kernel`` rates,
    ``reduced`` and ``rows``."""
    t0 = time.perf_counter()
    extra = run_rows(run)
    single = extra.pop("single_plant_steps_per_sec")
    rates = [single] + [extra[k] for k in RATES[1:]]
    extra.update({
        "rkc_fast_vs_baseline": (extra["single_plant_steps_per_sec_rkc_fast"]
                                 / BASELINE_STEPS_PER_S),
        "batched_n_plants": 32768,
        "batched_n_plants_rkc": 65536,
        "full_chemistry_n_plants": 8192,
        "full_chemistry_axes": ("nitrogen+gas+particles+disinfection"
                                "+biofilm+phase"),
        "integrated_n_plants": 65536,
        "ekf_n_filters": 1024,
        "ekf_state_dim": 18,
        "enkf_n_members": 8192,
        "surrogate_n_batch": 65536,
        "surrogate_compute_dtype": "bfloat16",
        "backend": run.device.type,
        "device": device_info(run.device),
        "quick": run.quick,
        "reduced": run.reduced,
        "seconds": time.perf_counter() - t0,
    })
    return {
        "metric": METRIC,
        "value": single,
        "unit": "steps/s",
        "vs_baseline": single / BASELINE_STEPS_PER_S,
        "ok": bool(all(math.isfinite(x) and x > 0 for x in rates)
                   and extra["philox_prng_ok"]),
        "extra": extra,
    }


def _emit(result: dict, out: Optional[str]) -> None:
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ics_wt_physicsengine_torch.bench",
        description="every row of bench.py through the port, one JSON line")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; no fallback) or cpu, an explicit "
                         "request for the plain PyTorch paths on the host")
    ap.add_argument("--quick", action="store_true",
                    help="cut every row's depth (steps, reps), keep its "
                         "widths")
    ap.add_argument("--out", default=None, help="also write the line here")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from ics_wt_physicsengine_torch.utils.backend_select import (
            ensure_default_backend)
        try:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available")
            ensure_default_backend(min_devices=1, log=_log)
        except RuntimeError as e:
            _emit({"metric": METRIC, "ok": False,
                   "reason": f"the card was asked for: {e}"}, args.out)
            return 1
    run = BenchRun(torch.device(args.device), quick=args.quick)
    run.log(f"device {run.device}; quick={run.quick}")
    result = bench(run)
    _emit(result, args.out)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
