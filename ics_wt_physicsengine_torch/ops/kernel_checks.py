"""
Kernels B1, B2, B3 and B4 held against their plain PyTorch versions on the
same CUDA inputs: the tables, schedules, cases and tolerances that
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` share.

Tolerances: the kernels are built without FMA contraction and the plain
versions divide as the kernels do, so both round every operation alike and
agree bit for bit where PyTorch's elementwise exp is the device's. The
bounds, float64 1e-12 and float32 1e-4, leave room for a last-bit
difference carried over a few hundred evaluations and are small enough to
catch a flipped stratification switch (Ri > 0.25), which moves a state by
~1e-3. Against the plain version on the CPU (whose exp may differ from the
card's in the last bit) the float64 bound is ``CPU_TOL``.

B3 adds the instruments, whose pipeline compares against thresholds (the
1e-4 fault roll, the [20, 28] V window, range and rate limits): a last-bit
difference in a normal draw could flip one and change a reading outright.
Uniforms are exact (24 bits times 2^-24), and the normals' ``log``,
``sqrt``, ``cos`` and ``sin`` and the chlorine sensor's ``10 ** x`` are the
same device functions on both sides, so B3 is held to the same ``TOL`` on
every float (state, the 94 float carry columns, rebuilt rings, readings),
with NaN in the same places and the 28 integer carry columns equal.

B4 (the Newton pH solve) tests ``|delta| < tolerance`` every iteration, and
in float32 the default tolerance lies below the resolution of pH near the
root, so one differently rounded operation would move a non-converged
element by up to the decayed step cap (~1e-2). Kernel and plain version do
the same operations in the same order on the same ``exp``, whatever
element a lane takes when, so they must agree bit for bit, with NaN in the
same places.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import chemistry as chem
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.models import plant as P
from ics_wt_physicsengine_torch.models.monte_carlo import (
    make_monte_carlo_batch)
from ics_wt_physicsengine_torch.ops import fused_plant as FP
from ics_wt_physicsengine_torch.ops import fused_rollout as F
from ics_wt_physicsengine_torch.ops import ph_solver as PS

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


def fleet_schedule(n_steps: int, n_plants: int) -> R.BoundaryConditions:
    """A fleet chunk's forcing, ``[n_steps, n_plants]`` fields: each lane
    slews its acid and chlorine pumps and its inlet valve from its own start
    toward its own command, as ``fleet._stack_boundary_schedule`` lays a
    chunk out under an actuator lag. No two lanes share an inlet-flow row,
    so a schedule read from another lane's column shows."""
    t = np.arange(n_steps)[:, None]
    i = np.arange(n_plants)[None, :]
    decay = np.exp(-t / 9.0)

    def slew(start, cmd):
        return cmd + (start - cmd) * decay

    return R.BoundaryConditions(
        inlet_flow_rate=slew(5.0 + 0.5 * (i % 3) + 0.004 * i,
                             4.0 + 0.25 * (i % 5)),
        inlet_pH=7.2, inlet_chlorine=0.5,
        acid_flow_rate=slew(0.0 * i, 0.05 * (i % 4)),
        chlorine_flow_rate=slew(0.1 + 0.0 * i, 0.02 * (i % 3)),
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


# ---------------------------------------------------------------------------
# Kernel B3: the instrumented plant
# ---------------------------------------------------------------------------

# Each case names what it adds to the matrix: single plant and 64-plant
# batches at 5 and 20 zones, RK4 and RKC-fast, constant forcing and
# ``bench_schedule``, injected words and the Philox stream, every step
# recorded and every tenth, per-plant line delays, non-default zone taps,
# and both working types. 60 steps cross the 30-step sample-line delay.
# The zone-count extremes fix the block layout's extremes
# (``fused_plant.plant_geometry``): one zone packs 32 plants into a block,
# 224 sensor lanes beside one physics warp; 128 zones give two plants a
# block, eight physics warps beside one sensor warp.
B3_CASES = {
    "single-z20-rk4-const-bits": dict(
        n_zones=20, n_plants=1, integrator="rk4", scheduled=False,
        rng="bits", record_every=1),
    "single-z20-fast-sched-philox-rec10": dict(
        n_zones=20, n_plants=1, integrator="fast", scheduled=True,
        rng="philox", record_every=10),
    "batch64-z5-rk4-const-philox-rec10": dict(
        n_zones=5, n_plants=64, integrator="rk4", scheduled=False,
        rng="philox", record_every=10),
    "batch64-z20-fast-const-bits": dict(
        n_zones=20, n_plants=64, integrator="fast", scheduled=False,
        rng="bits", record_every=1),
    "batch64-z20-rk4-sched-bits-rec10-delays": dict(
        n_zones=20, n_plants=64, integrator="rk4", scheduled=True,
        rng="bits", record_every=10, delays=True),
    "batch64-z5-fast-sched-philox-taps": dict(
        n_zones=5, n_plants=64, integrator="fast", scheduled=True,
        rng="philox", record_every=1, taps=True),
    "batch64-z20-rk4-const-philox-delays-taps-f64": dict(
        n_zones=20, n_plants=64, integrator="rk4", scheduled=False,
        rng="philox", record_every=10, delays=True, taps=True,
        dtype=torch.float64),
    "single-z20-fast-sched-bits-f64": dict(
        n_zones=20, n_plants=1, integrator="fast", scheduled=True,
        rng="bits", record_every=1, dtype=torch.float64),
    "batch64-z1-rk4-const-philox-rec10-delays": dict(
        n_zones=1, n_plants=64, integrator="rk4", scheduled=False,
        rng="philox", record_every=10, delays=True),
    "batch64-z128-fast-sched-philox": dict(
        n_zones=128, n_plants=64, integrator="fast", scheduled=True,
        rng="philox", record_every=1),
    # the serving chunk's launch: the Philox counter from a global step
    # past 2^32 (it wraps) and the fault-code record; and the fault record
    # on the forced fault paths of ``plant_words``; and a fleet shard's
    # chunk: lanes from plant0 = 4 of the fleet, a schedule per lane, each
    # lane on its own clock (a resumed lane lags); and the 254-unit fleet's
    # chunk (32 blocks, the last of 6 plants) as the second shard of two,
    # plant0 = 127, not a multiple of the 8 plants a block holds
    "single-z20-rk4-sched-philox-step0-faults-rec10": dict(
        n_zones=20, n_plants=1, integrator="rk4", scheduled=True,
        rng="philox", record_every=10, step0=(1 << 32) - 25, faults=True),
    "batch64-z5-rk4-sched-bits-faults": dict(
        n_zones=5, n_plants=64, integrator="rk4", scheduled=True,
        rng="bits", record_every=1, faults=True),
    "batch8-z20-rk4-lanesched-philox-plant0-clocks-faults": dict(
        n_zones=20, n_plants=8, integrator="rk4", scheduled="per_plant",
        rng="philox", record_every=4, plant0=4, clocks=True, faults=True,
        delays=True),
    "batch254-z20-rk4-lanesched-philox-plant0-clocks-faults": dict(
        n_zones=20, n_plants=254, integrator="rk4", scheduled="per_plant",
        rng="philox", record_every=4, plant0=127, clocks=True, faults=True,
        delays=True),
}
B3_STEPS = 60


def plant_plan(n_zones: int, integrator: str):
    """``(substeps, stages)`` of the default plant: RK4's
    ``default_substeps`` or the RKC2 plan of mode ``integrator``."""
    cfg = R.ReactorConfiguration(n_zones=n_zones)
    if integrator == "rk4":
        return R.default_substeps(cfg, DT), None
    return R.default_rkc_plan(cfg, DT, mode=integrator)


def _with_base(sensor_params, **changes):
    return dataclasses.replace(sensor_params, base=dataclasses.replace(
        sensor_params.base, **changes))


def plant_case(n_zones: int, n_plants: int, dtype, device, *,
               delays: bool = False, taps: bool = False, seed: int = 1,
               clocks: bool = False):
    """``(params, plant)``: ``make_plant`` when ``n_plants == 1``, else a
    ``make_plant_batch`` from ``seed``. ``delays`` gives the pH-inlet,
    pH-outlet and temperature-inlet lines per-plant delays between 0 and
    30 s (whole steps at dt = 1 s); ``taps`` moves four sensors to interior
    zones; ``clocks`` sets plant i's clock i * 37 s behind plant 0's,
    which starts at (n_plants - 1) * 37 s (a fleet whose lanes were paused
    for different spans)."""
    cfg = R.ReactorConfiguration(n_zones=n_zones)
    if n_plants == 1:
        params, plant = P.make_plant(cfg, dtype=dtype, device=device)
    else:
        params, plant = P.make_plant_batch(cfg, n_plants, seed=seed,
                                           dtype=dtype, device=device)
    if delays:
        i = torch.arange(n_plants, device=device)
        lines = {"ph_inlet": (i % 7) * 5.0, "ph_outlet": 30.0 - (i % 4) * 7.0,
                 "temp_inlet": (i % 3) * 11.0}
        if n_plants == 1:
            lines = {name: d[0] for name, d in lines.items()}
        params = dataclasses.replace(params, **{
            name: _with_base(getattr(params, name), line_delay_s=d.to(dtype))
            for name, d in lines.items()})
    if clocks:
        lead = 37.0 * torch.arange(n_plants - 1, -1, -1, device=device)
        plant = dataclasses.replace(plant, reactor=dataclasses.replace(
            plant.reactor, time=plant.reactor.time + lead.to(
                plant.reactor.time.dtype)))
    if taps:
        zones = {"ph_inlet": 2, "ph_outlet": -2, "chlorine_inlet": 3,
                 "temp_outlet": -4}
        params = dataclasses.replace(params, **{
            name: dataclasses.replace(getattr(params, name), zone_index=z)
            for name, z in zones.items()})
    return params, plant


def plant_words(n_steps: int, n_plants: int, device, seed: int = 0):
    """Injected words ``[n_steps, N_WORDS, n_plants]`` from ``seed``, with
    the fault paths forced rather than left to chance: in step 5 the
    pH-outlet sensor of plant 0 rolls an open circuit (fault-roll word 0),
    in step 7 its chlorine-outlet sensor a short circuit, and in step 9 the
    flow meter's supply voltage walks to 24 + 7.4 V (both Box-Muller words
    0) and latches a power fault."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2 ** 31, 2 ** 31,
                         size=(n_steps, FP.N_WORDS, n_plants), dtype=np.int32)
    off = FP._WORD_OFFSET

    def uniform_word(attr, kind, k):
        n_normals, _ = FP._RAND[kind]
        return off[attr] + 2 * ((n_normals + 1) // 2) + k

    if n_steps > 9:
        words[5, uniform_word("ph_outlet", "ph", 1), 0] = 0
        words[5, uniform_word("ph_outlet", "ph", 2), 0] = 0        # open
        words[7, uniform_word("chlorine_outlet", "cl", 1), 0] = 0
        words[7, uniform_word("chlorine_outlet", "cl", 2), 0] = -1  # short
        words[9, off["flow_main"], 0] = 0
        words[9, off["flow_main"] + 1, 0] = 0
    return torch.from_numpy(words).to(device)


def tree_leaves(obj, path=""):
    """``(path, tensor)`` for every tensor in a nest of dataclasses,
    dictionaries and lists."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tree_leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from tree_leaves(v, f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for k, v in enumerate(obj):
            yield from tree_leaves(v, f"{path}[{k}]")


def plant_diff(got, ref) -> dict:
    """Two ``(plant, readings)`` results leaf by leaf: the largest absolute
    difference over the floats (where neither is NaN; equal infinities count
    0), the leaf it is in, whether NaN sits in the same places, and whether
    every integer and boolean leaf is equal."""
    worst, where, nan_equal, ints_equal = 0.0, "", True, True
    for (path, a), (path_b, b) in zip(tree_leaves(got), tree_leaves(ref)):
        if path != path_b or a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"results differ in structure at {path}: "
                             f"{a.shape} {a.dtype} vs {path_b} {b.shape} "
                             f"{b.dtype}")
        if a.numel() == 0:
            continue
        if not a.is_floating_point():
            ints_equal = ints_equal and torch.equal(a, b)
            continue
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        nan_equal = nan_equal and torch.equal(nan_a, nan_b)
        d = torch.where((a == b) | nan_a | nan_b, torch.zeros_like(a),
                        (a - b).abs())
        err = float(torch.nan_to_num(d, nan=float("inf")).max())
        if err > worst:
            worst, where = err, path
    return dict(max_abs_err=worst, worst_leaf=where, nan_equal=nan_equal,
                ints_equal=ints_equal)


def _fused(run, params, plant, boundary, *, substeps, stages, n_steps,
           record_every=1, bits=None, seed=0, step0=0, plant0=0,
           record_faults=False):
    return FP._rollout_with(run, params, plant, boundary, dt=DT,
                            substeps=substeps, n_steps=n_steps,
                            stages=stages, record_every=record_every,
                            bits=bits, seed=seed, consume_line=True,
                            step0=step0, plant0=plant0,
                            record_faults=record_faults)


def b3_vs_plain(case: dict, device, n_steps: int = B3_STEPS):
    """Kernel B3 and its plain version on one ``B3_CASES`` entry, both on
    the card; returns the kernel's ``(plant, readings)`` (and its fault
    codes, for a case with ``faults``) and ``plant_diff`` of the two."""
    dtype = case.get("dtype", torch.float32)
    params, plant = plant_case(case["n_zones"], case["n_plants"], dtype,
                               device, delays=case.get("delays", False),
                               taps=case.get("taps", False),
                               clocks=case.get("clocks", False))
    substeps, stages = plant_plan(case["n_zones"], case["integrator"])
    boundary = fleet_schedule(n_steps, case["n_plants"]) \
        if case["scheduled"] == "per_plant" \
        else bench_schedule(n_steps) if case["scheduled"] else BC
    bits = plant_words(n_steps, case["n_plants"], device) \
        if case["rng"] == "bits" else None
    kw = dict(substeps=substeps, stages=stages, n_steps=n_steps,
              record_every=case["record_every"], bits=bits, seed=11,
              step0=case.get("step0", 0), plant0=case.get("plant0", 0),
              record_faults=case.get("faults", False))
    got = _fused(FP.plant_kernel, params, plant, boundary, **kw)
    torch.cuda.synchronize()
    ref = _fused(FP.plant_plain, params, plant, boundary, **kw)
    return got, plant_diff(got, ref)


def serve_chunk_vs_plain(device, n_steps: int = 120, record_every: int = 7,
                         step0: int = (1 << 32) - 50):
    """``models.plant.plant_serve_chunk`` on the card (one B3 launch, the
    Philox counter from ``step0``, the fault record) against the same chunk
    through B3's plain version on the card. Returns the chunk, ``plant_diff``
    of (plant, values, fault codes) and the launches it made."""
    params, plant = plant_case(20, 1, torch.float32, device)
    substeps, _ = plant_plan(20, "rk4")
    sched = bench_schedule(n_steps)
    FP.reset_launch_counts()
    got = P.plant_serve_chunk(params, plant, sched, dt=DT, substeps=substeps,
                              record_every=record_every, seed=11,
                              step0=step0)
    launches = FP.LAUNCHES["plant_rollout_fused"]
    every = math.gcd(n_steps, record_every)
    ref, values, faults = _fused(
        FP.plant_plain, params, plant, sched, substeps=substeps, stages=None,
        n_steps=n_steps, record_every=every, seed=11, step0=step0,
        record_faults=True)
    k = record_every // every
    ref_values = torch.stack(list(values.values()), dim=1)[k - 1::k]
    ref_faults = torch.stack(list(faults.values()), dim=1)[k - 1::k]
    torch.cuda.synchronize()
    return got, plant_diff((got.plant, got.values, got.faults),
                           (ref, ref_values, ref_faults)), launches


def _lanes(tree, lanes: slice):
    from ics_wt_physicsengine_torch.parallel.mesh import _map
    return _map(lambda x: x[lanes] if x.ndim else x, tree)


# ``fleet_chunk_vs_plain`` layouts: (lanes, paused lane, shard). Eight lanes
# fill one B3 block at 20 zones; 254 (the Modbus unit-id cap) fill 32, the
# last of 6, and the shard of lanes 127..253 starts inside a block and ends
# in a partial one of 7.
FLEET_CHUNK_CASES = {
    "fleet8": (8, 3, slice(4, 8)),
    "fleet254": (254, 200, slice(127, 254)),
}


def fleet_chunk_vs_plain(device, n_lanes: int = 8, n_steps: int = 120,
                         record_every: int = 4, paused: int = 3,
                         shard: slice = slice(4, 8)):
    """A fleet's chunk on the card (``fleet.serve_chunk_masked``: one B3
    launch over every lane, each lane on its own clock, line delays and
    slewing schedule, lane ``paused`` frozen) against B3's plain version on
    the card with the paused lane put back; and the chunk of lanes
    ``shard`` alone with ``plant0 = shard.start`` against those lanes of the
    whole chunk. Returns ``plant_diff`` of each and the whole chunk's
    launches."""
    from ics_wt_physicsengine_torch import fleet

    params, plant = plant_case(20, n_lanes, torch.float32, device,
                               delays=True, clocks=True)
    substeps, _ = plant_plan(20, "rk4")
    sched = fleet_schedule(n_steps, n_lanes)
    sched = R.BoundaryConditions(**{
        f.name: (torch.as_tensor(getattr(sched, f.name), dtype=torch.float32,
                                 device=device)
                 if np.ndim(getattr(sched, f.name)) else
                 getattr(sched, f.name))
        for f in dataclasses.fields(sched)})
    mask = torch.ones(n_lanes, dtype=torch.bool, device=device)
    mask[paused] = False
    kw = dict(dt=DT, substeps=substeps, record_every=record_every, seed=11,
              step0=5000)
    FP.reset_launch_counts()
    got = fleet.serve_chunk_masked(params, plant, sched, mask, **kw)
    launches = FP.LAUNCHES["plant_rollout_fused"]
    ref, values, faults = _fused(
        FP.plant_plain, params, plant, sched, substeps=substeps, stages=None,
        n_steps=n_steps, record_every=record_every, seed=11, step0=5000,
        record_faults=True)
    ref = fleet.select_lanes(mask, ref, plant)
    whole = plant_diff((got.plant, got.values, got.faults),
                       (ref, torch.stack(list(values.values()), dim=1),
                        torch.stack(list(faults.values()), dim=1)))
    part = fleet.serve_chunk_masked(
        _lanes(params, shard), _lanes(plant, shard),
        fleet._lane_rows(sched, shard, device), mask[shard],
        plant0=shard.start, **kw)
    torch.cuda.synchronize()
    sharded = plant_diff((part.plant, part.values, part.faults),
                         (_lanes(got.plant, shard), got.values[..., shard],
                          got.faults[..., shard]))
    return dict(whole=whole, shard=sharded, launches=launches)


def serve_chunks_invariant(device, sizes=(16, 16), record_every: int = 4):
    """Whether ``plant_serve_chunk`` in chunks of ``sizes`` (each passing
    its global step as ``step0``) gives the plant, the record and the last
    readings of one chunk of their sum, bit for bit, on ``device``."""
    params, plant = plant_case(20, 1, torch.float32, device)
    substeps, _ = plant_plan(20, "rk4")
    n = sum(sizes)
    full = bench_schedule(n)

    def part(a, b):
        return R.BoundaryConditions(**{
            f.name: (getattr(full, f.name)[a:b]
                     if np.ndim(getattr(full, f.name)) else
                     getattr(full, f.name))
            for f in dataclasses.fields(full)})

    kw = dict(dt=DT, substeps=substeps, record_every=record_every, seed=11)
    whole = P.plant_serve_chunk(params, plant, full, step0=0, **kw)
    p, values, faults, start = plant, [], [], 0
    for size in sizes:
        c = P.plant_serve_chunk(params, p, part(start, start + size),
                                step0=start, **kw)
        p, start = c.plant, start + size
        values.append(c.values)
        faults.append(c.faults)
    d = plant_diff((p, torch.cat(values), torch.cat(faults), c.last),
                   (whole.plant, whole.values, whole.faults, whole.last))
    return d["max_abs_err"] == 0.0 and d["nan_equal"] and d["ints_equal"]


def b3_constant_schedule_equals_constant(n_zones, n_plants, device, *,
                                         integrator, n_steps=40) -> bool:
    """Whether B3 on a schedule that repeats ``BC`` every step gives the
    constant-forcing result bit for bit: state, carries, rings and
    readings."""
    params, plant = plant_case(n_zones, n_plants, torch.float32, device)
    substeps, stages = plant_plan(n_zones, integrator)
    const = R.BoundaryConditions(**{
        f.name: np.full(n_steps, getattr(BC, f.name))
        for f in dataclasses.fields(BC) if getattr(BC, f.name) is not None})
    kw = dict(substeps=substeps, stages=stages, n_steps=n_steps,
              record_every=4, seed=5)
    a = _fused(FP.plant_kernel, params, plant, BC, **kw)
    b = _fused(FP.plant_kernel, params, plant, const, **kw)
    torch.cuda.synchronize()
    d = plant_diff(a, b)
    return d["max_abs_err"] == 0.0 and d["nan_equal"] and d["ints_equal"]


def b3_chained(device, n_plants: int = 8, n_zones: int = 5,
               segment: int = 20) -> dict:
    """Plain, kernel, plain against plain three times, ``segment`` steps
    each on per-plant line delays of up to 30 steps: the kernel segment
    consumes rings the plain version wrote (lead-in) and hands on rings it
    rebuilt (write-back). Returns ``plant_diff`` of the two chains' ends."""
    params, plant0 = plant_case(n_zones, n_plants, torch.float32, device,
                                delays=True)
    substeps, stages = plant_plan(n_zones, "rk4")
    words = plant_words(3 * segment, n_plants, device, seed=3)
    ends = []
    for runs in ((FP.plant_plain, FP.plant_kernel, FP.plant_plain),
                 (FP.plant_plain,) * 3):
        plant, rows = plant0, []
        for k, run in enumerate(runs):
            plant, readings = _fused(
                run, params, plant, BC, substeps=substeps, stages=stages,
                n_steps=segment,
                bits=words[k * segment:(k + 1) * segment].contiguous())
            rows.append(readings)
        ends.append((plant, rows))
    torch.cuda.synchronize()
    return plant_diff(*ends)


def philox_statistics(device, n_steps: int = 64, n_plants: int = 256,
                      seed: int = 2024) -> dict:
    """The kernel's own generator on the card: whether its words equal the
    plain version's integer-arithmetic stream, and the mean and variance of
    the ~1.2e6 uniforms and as many normals they give, with the rate of
    ``u < 1e-4`` (the open/short fault roll)."""
    words = FP.philox_words_kernel(seed, n_steps, n_plants, device)
    torch.cuda.synchronize()
    same = torch.equal(words, FP.philox_words(seed, 0, n_steps, n_plants,
                                              device))
    even, odd = words.reshape(-1)[0::2], words.reshape(-1)[1::2]
    n, u = FP.rand_from_words([even, odd, even, odd], 2, 2,
                              dtype=torch.float64)
    u, n = u.reshape(-1), n.reshape(-1)
    return dict(words_equal_plain=same, count=int(u.numel()),
                uniform_mean=float(u.mean()), uniform_var=float(u.var()),
                uniform_min=float(u.min()), uniform_max=float(u.max()),
                rate_below_1e_4=float((u < 1e-4).double().mean()),
                normal_mean=float(n.mean()), normal_var=float(n.var()),
                normal_abs_max=float(n.abs().max()))


# Bounds of ``philox_statistics`` at its default 1.2e6 draws: five standard
# errors of each estimate (uniform mean 2.6e-4, variance 6.7e-5 from its
# fourth moment; rate 9e-6; normal mean 9e-4, variance 1.3e-3).
PHILOX_BOUNDS = dict(uniform_mean=(0.5, 1.4e-3),
                     uniform_var=(1.0 / 12.0, 4e-4),
                     rate_below_1e_4=(1e-4, 5e-5),
                     normal_mean=(0.0, 5e-3), normal_var=(1.0, 7e-3))


# ---------------------------------------------------------------------------
# Kernel B4: the Newton pH solve
# ---------------------------------------------------------------------------

# Element counts around a warp (1, 7, 31, 33), around the block size of
# 256 (129, 1025), the 65,536-water batch and one more, a batch above the
# card's resident lanes (300,000: the lanes take new elements from the
# launch's counter), a small and a plants-by-zones 2-D shape; a batch with
# three degenerate waters; ``iters`` 0, 1 and 7; ``tolerance`` 0 (no
# element is done early) and 1e30 (every element done after one
# iteration); and titration solves whose never-done elements fill one run
# of 32 (``arrange="packed"``) or sit at every 32nd element
# (``"strided"``). Both working types.
B4_CASES = {
    f"{name}-{str(dtype)[6:]}": dict(shape=shape, dtype=dtype, **extra)
    for dtype in (torch.float64, torch.float32)
    for name, shape, extra in (
        ("n1", (1,), {}), ("n7", (7,), {}), ("n31", (31,), {}),
        ("n33", (33,), {}), ("n129", (129,), {}), ("n1025", (1025,), {}),
        ("n65536", (65536,), {}), ("n65537", (65537,), {}),
        ("n300000", (300000,), {}), ("4x6", (4, 6), {}),
        ("4096x20", (4096, 20), {}),
        ("degenerate", (300,), dict(degenerate=True)),
        ("iters0", (1025,), dict(iters=0)),
        ("iters1", (1025,), dict(iters=1)),
        ("iters7", (1025,), dict(iters=7)),
        ("tolerance0", (1025,), dict(tolerance=0.0)),
        ("tolerance1e30", (1025,), dict(tolerance=1e30)),
        ("never-done-packed", (1024,), dict(arrange="packed")),
        ("never-done-strided", (2048,), dict(arrange="strided")))
}
PH_LOOP_TOL = 2e-6      # kernel's exp form against the loop's 10 ** (-pH)


def ph_waters_numpy(n: int, seed: int = 42) -> dict:
    """``n`` chemically consistent waters from ``seed`` as float64 NumPy
    constants: total carbonate U(1, 5) mmol/L, alkalinity U(0.5, 1.3) x 50
    x C_T mg/L as CaCO3, temperature U(5, 35) C."""
    rng = np.random.default_rng(seed)
    ct = rng.uniform(1.0, 5.0, n)
    alk = rng.uniform(0.5, 1.3, n) * 50.0 * ct
    temp = rng.uniform(5.0, 35.0, n)
    return chem.chemistry_constants_numpy(alk, ct, temp)


def ph_waters(shape, dtype, device, seed: int = 42,
              degenerate: bool = False) -> chem.ChemistryConstants:
    """``ph_waters_numpy`` in ``shape`` on ``device``. ``degenerate`` makes
    element 0 pure water (no carbonate, no alkalinity: the root is the
    neutral pH of its temperature), gives element 1 a NaN alkalinity and element 2 an infinite
    Kw (no root: both must come out NaN)."""
    values = {name: np.array(v).reshape(shape) for name, v in
              ph_waters_numpy(int(np.prod(shape)), seed).items()}
    if degenerate:
        flat = {name: v.reshape(-1) for name, v in values.items()}
        flat["C_T_mol"][0] = flat["alk_eq"][0] = 0.0
        flat["alk_eq"][1] = np.nan
        flat["Kw"][2] = np.inf
    return chem.constants_from_numpy(values, dtype=dtype, device=device)


def ph_diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Two solves element by element: the largest absolute difference where
    neither is NaN, whether NaN sits in the same places, whether the two
    are bit-equal."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    d = torch.where(nan_a | nan_b, torch.zeros_like(a), (a - b).abs())
    return dict(max_abs_err=float(d.max()),
                nan_equal=torch.equal(nan_a, nan_b),
                bit_equal=torch.equal(torch.where(nan_a, 0.0, a),
                                      torch.where(nan_b, 0.0, b)))


def _never_done_arranged(arrange: str, n: int, dtype, device):
    """Flat B4 inputs of ``n`` titration solves (Monte-Carlo waters at
    +-1 meq/L, guess the unshifted pH): the never-done elements in run 5
    (``"packed"``: elements 160-191, all 32) or at every 32nd element
    (``"strided"``), done elements everywhere else."""
    k, shifts = titration_waters(64, 64, dtype, device)
    base = PS.solve_pH_plain(k, 7.0)
    pool, _ = PS.broadcast_inputs(
        dataclasses.replace(k, alk_eq=k.alk_eq + shifts), base)
    _, live = PS.ph_live_iters(*pool)
    never = torch.nonzero(live == PS.DEFAULT_ITERS).flatten()
    done = torch.nonzero(live < PS.DEFAULT_ITERS).flatten()
    slots = torch.arange(n, device=device)
    where = (slots // 32 == 5) if arrange == "packed" else (slots % 32 == 0)
    order = torch.empty(n, dtype=torch.int64, device=device)
    order[where] = never[:int(where.sum())]
    order[~where] = done[:int((~where).sum())]
    return [x[order] for x in pool], where


def b4_case_inputs(case: dict, device, guess: float = 7.0):
    """``(flat inputs, shape, solve keywords)`` of one ``B4_CASES``
    entry."""
    kw = {key: case[key] for key in ("iters", "tolerance") if key in case}
    if "arrange" in case:
        args, _ = _never_done_arranged(case["arrange"], case["shape"][0],
                                       case["dtype"], device)
        return args, case["shape"], kw
    k = ph_waters(case["shape"], case["dtype"], device,
                  degenerate=case.get("degenerate", False))
    ph0 = torch.full(case["shape"], guess, dtype=case["dtype"],
                     device=device)
    args, shape = PS.broadcast_inputs(k, ph0)
    return args, shape, kw


def b4_vs_plain(case: dict, device, guess: float = 7.0):
    """Kernel B4 and its plain version on one ``B4_CASES`` entry, both on
    the card; returns the kernel's pH and ``ph_diff`` of the two, with the
    case's live iterations (``mean_live``, ``max_live``)."""
    args, shape, kw = b4_case_inputs(case, device, guess)
    got = PS.ph_kernel(*args, **kw).reshape(shape)
    torch.cuda.synchronize()
    d = ph_diff(got, PS.ph_plain(*args, **kw).reshape(shape))
    _, live = PS.ph_live_iters(*args, **kw)
    d.update(mean_live=float(live.double().mean()),
             max_live=int(live.max()))
    return got, d


def b4_never_done_in_place(case: dict, device) -> bool:
    """Whether the never-done elements of an ``arrange`` case sit where the
    case puts them (and only there)."""
    args, where = _never_done_arranged(case["arrange"], case["shape"][0],
                                       case["dtype"], device)
    _, live = PS.ph_live_iters(*args)
    return torch.equal(live == PS.DEFAULT_ITERS, where)


def b4_streams(device) -> dict:
    """B4 twice back to back on one stream, then once on each of two
    streams at once, twice, at PH-TITR's shape (more elements than
    resident lanes, so the warps draw runs from the launch's counter):
    whether every result is bit-equal to the plain version, and whether
    every work counter is back at zero."""
    args = ph_cell_args("PH-TITR-4096x256", torch.float32, device)
    ref = PS.ph_plain(*args)
    got = [PS.ph_kernel(*args), PS.ph_kernel(*args)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    for _ in range(2):
        for stream in streams:
            with torch.cuda.stream(stream):
                got.append(PS.ph_kernel(*args))
    torch.cuda.synchronize()
    equal = [ph_diff(x, ref)["bit_equal"] for x in got]
    return dict(back_to_back=all(equal[:2]), two_streams=all(equal[2:]),
                counters_zero=all(int(w.abs().sum()) == 0
                                  for w in PS._WORK.values()))


def b4_vs_loop(device, n: int = 1025) -> float:
    """Largest difference of float64 B4 from ``core.chemistry.solve_pH``
    (the step-by-step loop with ``10 ** (-pH)``) on the same CUDA
    tensors."""
    k = ph_waters((n,), torch.float64, device)
    ph0 = torch.full((n,), 7.0, dtype=torch.float64, device=device)
    got = PS.solve_pH_kernel(k, ph0)
    return float((got - chem.solve_pH(k, ph0)).abs().max())


def b4_vs_host(device, n: int = 16) -> float:
    """Largest difference of float64 B4 from the host's scalar Newton loop
    (``core.chemistry.solve_pH_host``), water by water."""
    values = ph_waters_numpy(n)
    k = chem.constants_from_numpy(values, dtype=torch.float64, device=device)
    got = PS.solve_pH_kernel(
        k, torch.full((n,), 7.0, dtype=torch.float64, device=device)).cpu()
    host = [chem.solve_pH_host(chem.ChemistryConstants(
        **{name: v[i] for name, v in values.items()})) for i in range(n)]
    return float((got - torch.tensor(host, dtype=torch.float64)).abs().max())


# Charge-balance residual [eq/L], evaluated in float64, below which a solve
# counts as converged: the solver's pH tolerance times the buffer capacity
# in float64, the resolution of the alkalinity in float32.
PH_RESIDUAL_TOL = {torch.float64: 1e-9, torch.float32: 1e-7}
TITRATION_PH_TOP = 9.5
# Least shares of closed solves and of rising-checked neighbour pairs a
# titration of the Monte-Carlo waters at +-1 meq/L must show. 5.9-6.3% of
# its solves do not close in either package (the same elements, as
# tests/test_torch_ph_solver.py holds against the JAX package), and
# 63-70% of the pairs close below ``TITRATION_PH_TOP`` (64 x 32 up to
# 4096 x 256).
TITRATION_MIN_CLOSED = 0.93
TITRATION_MIN_PAIRS = 0.6


# Peaks of one H100 SXM at 700 W (NVIDIA's data sheet): non-tensor
# operations a second by type (FP64 is 132 SMs x 64 lanes x 2 x 1.98 GHz;
# the sheet rounds it to 34 TFLOP/s), the dense bfloat16 tensor-core rate
# (the surrogate's products) and device memory bytes a second.
PEAK_OPS = {torch.float32: 67e12, torch.float64: 33.5e12,
            torch.bfloat16: 989e12}
HBM_RATE = 3.35e12


def ph_bounds(args, live, iters: int = PS.DEFAULT_ITERS) -> dict:
    """B4's least times on one launch over ``args`` (flat inputs), in ms:
    ``fixed_ms`` counts every element through all ``iters`` (the lockstep
    kernel's work, the bound of PRs 3-5), ``live_ms`` the live iterations
    ``live`` (``ph_live_iters``): the work no schedule can skip, and the
    bound a kernel that stops done elements is held to. Each is the larger
    of the operations over the type's peak and the bytes over the memory
    rate (``*_by`` says which)."""
    n, dtype = args[0].numel(), args[0].dtype
    size = args[0].element_size()

    def bound(ops, moved):
        ops_ms = ops / PEAK_OPS[dtype] * 1e3
        bytes_ms = moved / HBM_RATE * 1e3
        return max(ops_ms, bytes_ms), \
            "operations" if ops_ms >= bytes_ms else "bytes"

    fixed_ms, fixed_by = bound(PS.ph_ops(n, iters),
                               PS.ph_bytes(n, size, iters))
    live_ms, live_by = bound(PS.ph_live_ops(live),
                             PS.ph_bytes(n, size, int(live.max())))
    return dict(fixed_ms=fixed_ms, fixed_by=fixed_by, live_ms=live_ms,
                live_by=live_by, mean_live=float(live.double().mean()))


PH_CELLS = ("PH-EQ-65536", "PH-TITR-4096x256")


def ph_cell_args(cell: str, dtype, device):
    """Flat B4 inputs of a main-path pH cell: ``"PH-EQ-65536"``, 65,536
    waters (``ph_waters``) from pH 7; ``"PH-TITR-4096x256"``, the
    Monte-Carlo plants' chemistry at 256 alkalinity shifts of +-1 meq/L
    (``titration_waters``), each from its plant's unshifted pH."""
    if cell == "PH-EQ-65536":
        k = ph_waters((65536,), dtype, device)
        return PS.broadcast_inputs(k, torch.full((65536,), 7.0, dtype=dtype,
                                                 device=device))[0]
    k, shifts = titration_waters(4096, 256, dtype, device)
    base = PS.solve_pH_plain(k, 7.0)
    return PS.broadcast_inputs(
        dataclasses.replace(k, alk_eq=k.alk_eq + shifts), base)[0]


def titration_waters(n_plants: int, n_shifts: int, dtype, device,
                     seed: int = 0, span_eq: float = 1e-3):
    """``(k, shifts)``: the chemistry of ``make_monte_carlo_batch(seed)``'s
    ``n_plants`` plants as ``[n_plants, 1]`` constants, and ``n_shifts``
    alkalinity shifts from ``-span_eq`` to ``+span_eq`` eq/L (+-1 meq/L):
    a titration curve per plant."""
    params, _ = make_monte_carlo_batch(R.ReactorConfiguration(n_zones=20),
                                       n_plants, seed=seed, dtype=dtype,
                                       device=device)
    k = chem.ChemistryConstants(**{
        f.name: getattr(params.chem, f.name)[:, None]
        for f in dataclasses.fields(params.chem)})
    return k, torch.linspace(-span_eq, span_eq, n_shifts, dtype=dtype,
                             device=device)


def titration_check(k: chem.ChemistryConstants, shifts, curve) -> dict:
    """What a run can show of ``curve = pH_after_alkalinity_shift(k,
    shifts, .)``: the share of solves whose charge balance closes
    (``PH_RESIDUAL_TOL``, residual in float64), and whether the curves rise
    with the shift wherever two neighbouring solves both closed below pH
    ``TITRATION_PH_TOP``; ``enough`` says that both shares reach
    ``TITRATION_MIN_CLOSED`` and ``TITRATION_MIN_PAIRS``.

    The rest is the model's, equal in the JAX package: its charge balance
    carries ``[H+] - [OH-]`` with that sign, so above pH ~10 the residual
    is not monotone in pH, a water with more alkalinity than its carbonate
    can carry has no root, and Newton from the unshifted pH ends away from
    one."""
    wide = {f.name: getattr(k, f.name).double()
            for f in dataclasses.fields(k)}
    wide["alk_eq"] = wide["alk_eq"] + shifts.double()
    residual = chem.charge_balance_error(
        curve.double(), chem.ChemistryConstants(**wide)).abs()
    closed = (residual < PH_RESIDUAL_TOL[curve.dtype]) \
        & (curve < TITRATION_PH_TOP)
    pairs = closed[:, 1:] & closed[:, :-1]
    steps = (curve[:, 1:] - curve[:, :-1])[pairs]
    closed_share = float((residual < PH_RESIDUAL_TOL[curve.dtype])
                         .double().mean())
    pair_share = float(pairs.double().mean())
    return dict(
        closed_share=closed_share, pair_share=pair_share,
        enough=closed_share >= TITRATION_MIN_CLOSED
        and pair_share >= TITRATION_MIN_PAIRS,
        min_step=float(steps.min()) if steps.numel() else float("nan"),
        rising=bool((steps > 0).all()) and steps.numel() > 0,
        finite=bool(torch.isfinite(curve).all()),
        in_range=bool(((curve >= 0.0) & (curve <= 14.0)).all()))
