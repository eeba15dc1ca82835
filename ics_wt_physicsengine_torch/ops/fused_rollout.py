"""
Fused whole-rollout kernels B1 and B2, their plain PyTorch versions and
their wrappers (port of ``ics_wt_physicsengine_tpu/ops/fused_rollout.py``).

Kernels (``csrc/fused_rollout.cu``, CUDA C++ for sm_90a, bound with
ctypes):

- B1 ``wt_rollout_fused`` replaces ``_rollout_kernel``
  (ics_wt_physicsengine_tpu/ops/fused_rollout.py:272): constant forcing.
- B2 ``wt_rollout_scheduled`` replaces ``_scheduled_kernel`` (:312): the
  boundary source terms are rebuilt every step from a ``[n_steps, 10]``
  schedule that all plants share. A constant schedule reproduces B1 bit for
  bit (same code path on the same values).

Each launch advances every plant through ``n_steps x substeps`` RK4 steps,
or s-stage RKC2 steps, of the 3-field zone ODE, clamps the state after
every step and optionally records it every ``record_every`` steps. One
thread holds one (plant, zone). The launch geometry is this module's
(``rollout_geometry``), sized by the batch: whole plants packed into a
block that exchanges zone neighbours through shared memory, or whole plants
inside one warp that exchange them by warp shuffle.

What bounds them on an H100: operations. The state is read and written once
per launch while every zone does ``DERIV_OPS`` operations per derivative
evaluation, so the least time is ``rollout_ops(...) / 67 TFLOP/s``
(non-tensor FP32). A batch that leaves the card's schedulers few warps is
bound by the latency of each plant's chain of dependent evaluations, far
above that.

Which path runs is decided by the device of the state alone: a CPU tensor
runs the plain version (a direct transcription of the reference kernel's
``_make_deriv``, ``_make_stepper`` and ``_bound`` on ``[B, Z]`` tensors), a
CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts kernel
launches by kernel name.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.ops.integrators import _rkc2_coefficients
from ics_wt_physicsengine_torch.utils.dispatch import ieee_div as _div

LN10 = math.log(10.0)
MAX_ZONES = 128
MAX_STAGES = 16

# Row order of the per-plant parameter table [16, B]
# (csrc/fused_rollout.cuh: ParamCol).
PARAM_COLS = (
    "volume_L", "zone_volume_L", "zone_height", "heat_area_m2",
    "k_exchange", "velocity_scale", "cl_k_ref", "cl_ea",
    "Kw", "Ka1", "Ka2", "Ka_HOCl", "C_T_mol",
    "strat_enabled", "ri_crit", "supp_factor",
)
# Column order of the boundary table [10, B] and of schedule rows [n, 10]
# (csrc/fused_rollout.cuh: BoundaryCol).
BOUNDARY_FIELDS = (
    "inlet_flow_rate", "inlet_pH", "inlet_chlorine", "inlet_temperature",
    "acid_flow_rate", "acid_concentration",
    "chlorine_flow_rate", "chlorine_concentration",
    "ambient_temperature", "heat_loss_coefficient",
)

LAUNCHES = {"rollout_fused": 0, "rollout_scheduled_fused": 0}

# Operations per zone per derivative evaluation, counted from
# csrc/fused_rollout.cuh::deriv for an interior zone (each add, subtract,
# multiply, divide, min/max and exp counts one): clamps 5, density 8,
# h 2, two interface rates 16, three stencils 15, speciation 7, beta 11,
# 1/(beta ln10) 2, dpH 1, chlorine decay 13, heat loss 3. Edge zones skip
# one interface (8 and 5 fewer) but zone 0 adds its sources (12 more).
DERIV_OPS = 83
# Per zone: the RK4 stage updates and weighted sum of one substep, the RKC2
# stage updates (first stage, each later stage), the end-of-step clamp.
RK4_UPDATE_OPS = 39
RKC_FIRST_OPS = 6
RKC_STAGE_OPS = 27
BOUND_OPS = 5


def rollout_ops(batch: int, n_zones: int, n_steps: int, substeps: int,
                stages: Optional[int]) -> int:
    """Operations a rollout of these sizes does (see ``DERIV_OPS``)."""
    if stages is None:
        per_substep = 4 * DERIV_OPS + RK4_UPDATE_OPS
    else:
        per_substep = stages * DERIV_OPS + RKC_FIRST_OPS \
            + (stages - 1) * RKC_STAGE_OPS
    return batch * n_zones * n_steps * (substeps * per_substep + BOUND_OPS)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Launch geometry
# ---------------------------------------------------------------------------

# csrc/fused_rollout.cu: Layout, kThreadsPerBlock (the packed layout's
# largest block, the size of its shared exchange buffers) and
# kMaxWarpsPerBlock (the warp layout's).
PACKED, WARP = 0, 1
WARP_SIZE = 32
MAX_BLOCK_THREADS = 256
MAX_WARPS_PER_BLOCK = 4
# The H100 SXM's warp schedulers (132 multiprocessors of 4), and the rule's
# two thresholds (``rollout_geometry``).
SCHEDULERS = 132 * 4
BUSY_WARPS_PER_SCHEDULER = 4
WARP_COST_RATIO = 1.15


@dataclass(frozen=True)
class RolloutGeometry:
    """Kernels B1/B2's launch geometry: ``layout`` (``PACKED`` or
    ``WARP``), ``plants_per_block`` whole plants on ``block_threads``
    threads a block."""

    layout: int
    plants_per_block: int
    block_threads: int

    def grid(self, batch: int) -> int:
        return -(-batch // self.plants_per_block)

    def cell(self, tid: int, n_zones: int):
        """``(local plant, zone, real)`` of thread ``tid`` of a block, as
        the kernel maps it (``cell_of``): a padding thread (packed) runs a
        one-zone copy of the block's first plant, an idle lane (warp) a copy
        of zone ``lane - P_w * Z`` of its warp's last plant, ``P_w = 32 //
        Z``; neither stores."""
        if self.layout == WARP:
            per_warp = WARP_SIZE // n_zones
            warp, lane = divmod(tid, WARP_SIZE)
            raw, zone = divmod(lane, n_zones)
            real = raw < per_warp
            if not real:
                raw, zone = per_warp - 1, lane - per_warp * n_zones
            return warp * per_warp + raw, zone, real
        real = tid < self.plants_per_block * n_zones
        local, zone = divmod(tid, n_zones) if real else (0, 0)
        return local, zone, real


def _warps(threads: int) -> int:
    return -(-threads // WARP_SIZE)


def packed_geometry(n_zones: int, batch: int) -> RolloutGeometry:
    """The packed layout: of the plant counts that fit a block (at most
    ``batch`` plants, at most ``MAX_BLOCK_THREADS`` threads), the one with
    the fewest warps per plant, the larger on a tie. 20 zones give 8 plants
    on 5 warps; a single plant one warp."""
    best = None
    for plants in range(1, min(MAX_BLOCK_THREADS // n_zones, batch) + 1):
        key = (_warps(plants * n_zones) / plants, -plants)
        if best is None or key < best[0]:
            best = (key, plants)
    plants = best[1]
    return RolloutGeometry(PACKED, plants,
                           _warps(plants * n_zones) * WARP_SIZE)


def warp_geometry(n_zones: int, batch: int) -> RolloutGeometry:
    """The warp layout (``n_zones <= 32``): ``32 // n_zones`` plants a
    warp, up to ``MAX_WARPS_PER_BLOCK`` warps a block, no more warps than
    the batch needs."""
    if n_zones > WARP_SIZE:
        raise ValueError(f"a {n_zones}-zone plant does not fit a warp")
    per_warp = WARP_SIZE // n_zones
    warps = min(MAX_WARPS_PER_BLOCK, -(-batch // per_warp))
    return RolloutGeometry(WARP, warps * per_warp, warps * WARP_SIZE)


def rollout_geometry(n_zones: int, batch: int) -> RolloutGeometry:
    """The launch geometry of B1/B2 for ``n_zones`` zones and ``batch``
    plants.

    For as many warps, the warp layout runs 11-18% faster than the packed
    one (no barrier, no shared memory, each interface rate computed once),
    but where ``32 % n_zones`` lanes of each warp idle it needs more warps
    per plant (1.6x at 20 zones), and once the schedulers are busy those
    cost issue slots. So the rule: the warp layout where a plant fits a
    warp and either its warps per plant are at most ``WARP_COST_RATIO``
    times the packed layout's (zone counts 1-8, 10, 14-16, 28-32 at a large
    batch), or the launch needs at most ``BUSY_WARPS_PER_SCHEDULER`` warps
    for each of the card's ``SCHEDULERS``; the packed layout otherwise.

    The numbers that chose it (B1, RK4 3 x 4, float32, both layouts in
    turns on an H100 80GB HBM3 at 700 W; ``tools/torch_rollout_compare.py
    --sweep``, PERF.md): warp / packed time at 20 zones 0.84 for one plant,
    0.74-0.75 from 32 to 528 plants, 0.83 at 1056, 1.00 at 2112 (four warps
    a scheduler), 1.27 at 4096; at 4096 and 32768 plants 0.83 / 0.88 at 5
    zones, 0.82 / 0.87 at 8, 0.86 / 0.87 at 16, 0.89 / 0.86 at 32, and at
    11 zones (1.44x the warps a plant) 0.86 at 4096 (2048 warps) but 1.24
    at 32768.
    """
    if not 1 <= n_zones <= MAX_ZONES or batch < 1:
        raise ValueError(f"no B1/B2 geometry for n_zones={n_zones}, "
                         f"batch={batch}")
    if n_zones > WARP_SIZE:
        return packed_geometry(n_zones, batch)
    warp, packed = warp_geometry(n_zones, batch), \
        packed_geometry(n_zones, batch)
    warps = -(-batch // (WARP_SIZE // n_zones))
    ratio = (warp.block_threads / warp.plants_per_block) \
        / (packed.block_threads / packed.plants_per_block)
    if ratio <= WARP_COST_RATIO \
            or warps <= BUSY_WARPS_PER_SCHEDULER * SCHEDULERS:
        return warp
    return packed


# ---------------------------------------------------------------------------
# Host-side tables
# ---------------------------------------------------------------------------


def _column(x, batch, dtype, device):
    # a Python float goes through NumPy so that it stays float64 until the
    # cast to ``dtype`` (torch.as_tensor would make it float32 first)
    return torch.as_tensor(
        np.asarray(x) if not isinstance(x, torch.Tensor) else x,
        device=device).to(dtype).expand(batch)


def param_table(params: R.ReactorParams, batch: int, dtype,
                device) -> torch.Tensor:
    """The per-plant parameters as a ``[16, B]`` struct-of-arrays table."""
    values = {f.name: getattr(params, f.name) for f in fields(params)}
    values.update({f.name: getattr(params.chem, f.name)
                   for f in fields(params.chem)})
    return torch.stack([_column(values[name], batch, dtype, device)
                        for name in PARAM_COLS]).contiguous()


def boundary_table(boundary: R.BoundaryConditions, batch: int, dtype,
                   device) -> torch.Tensor:
    """Constant forcing as a ``[10, B]`` table (a scalar field holds for
    every plant)."""
    return torch.stack([_column(getattr(boundary, name), batch, dtype, device)
                        for name in BOUNDARY_FIELDS]).contiguous()


def schedule_table(schedule: R.BoundaryConditions, n_steps: int, dtype,
                   device) -> torch.Tensor:
    """Per-step forcing as a ``[n_steps, 10]`` table (a scalar field holds
    for every step)."""
    return torch.stack([_column(getattr(schedule, name), n_steps, dtype,
                                device)
                        for name in BOUNDARY_FIELDS], dim=1).contiguous()


def _rkc_host_table(stages: int, h_step: float):
    """``[mu1h, (c0, mu, nu, muth, gmth) for j in 0..stages]`` folded in
    double, as the reference kernel folds its Python floats."""
    mu1t, mu, nu, mut, gmt = _rkc2_coefficients(stages)
    table = [float(mu1t) * h_step]
    for j in range(stages + 1):
        table += [1.0 - float(mu[j]) - float(nu[j]), float(mu[j]),
                  float(nu[j]), float(mut[j]) * h_step,
                  float(gmt[j]) * h_step]
    return (ctypes.c_double * len(table))(*table)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path; the reference for the kernels)
# ---------------------------------------------------------------------------


def _boundary_terms(p, get):
    """Boundary-derived source terms from a field accessor ``get(name)``
    (``[B, 1]`` columns for B1, 0-d schedule entries for B2)."""
    return {
        "q_per_v": _div(get("inlet_flow_rate"), 60.0) / p["volume_L"],
        "h_inlet": torch.exp(-LN10 * get("inlet_pH")),
        "cl_inlet": get("inlet_chlorine"),
        "t_inlet": get("inlet_temperature"),
        "dh_dosing": _div(get("acid_flow_rate"), 60.0)
        * get("acid_concentration") / p["zone_volume_L"],
        "dcl_dosing": _div(get("chlorine_flow_rate"), 60.0)
        / p["zone_volume_L"] * get("chlorine_concentration"),
        "t_amb": get("ambient_temperature"),
        "heat_rate": get("heat_loss_coefficient") * p["heat_area_m2"]
        / (c.WATER_DENSITY_20C * c.WATER_CP * _div(p["volume_L"], 1000.0)),
    }


def _make_deriv(p, b, n_zones: int):
    """The ODE right-hand side on ``[B, Z]`` tensors; ``p`` holds ``[B, 1]``
    parameter columns, ``b`` the boundary terms."""
    zone = torch.arange(n_zones, device=p["volume_L"].device)
    iface_mask = zone < (n_zones - 1)
    not_first = zone >= 1
    first = zone == 0
    last = zone == (n_zones - 1)
    safe_u2 = torch.clamp(p["velocity_scale"], min=1e-6) ** 2
    has_flow = p["velocity_scale"] > 1e-6

    def roll_next(x):
        return torch.roll(x, -1, dims=-1)

    def roll_prev(x):
        return torch.roll(x, 1, dims=-1)

    def exchange(x, k_iface):
        up = torch.where(iface_mask, k_iface * (roll_next(x) - x), 0.0)
        k_prev = roll_prev(k_iface)
        dn = torch.where(not_first, k_prev * (roll_prev(x) - x), 0.0)
        return up + dn - torch.where(last, b["q_per_v"] * x, 0.0)

    def deriv(ph, cl, t):
        ph = torch.clip(ph, 0.0, 14.0)
        cl = torch.clamp(cl, min=0.0)
        t = torch.clip(t, 0.0, 100.0)

        rho = torch.where(
            t <= 8.0,
            c.RHO_MAX_4C - c.DENSITY_ANOMALY_COEFF * (t - 4.0) ** 2,
            c.WATER_DENSITY_20C * (1.0 - c.THERMAL_EXPANSION_COEFF
                                   * (t - 20.0)))
        rho_next = roll_next(rho)
        drho = rho_next - rho
        rho_avg = 0.5 * (rho_next + rho)
        ri = c.G_GRAVITY * drho * p["zone_height"] / (rho_avg * safe_u2)
        stratified = (ri > p["ri_crit"]) | torch.logical_not(has_flow)
        supp = torch.where(stratified & (p["strat_enabled"] > 0.5),
                           p["supp_factor"], 1.0)
        k_iface = p["k_exchange"] * supp

        h = torch.exp(-LN10 * ph)
        d = h * h + p["Ka1"] * h + p["Ka1"] * p["Ka2"]
        a0 = h * h / d
        a1 = p["Ka1"] * h / d
        a2 = p["Ka1"] * p["Ka2"] / d
        beta = 2.303 * (h + p["Kw"] / h) \
            + 2.303 * p["C_T_mol"] * (a0 * a1 + 4.0 * a1 * a2 + a0 * a2)
        inv_beta_ln10 = 1.0 / (beta * LN10)

        dph = -exchange(h, k_iface) * inv_beta_ln10
        dh_in = b["q_per_v"] * (b["h_inlet"] - h)
        dph = dph - torch.where(
            first, (b["dh_dosing"] + dh_in) * inv_beta_ln10, 0.0)

        dcl = exchange(cl, k_iface)
        dcl = dcl + torch.where(
            first, b["dcl_dosing"] + b["q_per_v"] * (b["cl_inlet"] - cl), 0.0)
        t_k = t + 273.15
        ea_r = -_div(p["cl_ea"], c.R_GAS)
        k_base = p["cl_k_ref"] * torch.exp(
            ea_r * (1.0 / t_k - 1.0 / c.T_REFERENCE_K))
        a_hocl = h / (h + p["Ka_HOCl"])
        ph_factor = a_hocl + (1.0 - a_hocl) * c.K_OCL_RELATIVE
        dcl = dcl - k_base * ph_factor * cl

        dtemp = exchange(t, k_iface)
        dtemp = dtemp + torch.where(
            first, b["q_per_v"] * (b["t_inlet"] - t), 0.0)
        dtemp = dtemp - b["heat_rate"] * (t - b["t_amb"])
        return dph, dcl, dtemp

    return deriv


def _make_stepper(deriv, h_step: float, stages: Optional[int]):
    """One integrator substep: classical RK4 or s-stage RKC2 with the
    coefficients folded in double."""

    def rk4(carry):
        ph, cl, t = carry
        k1 = deriv(ph, cl, t)
        k2 = deriv(ph + 0.5 * h_step * k1[0], cl + 0.5 * h_step * k1[1],
                   t + 0.5 * h_step * k1[2])
        k3 = deriv(ph + 0.5 * h_step * k2[0], cl + 0.5 * h_step * k2[1],
                   t + 0.5 * h_step * k2[2])
        k4 = deriv(ph + h_step * k3[0], cl + h_step * k3[1],
                   t + h_step * k3[2])
        ph = ph + (h_step / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        cl = cl + (h_step / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        t = t + (h_step / 6.0) * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2])
        return ph, cl, t

    def rkc(carry):
        mu1t, mu, nu, mut, gmt = _rkc2_coefficients(stages)
        y0 = carry
        f0 = deriv(*y0)
        yjm2 = y0
        yjm1 = tuple(a + float(mu1t) * h_step * b for a, b in zip(y0, f0))
        for j in range(2, stages + 1):
            fj = deriv(*yjm1)
            c0 = 1.0 - float(mu[j]) - float(nu[j])
            yj = tuple(
                c0 * a0 + float(mu[j]) * a1 + float(nu[j]) * a2
                + float(mut[j]) * h_step * fj_ + float(gmt[j]) * h_step * f0_
                for a0, a1, a2, fj_, f0_ in zip(y0, yjm1, yjm2, fj, f0))
            yjm2, yjm1 = yjm1, yj
        return yjm1

    return rk4 if stages is None else rkc


def _bound(ph, cl, t):
    """End-of-step physical bounds."""
    return (torch.clip(ph, 0.0, 14.0), torch.clamp(cl, min=0.0),
            torch.clip(t, 0.0, 100.0))


def _plain(ptab, forcing, ph, cl, t, *, scheduled, dt, substeps, n_steps,
           stages, record_every):
    n_zones = ph.shape[-1]
    p = {name: ptab[i][:, None] for i, name in enumerate(PARAM_COLS)}

    def terms(get_col):
        return _boundary_terms(
            p, lambda name: get_col(BOUNDARY_FIELDS.index(name)))

    if not scheduled:
        step_fn = _make_stepper(
            _make_deriv(p, terms(lambda i: forcing[i][:, None]), n_zones),
            dt / substeps, stages)
    traj = []
    for i in range(n_steps):
        if scheduled:
            row = forcing[i]
            step_fn = _make_stepper(
                _make_deriv(p, terms(lambda j: row[j]), n_zones),
                dt / substeps, stages)
        carry = (ph, cl, t)
        for _ in range(substeps):
            carry = step_fn(carry)
        ph, cl, t = _bound(*carry)
        if record_every and (i + 1) % record_every == 0:
            traj.append((ph, cl, t))
    if not record_every:
        return ph, cl, t, None
    if not traj:
        empty = ph.new_empty((0,) + tuple(ph.shape))
        return ph, cl, t, (empty, empty.clone(), empty.clone())
    return ph, cl, t, tuple(torch.stack(x) for x in zip(*traj))


def rollout_plain(ptab, btab, ph, cl, t, *, dt, substeps, n_steps,
                  stages=None, record_every=None):
    """Plain PyTorch version of kernel B1 on tables: ``ptab [16, B]``,
    ``btab [10, B]``, state ``[B, Z]``. Returns ``(ph, cl, t, traj)`` with
    ``traj`` a tuple of three ``[n_steps // k, B, Z]`` tensors or None."""
    return _plain(ptab, btab, ph, cl, t, scheduled=False, dt=dt,
                  substeps=substeps, n_steps=n_steps, stages=stages,
                  record_every=record_every)


def scheduled_plain(ptab, sched, ph, cl, t, *, dt, substeps, stages=None,
                    record_every=None):
    """Plain PyTorch version of kernel B2: as ``rollout_plain`` with the
    ``[n_steps, 10]`` schedule in place of the boundary table."""
    return _plain(ptab, sched, ph, cl, t, scheduled=True, dt=dt,
                  substeps=substeps, n_steps=sched.shape[0], stages=stages,
                  record_every=record_every)


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _launch(name, ptab, forcing, ph, cl, t, *, dt, substeps, n_steps, stages,
            record_every):
    from ics_wt_physicsengine_torch.ops import _build

    tensors = (ptab, forcing, ph, cl, t)
    if any(x.device.type != "cuda" for x in tensors):
        raise ValueError(f"{name}: every input must be a CUDA tensor")
    dtype = ph.dtype
    if dtype not in (torch.float32, torch.float64) \
            or any(x.dtype != dtype for x in tensors):
        raise ValueError(f"{name}: inputs must all be float32 or all float64")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    batch, n_zones = ph.shape
    if cl.shape != ph.shape or t.shape != ph.shape \
            or ptab.shape != (len(PARAM_COLS), batch):
        raise ValueError(f"{name}: shapes disagree")
    if stages is not None and not 2 <= stages <= MAX_STAGES:
        raise ValueError(f"stages must be in [2, {MAX_STAGES}], got {stages}")

    lib = _build.load()
    outs = [torch.empty_like(ph) for _ in range(3)]
    k = record_every or 0
    traj = [torch.empty((n_steps // k, batch, n_zones), dtype=dtype,
                        device=ph.device) for _ in range(3)] if k else []
    h_step = dt / substeps
    rkc = _rkc_host_table(stages, h_step) if stages is not None else None
    g = rollout_geometry(n_zones, batch)
    fn = lib.wt_rollout_scheduled if name == "rollout_scheduled_fused" \
        else lib.wt_rollout_fused
    with torch.cuda.device(ph.device):     # the launch's current device
        err = fn(int(dtype == torch.float64), ptab.data_ptr(),
                 forcing.data_ptr(),
                 ctypes.cast(rkc, ctypes.c_void_p) if rkc is not None
                 else None,
                 stages or 0, ph.data_ptr(), cl.data_ptr(), t.data_ptr(),
                 *(x.data_ptr() for x in outs),
                 *((x.data_ptr() for x in traj) if k
                   else (None, None, None)),
                 batch, n_zones, n_steps, substeps, k, h_step, g.layout,
                 g.plants_per_block, g.block_threads,
                 torch.cuda.current_stream(ph.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.wt_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return (*outs, tuple(traj) if k else None)


def rollout_kernel(ptab, btab, ph, cl, t, *, dt, substeps, n_steps,
                   stages=None, record_every=None):
    """Kernel B1 on CUDA tables (same contract as ``rollout_plain``)."""
    if btab.shape != (len(BOUNDARY_FIELDS), ph.shape[0]):
        raise ValueError("rollout_fused: boundary table must be [10, B]")
    return _launch("rollout_fused", ptab, btab, ph, cl, t, dt=dt,
                   substeps=substeps, n_steps=n_steps, stages=stages,
                   record_every=record_every)


def scheduled_kernel(ptab, sched, ph, cl, t, *, dt, substeps, stages=None,
                     record_every=None):
    """Kernel B2 on CUDA tables (same contract as ``scheduled_plain``)."""
    if sched.ndim != 2 or sched.shape[1] != len(BOUNDARY_FIELDS):
        raise ValueError("rollout_scheduled_fused: schedule must be "
                         "[n_steps, 10]")
    return _launch("rollout_scheduled_fused", ptab, sched, ph, cl, t, dt=dt,
                   substeps=substeps, n_steps=sched.shape[0], stages=stages,
                   record_every=record_every)


# ---------------------------------------------------------------------------
# Public wrappers (``core.reactor`` objects in and out)
# ---------------------------------------------------------------------------


def _check_params(params: R.ReactorParams):
    if any(getattr(params, axis) is not None for axis in R.EXTENSION_AXES):
        raise ValueError(
            "the fused physics kernels do not support the nitrogen/gas/"
            "particle/disinfection/biofilm/phase extensions; use "
            "core.reactor.rollout / rollout_scheduled")
    if params.n_zones > MAX_ZONES:
        raise ValueError(f"fused rollout supports n_zones <= {MAX_ZONES}, "
                         f"got {params.n_zones}")


def _check_record(n_steps, record_every):
    if record_every is not None and n_steps % record_every:
        raise ValueError(f"n_steps={n_steps} must be a multiple of "
                         f"record_every={record_every}")


def _prepare(params, state):
    ph = state.pH
    single = ph.ndim == 1
    batch = 1 if single else ph.shape[0]
    dtype, device = ph.dtype, ph.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")

    def prep(x):
        x = torch.as_tensor(x, device=device).to(dtype)
        return (x[None, :] if single else x).contiguous()

    states = (prep(state.pH), prep(state.chlorine), prep(state.temperature))
    return single, batch, states, param_table(params, batch, dtype, device)


def _finish(state, single, outs, total_flow, dt, n_steps, record_every):
    ph_f, cl_f, t_f, traj = outs

    def unprep(x):
        return x[0] if single else x

    dtype = ph_f.dtype
    new_state = R.ReactorState(
        time=state.time + dt * n_steps,
        pH=unprep(ph_f), chlorine=unprep(cl_f), temperature=unprep(t_f),
        flow_rate=torch.as_tensor(total_flow, dtype=dtype,
                                  device=ph_f.device)
        + torch.zeros_like(torch.as_tensor(state.flow_rate)),
    )
    new_state = R._update_derived(new_state)
    if record_every is None:
        return new_state

    def unprep_traj(x):
        return x[:, 0] if single else x

    return new_state, {"pH": unprep_traj(traj[0]),
                       "chlorine": unprep_traj(traj[1]),
                       "temperature": unprep_traj(traj[2])}


def rollout_fused(params: R.ReactorParams, state: R.ReactorState,
                  boundary: R.BoundaryConditions, *, dt: float,
                  substeps: int, n_steps: int,
                  stages: Optional[int] = None,
                  record_every: Optional[int] = None):
    """Advance ``n_steps`` of ``dt`` seconds in one launch of kernel B1
    (its plain version for a CPU state).

    Accepts a single plant (``[Z]`` state) or a batch (``[B, Z]`` state with
    ``[B]`` params); returns the final state with derived quantities updated,
    matching ``core.reactor.rollout(..., record=False)[0]``. ``stages``
    switches the integrator from RK4 to s-stage RKC2. ``record_every=k``
    returns ``(final_state, traj)`` where traj stacks pH/chlorine/
    temperature every k-th step (``[n_steps // k, ..., Z]``).
    """
    _check_params(params)
    _check_record(n_steps, record_every)
    single, batch, (ph, cl, t), ptab = _prepare(params, state)
    btab = boundary_table(boundary, batch, ph.dtype, ph.device)
    run = rollout_kernel if ph.is_cuda else rollout_plain
    outs = run(ptab, btab, ph, cl, t, dt=dt, substeps=substeps,
               n_steps=n_steps, stages=stages, record_every=record_every)
    total_flow = (boundary.inlet_flow_rate + boundary.acid_flow_rate
                  + boundary.chlorine_flow_rate)
    return _finish(state, single, outs, total_flow, dt, n_steps,
                   record_every)


def rollout_scheduled_fused(params: R.ReactorParams, state: R.ReactorState,
                            schedule: R.BoundaryConditions, *, dt: float,
                            substeps: int, stages: Optional[int] = None,
                            record_every: Optional[int] = None):
    """``core.reactor.rollout_scheduled`` semantics in one launch of kernel
    B2 (its plain version for a CPU state): one step per schedule row.

    ``schedule`` is a ``BoundaryConditions`` whose fields carry a leading
    ``[n_steps]`` time axis (scalar fields hold for every step). The final
    state's flow rate is the last row's total flow. ``record_every=k``
    returns ``(final_state, traj)`` as ``rollout_fused`` does.
    """
    _check_params(params)
    n_steps = R.schedule_length(schedule)
    _check_record(n_steps, record_every)
    single, batch, (ph, cl, t), ptab = _prepare(params, state)
    sched = schedule_table(schedule, n_steps, ph.dtype, ph.device)
    run = scheduled_kernel if ph.is_cuda else scheduled_plain
    outs = run(ptab, sched, ph, cl, t, dt=dt, substeps=substeps,
               stages=stages, record_every=record_every)
    last = sched[n_steps - 1]
    col = BOUNDARY_FIELDS.index
    total_flow = (last[col("inlet_flow_rate")] + last[col("acid_flow_rate")]
                  + last[col("chlorine_flow_rate")])
    return _finish(state, single, outs, total_flow, dt, n_steps,
                   record_every)
