"""
The yardstick of the kernels: the operations and bytes a call's work needs,
from its shapes and its algorithm alone, and the card's peaks.

Operations are counted from the algorithm, each add, subtract, multiply,
divide, compare-select, min/max and transcendental one (an FMA two): per
zone a derivative evaluation of the tank is ``DERIV_OPS``, an RK4 substep's
stage updates and weighted sum ``RK4_UPDATE_OPS``, an RKC2 substep's first
stage ``RKC_FIRST_OPS`` and each later one ``RKC_STAGE_OPS`` besides its
evaluation, the end-of-step bounds ``BOUND_OPS``; per plant a step of the
seven instruments is ``SENSOR_OPS`` (words to normals and uniforms, base
pipelines, overlays, taps, histories, recording) and the Philox words it
draws ``PHILOX_OPS`` (19 blocks of 10 rounds, 10 integer operations a
round). The Philox
operations count however the words are made. Bytes: every input read once
and every output written once.

These counts are frozen here, so that a change to the program moves the
share it reaches of them, never the counts.
"""

from __future__ import annotations

DERIV_OPS = 83
RK4_UPDATE_OPS = 39
RKC_FIRST_OPS = 6
RKC_STAGE_OPS = 27
BOUND_OPS = 5
SENSOR_OPS = 1145
PHILOX_OPS = 1900

PARAM_COLS = 16            # reactor parameters a plant
BOUNDARY_COLS = 10         # forcing fields
SENSOR_PARAM_COLS = 98     # the seven instruments' parameters a plant
CARRY_FLOAT_COLS = 94      # their float carries
CARRY_INT_COLS = 28        # their flag and code carries
INSTRUMENTS = 7
LINES = 4                  # instruments with a sample line
ITEMSIZE = 4               # float32, the configurations' type

# One H100 SXM at its 700 W limit (NVIDIA's data sheet): float32 outside
# the tensor cores, and device memory.
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12


def rollout_ops(batch: int, n_zones: int, n_steps: int, substeps: int,
                stages: int = None) -> int:
    """Operations of ``n_steps`` tank steps of ``batch`` plants, each
    ``substeps`` RK4 substeps (``stages`` None) or RKC2 substeps of
    ``stages`` stages."""
    if stages is None:
        per_substep = 4 * DERIV_OPS + RK4_UPDATE_OPS
    else:
        per_substep = stages * DERIV_OPS + RKC_FIRST_OPS \
            + (stages - 1) * RKC_STAGE_OPS
    return batch * n_zones * n_steps * (substeps * per_substep + BOUND_OPS)


def rollout_bytes(batch: int, n_zones: int) -> int:
    """Bytes of a constant-forcing tank rollout: the state in and out, the
    parameter and forcing tables in."""
    return 2 * 3 * batch * n_zones * ITEMSIZE \
        + (PARAM_COLS + BOUNDARY_COLS) * batch * ITEMSIZE


def plant_ops(batch: int, n_zones: int, n_steps: int, substeps: int,
              stages: int = None) -> int:
    """Operations of ``n_steps`` instrumented plant steps: the tank and,
    every step, the instruments with their Philox words."""
    return rollout_ops(batch, n_zones, n_steps, substeps, stages) \
        + batch * n_steps * (SENSOR_OPS + PHILOX_OPS)


def plant_bytes(batch: int, n_zones: int, n_steps: int, record_every: int,
                hist_slots: int, scheduled: int,
                faults: bool = False) -> int:
    """Bytes of an instrumented rollout: state, carries and line histories
    in and out; tables, delays and forcing (constant 0, one schedule 1, a
    schedule a plant 2) in; readings (and their fault codes) out."""
    state = 3 * batch * n_zones * ITEMSIZE
    tables = (PARAM_COLS + SENSOR_PARAM_COLS) * batch * ITEMSIZE \
        + LINES * batch * 4
    forcing = (batch, n_steps, n_steps * batch)[scheduled] \
        * BOUNDARY_COLS * ITEMSIZE
    carries = batch * (CARRY_FLOAT_COLS * ITEMSIZE + CARRY_INT_COLS * 4)
    readings = (n_steps // record_every) * INSTRUMENTS * batch \
        * (ITEMSIZE + (4 if faults else 0))
    return 2 * state + tables + forcing + 2 * carries \
        + 2 * hist_slots * batch * ITEMSIZE + readings


def bound_s(ops: int, moved: int) -> tuple:
    """``(seconds, "operations" or "bytes")``: the least time of the
    work on one card."""
    t_ops, t_bytes = ops / PEAK_FLOPS_F32, moved / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
