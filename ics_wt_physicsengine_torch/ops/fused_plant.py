"""
Fused whole-rollout kernel B3 of the instrumented plant, its plain PyTorch
version and its wrapper (port of
``ics_wt_physicsengine_tpu/ops/fused_plant.py``).

Kernel (``csrc/fused_plant.cu`` with ``sensors.cuh`` and ``philox.cuh``,
CUDA C++ for sm_90a, bound with ctypes): ``wt_plant_rollout`` replaces
``_plant_kernel`` (ics_wt_physicsengine_tpu/ops/fused_plant.py:293). One
launch advances every plant ``n_steps``: per step the physics of kernels
B1/B2, then all seven instruments read the new state (random words to
normals and uniforms, zone taps, four sample-line histories, base pipeline
plus overlay), and the readings are recorded every ``record_every`` steps.
Forcing is constant, a ``[n_steps]`` schedule that all plants share, or a
``[n_steps, B]`` schedule per plant (a fleet's chunk, whose lanes slew
toward their own commands).

Layout (``plant_geometry``): a block holds whole plants on two kinds of
warp, physics warps with one thread per (plant, zone) as in B1/B2, and
sensor warps with one lane per (plant, sensor), sensor-major. The sensor
lanes read step s while the physics warps compute step s + 1, so a step
costs about the larger of the two, not their sum. Each lane draws only the
Philox blocks that hold its own words (``STATICS_FIELDS``: first block,
skip, block count).

What bounds it on an H100: operations (``plant_ops`` / 67 TFLOP/s of
non-tensor FP32). The tables move once per launch (``plant_bytes``); with
injected words (``rng="bits"``) the ``[n_steps, 76, B]`` word tensor is
read too. A single plant is one block on one SM and is bound by the latency
of its dependent chains.

Sample line: with a fixed step the nearest-timestamp ring lookup of
``sensors.base`` is "the tap from round(delay / dt) steps ago", a circular
``[d_max + 1, B]`` history per line. Incoming carry rings are consumed
(``_resolve_lead_in`` prefills what the exact lookup would return for the
first ``delay`` reads) and on exit the rings are rebuilt from the histories
(``_rebuild_rings``), so chaining with the ``plant_step`` loop is exact in
both directions. Differences from the exact ring, kept from the JAX
package: the fused line records the true value every step, even while a
sensor warms up or is power-faulted; exact-distance ties between an
incoming and an in-rollout sample resolve by ring slot; a rollout shorter
than a line's delay loses earlier history beyond the rebuilt window. A
served chunk (``_rollout_with(served=True)``) keeps it instead: its rebuilt
ring is joined with the ring before it (``_join_rings``).

Randomness: ``rng="philox"`` (production) is Philox4x32-10 keyed by the
64-bit ``seed`` with counter (step0 + step, plant0 + plant, word block
0..18, 0), both counters taken modulo 2^32; the stream depends on the global
step and the global plant only, and ``philox_words`` reproduces it in
integer tensor arithmetic. A serving loop that launches once per chunk
passes its step count as ``step0`` (default 0), so that a run's noise does
not depend on how it is chunked; a launch over lanes ``plant0 ..`` of a
larger fleet (one card's shard, ``parallel.mesh``) passes ``plant0``
(default 0), so that the noise does not depend on how the fleet is split.
``rng="bits"`` consumes caller-supplied int32 words ``[n_steps, N_WORDS,
B]``, one stream per plant. Uniforms take a word's top 24 bits, normals
are Box-Muller pairs (``rand_from_words``).

Clocks: every plant keeps its own clock (``time`` ``[B]``), so that a
fleet whose paused lanes held their clocks runs in one launch.

Fault record: with ``record_faults`` the kernel and its plain version also
write each recorded reading's fault code, int32 ``[n_steps //
record_every, 7, B]`` beside the values (the serving chunk's history needs
them; ``models.plant.plant_serve_chunk``).

Which path runs is decided by the device of the state alone: a CPU tensor
runs the plain version (the same algorithm as a Python loop over steps on
``[B]``/``[B, Z]`` tensors, calling the ``sensors`` package's read
functions), a CUDA tensor launches the kernel or raises. ``LAUNCHES``
counts kernel launches, B3's and the table pack's;
``division_fallbacks()`` reads B3's own count of float32 blocks that took
the IEEE divisions (``fused_rollout.DIVISION_PARAM_WINDOWS``).

On the card the wrapper only enqueues work: once ``sensor_statics`` has
seen a parameter set and ``dt`` (``STATICS_CACHE`` counts its hits and
misses), no call synchronizes with the device or copies from the host
with a wait, so the host prepares the next call while B3 runs this one.

Tables: B3's come from one launch of the pack kernel
(``csrc/fused_plant.cu::pack_tables_kernel``, ``pack_tables``): the host
walks the leaves the tables read (``PACK_LEAVES``) and hands their
addresses, types and strides, or their values where they are host
numbers, to the kernel in its arguments (``describe_tables``), and the
kernel converts every element and resolves the four lead-ins, bit-equal to
``build_tables``. The plain version's tables are ``build_tables``', made by
PyTorch operations on either device. A route pairs the two
(``kernel_route``, ``tensor_route``; ``table_runner`` picks one by device);
``TABLE_PACKS`` counts the tables each builder makes.
"""

from __future__ import annotations

import ctypes
import math
import struct
import weakref
from dataclasses import dataclass, fields, replace
from typing import List, Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.ops import fused_rollout as F
from ics_wt_physicsengine_torch.sensors import base as SB
from ics_wt_physicsengine_torch.sensors import chlorine as SC
from ics_wt_physicsengine_torch.sensors import flow as SF
from ics_wt_physicsengine_torch.sensors import ph as SP
from ics_wt_physicsengine_torch.sensors import temperature as ST
from ics_wt_physicsengine_torch.utils.dispatch import ieee_div
from ics_wt_physicsengine_torch.utils.profiling import span, spanned

# ---------------------------------------------------------------------------
# Registries: sensor order, randomness layout, packed column layouts
# ---------------------------------------------------------------------------

# (reading name, PlantParams/PlantState attribute, kind)
SENSORS = [
    ("pH_inlet", "ph_inlet", "ph"),
    ("pH_outlet", "ph_outlet", "ph"),
    ("chlorine_inlet", "chlorine_inlet", "cl"),
    ("chlorine_outlet", "chlorine_outlet", "cl"),
    ("flow_main", "flow_main", "flow"),
    ("temp_inlet", "temp_inlet", "temp"),
    ("temp_outlet", "temp_outlet", "temp"),
]

_RAND = {  # (n_normals, n_uniforms) per sensor kind
    "ph": (SP.N_NORMALS, SP.N_UNIFORMS),
    "cl": (SC.N_NORMALS, SC.N_UNIFORMS),
    "flow": (SF.N_NORMALS, SF.N_UNIFORMS),
    "temp": (ST.N_NORMALS, ST.N_UNIFORMS),
}


def words_per_sensor(kind: str) -> int:
    n, m = _RAND[kind]
    return 2 * ((n + 1) // 2) + m


N_WORDS = sum(words_per_sensor(kind) for _, _, kind in SENSORS)
_WORD_OFFSET = {}
_off = 0
for _rname, _attr, _kind in SENSORS:
    _WORD_OFFSET[_attr] = _off
    _off += words_per_sensor(_kind)

# Per-plant float parameter columns: the base fields base_read uses, then
# each kind's overlay fields.
_BASE_P = ["min_value", "max_value", "precision", "drift_rate",
           "warmup_time_s", "max_rate_of_change", "flow_velocity",
           "air_bubble_frequency", "grounding_quality", "pipe_vibration_g",
           "ambient_temperature"]
_OVERLAY_P = {
    "ph": ["temperature_coefficient"],
    "cl": ["ozone_sensitivity", "h2o2_sensitivity", "clo2_sensitivity"],
    "flow": ["full_scale"],
    "temp": ["nominal_resistance", "rtd_alpha", "lead_resistance",
             "excitation_current_mA", "self_heating_C_per_mW",
             "seebeck_coefficient"],
}

# Carry columns with their kind: f = float, b = bool, i = int.
_BASE_C = [("current_value", "f"), ("supply_voltage", "f"),
           ("power_on_time", "f"), ("calibration_offset", "f"),
           ("last_calibration_time", "f"),
           ("calibration_validity_hours", "f"), ("has_calibration", "b"),
           ("status", "i"), ("fault", "i"), ("last_value", "f"),
           ("last_timestamp", "f"), ("has_history", "b")]
_OVERLAY_C = {
    "ph": [("membrane_fouling", "f"), ("glass_etching", "f"),
           ("days_since_cleaning", "f"), ("water_hardness", "f"),
           ("reference_contamination", "f"), ("slope_percentage", "f"),
           ("cal_point_1", "f"), ("cal_point_2", "f")],
    "cl": [("membrane_fouling", "f"), ("membrane_age_days", "f"),
           ("electrode_polarization", "f"), ("reagent_potency", "f"),
           ("reagent_age_days", "f"), ("light_exposure_hours", "f"),
           ("storage_temperature", "f")],
    "flow": [("bearing_friction", "f"), ("bearing_wear_days", "f"),
             ("electrode_fouling", "f"), ("fluid_conductivity", "f")],
    "temp": [("cold_junction_temp", "f"), ("cold_junction_drift", "f")],
}


def _build_cols():
    pcols, ccols = [], []
    for _, attr, kind in SENSORS:
        for f in _BASE_P:
            pcols.append((attr, "base", f))
        for f in _OVERLAY_P[kind]:
            pcols.append((attr, None, f))
        for f, k in _BASE_C:
            ccols.append((attr, "base", f, k))
        for f, k in _OVERLAY_C[kind]:
            ccols.append((attr, None, f, k))
    return pcols, ccols


_PCOLS, _CCOLS = _build_cols()
_PCOL = {c[:3]: i for i, c in enumerate(_PCOLS)}
_CCOL = {c[:3]: i for i, c in enumerate(_CCOLS)}
N_PCOLS, N_CCOLS = len(_PCOLS), len(_CCOLS)

# The carries travel as two struct-of-arrays tables: the float columns
# ``[N_FLOAT_CCOLS, B]`` in the working type and the bool/int columns
# ``[N_INT_CCOLS, B]`` as int32, each in ``_CCOLS`` order.
_FLOAT_CCOLS = [c for c in _CCOLS if c[3] == "f"]
_INT_CCOLS = [c for c in _CCOLS if c[3] != "f"]
N_FLOAT_CCOLS, N_INT_CCOLS = len(_FLOAT_CCOLS), len(_INT_CCOLS)

_LINE_ATTRS = ("ph_inlet", "ph_outlet", "temp_inlet", "temp_outlet")

# Sensor types as the kernel's integer codes (csrc/sensors.cuh:
# SensorTypeCode); a kind without types has code 0.
TYPE_CODES = {
    "ph": lambda sensor_type: 0,
    "cl": lambda sensor_type: 0 if sensor_type == SC.AMPEROMETRIC else 1,
    "flow": lambda sensor_type: 0 if sensor_type == SF.TURBINE else 1,
    "temp": lambda sensor_type: 0 if "rtd" in sensor_type else 1,
}

LAUNCHES = {"plant_rollout_fused": 0, "pack_tables": 0}
# The cards this process launched B3 on since the last reset (as
# fused_rollout._DIVISION_DEVICES).
_DIVISION_DEVICES: set = set()

# Operations per plant per step of the sensor phase, counted from
# csrc/sensors.cuh (each add, subtract, multiply, divide, compare-select,
# min/max and transcendental counts one): 76 words to 50 normals and 22
# uniforms (26 Box-Muller pairs x 11 + 22 x 2 = 330, or 19 Philox blocks x
# 10 rounds x 10 integer operations = 1900 more when the words are
# generated), base pipeline 75 x 7, overlays pH 2 x 55, chlorine 30 + 35,
# flow 25, temperature 2 x 25, taps, histories and recording 40.
SENSOR_OPS = 1145
PHILOX_OPS = 1900


def plant_ops(batch: int, n_zones: int, n_steps: int, substeps: int,
              stages: Optional[int], philox: bool = True) -> int:
    """Operations a fused plant rollout of these sizes does: the physics
    (``fused_rollout.rollout_ops``) plus the sensor phase."""
    per_step = SENSOR_OPS + (PHILOX_OPS if philox else 0)
    return F.rollout_ops(batch, n_zones, n_steps, substeps, stages) \
        + batch * n_steps * per_step


def plant_bytes(batch: int, n_zones: int, n_steps: int, record_every: int,
                hist_slots: int, scheduled: int, bits: bool,
                itemsize: int = 4, faults: bool = False) -> int:
    """Bytes a launch must move: every input read once, every output
    written once. ``hist_slots`` is the sum of the four histories' slot
    counts; ``faults``: the fault-code record is written too."""
    state = 3 * batch * n_zones * itemsize
    tables = (len(F.PARAM_COLS) + N_PCOLS) * batch * itemsize \
        + 4 * batch * 4
    forcing = (batch, n_steps, n_steps * batch)[int(scheduled)] \
        * len(F.BOUNDARY_FIELDS) * itemsize
    carries = batch * (N_FLOAT_CCOLS * itemsize + N_INT_CCOLS * 4)
    hist = hist_slots * batch * itemsize
    readings = (n_steps // record_every) * len(SENSORS) * batch \
        * (itemsize + (4 if faults else 0))
    words = n_steps * N_WORDS * batch * 4 if bits else 0
    return 2 * state + tables + forcing + 2 * carries + 2 * hist \
        + readings + words


# Largest block of kernel B3 and most physics threads in one
# (csrc/fused_plant.cu: kMaxBlockThreads; fused_rollout.cuh:
# kThreadsPerBlock, the size of the shared exchange buffers).
MAX_BLOCK_THREADS = 448
MAX_PHYSICS_THREADS = 256


@dataclass(frozen=True)
class PlantGeometry:
    """Kernel B3's launch geometry: ``plants_per_block`` whole plants per
    block on ``physics_threads`` physics threads (one per (plant, zone),
    padded to whole warps) followed by the sensor lanes (one per (plant,
    sensor), sensor-major: sensor k's lanes start at lane k *
    ``sensor_stride``), padded to whole warps."""

    plants_per_block: int
    physics_threads: int
    sensor_stride: int

    @property
    def sensor_threads(self) -> int:
        return F._warps(len(SENSORS) * self.sensor_stride) * F.WARP_SIZE

    @property
    def block_threads(self) -> int:
        return self.physics_threads + self.sensor_threads

    def grid(self, batch: int) -> int:
        return -(-batch // self.plants_per_block)

    def sensor_lane(self, lane: int):
        """``(sensor, local plant)`` of sensor lane ``lane`` (counted from
        the first sensor warp), or None for a padding lane."""
        sensor, local_plant = divmod(lane, self.sensor_stride)
        if sensor < len(SENSORS) and local_plant < self.plants_per_block:
            return sensor, local_plant
        return None


def plant_geometry(n_zones: int, batch: int) -> PlantGeometry:
    """The block layout of kernel B3 for ``n_zones`` zones and ``batch``
    plants: of the plant counts that fit (at most ``batch``, physics
    threads at most ``MAX_PHYSICS_THREADS``, the block at most
    ``MAX_BLOCK_THREADS``), the one that needs the fewest warps per plant,
    the larger on a tie. 20 zones give 8 plants on 5 physics warps and 2
    sensor warps; one zone 32 plants; 128 zones 2 plants.

    Where all sensor lanes would share one warp (at most 4 plants a block:
    a small batch), each sensor gets a warp of its own if the block still
    fits, so that the seven pipelines run side by side rather than one
    after another in a diverged warp."""
    if not 1 <= n_zones <= F.MAX_ZONES or batch < 1:
        raise ValueError(f"no B3 geometry for n_zones={n_zones}, "
                         f"batch={batch}")
    best = None
    for plants in range(1, min(MAX_PHYSICS_THREADS // n_zones, batch) + 1):
        warps = F._warps(plants * n_zones) + F._warps(len(SENSORS) * plants)
        if warps * F.WARP_SIZE > MAX_BLOCK_THREADS:
            continue
        key = (warps / plants, -plants)
        if best is None or key < best[0]:
            best = (key, plants)
    plants = best[1]
    physics = F._warps(plants * n_zones) * F.WARP_SIZE
    spread = len(SENSORS) * plants <= F.WARP_SIZE \
        and physics + len(SENSORS) * F.WARP_SIZE <= MAX_BLOCK_THREADS
    return PlantGeometry(plants_per_block=plants, physics_threads=physics,
                         sensor_stride=F.WARP_SIZE if spread else plants)


def reset_launch_counts() -> None:
    """Zero ``LAUNCHES``, ``TABLE_PACKS`` and, on the cards launched on,
    B3's division counter."""
    from ics_wt_physicsengine_torch.ops import _build

    for counts in (LAUNCHES, TABLE_PACKS):
        for name in counts:
            counts[name] = 0
    _build.reset_division_fallbacks("fused_plant", _DIVISION_DEVICES)


def division_fallbacks() -> int:
    """Float32 blocks of B3 launches since ``reset_launch_counts`` that took
    the IEEE divisions. Waits for the cards, so never on a wrapper's path;
    raises without a CUDA card."""
    from ics_wt_physicsengine_torch.ops import _build

    return _build.division_fallbacks("fused_plant", _DIVISION_DEVICES)


# ---------------------------------------------------------------------------
# Randomness: words to draws, and the Philox stream
# ---------------------------------------------------------------------------


def rand_from_words(words, n_normals: int, n_uniforms: int,
                    dtype=torch.float32):
    """Raw int32 words to ``(normals[..., n_normals], uniforms[...,
    n_uniforms])``; ``words[k]`` is word k of every plant. The kernel and
    the plain version consume identical streams through this map.

    Uniforms take the top 24 bits (mask after the shift: the words are
    signed int32 and ``>>`` sign-extends); normals are Box-Muller pairs."""
    def unif(w):
        return ((w >> 8) & 0xFFFFFF).to(dtype) * (1.0 / (1 << 24))

    n_pairs = (n_normals + 1) // 2
    normals = []
    for p in range(n_pairs):
        u1 = unif(words[2 * p])
        u2 = unif(words[2 * p + 1])
        r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
        theta = (2.0 * math.pi) * u2
        normals.append(r * torch.cos(theta))
        normals.append(r * torch.sin(theta))
    normals = normals[:n_normals]
    uniforms = [unif(words[2 * n_pairs + i]) for i in range(n_uniforms)]
    return torch.stack(normals, dim=-1), torch.stack(uniforms, dim=-1)


_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """High and low 32 bits of ``m * x`` for a 32-bit constant and 32-bit
    values held in int64, without overflowing int64."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit values: ``counter`` is
    four tensors, ``key`` two Python ints; returns four tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def philox_words(seed: int, step0: int, n_steps: int, batch: int,
                 device, plant0: int = 0) -> torch.Tensor:
    """The kernel's word stream for steps ``step0 .. step0 + n_steps - 1``
    of plants ``plant0 .. plant0 + batch - 1``, as int32 ``[n_steps,
    N_WORDS, batch]``: nineteen Philox blocks per plant and step with
    counter (step mod 2^32, plant mod 2^32, block, 0) under the key
    ``seed``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    i64 = dict(dtype=torch.int64, device=device)
    step = (torch.arange(step0, step0 + n_steps, **i64)
            & _MASK32)[:, None, None]
    block = torch.arange(N_WORDS // 4, **i64)[None, :, None]
    plant = (torch.arange(plant0, plant0 + batch, **i64)
             & _MASK32)[None, None, :]
    shape = (n_steps, N_WORDS // 4, batch)
    out = philox4x32_10(
        (step.expand(shape), plant.expand(shape), block.expand(shape),
         torch.zeros(shape, **i64)),
        (seed & _MASK32, seed >> 32))
    words = torch.stack(out, dim=2).reshape(n_steps, N_WORDS, batch)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words) \
        .to(torch.int32)


def philox_words_kernel(seed: int, n_steps: int, batch: int,
                        device) -> torch.Tensor:
    """``philox_words(seed, 0, n_steps, batch)`` drawn by the kernel's own
    generator on the CUDA card."""
    from ics_wt_physicsengine_torch.ops import _build

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("philox_words_kernel needs a CUDA device")
    lib = _build.load("fused_plant")
    out = torch.empty((n_steps, N_WORDS, batch), dtype=torch.int32,
                      device=device)
    with torch.cuda.device(device):     # the launch's current device
        err = lib.wt_philox_words(
            int(seed) & 0xFFFFFFFFFFFFFFFF, n_steps, batch, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("philox words kernel launch failed: "
                           f"{lib.wt_plant_error_string(err).decode()}")
    return out


# ---------------------------------------------------------------------------
# Sample-line lead-in, ring rebuild and join (host side)
# ---------------------------------------------------------------------------


@spanned("wt.b3.lead_in")
def _resolve_lead_in(base_carry, delay_s, d_arr, d_max, t0, dt, batch,
                     dtype):
    """Prefill ``[d_max + 1, batch]`` for a sample-line history: what the
    exact nearest-timestamp ring lookup
    (``sensors.base._ring_append_and_lookup``) would return for each of the
    first ``d`` in-rollout reads, resolved from the incoming carry ring.
    NaN = "no usable pre-rollout sample": the rollout falls back to its
    first own sample. Emulates the exact path including the progressive
    overwrite of incoming entries by in-rollout appends and argmin's
    storage-order tie-break."""
    device = base_carry.line_values.device
    cap = d_max + 1
    nanfill = torch.full((cap, batch), math.nan, dtype=dtype, device=device)
    lv = base_carry.line_values.to(dtype)
    lt = base_carry.line_times.to(dtype)
    if lv.ndim == 1:
        lv, lt = lv[None, :], lt[None, :]
    C = lv.shape[-1]
    if d_max == 0 or C == 0:
        return nanfill
    lv = lv.expand(batch, C)
    lt = lt.expand(batch, C)
    count = F._column(base_carry.line_count, batch, torch.int64, device)
    ptr = F._column(base_carry.line_ptr, batch, torch.int64, device)
    delay_s = F._column(delay_s, batch, dtype, device)
    d_arr = F._column(d_arr, batch, torch.int64, device)
    t0 = F._column(t0, batch, dtype, device)

    g = torch.arange(d_max, device=device)[:, None]                # [d, 1]
    target = t0[None, :] + (g.to(dtype) + 1.0) * dt \
        - delay_s[None, :]                                         # [d, B]
    s = torch.arange(C, device=device)[None, :]                    # [1, C]
    overwrite_step = torch.remainder(s - ptr[:, None], C)          # [B, C]
    valid = s < count[:, None]                                     # [B, C]
    surv = valid[None] & (overwrite_step[None] > g[:, :, None])    # [d, B, C]
    dist = torch.where(surv, (lt[None] - target[..., None]).abs(), math.inf)
    slot_in = torch.argmin(dist, dim=-1)                           # [d, B]
    dist_in = torch.amin(dist, dim=-1)
    # the nearest in-rollout candidate for a read this young is always the
    # step-0 sample (slot ptr), at |delay - g*dt|
    dist0 = (delay_s[None, :] - g.to(dtype) * dt).abs()
    use = (dist_in < dist0) | ((dist_in == dist0)
                               & (slot_in < ptr[None, :]))
    use = use & (g < d_arr[None, :])
    vals = torch.gather(lv[None].expand(d_max, batch, C), -1,
                        slot_in[..., None])[..., 0]
    lead_gb = torch.where(use, vals, math.nan)                     # [d, B]

    # scatter into prefill slots: the read for step g < d_b hits history
    # slot (g - d_b + cap) % cap = g + 1 + (d_max - d_b)
    slots = torch.arange(cap, device=device)[:, None]              # [cap, 1]
    g_of = slots - 1 - (d_max - d_arr[None, :])                    # [cap, B]
    ok = (g_of >= 0) & (g_of < d_arr[None, :])
    gi = torch.clamp(g_of, 0, d_max - 1)
    return torch.where(ok, torch.gather(lead_gb, 0, gi), math.nan).to(dtype)


@spanned("wt.b3.rings")
def _rebuild_rings(hist, old_carry, d_max: int, n_steps: int, t0, dt,
                   batch: int, dtype):
    """Rebuild a sensor's sample-line ring from the written-back circular
    history ``[d_max + 1, batch]``: the last min(n_steps, d_max+1, C)
    samples, laid out oldest to newest from slot 0 with ptr/count set so
    that a following segment's nearest-timestamp lookups resolve as if the
    ring had been appended sample by sample."""
    device = hist.device
    cap = d_max + 1
    C = int(old_carry.line_values.shape[-1])
    k = min(n_steps, cap, C)
    # the in-rollout steps kept, made on the device (a host list would be
    # a blocking copy behind the kernel just launched); the history slot
    # of step g is g % cap
    g = torch.arange(n_steps - k, n_steps, device=device)
    vals = hist.index_select(0, torch.remainder(g, cap))         # [k, B]
    t0b = F.on_device(t0, device).to(dtype).reshape(-1).expand(batch)
    times = t0b[None, :] + (g.to(dtype)[:, None] + 1.0) * dt
    ref_v, ref_t = old_carry.line_values, old_carry.line_times
    single = ref_v.ndim == 1
    # joined, not written into a slice: a single plant's slice would be a
    # device-to-device cudaMemcpy
    new_v = torch.cat([vals.T.to(ref_v.dtype), torch.zeros(
        (batch, C - k), dtype=ref_v.dtype, device=device)], dim=1)
    new_t = torch.cat([times.T.to(ref_t.dtype), torch.full(
        (batch, C - k), -math.inf, dtype=ref_t.dtype, device=device)], dim=1)
    if single:
        new_v, new_t = new_v[0], new_t[0]
    shape = () if single else (batch,)
    count = torch.full(shape, k, dtype=torch.int32, device=device)
    ptr = torch.full(shape, k % C, dtype=torch.int32, device=device)
    return {"line_values": new_v, "line_times": new_t,
            "line_count": count, "line_ptr": ptr}


@spanned("wt.b3.rings")
def _join_rings(old_carry, new: dict, window: int) -> dict:
    """A served chunk's ring (``_rebuild_rings``' fields ``new``, the
    chunk's last ``k`` samples from slot 0) joined with the ring before
    the chunk: where ``k`` is short of ``window`` (the line's history, at
    most the ring), the newest samples of ``old_carry`` go in front of
    them, oldest first from slot 0, so that the ring holds the last
    ``min(count + k, window)`` samples, as one chunk of the two chunks'
    length would leave it."""
    C = int(new["line_values"].shape[-1])
    k = new["line_count"].to(torch.int64)
    count = old_carry.line_count.to(torch.int64)
    keep = torch.clamp(count + k, max=window)
    n_old = keep - k                                   # old samples kept
    j = torch.arange(C, device=k.device)
    lead = j < n_old[..., None]
    old_slot = torch.remainder(old_carry.line_ptr.to(torch.int64)[..., None]
                               - n_old[..., None] + j, C)
    new_slot = torch.clamp(j - n_old[..., None], 0, C - 1)

    def join(o, x, empty):
        v = torch.where(lead, torch.gather(o, -1, old_slot),
                        torch.gather(x, -1, new_slot))
        return torch.where(j < keep[..., None], v, empty)

    return {"line_values": join(old_carry.line_values, new["line_values"],
                                0.0),
            "line_times": join(old_carry.line_times, new["line_times"],
                               -math.inf),
            "line_count": keep.to(new["line_count"].dtype),
            "line_ptr": torch.remainder(keep, C).to(new["line_ptr"].dtype)}


# ``sensor_statics``' results by ``_statics_key``, each with weak references
# to the delay tensors it read, and how many lookups found one (``hits``)
# and how many computed it (``misses``).
_STATICS: dict = {}
_STATICS_MAX = 64
STATICS_CACHE = {"hits": 0, "misses": 0}


def _statics_key(params, dt: float):
    """What ``sensor_statics`` reads, as ``(key, delay tensors)``: ``dt``,
    the zone count, each sensor's zone and type, each sample line's
    capacity and its delays' tensor by identity and ``_version`` (an
    in-place change of the delays makes another key). Never the delays'
    values: reading them is a copy from the card. ``(None, ())`` where a
    delay tensor cannot be keyed (not a tensor, or an inference tensor,
    which keeps no version)."""
    key, tensors = [float(dt), params.reactor.n_zones], []
    for _, attr, _ in SENSORS:
        sp = getattr(params, attr)
        key += [getattr(sp, "zone_index", 0), getattr(sp, "sensor_type", None)]
        if attr in _LINE_ATTRS:
            key.append(sp.base.line_capacity)
            if sp.base.line_capacity > 0:
                delay = sp.base.line_delay_s
                if not isinstance(delay, torch.Tensor) or delay.is_inference():
                    return None, ()
                key += [id(delay), delay._version]
                tensors.append(delay)
    return tuple(key), tuple(tensors)


@spanned("wt.b3.statics")
def sensor_statics(params, dt: float):
    """Per sensor ``(attr, normalized zone, sensor type, d_static, d_max)``:
    what is uniform over the batch and fixes the kernel's shape. ``d_static``
    is the line's delay in steps when all plants share it, else None (kept
    so that the tuple equals the JAX package's; the kernel reads each
    plant's own delay either way); ``d_max`` the batch's largest.

    The delays are read on the host once per parameter set and ``dt``
    (``_STATICS``, counted in ``STATICS_CACHE``): a wrapper that read them
    every call would wait there for the kernel in flight."""
    key, tensors = _statics_key(params, dt)
    entry = _STATICS.get(key) if key is not None else None
    if entry is not None and all(
            ref() is t for ref, t in zip(entry[0], tensors)):
        STATICS_CACHE["hits"] += 1
        return entry[1]
    STATICS_CACHE["misses"] += 1
    statics = _sensor_statics(params, dt)
    if key is not None:
        if len(_STATICS) >= _STATICS_MAX:
            _STATICS.clear()
        _STATICS[key] = (tuple(weakref.ref(t) for t in tensors), statics)
    return statics


def _sensor_statics(params, dt: float):
    z = params.reactor.n_zones
    statics = []
    for _, attr, kind in SENSORS:
        sp = getattr(params, attr)
        zi = getattr(sp, "zone_index", 0)
        if not -z <= zi < z:
            raise ValueError(f"{attr}: zone_index {zi} out of range for "
                             f"{z} zones")
        zi = zi % z
        d_static, d_max = 0, 0
        if attr in _LINE_ATTRS and sp.base.line_capacity > 0:
            darr = np.round(sp.base.line_delay_s.detach().cpu().numpy()
                            .astype(np.float64).ravel() / dt) \
                .astype(np.int64)
            darr = np.maximum(darr, 0)
            d_max = int(darr.max()) if darr.size else 0
            d_static = int(darr[0]) \
                if darr.size and np.all(darr == darr[0]) else None
        statics.append((attr, zi, getattr(sp, "sensor_type", None),
                        d_static, d_max))
    return tuple(statics)


# ---------------------------------------------------------------------------
# Tables: what the kernel and its plain version take and give
# ---------------------------------------------------------------------------


# Forcing modes (the kernel's ``scheduled``): constant ``[10, B]``, one
# schedule ``[n_steps, 10]``, or a schedule per plant ``[n_steps, 10, B]``.
FORCING_CONSTANT, FORCING_SHARED, FORCING_PER_PLANT = 0, 1, 2


def plant_schedule_table(schedule: R.BoundaryConditions, n_steps: int,
                         batch: int, dtype, device) -> torch.Tensor:
    """Per-plant forcing as a ``[n_steps, 10, B]`` table: a ``[n_steps,
    B]`` field per step and plant, a ``[n_steps]`` field per step, a scalar
    for every step and plant. Host numbers convert as ``_column``'s do
    (through NumPy: a Python float stays float64 until the cast)."""
    cols = []
    for name in F.BOUNDARY_FIELDS:
        x = getattr(schedule, name)
        x = F.on_device(x if isinstance(x, torch.Tensor) else np.asarray(x),
                        device).to(dtype)
        x = x.reshape(tuple(x.shape) + (1,) * (2 - x.ndim))
        cols.append(x.expand(n_steps, batch))
    return torch.stack(cols, dim=1).contiguous()


@dataclass
class PlantTables:
    """One rollout's inputs as contiguous tables on one device."""

    statics: tuple              # sensor_statics(...)
    scheduled: int              # FORCING_CONSTANT, _SHARED or _PER_PLANT
    ptab: torch.Tensor          # [16, B] reactor parameters
    forcing: torch.Tensor       # [10, B], [n_steps, 10] or [n_steps, 10, B]
    sensor_params: torch.Tensor  # [N_PCOLS, B]
    carry_float: torch.Tensor   # [N_FLOAT_CCOLS, B]
    carry_int: torch.Tensor     # [N_INT_CCOLS, B] int32
    delay_steps: torch.Tensor   # [4, B] int32, each <= its line's d_max
    lead: List[torch.Tensor]    # 4 x [d_max + 1, B]: history lead-in
    ph: torch.Tensor            # [B, Z]
    cl: torch.Tensor
    t: torch.Tensor
    time: torch.Tensor          # [B]: each plant's clock
    # the four lead-ins in order, one buffer that ``lead`` views: B3's
    # histories start as one copy of it
    lead_block: torch.Tensor


@dataclass
class PlantResult:
    ph: torch.Tensor            # [B, Z]
    cl: torch.Tensor
    t: torch.Tensor
    time: torch.Tensor          # [B]
    carry_float: torch.Tensor   # [N_FLOAT_CCOLS, B]
    carry_int: torch.Tensor     # [N_INT_CCOLS, B]
    hist: List[torch.Tensor]    # 4 x [d_max + 1, B]
    readings: torch.Tensor      # [n_steps // record_every, 7, B]
    faults: Optional[torch.Tensor] = None   # int32, as readings


def _leaf(obj, sub, field):
    return getattr(obj.base if sub == "base" else obj, field)


def forcing_mode(boundary, n_steps: int, batch: int) -> int:
    """``FORCING_CONSTANT``, ``_SHARED`` or ``_PER_PLANT`` from the fields'
    ranks; raises for a schedule of another length than ``n_steps`` or a
    per-plant field of another shape than ``[n_steps, batch]``."""
    ndims = {name: getattr(getattr(boundary, name), "ndim", 0)
             for name in F.BOUNDARY_FIELDS}
    scheduled = FORCING_CONSTANT if max(ndims.values()) == 0 \
        else FORCING_SHARED if max(ndims.values()) == 1 \
        else FORCING_PER_PLANT
    if scheduled != FORCING_CONSTANT:
        lengths = {int(getattr(boundary, name).shape[0])
                   for name, nd in ndims.items() if nd >= 1}
        if lengths != {n_steps}:
            raise ValueError(f"schedule fields have length {lengths}; "
                             f"expected n_steps={n_steps}")
    if scheduled == FORCING_PER_PLANT:
        if any(tuple(getattr(boundary, name).shape) != (n_steps, batch)
               for name, nd in ndims.items() if nd == 2) \
                or max(ndims.values()) > 2:
            raise ValueError(f"per-plant schedule fields must be "
                             f"[{n_steps}, {batch}]")
    return scheduled


def _state_tables(state, dtype, single: bool):
    """The reactor state as the kernel's ``[B, Z]`` tables in ``dtype``."""
    def prep(x):
        x = x if x.dtype == dtype else x.to(dtype)
        return (x.unsqueeze(0) if single else x).contiguous()

    return prep(state.pH), prep(state.chlorine), prep(state.temperature)


@spanned("wt.b3.tables")
def build_tables(params, plant, boundary, *, dt: float, n_steps: int,
                 consume_line: bool = True) -> PlantTables:
    """Pack a plant (single ``[Z]`` or batched ``[B, Z]``) and its forcing
    into the kernel's tables, resolving the sample lines' lead-in from the
    incoming carry rings, with PyTorch operations (the plain version's
    route; ``pack_tables`` makes the same tables for B3)."""
    state = plant.reactor
    ph = state.pH
    single = ph.ndim == 1
    batch = 1 if single else ph.shape[0]
    dtype, device = ph.dtype, ph.device
    statics = sensor_statics(params, dt)

    scheduled = forcing_mode(boundary, n_steps, batch)
    if scheduled == FORCING_PER_PLANT:
        forcing = plant_schedule_table(boundary, n_steps, batch, dtype,
                                       device)
    elif scheduled == FORCING_SHARED:
        forcing = F.schedule_table(boundary, n_steps, dtype, device)
    else:
        forcing = F.boundary_table(boundary, batch, dtype, device)

    sensor_params = torch.stack([
        F._column(_leaf(getattr(params, attr), sub, field), batch, dtype,
                  device)
        for attr, sub, field in _PCOLS]).contiguous()
    carry_float = torch.stack([
        F._column(_leaf(getattr(plant, attr), sub, field), batch, dtype,
                  device)
        for attr, sub, field, _ in _FLOAT_CCOLS]).contiguous()
    carry_int = torch.stack([
        F._column(_leaf(getattr(plant, attr), sub, field), batch,
                  torch.int32, device)
        for attr, sub, field, _ in _INT_CCOLS]).contiguous()

    d_max_of = {attr: d_max for attr, _, _, _, d_max in statics}
    lead, delay_steps = [], []
    for attr in _LINE_ATTRS:
        sp = getattr(params, attr).base
        d_max = d_max_of[attr]
        delay = sp.line_delay_s.to(dtype)
        # round half to even, as the statics' np.round; never beyond the
        # history the statics sized
        d_arr = torch.clamp(torch.round(ieee_div(delay, dt)), 0.0,
                            float(d_max)).to(torch.int32)
        delay_steps.append(F._column(d_arr, batch, torch.int32, device))
        if consume_line and d_max > 0 and sp.line_capacity > 0:
            lead.append(_resolve_lead_in(
                getattr(plant, attr).base, delay, d_arr, d_max, state.time,
                dt, batch, dtype))
        else:
            lead.append(torch.full((d_max + 1, batch), math.nan,
                                   dtype=dtype, device=device))
    # the lead-ins as views of one block, as the pack makes them
    lead_block = torch.cat([x.reshape(-1) for x in lead])
    lead = [x.view(y.shape) for x, y in zip(
        lead_block.split([y.numel() for y in lead]), lead)]
    ph, cl, t = _state_tables(state, dtype, single)
    TABLE_PACKS["tensors"] += 1
    return PlantTables(
        statics=statics, scheduled=scheduled,
        ptab=F.param_table(params.reactor, batch, dtype, device),
        forcing=forcing, sensor_params=sensor_params,
        carry_float=carry_float, carry_int=carry_int,
        delay_steps=torch.stack(delay_steps).contiguous(), lead=lead,
        ph=ph, cl=cl, t=t,
        time=state.time.to(dtype).reshape(-1).expand(batch).contiguous(),
        lead_block=lead_block)


# ---------------------------------------------------------------------------
# The table pack: the same tables made on the card in one launch
# ---------------------------------------------------------------------------

# The leaves ``build_tables`` reads, in the pack kernel's order
# (csrc/fused_plant.cu: pack::kPCols .. pack::kLeaves): each sensor's
# parameters (``_PCOLS``), float carries and integer carries, the reactor
# parameters (``PARAM_COLS``, from ``params.reactor`` or its ``chem``), the
# boundary fields, the plant clock, then per sample line its ring's
# values, times, count and pointer and its delay.
_CHEM = {f.name for f in fields(R.ChemistryConstants)}
_PARAM_SUB = {name: "chem" if name in _CHEM else None
              for name in F.PARAM_COLS}
_LINE_LEAVES = ("line_values", "line_times", "line_count", "line_ptr")
PACK_LEAVES = tuple(
    [("params", attr, sub, field) for attr, sub, field in _PCOLS]
    + [("plant", attr, sub, field) for attr, sub, field, _ in _FLOAT_CCOLS]
    + [("plant", attr, sub, field) for attr, sub, field, _ in _INT_CCOLS]
    + [("reactor", _PARAM_SUB[name], name) for name in F.PARAM_COLS]
    + [("boundary", name) for name in F.BOUNDARY_FIELDS]
    + [("clock",)]
    + [leaf for attr in _LINE_ATTRS
       for leaf in [("plant", attr, "base", f) for f in _LINE_LEAVES]
       + [("params", attr, "base", "line_delay_s")]])
# The column leaves before the boundary fields as (holder, field): the
# holders are the reactor parameters, their chemistry, then per sensor its
# parameters, their base, its carry and the carry's base.
_HOLDERS = [("reactor", None), ("reactor", "chem")] + [
    (src, attr, sub) for _, attr, _ in SENSORS for src in ("params", "plant")
    for sub in (None, "base")]
_COLUMN_LEAVES = [(_HOLDERS.index(leaf[:-1]), leaf[-1])
                  for leaf in PACK_LEAVES[:N_PCOLS + N_CCOLS
                                          + len(F.PARAM_COLS)]]
# Rows of the float block before the forcing (sensor parameters, float
# carries, reactor parameters) and of the int32 block (integer carries,
# then the four delays in steps).
PACK_FLOAT_ROWS = N_PCOLS + N_FLOAT_CCOLS + len(F.PARAM_COLS)
PACK_INT_ROWS = N_INT_CCOLS + len(_LINE_ATTRS)

# Element types of a leaf (csrc/fused_plant.cu: pack::LeafKind): a tensor's,
# or a host number kept as ``_column`` keeps it, float64 or int64 until the
# cast.
LEAF_KINDS = {torch.float32: 0, torch.float64: 1, torch.bool: 2,
              torch.int32: 3, torch.int64: 4}
HOST_FLOAT, HOST_INT = 5, 6
_KIND_BITS = 4
_MAX_STRIDE = 1 << (32 - _KIND_BITS)

# The int64 fields the pack kernel takes besides the leaves
# (csrc/fused_plant.cu: pack::Layout), in order; the per-line ones hold
# four values, ``forcing_plant_stride`` ten (one per boundary field).
PACK_FIELDS = ("n_leaves", "n_pcols", "n_float_ccols", "n_int_ccols",
               "n_params", "n_boundary", "batch", "n_steps", "scheduled",
               "forcing_at", "clock_at", "forcing_plant_stride", "d_max",
               "slots", "lead", "value_slot_stride", "time_slot_stride",
               "lead_at")

# How often a call's tables were made, by route, counted where they are
# made: "kernel" the pack kernel (``pack_tables``, for B3), "tensors"
# PyTorch operations (``build_tables``, for the plain version on either
# device).
TABLE_PACKS = {"kernel": 0, "tensors": 0}


@dataclass
class TableDescriptor:
    """What the pack kernel reads. Per leaf of ``PACK_LEAVES``: its value
    (a tensor on the plant's device, a host number, or None for the ring of
    a line whose lead-in is not consumed), its element type (``LEAF_KINDS``,
    ``HOST_FLOAT``, ``HOST_INT``) and its batch stride (0: one value for
    every plant; a scheduled boundary field's is its step stride).
    ``layout``: ``PACK_FIELDS``' values, where the tables go in the float
    block included (elements from its start)."""

    leaves: list
    kinds: list
    strides: list
    layout: dict

    def arrays(self):
        """The arrays ``wt_pack_tables`` takes, as NumPy arrays: addresses
        (a host number's bits), codes (kind | stride << 4), the layout."""
        at = [x.data_ptr() if kind < HOST_FLOAT
              else struct.unpack("<Q", struct.pack("<d", x))[0]
              if kind == HOST_FLOAT else int(x or 0) & 0xFFFFFFFFFFFFFFFF
              for x, kind in zip(self.leaves, self.kinds)]
        code = np.array(self.kinds, np.uint32) \
            | np.array(self.strides, np.uint32) << np.uint32(_KIND_BITS)
        flat = []
        for name in PACK_FIELDS:
            v = self.layout[name]
            flat += v if isinstance(v, list) else [v]
        return (np.array(at, np.uint64), code, np.array(flat, np.int64))


def _host_entry(x):
    """A host number as ``_column`` converts it (through NumPy: a Python
    float stays float64): ``(value, kind, 0)``, or None for what is not
    one number."""
    a = np.asarray(x)
    if a.size != 1 or a.dtype.kind not in "fbiu":
        return None
    if a.dtype.kind == "f":
        return float(a.reshape(())), HOST_FLOAT, 0
    return int(a.reshape(())), HOST_INT, 0


def _tensor_entry(x: torch.Tensor, stride: int):
    kind = LEAF_KINDS.get(x.dtype)
    if kind is None:
        raise TypeError(f"the table pack reads float32, float64, bool, "
                        f"int32 and int64 leaves, not {x.dtype}")
    if not 0 <= stride < _MAX_STRIDE:
        raise ValueError(f"a leaf's stride {stride} is beyond the table "
                         f"pack's {_MAX_STRIDE}")
    return x, kind, stride


def _on(x, device):
    """``x`` where the pack kernel reads it: a tensor on ``device`` (as
    ``_column`` puts it there), or a host number, which travels in the
    descriptor."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else F.on_device(x, device)
    if _host_entry(x) is not None:
        return x
    return F.on_device(np.asarray(x), device)


def _column_entry(x, n: int, device):
    """``(value, kind, stride)`` of a leaf that ``_column(x, n, ...)``
    reads: one value, or ``n`` values ``stride`` elements apart."""
    x = _on(x, device)
    if not isinstance(x, torch.Tensor):
        return _host_entry(x)
    size = x.numel()
    if size == 1:
        return _tensor_entry(x, 0)
    if size != n:
        raise ValueError(f"a leaf of {size} values where the table takes "
                         f"1 or {n}")
    if x.ndim != 1:
        x = x.reshape(-1)
    return _tensor_entry(x, x.stride(0))


def _ring_entry(x, batch: int, device):
    """A ring's values or times (``[C]`` for every plant, or ``[B, C]``):
    ``((value, kind, plant stride), slot stride)``."""
    if not isinstance(x, torch.Tensor) or x.ndim not in (1, 2) \
            or (x.ndim == 2 and x.shape[0] not in (1, batch)):
        raise ValueError(f"a sample-line ring must be [C] or [{batch}, C]")
    if x.device != device:
        x = F.on_device(x, device)
    plant = x.stride(0) if x.ndim == 2 and x.shape[0] > 1 else 0
    return _tensor_entry(x, plant), x.stride(-1)


def describe_tables(params, plant, boundary, statics, *, dt: float,
                    n_steps: int, consume_line: bool = True
                    ) -> TableDescriptor:
    """The pack kernel's descriptor of the tables ``build_tables`` makes
    from these inputs (``statics``: ``sensor_statics(params, dt)``). Walks
    ``PACK_LEAVES`` reading each tensor's address, type and stride; a host
    number travels in the descriptor. Raises where ``build_tables`` would:
    a schedule of the wrong length or shape."""
    state = plant.reactor
    ph = state.pH
    batch = 1 if ph.ndim == 1 else ph.shape[0]
    device = ph.device
    scheduled = forcing_mode(boundary, n_steps, batch)

    # the objects the column leaves hang from (_HOLDERS' order), each
    # looked up once
    holders = [params.reactor, params.reactor.chem]
    for _, attr, _ in SENSORS:
        for obj in (getattr(params, attr), getattr(plant, attr)):
            holders += [obj, obj.base]
    entries = []
    for holder, field in _COLUMN_LEAVES:
        x = getattr(holders[holder], field)
        # the common leaf, one value on the device, without a call
        kind = LEAF_KINDS.get(x.dtype) if type(x) is torch.Tensor \
            and x.ndim == 0 and x.device == device else None
        entries.append((x, kind, 0) if kind is not None
                       else _column_entry(x, batch, device))

    plant_stride = [0] * len(F.BOUNDARY_FIELDS)
    for i, name in enumerate(F.BOUNDARY_FIELDS):
        x = getattr(boundary, name)
        if scheduled != FORCING_PER_PLANT:
            entries.append(_column_entry(
                x, n_steps if scheduled else batch, device))
            continue
        # [n_steps, B], [n_steps] or one value, broadcast as
        # plant_schedule_table broadcasts it
        x = _on(x, device)
        if not isinstance(x, torch.Tensor):
            entries.append(_host_entry(x))
            continue
        step = x.stride(0) if x.ndim >= 1 and x.shape[0] > 1 else 0
        if x.ndim == 2 and x.shape[1] > 1:
            plant_stride[i] = x.stride(1)
        entries.append(_tensor_entry(x, step))
    entries.append(_column_entry(state.time, batch, device))

    d_max_of = {attr: d_max for attr, _, _, _, d_max in statics}
    d_max, slots, lead, value_stride, time_stride = [], [], [], [], []
    for attr in _LINE_ATTRS:
        sp, carry = getattr(params, attr).base, getattr(plant, attr).base
        d_max.append(d_max_of[attr])
        ring = consume_line and d_max[-1] > 0 and sp.line_capacity > 0 \
            and carry.line_values.shape[-1] > 0
        lead.append(int(ring))
        if ring:
            (lv, vs), (lt, ts) = (_ring_entry(carry.line_values, batch,
                                              device),
                                  _ring_entry(carry.line_times, batch,
                                              device))
            entries += [lv, lt, _column_entry(carry.line_count, batch, device),
                        _column_entry(carry.line_ptr, batch, device)]
            slots.append(int(carry.line_values.shape[-1]))
        else:
            entries += [(None, HOST_INT, 0)] * len(_LINE_LEAVES)
            vs = ts = 0
            slots.append(0)
        value_stride.append(vs)
        time_stride.append(ts)
        if not isinstance(sp.line_delay_s, torch.Tensor):
            raise TypeError(f"{attr}: line_delay_s must be a tensor")
        entries.append(_column_entry(sp.line_delay_s, batch, device))

    forcing = {FORCING_CONSTANT: batch, FORCING_SHARED: n_steps,
               FORCING_PER_PLANT: n_steps * batch}[scheduled] \
        * len(F.BOUNDARY_FIELDS)
    forcing_at = PACK_FLOAT_ROWS * batch
    clock_at = forcing_at + forcing
    lead_at = [clock_at + batch]
    for d in d_max[:-1]:
        lead_at.append(lead_at[-1] + (d + 1) * batch)
    leaves, kinds, strides = (list(x) for x in zip(*entries))
    return TableDescriptor(leaves, kinds, strides, layout=dict(
        n_leaves=len(PACK_LEAVES), n_pcols=N_PCOLS,
        n_float_ccols=N_FLOAT_CCOLS, n_int_ccols=N_INT_CCOLS,
        n_params=len(F.PARAM_COLS), n_boundary=len(F.BOUNDARY_FIELDS),
        batch=batch, n_steps=n_steps, scheduled=scheduled,
        forcing_at=forcing_at, clock_at=clock_at,
        forcing_plant_stride=plant_stride, d_max=d_max, slots=slots,
        lead=lead, value_slot_stride=value_stride,
        time_slot_stride=time_stride, lead_at=lead_at))


@spanned("wt.b3.tables")
def pack_tables(params, plant, boundary, *, dt: float, n_steps: int,
                consume_line: bool = True) -> PlantTables:
    """``build_tables``' tables, bit for bit, made on the card by one
    launch of the pack kernel (``csrc/fused_plant.cu::pack_tables_kernel``)
    from ``describe_tables``' descriptor, passed in the launch's arguments.
    The tables are views of one buffer; the state tables are
    ``build_tables``'. A CPU plant raises: its tables are
    ``build_tables``'."""
    from ics_wt_physicsengine_torch.ops import _build

    state = plant.reactor
    ph = state.pH
    dtype, device = ph.dtype, ph.device
    if device.type != "cuda":
        raise ValueError("pack_tables needs a CUDA plant")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pack_tables: float32 or float64 plants, not "
                         f"{dtype}")
    statics = sensor_statics(params, dt)
    desc = describe_tables(params, plant, boundary, statics, dt=dt,
                           n_steps=n_steps, consume_line=consume_line)
    lay = desc.layout
    batch, d_max = lay["batch"], lay["d_max"]
    # one buffer in the working type: the float block, then the int32 block
    # (32 int32 rows of B fill whole elements of either type)
    lead_sizes = [(d + 1) * batch for d in d_max]
    n_ints = PACK_INT_ROWS * batch * 4 // ph.element_size()
    rows, forcing, time, *lead, ints = torch.empty(
        lay["lead_at"][-1] + lead_sizes[-1] + n_ints, dtype=dtype,
        device=device).split([PACK_FLOAT_ROWS * batch,
                              lay["clock_at"] - lay["forcing_at"], batch]
                             + lead_sizes + [n_ints])
    ints = ints.view(torch.int32)
    lib = _build.load("fused_plant")
    arrays = desc.arrays()      # alive until the launch has copied them
    with torch.cuda.device(device):     # the launch's current device
        err = lib.wt_pack_tables(
            int(dtype == torch.float64), *(a.ctypes.data for a in arrays),
            float(dt), rows.data_ptr(), ints.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("table pack kernel launch failed: "
                           f"{lib.wt_plant_error_string(err).decode()}")
    LAUNCHES["pack_tables"] += 1
    TABLE_PACKS["kernel"] += 1

    forcing_shape = {
        FORCING_CONSTANT: (len(F.BOUNDARY_FIELDS), batch),
        FORCING_SHARED: (n_steps, len(F.BOUNDARY_FIELDS)),
        FORCING_PER_PLANT: (n_steps, len(F.BOUNDARY_FIELDS), batch),
    }[lay["scheduled"]]
    sensor_params, carry_float, ptab = rows.view(PACK_FLOAT_ROWS, batch) \
        .split([N_PCOLS, N_FLOAT_CCOLS, len(F.PARAM_COLS)])
    carry_int, delay_steps = ints.view(PACK_INT_ROWS, batch).split(
        [N_INT_CCOLS, len(_LINE_ATTRS)])
    ph, cl, t = _state_tables(state, dtype, ph.ndim == 1)
    return PlantTables(
        statics=statics, scheduled=lay["scheduled"], ptab=ptab,
        forcing=forcing.view(forcing_shape), sensor_params=sensor_params,
        carry_float=carry_float, carry_int=carry_int,
        delay_steps=delay_steps,
        lead=[x.view(d + 1, batch) for x, d in zip(lead, d_max)],
        ph=ph, cl=cl, t=t, time=time,
        lead_block=rows.as_strided((sum(lead_sizes),), (1,),
                                   lead[0].storage_offset()))


def _words_for(bits, batch, n_steps, device):
    if bits is None:
        return None
    bits = torch.as_tensor(bits, device=device)
    expect = (n_steps, N_WORDS, batch)
    if bits.dtype != torch.int32 or tuple(bits.shape) != expect:
        raise ValueError(f"bits must be int32 {expect}, got {bits.dtype} "
                         f"{tuple(bits.shape)}")
    return bits.contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path; the reference for the kernel)
# ---------------------------------------------------------------------------

_PARAM_CLS = {"ph": SP.PHSensorParams, "cl": SC.ChlorineSensorParams,
              "flow": SF.FlowSensorParams,
              "temp": ST.TemperatureSensorParams}
_CARRY_CLS = {"ph": SP.PHSensorCarry, "cl": SC.ChlorineSensorCarry,
              "flow": SF.FlowSensorCarry,
              "temp": ST.TemperatureSensorCarry}
_FCOL = {c[:3]: i for i, c in enumerate(_FLOAT_CCOLS)}
_ICOL = {c[:3]: i for i, c in enumerate(_INT_CCOLS)}


def _unpack_sensor(tables: PlantTables, attr, kind, sensor_type):
    """The sensor's params (sample line resolved outside: no ring) and
    carry as the ``sensors`` package's objects with ``[B]`` fields."""
    sp, cf, ci = tables.sensor_params, tables.carry_float, tables.carry_int
    zero = torch.zeros_like(sp[0])
    base_p = SB.SensorParams(
        line_capacity=0, response_time=zero, hysteresis_magnitude=zero,
        line_delay_s=zero,
        **{f: sp[_PCOL[(attr, "base", f)]] for f in _BASE_P})
    extra = {f: sp[_PCOL[(attr, None, f)]] for f in _OVERLAY_P[kind]}
    if kind == "ph":
        p = SP.PHSensorParams(zone_index=0, base=base_p, **extra)
    elif kind == "flow":
        p = SF.FlowSensorParams(sensor_type=sensor_type, base=base_p,
                                **extra)
    else:
        p = _PARAM_CLS[kind](zone_index=0, sensor_type=sensor_type,
                             base=base_p, **extra)

    base_c = {}
    for f, tag in _BASE_C:
        if tag == "f":
            base_c[f] = cf[_FCOL[(attr, "base", f)]]
        else:
            v = ci[_ICOL[(attr, "base", f)]]
            base_c[f] = v != 0 if tag == "b" else v
    base_c = SB.SensorCarry(
        **base_c, line_values=zero[:, None], line_times=zero[:, None],
        line_count=torch.zeros_like(ci[0]), line_ptr=torch.zeros_like(ci[0]))
    c = _CARRY_CLS[kind](base=base_c, **{
        f: cf[_FCOL[(attr, None, f)]] for f, _ in _OVERLAY_C[kind]})
    return p, c


def _pack_carries(carries, like_float, like_int):
    cf = torch.stack([
        _leaf(carries[attr], sub, field).to(like_float.dtype)
        for attr, sub, field, _ in _FLOAT_CCOLS])
    ci = torch.stack([
        _leaf(carries[attr], sub, field).to(torch.int32)
        for attr, sub, field, _ in _INT_CCOLS])
    return cf.contiguous(), ci.contiguous()


def plant_plain(tables: PlantTables, *, dt: float, substeps: int,
                n_steps: int, stages: Optional[int] = None,
                record_every: int = 1, bits=None, seed: int = 0,
                step0: int = 0, plant0: int = 0,
                record_faults: bool = False) -> PlantResult:
    """Plain PyTorch version of kernel B3 on tables: a Python loop over
    steps. ``bits`` None draws the Philox stream of ``seed`` from step
    ``step0`` and plant ``plant0``; ``record_faults`` records the fault
    codes too."""
    ph, cl, t = tables.ph, tables.cl, tables.t
    batch, n_zones = ph.shape
    dtype, device = ph.dtype, ph.device
    bits = _words_for(bits, batch, n_steps, device)
    col = F.BOUNDARY_FIELDS.index
    p = {name: tables.ptab[i][:, None] for i, name in enumerate(F.PARAM_COLS)}

    def forcing_at(get):
        terms = F._boundary_terms(p, lambda name: get(col(name)))
        flow_total = get(col("inlet_flow_rate")) \
            + get(col("acid_flow_rate")) + get(col("chlorine_flow_rate"))
        step_fn = F._make_stepper(F._make_deriv(p, terms, n_zones),
                                  dt / substeps, stages)
        return step_fn, flow_total.reshape(-1).expand(batch)

    if not tables.scheduled:
        step_fn, flow_total = forcing_at(
            lambda i: tables.forcing[i][:, None])

    info = {attr: (zone, typ, d_max)
            for attr, zone, typ, _, d_max in tables.statics}
    sensors = {attr: _unpack_sensor(tables, attr, kind, info[attr][1])
               for _, attr, kind in SENSORS}
    sparams = {attr: pc[0] for attr, pc in sensors.items()}
    carries = {attr: pc[1] for attr, pc in sensors.items()}
    hist = {attr: tables.lead[i].clone()
            for i, attr in enumerate(_LINE_ATTRS)}
    delay = {attr: tables.delay_steps[i].to(torch.int64)
             for i, attr in enumerate(_LINE_ATTRS)}

    def delayed(attr, g, tap):
        """Append this step's tap to the circular history, read the tap
        from ``d`` steps ago; a NaN lead-in slot falls back to slot 0."""
        d_max = info[attr][2]
        if d_max == 0:
            return tap
        cap = d_max + 1
        h = hist[attr]
        h[g % cap] = tap
        slot = torch.remainder(g - delay[attr] + cap, cap)
        v = torch.gather(h, 0, slot[None, :])[0]
        return torch.where(torch.isnan(v), h[0], v)

    time = tables.time.clone()
    chunk = max(1, (1 << 16) // batch)   # steps of Philox words at a time
    words_chunk, chunk0 = None, 0
    rows, fault_rows = [], []
    for g in range(n_steps):
        if tables.scheduled == FORCING_SHARED:
            row = tables.forcing[g]
            step_fn, flow_total = forcing_at(lambda i: row[i])
        elif tables.scheduled == FORCING_PER_PLANT:
            row = tables.forcing[g]
            step_fn, flow_total = forcing_at(lambda i: row[i][:, None])
        carry = (ph, cl, t)
        for _ in range(substeps):
            carry = step_fn(carry)
        ph, cl, t = F._bound(*carry)
        time = time + dt
        now = time

        if bits is not None:
            words = bits[g]
        else:
            if words_chunk is None or g >= chunk0 + words_chunk.shape[0]:
                chunk0 = g
                words_chunk = philox_words(seed, step0 + g,
                                           min(chunk, n_steps - g), batch,
                                           device, plant0=plant0)
            words = words_chunk[g - chunk0]

        values, faults = [], []
        for _, attr, kind in SENSORS:
            zone = info[attr][0]
            w0 = _WORD_OFFSET[attr]
            rand = rand_from_words(words[w0:w0 + words_per_sensor(kind)],
                                   *_RAND[kind], dtype=dtype)
            sp, c = sparams[attr], carries[attr]
            if kind == "ph":
                tap_ph, tap_t = ph[:, zone], t[:, zone]
                comp = SP.nernst_compensated_ph(sp, tap_ph, tap_t)
                c, out = SP.ph_read(sp, c, tap_ph, tap_t, now, rand=rand,
                                    delayed_true=delayed(attr, g, comp))
            elif kind == "cl":
                c, out = SC.chlorine_read(sp, c, cl[:, zone], ph[:, zone],
                                          now, rand=rand)
            elif kind == "flow":
                c, out = SF.flow_read(sp, c, flow_total, now, rand=rand)
            else:
                tap_t = t[:, zone]
                c, out = ST.temperature_read(
                    sp, c, tap_t, now, rand=rand,
                    delayed_true=delayed(attr, g, tap_t))
            carries[attr] = c
            values.append(out.value)
            faults.append(out.fault)
        if (g + 1) % record_every == 0:
            rows.append(torch.stack(values))
            fault_rows.append(torch.stack(faults).to(torch.int32))

    carry_float, carry_int = _pack_carries(carries, tables.carry_float,
                                           tables.carry_int)
    readings = torch.stack(rows) if rows else \
        ph.new_empty((0, len(SENSORS), batch))
    faults = None
    if record_faults:
        faults = torch.stack(fault_rows) if fault_rows else torch.empty(
            (0, len(SENSORS), batch), dtype=torch.int32, device=device)
    return PlantResult(ph=ph, cl=cl, t=t, time=time,
                       carry_float=carry_float, carry_int=carry_int,
                       hist=[hist[a] for a in _LINE_ATTRS],
                       readings=readings, faults=faults)


# ---------------------------------------------------------------------------
# Kernel launcher (CUDA tensors only)
# ---------------------------------------------------------------------------


# The fields of the kernel's ``PlantStatics`` (csrc/fused_plant.cu), in
# order: one int per sensor each, then ``d_max`` per sample line.
STATICS_FIELDS = ("zone", "type", "param_col", "float_col", "int_col",
                  "word", "n_words", "block", "skip", "n_blocks", "d_max")


def statics_fields(statics) -> dict:
    """``PlantStatics`` as ``{field: [int, ...]}``: per sensor its tapped
    zone, type code, first parameter, float carry and integer carry
    columns, its words in a step (first, count) and the Philox blocks that
    hold them (first, skip into it, count); per sample line ``d_max``."""
    by_attr = {attr: (zone, typ, d_max)
               for attr, zone, typ, _, d_max in statics}
    out = {name: [] for name in STATICS_FIELDS}
    for _, attr, kind in SENSORS:
        word, n_words = _WORD_OFFSET[attr], words_per_sensor(kind)
        block = word // 4
        out["zone"].append(by_attr[attr][0])
        out["type"].append(TYPE_CODES[kind](by_attr[attr][1]))
        out["param_col"].append(_PCOL[(attr, "base", _BASE_P[0])])
        out["float_col"].append(_FCOL[(attr, "base", _BASE_C[0][0])])
        out["int_col"].append(_ICOL[(attr, "base", "has_calibration")])
        out["word"].append(word)
        out["n_words"].append(n_words)
        out["block"].append(block)
        out["skip"].append(word - 4 * block)
        out["n_blocks"].append((word + n_words - 1) // 4 - block + 1)
    out["d_max"] = [by_attr[attr][2] for attr in _LINE_ATTRS]
    return out


def _statics_array(statics):
    """``statics_fields`` flattened in ``STATICS_FIELDS`` order as the C
    int array the kernel copies into its ``PlantStatics``."""
    fields = statics_fields(statics)
    flat = [v for name in STATICS_FIELDS for v in fields[name]]
    return (ctypes.c_int * len(flat))(*flat)


def plant_kernel(tables: PlantTables, *, dt: float, substeps: int,
                 n_steps: int, stages: Optional[int] = None,
                 record_every: int = 1, bits=None, seed: int = 0,
                 step0: int = 0, plant0: int = 0,
                 record_faults: bool = False) -> PlantResult:
    """Kernel B3 on CUDA tables (same contract as ``plant_plain``)."""
    from ics_wt_physicsengine_torch.ops import _build

    name = "plant_rollout_fused"
    ph = tables.ph
    dtype, device = ph.dtype, ph.device
    F._check_launch(name, (ph, tables.ptab, tables.forcing,
                           tables.sensor_params, tables.carry_float,
                           tables.cl, tables.t, tables.time, *tables.lead),
                    (tables.carry_int, tables.delay_steps), stages)
    batch, n_zones = ph.shape
    d_max = [s[4] for s in tables.statics if s[0] in _LINE_ATTRS]
    if tables.cl.shape != ph.shape or tables.t.shape != ph.shape \
            or tables.ptab.shape != (len(F.PARAM_COLS), batch) \
            or tables.sensor_params.shape != (N_PCOLS, batch) \
            or tables.carry_float.shape != (N_FLOAT_CCOLS, batch) \
            or tables.carry_int.shape != (N_INT_CCOLS, batch) \
            or tables.delay_steps.shape != (len(_LINE_ATTRS), batch) \
            or tables.time.shape != (batch,) \
            or any(x.shape != (d + 1, batch)
                   for x, d in zip(tables.lead, d_max)) \
            or tables.forcing.shape != {
                FORCING_CONSTANT: (len(F.BOUNDARY_FIELDS), batch),
                FORCING_SHARED: (n_steps, len(F.BOUNDARY_FIELDS)),
                FORCING_PER_PLANT: (n_steps, len(F.BOUNDARY_FIELDS), batch),
            }[tables.scheduled]:
        raise ValueError(f"{name}: shapes disagree")
    if not 1 <= n_zones <= F.MAX_ZONES:
        raise ValueError(f"{name}: n_zones must be in [1, {F.MAX_ZONES}]")
    if record_every < 1 or n_steps % record_every:
        raise ValueError(f"n_steps={n_steps} must be a multiple of "
                         f"record_every={record_every}")
    words = _words_for(bits, batch, n_steps, device)
    geometry = plant_geometry(n_zones, batch)

    lib = _build.load("fused_plant")
    n_rec = n_steps // record_every
    # the histories start as one copy of the lead-ins' block (a clone each
    # is four cudaMemcpy calls a launch); the kernel indexes them by
    # element, so any offset in the buffer will do
    sizes = [x.numel() for x in tables.lead]
    hist = [h.view(x.shape) for h, x in zip(
        tables.lead_block.clone().split(sizes), tables.lead)]
    out = PlantResult(
        ph=torch.empty_like(ph), cl=torch.empty_like(ph),
        t=torch.empty_like(ph), time=torch.empty_like(tables.time),
        carry_float=torch.empty_like(tables.carry_float),
        carry_int=torch.empty_like(tables.carry_int),
        hist=hist,
        readings=torch.empty((n_rec, len(SENSORS), batch), dtype=dtype,
                             device=device),
        faults=torch.empty((n_rec, len(SENSORS), batch), dtype=torch.int32,
                           device=device) if record_faults else None)
    h_step = dt / substeps
    rkc = F._rkc_host_table(stages, h_step) if stages is not None else None
    hist_ptrs = (ctypes.c_void_p * len(out.hist))(
        *(x.data_ptr() for x in out.hist))
    with torch.cuda.device(device):     # the launch's current device
        err = lib.wt_plant_rollout(
            int(dtype == torch.float64), tables.ptab.data_ptr(),
            tables.forcing.data_ptr(), int(tables.scheduled),
            ctypes.cast(rkc, ctypes.c_void_p) if rkc is not None else None,
            stages or 0, tables.sensor_params.data_ptr(),
            tables.carry_float.data_ptr(), tables.carry_int.data_ptr(),
            tables.delay_steps.data_ptr(),
            words.data_ptr() if words is not None else None,
            int(seed) & 0xFFFFFFFFFFFFFFFF, int(step0) & _MASK32,
            int(plant0) & _MASK32, tables.time.data_ptr(),
            tables.ph.data_ptr(), tables.cl.data_ptr(), tables.t.data_ptr(),
            out.ph.data_ptr(), out.cl.data_ptr(), out.t.data_ptr(),
            out.time.data_ptr(), out.carry_float.data_ptr(),
            out.carry_int.data_ptr(), ctypes.cast(hist_ptrs, ctypes.c_void_p),
            out.readings.data_ptr(),
            out.faults.data_ptr() if out.faults is not None else None,
            ctypes.cast(_statics_array(tables.statics), ctypes.c_void_p),
            batch, n_zones, geometry.plants_per_block,
            geometry.physics_threads, geometry.sensor_stride, n_steps,
            substeps, record_every, h_step, dt,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.wt_plant_error_string(err).decode()}")
    LAUNCHES[name] += 1
    _DIVISION_DEVICES.add(tables.ph.get_device())
    return out


# ---------------------------------------------------------------------------
# Public wrapper (plant objects in and out, of the caller's own classes)
# ---------------------------------------------------------------------------


def unsupported_reason(params) -> Optional[str]:
    """Why the fused plant kernel cannot run this configuration, or None
    when it can."""
    rparams = params.reactor
    if any(getattr(rparams, axis) is not None for axis in R.EXTENSION_AXES) \
            or any(getattr(params, name) is not None for name in (
                "ammonia_outlet", "oxygen_outlet", "turbidity_outlet")):
        return ("the fused plant kernel does not support the nitrogen/gas/"
                "particle/disinfection/biofilm/phase extensions; use the "
                "plant_step loop (models.plant.plant_rollout)")
    if rparams.n_zones > F.MAX_ZONES:
        return f"fused plant supports n_zones <= {F.MAX_ZONES}"
    return None


def plant_rollout_fused(params, plant, boundary, *, dt: float,
                        substeps: int, n_steps: int,
                        stages: Optional[int] = None, record_every: int = 1,
                        rng: str = "philox", bits=None, seed: int = 0,
                        consume_line: bool = True, step0: int = 0,
                        plant0: int = 0):
    """Advance the full instrumented plant ``n_steps`` in one launch of
    kernel B3 (its plain version for a CPU plant).

    Returns ``(new_plant, readings)`` where readings maps each sensor name
    to its measured values ``[n_steps // record_every, ...]``.

    ``boundary`` may be constant (scalar fields) or a schedule: a
    BoundaryConditions with ``[n_steps]`` fields (scalars hold for every
    step), one row per step for every plant.

    ``rng="philox"`` draws the Philox stream of ``seed`` from step
    ``step0``; ``rng="bits"`` consumes caller-supplied int32 ``bits`` of
    shape ``[n_steps, N_WORDS, B]`` (see the module docstring).

    Sample lines: delays may differ per plant, sensors may tap any zone
    (``zone_index``, uniform over the batch), and the incoming carry rings
    are consumed (``consume_line=True``): the first ``delay`` reads resolve
    against the pre-rollout ring contents with the exact nearest-timestamp
    rule, and on exit the histories are written back into the carry rings,
    so chaining with the ``plant_step`` loop in either direction is
    sample-exact.

    ``plant0``: the batch is lanes ``plant0 ..`` of a larger fleet (the
    Philox plant counter starts there).

    Constraints: n_zones <= 128; no extension axis. Each plant keeps its
    own clock.
    """
    if rng not in ("philox", "bits"):
        raise ValueError(f"unknown rng {rng!r} (philox or bits)")
    if (rng == "bits") != (bits is not None):
        raise ValueError("rng='bits' needs bits=, and bits= needs "
                         "rng='bits'")
    if record_every < 1 or n_steps % record_every:
        raise ValueError(f"n_steps={n_steps} must be a multiple of "
                         f"record_every={record_every}")
    new_plant, values, _ = _rollout_with(
        table_runner(params, plant), params, plant, boundary, dt=dt,
        substeps=substeps, n_steps=n_steps, stages=stages,
        record_every=record_every, bits=bits, seed=seed,
        consume_line=consume_line, step0=step0, plant0=plant0)
    return new_plant, {rname: values[:, k]
                       for k, (rname, _, _) in enumerate(SENSORS)}


def kernel_route():
    """B3's route: ``(pack_tables, plant_kernel)``, the tables made by the
    pack kernel and run by B3."""
    return pack_tables, plant_kernel


def tensor_route():
    """The plain version's route: ``(build_tables, plant_plain)``, the
    tables made by PyTorch operations and run by the plain version, on
    either device."""
    return build_tables, plant_plain


def table_runner(params, plant):
    """The route a plant's device selects, ``(make tables, run them)``:
    ``kernel_route()`` for a CUDA plant, ``tensor_route()`` for a CPU
    plant. Raises for a configuration the kernel does not support."""
    reason = unsupported_reason(params)
    if reason is not None:
        raise ValueError(reason)
    device = plant.reactor.pH.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return kernel_route() if device.type == "cuda" else tensor_route()


@spanned("wt.b3.wrapper")
def _rollout_with(route, params, plant, boundary, *, dt, substeps, n_steps,
                  stages, record_every, bits, seed, consume_line,
                  step0: int = 0, plant0: int = 0, served: bool = False):
    """``plant_rollout_fused`` on ``route`` (``table_runner``'s): make the
    tables, run, rebuild the plant. The kernel checks call it with
    ``tensor_route()`` on CUDA tensors for the reference on the card.

    Returns ``(plant, values, faults)``: the record as the kernel writes it,
    ``[n_steps // record_every, 7, B]`` in ``SENSORS`` order (``[...,
    7]`` for a single plant), and the fault codes alike or None.

    ``served``: a served chunk's (``models.plant.plant_serve_chunk``). The
    fault codes are recorded, and a chunk shorter than a sample line's
    history joins the rebuilt ring with the ring before it
    (``_join_rings``), so that short chunks chain as one longer chunk
    would. Without it the rings keep the JAX package's loss of history
    (the module docstring)."""
    state = plant.reactor
    single = state.pH.ndim == 1
    batch = 1 if single else state.pH.shape[0]
    dtype = state.pH.dtype
    make_tables, run = route
    tables = make_tables(params, plant, boundary, dt=dt, n_steps=n_steps,
                         consume_line=consume_line)
    with span("wt.b3.launch"):
        out = run(tables, dt=dt, substeps=substeps, n_steps=n_steps,
                  stages=stages, record_every=record_every, bits=bits,
                  seed=seed, step0=step0, plant0=plant0,
                  record_faults=served)

    with span("wt.b3.unpack"):
        def unprep(x):
            return x[0] if single else x

        last = tables.forcing[n_steps - 1] if tables.scheduled \
            else tables.forcing[:, 0] if single else tables.forcing
        col = F.BOUNDARY_FIELDS.index
        total_flow = last[col("inlet_flow_rate")] \
            + last[col("acid_flow_rate")] + last[col("chlorine_flow_rate")]
        # each plant's clock; a batch that kept one shared clock keeps it
        time = out.time.to(state.time.dtype)
        time = time.reshape(state.time.shape) \
            if state.time.numel() == batch else time[0] + torch.zeros_like(
                state.time)
        new_reactor = R._update_derived(R.ReactorState(
            time=time,
            pH=unprep(out.ph), chlorine=unprep(out.cl),
            temperature=unprep(out.t),
            flow_rate=total_flow + torch.zeros_like(state.flow_rate)))

        # the plant again: updated carries, and delay rings rebuilt from
        # the written-back histories (joined with the old ones when served)
        t0 = tables.time
        sensors_new = {}
        for _, attr, kind in SENSORS:
            old = getattr(plant, attr)
            base_updates, overlay_updates = {}, {}
            for a, sub, field, tag in _CCOLS:
                if a != attr:
                    continue
                ref = _leaf(old, sub, field)
                if tag == "f":
                    val = unprep(out.carry_float[_FCOL[(a, sub, field)]]) \
                        .to(ref.dtype)
                else:
                    val = unprep(out.carry_int[_ICOL[(a, sub, field)]])
                    val = val != 0 if tag == "b" else val
                (base_updates if sub == "base"
                 else overlay_updates)[field] = val
            if attr in _LINE_ATTRS:
                i = _LINE_ATTRS.index(attr)
                d_max = tables.lead[i].shape[0] - 1
                if d_max > 0 and old.base.line_values is not None:
                    rings = _rebuild_rings(out.hist[i], old.base, d_max,
                                           n_steps, t0, dt, batch, dtype)
                    if served and n_steps < min(
                            d_max + 1, old.base.line_values.shape[-1]):
                        rings = _join_rings(old.base, rings, d_max + 1)
                    base_updates.update(rings)
            sensors_new[attr] = replace(
                old, base=replace(old.base, **base_updates),
                **overlay_updates)

        new_plant = type(plant)(reactor=new_reactor, **sensors_new)
        if single:
            return new_plant, out.readings[..., 0], \
                out.faults[..., 0] if served else None
        return new_plant, out.readings, out.faults
