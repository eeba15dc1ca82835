"""
Equilibrium-pH Newton solver: kernel B4, its plain PyTorch version and
their wrappers (port of ``ics_wt_physicsengine_tpu/ops/ph_solver.py``).

Kernel (``csrc/ph_solver.cu``, CUDA C++ for sm_90a, bound with ctypes):
B4 ``wt_solve_ph`` replaces ``_ph_newton_kernel``
(ics_wt_physicsengine_tpu/ops/ph_solver.py:55). For every element of an
array of any shape it runs up to ``iters`` iterations of damped
Newton-Raphson on the carbonate charge balance in one launch. A lane
takes a new element as soon as its own is done (converged, or ``iters``
reached), so the card does only the iterations that change a result; the
TPU kernel runs every element through all ``iters`` in lockstep and
freezes the done ones. The launch geometry is the host's
(``ph_geometry``, ``kernel_geometry``); where the elements outnumber the
grid's lanes, warps draw further runs of 32 elements from a counter that
belongs to the launch (one per stream, left at zero by each launch).

What bounds it on an H100: the live iterations (``ph_live_iters``: each
element's iterations up to and including the one that meets the
tolerance). Over those, its operations (``ph_live_ops`` over the
non-tensor peak of the working type) and its bytes (``ph_bytes``) weigh
about alike. ``ph_ops`` counts all ``iters`` for every element, the bound
of the lockstep kernel.

The step cap of iteration ``i`` is ``MAX_NEWTON_STEP * NEWTON_STEP_DECAY **
i`` folded in double on the host and cast to the working type, one table of
``iters`` entries that the kernel and the plain version both read (the TPU
kernel computes ``exp(i * log(decay))`` in the working type instead, for
want of a ``powf``; the two agree within the solver's tolerance).

float32: the default tolerance 1e-6 lies below the resolution of pH near
the root, so an element that cannot meet it keeps stepping inside the
decayed cap (~1e-2 by iteration 100). ``solve_pH_kernel`` warns about such
a call; pass float64 where solver-grade accuracy matters. For the same
reason the kernel and the plain version round alike (same operation order,
no FMA contraction, IEEE division) and agree bit for bit.

Which path runs is decided by the device of the tensors alone: CPU tensors
take the plain version (``solve_pH_kernel``) or ``core.chemistry.solve_pH``
(``solve_pH_auto``), CUDA tensors launch the kernel or raise. Constants on
the card with a guess on the CPU, or the other way round, raise too
(``inputs_device``): nothing is copied off the card to be solved on the
host. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass

import torch

from ics_wt_physicsengine_torch.core import chemistry as chem
from ics_wt_physicsengine_torch.core.chemistry import (
    LN10, MAX_ITERATIONS, MAX_NEWTON_STEP, NEWTON_STEP_DECAY, PH_TOLERANCE,
    ChemistryConstants)
from ics_wt_physicsengine_torch.ops import _build

DEFAULT_ITERS = MAX_ITERATIONS

LAUNCHES = {"solve_pH_kernel": 0}

# Operations per element per iteration, counted from
# csrc/ph_newton.cuh::newton_delta and its caller as written (each add,
# subtract, multiply, divide, exp, abs, compare and select counts one; a
# negation is an operand modifier and counts nothing): h 2, oh 1, d 5,
# a1 2, a2 2, f 7, dh 1, doh 3, dd 2, da1 5, da2 4, df 8, Newton step 1,
# its clip 2, update and clip 3, done test 2, selection 1, mask update 1
# (the last two are the lockstep kernel's; the redesigned one spends them
# on its iteration count and loop test instead). Counted as written:
# ``ka1 * ka2`` (three times, loop-invariant), ``d * d`` and ``h * h``
# (twice each) are counted each time, 5 operations a compiler may share;
# against that, the 7 divisions and the ``exp`` count one each and cost
# many instructions.
PH_OPS = 52
N_ARRAYS = 7        # Kw, Ka1, Ka2, C_T, alk, pH0 in; pH out


def ph_ops(n_elements: int, iters: int = DEFAULT_ITERS) -> int:
    """Operations a solve of these sizes does when every element runs all
    ``iters`` iterations, as the TPU kernel does (see ``PH_OPS``)."""
    return n_elements * iters * PH_OPS


def ph_live_ops(live: torch.Tensor) -> int:
    """Operations of the live iterations ``live`` (``ph_live_iters``): the
    work a solve cannot skip."""
    return int(live.sum()) * PH_OPS


def ph_bytes(n_elements: int, element_size: int,
             iters: int = DEFAULT_ITERS) -> int:
    """Bytes a solve must move: six inputs and the cap table read once, the
    output written once."""
    return (N_ARRAYS * n_elements + iters) * element_size


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def step_caps(iters: int) -> list:
    """The step cap of each iteration, folded in double."""
    return [MAX_NEWTON_STEP * NEWTON_STEP_DECAY ** i for i in range(iters)]


@functools.lru_cache(maxsize=16)
def _cap_table(iters: int, dtype, device) -> torch.Tensor:
    return torch.tensor(step_caps(iters), dtype=torch.float64).to(
        dtype).to(device)


def inputs_device(constants: ChemistryConstants, initial_guess) -> torch.device:
    """The one device the solver's inputs lie on. A Python number or a
    0-dim CPU tensor counts as a scalar and follows the others (PyTorch's
    own rule); tensor inputs on different devices raise ``ValueError``, so
    that no input is ever copied off the card to solve on the CPU."""
    tensors = [x for x in (constants.Kw, constants.Ka1, constants.Ka2,
                           constants.C_T_mol, constants.alk_eq,
                           initial_guess) if isinstance(x, torch.Tensor)]
    devices = {x.device for x in tensors
               if x.ndim > 0 or x.device.type != "cpu"}
    if len(devices) > 1:
        raise ValueError(
            "solve_pH: the constants and the guess lie on different "
            f"devices ({', '.join(sorted(map(str, devices)))})")
    return devices.pop() if devices else torch.device("cpu")


def broadcast_inputs(constants: ChemistryConstants, initial_guess):
    """``(args, shape)``: the six solver inputs broadcast to ``shape`` as
    flat contiguous tensors on ``inputs_device``, in the guess's dtype (the
    constants' for a Python guess). ``args`` is what ``ph_kernel`` and
    ``ph_plain`` take."""
    device = inputs_device(constants, initial_guess)
    dtype = initial_guess.dtype if isinstance(initial_guess, torch.Tensor) \
        else torch.as_tensor(constants.Kw).dtype
    args = torch.broadcast_tensors(*(
        torch.as_tensor(x, device=device).to(dtype)
        for x in (constants.Kw, constants.Ka1, constants.Ka2,
                  constants.C_T_mol, constants.alk_eq, initial_guess)))
    shape = args[0].shape
    return [a.reshape(-1).contiguous() for a in args], shape


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path; the reference for the kernel)
# ---------------------------------------------------------------------------


def ph_plain(kw, ka1, ka2, ct, alk, ph0, *, iters: int = DEFAULT_ITERS,
             tolerance: float = PH_TOLERANCE) -> torch.Tensor:
    """The kernel's arithmetic, operation for operation, on tensors of one
    shape (any device): ``exp(-ln10 pH)`` for the hydrogen ion, the cap
    table of ``step_caps``, a boolean done-mask."""
    caps = _cap_table(iters, ph0.dtype, ph0.device)
    tol = torch.tensor(tolerance, dtype=torch.float64).to(ph0.dtype).to(
        ph0.device)
    ph = ph0
    done = torch.zeros_like(ph, dtype=torch.bool)
    for i in range(iters):
        h = torch.exp(-LN10 * ph)
        oh = kw / h
        d = h * h + ka1 * h + ka1 * ka2
        a1 = ka1 * h / d
        a2 = ka1 * ka2 / d
        f = h - oh + a1 * ct + 2.0 * a2 * ct - alk

        dh_dph = -LN10 * h
        doh_dph = -(kw / (h * h)) * dh_dph
        dd_dh = 2.0 * h + ka1
        da1_dh = ka1 * (d - h * dd_dh) / (d * d)
        da2_dh = -ka1 * ka2 * dd_dh / (d * d)
        df = dh_dph - doh_dph + ct * da1_dh * dh_dph \
            + 2.0 * ct * da2_dh * dh_dph

        cap = caps[i]
        delta = torch.clamp(-f / df, min=-cap, max=cap)
        ph_new = torch.clamp(ph + delta, min=0.0, max=14.0)
        ph = torch.where(done, ph, ph_new)
        done = done | (torch.abs(delta) < tol)
    return ph


def ph_live_iters(kw, ka1, ka2, ct, alk, ph0, *, iters: int = DEFAULT_ITERS,
                  tolerance: float = PH_TOLERANCE):
    """``(pH, live)``: ``ph_plain``'s iteration with a count beside it, so
    its pH is ``ph_plain``'s bit for bit (the tests hold it so), and each
    element's live iterations as int64: the iterations up to and including
    the one whose step met the tolerance, or ``iters`` for an element that
    never meets it (NaN inputs, ``tolerance=0``, float32 elements stuck
    below their resolution). Their sum is the work the kernel cannot
    skip."""
    caps = _cap_table(iters, ph0.dtype, ph0.device)
    tol = torch.tensor(tolerance, dtype=torch.float64).to(ph0.dtype).to(
        ph0.device)
    ph = ph0
    done = torch.zeros_like(ph, dtype=torch.bool)
    live = torch.zeros_like(ph, dtype=torch.int64)
    for i in range(iters):
        h = torch.exp(-LN10 * ph)
        oh = kw / h
        d = h * h + ka1 * h + ka1 * ka2
        a1 = ka1 * h / d
        a2 = ka1 * ka2 / d
        f = h - oh + a1 * ct + 2.0 * a2 * ct - alk

        dh_dph = -LN10 * h
        doh_dph = -(kw / (h * h)) * dh_dph
        dd_dh = 2.0 * h + ka1
        da1_dh = ka1 * (d - h * dd_dh) / (d * d)
        da2_dh = -ka1 * ka2 * dd_dh / (d * d)
        df = dh_dph - doh_dph + ct * da1_dh * dh_dph \
            + 2.0 * ct * da2_dh * dh_dph

        cap = caps[i]
        delta = torch.clamp(-f / df, min=-cap, max=cap)
        ph_new = torch.clamp(ph + delta, min=0.0, max=14.0)
        ph = torch.where(done, ph, ph_new)
        live = live + (~done).to(torch.int64)
        done = done | (torch.abs(delta) < tol)
    return ph, live


def solve_pH_plain(constants: ChemistryConstants, initial_guess,
                   iters: int = DEFAULT_ITERS,
                   tolerance: float = PH_TOLERANCE) -> torch.Tensor:
    """``solve_pH_kernel``'s contract through the plain version, on
    whatever device the tensors lie."""
    args, shape = broadcast_inputs(constants, initial_guess)
    return ph_plain(*args, iters=iters, tolerance=tolerance).reshape(shape)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


# csrc/ph_solver.cu: a warp's lanes, the largest block it takes, and its
# unit of work (a run of consecutive elements)
WARP = 32
PH_THREADS = 256
# At most this many blocks of PH_THREADS an SM, whatever the occupancy
# allows (24 warps): more lanes hold more elements at the end of a launch,
# when each lane finishes its last one and the warps run on with few lanes
# in use. B4 on an H100 80GB HBM3 at 700 W, in turns over 1-6 blocks an SM
# (tools/torch_b4_compare.py --sweep, PERF.md): PH-TITR-4096x256 was
# fastest at 3 and 4 (within 1% of each other) in both types, 7-13%
# slower at 2 and 6.
PH_BLOCKS_PER_SM = 3


@dataclass(frozen=True)
class PhGeometry:
    """B4's launch: ``blocks`` blocks of ``threads`` threads."""
    blocks: int
    threads: int

    @property
    def lanes(self) -> int:
        return self.blocks * self.threads


def ph_geometry(n: int, sm_count: int, blocks_per_sm: int,
                threads: int = PH_THREADS) -> PhGeometry:
    """The grid of one B4 launch on ``n`` elements, for a card of
    ``sm_count`` SMs that holds ``blocks_per_sm`` blocks of ``threads``
    threads each at once (the occupancy calculator's answer).

    With at least as many elements as resident lanes, every block the card
    holds, and no more: the lanes stay and take new elements until the work
    is gone. With fewer, the elements spread over every SM at about one a
    lane: ``k`` blocks an SM (the fewest that hold ``n``), each as narrow
    as its share of the elements allows in whole warps, and no more blocks
    than warps of elements. Every run of 32 elements then has its own warp
    from the start, and no SM holds twice the warps of another."""
    if n < 1 or sm_count < 1 or blocks_per_sm < 1 \
            or not WARP <= threads <= PH_THREADS or threads % WARP:
        raise ValueError(f"no B4 geometry for n={n}, sm_count={sm_count}, "
                         f"blocks_per_sm={blocks_per_sm}, threads={threads}")
    resident = sm_count * blocks_per_sm
    if n >= resident * threads:
        return PhGeometry(resident, threads)
    per_sm = -(-n // sm_count)
    k = -(-per_sm // threads)
    blocks = min(sm_count * k, -(-n // WARP))
    width = -(-n // blocks)
    return PhGeometry(blocks, -(-width // WARP) * WARP)


@functools.lru_cache(maxsize=64)
def _blocks_per_sm(device_index: int, is_double: bool, threads: int) -> int:
    with torch.cuda.device(device_index):
        blocks = _build.load("ph_solver").wt_ph_blocks_per_sm(
            int(is_double), threads)
    if blocks < 1:
        raise RuntimeError(f"solve_pH_kernel: no occupancy for {threads} "
                           f"threads ({blocks})")
    return blocks


def kernel_geometry(n: int, device: torch.device,
                    is_double: bool) -> PhGeometry:
    """The grid ``ph_kernel`` launches on ``n`` elements on ``device``:
    ``ph_geometry`` with the card's SM count and its occupancy, capped at
    ``PH_BLOCKS_PER_SM``."""
    return ph_geometry(
        n, torch.cuda.get_device_properties(device).multi_processor_count,
        min(PH_BLOCKS_PER_SM,
            _blocks_per_sm(device.index, is_double, PH_THREADS)))


# Per (device, stream): B4's work counter (the next run, the warps
# finished), zeroed once when made; each launch that draws on it leaves it
# zero again. A launch on another stream gets its own, so two launches
# never share one.
_WORK: dict = {}


def _work_counter(device: torch.device, stream) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    if key not in _WORK:
        _WORK[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _WORK[key]


def ph_kernel(kw, ka1, ka2, ct, alk, ph0, *, iters: int = DEFAULT_ITERS,
              tolerance: float = PH_TOLERANCE) -> torch.Tensor:
    """Kernel B4 on flat CUDA tensors of one length and one floating type
    (same contract as ``ph_plain``)."""
    tensors = (kw, ka1, ka2, ct, alk, ph0)
    if any(x.device.type != "cuda" for x in tensors):
        raise ValueError("solve_pH_kernel: every input must be a CUDA "
                         "tensor")
    dtype = ph0.dtype
    if dtype not in (torch.float32, torch.float64) \
            or any(x.dtype != dtype for x in tensors):
        raise ValueError("solve_pH_kernel: inputs must all be float32 or "
                         "all float64")
    if ph0.ndim != 1 or any(x.shape != ph0.shape for x in tensors):
        raise ValueError("solve_pH_kernel: inputs must be flat and of one "
                         "length")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("solve_pH_kernel: inputs must be contiguous")
    if ph0.numel() < 1 or iters < 0:
        raise ValueError("solve_pH_kernel: needs at least one element and "
                         "iters >= 0")

    lib = _build.load("ph_solver")
    device = ph0.device
    is_double = dtype == torch.float64
    g = kernel_geometry(ph0.numel(), device, is_double)
    caps = _cap_table(iters, dtype, device)
    stream = torch.cuda.current_stream(device)
    out = torch.empty_like(ph0)
    work = _work_counter(device, stream)
    with torch.cuda.device(device):     # the launch's current device
        err = lib.wt_solve_ph(
            int(is_double), *(x.data_ptr() for x in tensors),
            caps.data_ptr(), out.data_ptr(), ph0.numel(), iters,
            float(tolerance), g.blocks, g.threads, work.data_ptr(),
            stream.cuda_stream)
    if err != 0:
        raise RuntimeError("solve_pH_kernel launch failed: "
                           f"{lib.wt_ph_error_string(err).decode()}")
    LAUNCHES["solve_pH_kernel"] += 1
    return out


# ---------------------------------------------------------------------------
# Public wrappers (``ChemistryConstants`` in, pH out)
# ---------------------------------------------------------------------------


def solve_pH_kernel(constants: ChemistryConstants, initial_guess,
                    iters: int = DEFAULT_ITERS,
                    tolerance: float = PH_TOLERANCE) -> torch.Tensor:
    """Solve the charge balance for every element in one launch of kernel
    B4 (its plain version for CPU tensors).

    The leaves of ``constants`` and ``initial_guess`` broadcast to one shape
    (any rank); the result has that shape and the guess's dtype. A float32
    guess with a tolerance below 1e-5 warns: see the module docstring.
    """
    args, shape = broadcast_inputs(constants, initial_guess)
    if args[-1].dtype == torch.float32 and tolerance < 1e-5:
        warnings.warn(
            f"solve_pH_kernel: tolerance {tolerance:g} is below float32 "
            "resolution near the root; convergence stalls at ~1e-2 "
            "worst-case. Use float64 inputs or tolerance >= 1e-5.",
            RuntimeWarning, stacklevel=2)
    run = ph_kernel if args[-1].is_cuda else ph_plain
    return run(*args, iters=iters, tolerance=tolerance).reshape(shape)


def solve_pH_auto(constants: ChemistryConstants, initial_guess,
                  iters: int = DEFAULT_ITERS,
                  tolerance: float = PH_TOLERANCE) -> torch.Tensor:
    """The solve on the path that fits the tensors' device: CUDA tensors
    launch kernel B4 (one launch instead of the ~45 elementwise launches
    per iteration of the step-by-step loop), CPU tensors run
    ``core.chemistry.solve_pH``.

    Unlike the JAX package's ``solve_pH_auto``, which always takes the
    compiler-fused loop, this one routes by device: PyTorch fuses nothing,
    so on the card the loop is thousands of small launches. The float32
    note of the module docstring holds here too, and the card's branch
    warns as ``solve_pH_kernel`` does; in-reactor dynamics never call this
    solver (the buffering chain rule uses beta directly).
    """
    if inputs_device(constants, initial_guess).type != "cuda":
        return chem.solve_pH(constants, initial_guess, tolerance=tolerance,
                             max_iter=iters)
    return solve_pH_kernel(constants, initial_guess, iters, tolerance)
