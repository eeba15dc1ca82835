"""What surrounds kernel B4 on the host, held on the CPU: the live-iteration
count ``ph_live_iters`` (the plain version's pH bit for bit, and each
element's iterations up to the one that meets the tolerance), the bounds
over all and over the live iterations, the launch geometry
``ph_geometry``, and the constants shared with ``csrc/ph_solver.cu`` (the
kernel itself runs only on the card: tests/test_torch_gpu.py)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import chemistry as jchem
from ics_wt_physicsengine_tpu.ops import ph_solver as jph

from ics_wt_physicsengine_torch.ops import kernel_checks as K
from ics_wt_physicsengine_torch.ops import ph_solver as PS

torch.set_num_threads(1)

CSRC = Path(PS.__file__).resolve().parents[1] / "csrc"
F64, F32 = torch.float64, torch.float32
# (n, sm_count, blocks_per_sm): element counts around a warp, PH-EQ's and
# PH-TITR's, on an H100's 132 SMs and on smaller and larger cards, at one
# and several blocks an SM
GEOMETRIES = [(n, sms, bps) for n in (1, 31, 33, 65536, 1 << 20)
              for sms in (1, 7, 132, 144) for bps in (1, 2, 6)]


def _args(shape, dtype, **kw):
    args, _ = PS.broadcast_inputs(
        K.ph_waters(shape, dtype, "cpu", **kw),
        torch.full(shape, 7.0, dtype=dtype))
    return args


@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
@pytest.mark.parametrize("iters,tolerance", [(100, 1e-6), (7, 1e-6),
                                             (100, 1e-3), (100, 0.0)])
def test_live_iters_gives_the_plain_ph_bit_for_bit(dtype, iters, tolerance):
    args = _args((1025,), dtype, degenerate=True)
    ph, live = PS.ph_live_iters(*args, iters=iters, tolerance=tolerance)
    ref = PS.ph_plain(*args, iters=iters, tolerance=tolerance)
    assert torch.equal(torch.isnan(ph), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(ph), torch.nan_to_num(ref))
    assert live.dtype == torch.int64 and live.shape == ph.shape
    assert bool(((live >= 1) & (live <= iters)).all())


def test_live_iters_of_the_plain_version_match_the_jax_kernel():
    """The pH that ``ph_live_iters`` returns against the interpreted Pallas
    kernel, as ``tests/test_torch_ph_solver.py`` holds ``ph_plain``."""
    values = {name: np.asarray(v) for name, v in
              K.ph_waters_numpy(129).items()}
    jk = jchem.ChemistryConstants(**{name: jnp.asarray(v)
                                     for name, v in values.items()})
    ref = np.asarray(jph.solve_pH_pallas(jk, jnp.full(129, 7.0, jnp.float64),
                                         interpret=True))
    ph, live = PS.ph_live_iters(*_args((129,), F64))
    np.testing.assert_allclose(ph.numpy(), ref, rtol=0, atol=1e-10)
    assert 1 <= int(live.min()) and int(live.max()) < PS.DEFAULT_ITERS


@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
def test_live_iters_counts(dtype):
    """0 for ``iters=0`` (the guess comes back), 1 everywhere on finite
    waters for a huge tolerance, ``iters`` for NaN elements whatever the
    tolerance and everywhere for tolerance 0; the count is the iteration
    that met the tolerance."""
    args = _args((300,), dtype, degenerate=True)
    ph, live = PS.ph_live_iters(*args, iters=0)
    assert torch.equal(live, torch.zeros(300, dtype=torch.int64))
    assert torch.equal(ph, args[-1])
    _, live = PS.ph_live_iters(*args, tolerance=1e30)
    assert bool((live[1:3] == 100).all())
    assert torch.equal(live[3:], torch.ones(297, dtype=torch.int64))
    _, live = PS.ph_live_iters(*_args((300,), dtype), tolerance=1e30)
    assert torch.equal(live, torch.ones(300, dtype=torch.int64))
    _, live = PS.ph_live_iters(*args, tolerance=0.0)
    assert torch.equal(live, torch.full((300,), 100, dtype=torch.int64))
    ph, live = PS.ph_live_iters(*args)
    assert torch.isnan(ph[1:3]).all() and bool((live[1:3] == 100).all())
    # a solve stopped after each element's live iterations is the full one
    for k in torch.unique(live[live < 100]).tolist():
        done_at_k = live == k
        assert torch.equal(PS.ph_plain(*args, iters=k)[done_at_k],
                           ph[done_at_k])


def test_live_ops_and_bounds():
    """``ph_live_ops`` counts ``PH_OPS`` a live iteration; float32 is held
    to the FP32 peak, float64 to the FP64 peak (half of it); the live bound
    never exceeds the bound over every iteration."""
    live = torch.tensor([1, 5, 100, 0])
    assert PS.ph_live_ops(live) == 106 * PS.PH_OPS
    assert K.PEAK_OPS[F64] == K.PEAK_OPS[F32] / 2
    for dtype in (F32, F64):
        args = _args((4096,), dtype)
        _, live = PS.ph_live_iters(*args)
        b = K.ph_bounds(args, live)
        ops_ms = PS.ph_ops(4096) / K.PEAK_OPS[dtype] * 1e3
        assert b["fixed_by"] == "operations"
        assert b["fixed_ms"] == pytest.approx(ops_ms, rel=1e-12)
        assert b["live_ms"] <= b["fixed_ms"]
        assert b["mean_live"] == pytest.approx(float(live.double().mean()))
    # at PH-TITR's size in float64: 1,048,576 x 100 x 52 / 33.5e12
    assert PS.ph_ops(1 << 20) / K.PEAK_OPS[F64] * 1e3 == pytest.approx(
        0.16276, rel=1e-4)


@pytest.mark.parametrize("n,sm_count,blocks_per_sm", GEOMETRIES,
                         ids=lambda x: str(x))
def test_geometry(n, sm_count, blocks_per_sm):
    """Whole warps within the block limit; never more blocks than the card
    holds at once; every element has a lane from the start when the card
    holds them all, and then the elements spread over every SM (no SM
    short of a block while another holds two, no block without a run),
    else every resident block runs and the lanes take new elements."""
    g = PS.ph_geometry(n, sm_count, blocks_per_sm)
    resident = sm_count * blocks_per_sm
    assert g.threads % PS.WARP == 0 and PS.WARP <= g.threads <= PS.PH_THREADS
    assert 1 <= g.blocks <= resident
    if n >= resident * PS.PH_THREADS:
        assert g == PS.PhGeometry(resident, PS.PH_THREADS)
    else:
        runs = -(-n // PS.WARP)
        assert g.lanes >= n
        assert g.blocks == min(runs, sm_count * -(-g.blocks // sm_count))
        assert g.blocks >= min(sm_count, runs)
        # no block lacks a run under the kernel's first hand-out (warp w of
        # block b takes run w * blocks + b)
        assert g.blocks <= runs
        assert g.lanes - n < g.blocks * PS.WARP


def test_geometry_of_the_cells():
    """PH-EQ-65536 spreads over two blocks an SM of a 132-SM card;
    PH-TITR-4096x256 takes every resident block."""
    assert PS.ph_geometry(65536, 132, 6) == PS.PhGeometry(264, 256)
    assert PS.ph_geometry(1 << 20, 132, 6) == PS.PhGeometry(792, 256)
    assert PS.ph_geometry(1, 132, 6) == PS.PhGeometry(1, 32)
    assert PS.ph_geometry(33, 132, 6) == PS.PhGeometry(2, 32)


@pytest.mark.parametrize("bad", [
    (0, 132, 6), (10, 0, 6), (10, 132, 0), (10, 132, 6, 48),
    (10, 132, 6, 512), (10, 132, 6, 0)])
def test_geometry_refuses(bad):
    with pytest.raises(ValueError, match="no B4 geometry"):
        PS.ph_geometry(*bad)


def test_constants_match_the_kernel_source():
    src = (CSRC / "ph_solver.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr \w+ {name} = (\w+);", src).group(1))
    assert constant("kWarp") == PS.WARP
    assert constant("kMaxThreads") == PS.PH_THREADS
