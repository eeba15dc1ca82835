"""What surrounds kernels B1/B2 on the host, held on the CPU: the launch
geometry ``rollout_geometry`` for every zone count and the batches the
port runs, the thread-to-cell map the kernels use (padding threads and
idle lanes included), the constants shared with ``csrc/fused_rollout.cu``
and the wrappers' refusals (the kernels themselves run only on the card:
tests/test_torch_gpu.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.ops import fused_rollout as F

CSRC = Path(F.__file__).resolve().parents[1] / "csrc"
BATCHES = (1, 2, 7, 13, 4096, 32768)


def _cells(g, n_zones):
    """Per thread of a block: local plant, zone, and whether it is real."""
    rows = [g.cell(tid, n_zones) for tid in range(g.block_threads)]
    return tuple(np.array(col) for col in zip(*rows))


@pytest.mark.parametrize("batch", BATCHES)
def test_geometry_fits_and_covers_every_cell_once(batch):
    """For every Z in 1..128: whole plants within the block limits, no plant
    across a warp in the warp layout, and every (plant, zone) of the batch
    held by exactly one real thread of the grid."""
    for n_zones in range(1, F.MAX_ZONES + 1):
        g = F.rollout_geometry(n_zones, batch)
        assert g.layout in (F.PACKED, F.WARP)
        assert g.block_threads % F.WARP_SIZE == 0
        assert 1 <= g.plants_per_block
        if g.layout == F.WARP:
            per_warp = F.WARP_SIZE // n_zones
            assert n_zones <= F.WARP_SIZE
            assert g.block_threads <= F.WARP_SIZE * F.MAX_WARPS_PER_BLOCK
            assert g.plants_per_block \
                == g.block_threads // F.WARP_SIZE * per_warp
            # no more warps than the batch needs
            assert g.block_threads // F.WARP_SIZE \
                <= -(-batch // per_warp)
        else:
            assert g.plants_per_block <= batch
            assert g.plants_per_block * n_zones <= g.block_threads \
                < g.plants_per_block * n_zones + F.WARP_SIZE
            assert g.block_threads <= F.MAX_BLOCK_THREADS
        local, zone, real = _cells(g, n_zones)
        assert np.all((0 <= zone) & (zone < n_zones))
        assert np.all((0 <= local) & (local < g.plants_per_block))
        if g.layout == F.WARP:
            warp = np.arange(g.block_threads) // F.WARP_SIZE
            for plant in np.unique(local[real]):
                assert len(set(warp[real & (local == plant)])) == 1
        blocks = np.arange(g.grid(batch))[:, None]
        plant = blocks * g.plants_per_block + local[None, :]
        held = real[None, :] & (plant < batch)
        ids = (plant * n_zones + zone[None, :])[held]
        assert np.array_equal(np.bincount(ids, minlength=batch * n_zones),
                              np.ones(batch * n_zones, dtype=np.int64))


def test_geometry_rule():
    """The warp layout where a plant fits a warp and either it needs few
    more warps per plant than the packed layout or the launch leaves each
    of the 528 schedulers at most four warps; the packed layout
    otherwise."""
    assert F.rollout_geometry(20, 1) == F.RolloutGeometry(F.WARP, 1, 32)
    assert F.rollout_geometry(20, 2112) == F.RolloutGeometry(F.WARP, 4, 128)
    assert F.rollout_geometry(20, 2113) \
        == F.RolloutGeometry(F.PACKED, 8, 160)
    assert F.rollout_geometry(20, 4096).grid(4096) == 512
    assert F.rollout_geometry(20, 32768) \
        == F.RolloutGeometry(F.PACKED, 8, 160)
    assert F.rollout_geometry(11, 4096).layout == F.WARP
    assert F.rollout_geometry(11, 32768).layout == F.PACKED
    for n_zones in (1, 5, 8, 16, 32):
        assert F.rollout_geometry(n_zones, 32768).layout == F.WARP
    large = [z for z in range(1, 33)
             if F.rollout_geometry(z, 10 ** 6).layout == F.WARP]
    assert large == [*range(1, 9), 10, 14, 15, 16, *range(28, 33)]
    assert F.rollout_geometry(1, 50) == F.RolloutGeometry(F.WARP, 64, 64)
    assert F.rollout_geometry(33, 1) == F.RolloutGeometry(F.PACKED, 1, 64)
    assert F.rollout_geometry(33, 64) == F.RolloutGeometry(F.PACKED, 7, 256)
    assert F.rollout_geometry(128, 16) \
        == F.RolloutGeometry(F.PACKED, 2, 256)
    # one plant: one warp in either layout, not B1's old block of twelve
    for n_zones in range(1, 33):
        assert F.rollout_geometry(n_zones, 1).block_threads == 32
    assert F.packed_geometry(20, 1) == F.RolloutGeometry(F.PACKED, 1, 32)
    assert F.packed_geometry(20, 4096) == F.RolloutGeometry(F.PACKED, 8, 160)
    for bad in ((0, 1), (F.MAX_ZONES + 1, 1), (20, 0)):
        with pytest.raises(ValueError):
            F.rollout_geometry(*bad)
    with pytest.raises(ValueError):
        F.warp_geometry(33, 4)


@pytest.mark.parametrize("n_zones,batch,expect", [
    # 20 zones, one plant a warp: lanes 20..31 copy zones 0..11
    (20, 1, {0: (0, 0, True), 19: (0, 19, True), 20: (0, 0, False),
             31: (0, 11, False)}),
    # 11 zones, two plants a warp: lanes 22..31 copy the second plant's
    # zones 0..9; warp 1 holds plants 2 and 3
    (11, 13, {21: (1, 10, True), 22: (1, 0, False), 31: (1, 9, False),
              32: (2, 0, True), 43: (3, 0, True), 54: (3, 0, False),
              63: (3, 9, False)}),
    # one zone: every lane a plant
    (1, 50, {0: (0, 0, True), 31: (31, 0, True), 63: (63, 0, True)}),
    # 33 zones, packed: 7 plants on 231 threads, 25 padding threads
    (33, 64, {230: (6, 32, True), 231: (0, 0, False), 255: (0, 0, False)}),
])
def test_padding_and_idle_lanes(n_zones, batch, expect):
    g = F.rollout_geometry(n_zones, batch)
    for tid, cell in expect.items():
        assert g.cell(tid, n_zones) == cell


def test_constants_are_the_kernels():
    src = (CSRC / "fused_rollout.cu").read_text()
    header = (CSRC / "fused_rollout.cuh").read_text()
    assert re.search(r"enum Layout \{ kPacked = (\d), kWarp = (\d) \};",
                     src).groups() == (str(F.PACKED), str(F.WARP))
    assert re.search(r"kMaxWarpsPerBlock = (\d+);", src).group(1) \
        == str(F.MAX_WARPS_PER_BLOCK)
    assert re.search(r"kWarpSize = (\d+);", src).group(1) \
        == str(F.WARP_SIZE)
    assert re.search(r"kThreadsPerBlock = (\d+);", header).group(1) \
        == str(F.MAX_BLOCK_THREADS)
    assert re.search(r"kMaxZones = (\d+);", header).group(1) \
        == str(F.MAX_ZONES)


def _plant(n_zones):
    cfg = R.ReactorConfiguration(n_zones=n_zones)
    return (R.make_params(cfg, device="cpu"),
            R.make_initial_state(cfg, device="cpu"))


def test_wrappers_refuse_what_they_refused():
    """The wrappers' contracts are unchanged by the geometry: more than 128
    zones and a ``record_every`` that does not divide ``n_steps`` raise, and
    a CPU table does not reach a kernel."""
    params, state = _plant(20)
    bc = R.BoundaryConditions()
    with pytest.raises(ValueError, match="multiple"):
        F.rollout_fused(params, state, bc, dt=1.0, substeps=1, n_steps=10,
                        record_every=3)
    sched = R.BoundaryConditions(inlet_pH=np.full(10, 7.0))
    with pytest.raises(ValueError, match="multiple"):
        F.rollout_scheduled_fused(params, state, sched, dt=1.0, substeps=1,
                                  record_every=4)
    params, state = _plant(F.MAX_ZONES + 1)
    with pytest.raises(ValueError, match="n_zones"):
        F.rollout_fused(params, state, bc, dt=1.0, substeps=1, n_steps=2)
    with pytest.raises(ValueError, match="CUDA"):
        F.rollout_kernel(*_tables(20), dt=1.0, substeps=1, n_steps=2)


def _tables(n_zones):
    params, state = _plant(n_zones)
    ptab = F.param_table(params, 1, torch.float64, "cpu")
    btab = F.boundary_table(R.BoundaryConditions(), 1, torch.float64, "cpu")
    y = tuple(x.reshape(1, n_zones).double().contiguous()
              for x in (state.pH, state.chlorine, state.temperature))
    return (ptab, btab, *y)
