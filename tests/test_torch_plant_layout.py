"""What surrounds kernel B3 on the host, held on the CPU: its launch
geometry for every zone count, the Philox blocks each sensor lane draws,
and the ``PlantStatics`` layout the kernel copies (the kernel itself runs
only on the card: tests/test_torch_gpu.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.models import plant as P
from ics_wt_physicsengine_torch.ops import fused_plant as FP
from ics_wt_physicsengine_torch.ops import fused_rollout as F

CSRC = Path(FP.__file__).resolve().parents[1] / "csrc"
N_SENSORS = len(FP.SENSORS)
BATCH = 4096


def _source(name):
    return (CSRC / name).read_text()


def _sensor_lanes(g):
    """Per sensor lane: its sensor (or -1 for padding) and local plant."""
    lanes = np.arange(g.sensor_threads)
    pairs = [g.sensor_lane(int(i)) for i in lanes]
    sensor = np.array([p[0] if p else -1 for p in pairs])
    local = np.array([p[1] if p else -1 for p in pairs])
    return sensor, local


def test_geometry_fits_a_block_for_every_zone_count():
    for n_zones in range(1, F.MAX_ZONES + 1):
        g = FP.plant_geometry(n_zones, BATCH)
        plants = g.plants_per_block
        assert plants >= 1
        assert g.physics_threads % 32 == 0 and g.sensor_threads % 32 == 0
        assert plants * n_zones <= g.physics_threads \
            < plants * n_zones + 32
        # packed, or one warp a sensor where all would share one warp
        assert g.sensor_stride == plants \
            or (g.sensor_stride == 32 and N_SENSORS * plants <= 32)
        assert N_SENSORS * g.sensor_stride <= g.sensor_threads \
            < N_SENSORS * g.sensor_stride + 32
        assert g.physics_threads <= FP.MAX_PHYSICS_THREADS
        assert g.block_threads <= FP.MAX_BLOCK_THREADS <= 1024
    assert FP.plant_geometry(20, BATCH) == FP.PlantGeometry(8, 160, 8)
    assert FP.plant_geometry(20, BATCH).block_threads == 224
    assert FP.plant_geometry(1, 64).plants_per_block == 32
    assert FP.plant_geometry(128, 64) == FP.PlantGeometry(2, 256, 2)
    # a single plant: one physics warp, and a warp for each sensor
    assert FP.plant_geometry(20, 1) == FP.PlantGeometry(1, 32, 32)
    assert FP.plant_geometry(20, 1).sensor_threads == 7 * 32
    for bad in ((0, 1), (F.MAX_ZONES + 1, 1), (20, 0)):
        with pytest.raises(ValueError):
            FP.plant_geometry(*bad)


def test_geometry_serves_every_pair_once_for_every_zone_count():
    """Every (plant, sensor) pair and every (plant, zone) of a 4096-plant
    batch belongs to exactly one thread of the grid."""
    for n_zones in range(1, F.MAX_ZONES + 1):
        g = FP.plant_geometry(n_zones, BATCH)
        blocks = np.arange(g.grid(BATCH))[:, None]
        sensor, local = _sensor_lanes(g)
        plant = blocks * g.plants_per_block + local[None, :]
        served = (sensor[None, :] >= 0) & (plant < BATCH)
        ids = (sensor[None, :] * BATCH + plant)[served]
        assert np.array_equal(np.bincount(ids, minlength=N_SENSORS * BATCH),
                              np.ones(N_SENSORS * BATCH, dtype=np.int64))
        tid = np.arange(g.plants_per_block * n_zones)
        cells = (blocks * g.plants_per_block + tid[None, :] // n_zones) \
            * n_zones + tid[None, :] % n_zones
        cells = cells[cells < BATCH * n_zones]
        assert np.array_equal(np.sort(cells), np.arange(BATCH * n_zones))


def test_sensor_warps_are_sensor_major_for_every_zone_count():
    """Neighbouring lanes of one sensor are neighbouring plants, sensors
    follow in SENSORS order, and a warp spans at most ceil(32 / P) + 1
    sensors (so the pH, chlorine and temperature pairs share warps)."""
    for n_zones in range(1, F.MAX_ZONES + 1):
        g = FP.plant_geometry(n_zones, BATCH)
        plants = g.plants_per_block
        sensor, local = _sensor_lanes(g)
        used = sensor >= 0
        assert np.array_equal(sensor[used],
                              np.repeat(np.arange(N_SENSORS), plants))
        assert np.array_equal(local[used],
                              np.tile(np.arange(plants), N_SENSORS))
        starts = np.flatnonzero(used & (local == 0))
        assert np.array_equal(starts,
                              np.arange(N_SENSORS) * g.sensor_stride)
        for warp in range(g.sensor_threads // 32):
            kinds = set(sensor[warp * 32:(warp + 1) * 32]) - {-1}
            assert len(kinds) <= -(-32 // plants) + 1
    # 20 zones: two sensor warps, the first pH and chlorine, the second
    # flow and temperature
    sensor, _ = _sensor_lanes(FP.plant_geometry(20, BATCH))
    kinds = [FP.SENSORS[k][2] for k in sensor if k >= 0]
    assert set(kinds[:32]) == {"ph", "cl"}
    assert set(kinds[32:]) == {"flow", "temp"}
    # a single plant: sensor k alone in warp k, on its first lane
    sensor, local = _sensor_lanes(FP.plant_geometry(20, 1))
    assert np.array_equal(np.flatnonzero(sensor >= 0),
                          np.arange(N_SENSORS) * 32)


@pytest.fixture(scope="module")
def statics():
    params, _ = P.make_plant(R.ReactorConfiguration(n_zones=20),
                             device="cpu")
    return FP.sensor_statics(params, 1.0)


@pytest.mark.parametrize("seed,step,plant", [
    (0, 0, 0), (7, 3, 5), (2 ** 32 + 17, 1234, 9),
    (2 ** 64 - 1, 2 ** 31 + 3, 2 ** 16 + 1)])
def test_sensor_philox_blocks_give_the_plant_stream(statics, seed, step,
                                                    plant):
    """Each sensor's blocks (first block, count) and word skip in the
    statics, drawn as the kernel's lanes draw them, give exactly that
    sensor's words of the plant-wide stream."""
    fields = FP.statics_fields(statics)
    stream = FP.philox_words(seed, step, 1, plant + 1, "cpu")[0, :, plant]
    seed &= 2 ** 64 - 1
    drawn = set()
    for k in range(N_SENSORS):
        blocks = torch.arange(fields["block"][k],
                              fields["block"][k] + fields["n_blocks"][k])
        assert fields["n_blocks"][k] <= 4
        drawn.update(blocks.tolist())
        out = FP.philox4x32_10(
            (torch.full_like(blocks, step), torch.full_like(blocks, plant),
             blocks, torch.zeros_like(blocks)),
            (seed & 0xFFFFFFFF, seed >> 32))
        words = torch.stack(out, dim=1).reshape(-1)
        words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
        skip, n = fields["skip"][k], fields["n_words"][k]
        assert skip + n <= 4 * fields["n_blocks"][k] and n <= 11
        w0 = fields["word"][k]
        assert torch.equal(words[skip:skip + n].to(torch.int32),
                           stream[w0:w0 + n])
    assert drawn == set(range(FP.N_WORDS // 4))
    assert sum(fields["n_blocks"]) == 24


def test_statics_array_is_the_layout_the_kernel_reads(statics):
    src = _source("fused_plant.cu")
    body = re.search(r"struct PlantStatics \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"int (\w+)\[(kSensors|kLineSensors)\];", body)
    assert tuple(n for n, _ in names) == FP.STATICS_FIELDS
    assert [size for _, size in names] \
        == ["kSensors"] * (len(names) - 1) + ["kLineSensors"]
    assert re.search(r"kMaxBlockThreads = (\d+);", src).group(1) \
        == str(FP.MAX_BLOCK_THREADS)
    assert re.search(r"kThreadsPerBlock = (\d+);",
                     _source("fused_rollout.cuh")).group(1) \
        == str(FP.MAX_PHYSICS_THREADS)

    fields = FP.statics_fields(statics)
    flat = list(FP._statics_array(statics))
    assert len(flat) == 10 * N_SENSORS + 4 == 74
    at = 0
    for name in FP.STATICS_FIELDS:
        width = 4 if name == "d_max" else N_SENSORS
        assert flat[at:at + width] == fields[name]
        at += width
    for k, (_, attr, kind) in enumerate(FP.SENSORS):
        assert FP._PCOLS[fields["param_col"][k]] \
            == (attr, "base", "min_value")
        assert FP._FLOAT_CCOLS[fields["float_col"][k]][:3] \
            == (attr, "base", "current_value")
        assert FP._INT_CCOLS[fields["int_col"][k]][:3] \
            == (attr, "base", "has_calibration")
        assert fields["word"][k] == FP._WORD_OFFSET[attr]
        assert fields["n_words"][k] == FP.words_per_sensor(kind)
        assert fields["word"][k] == 4 * fields["block"][k] + fields["skip"][k]
        assert 0 <= fields["zone"][k] < 20
    assert fields["d_max"] == [s[4] for s in statics
                               if s[0] in FP._LINE_ATTRS]
