"""Kernels B1, B2, B3 and B4 on the CUDA card against their plain PyTorch versions
on the same inputs (the kernels have no CPU mode, so these tests skip
without a card), the plain paths of the six extension axes, of the
control package and of the surrogate on the card against the CPU, and
checkpoints saved from the card. This file imports no JAX: the
machine with the card has none. Run it there with

    python -m pytest -m gpu --noconftest -p no:randomly tests/test_torch_gpu.py

The tables and tolerances are ``ops/kernel_checks.py``'s, which
``chip_smoke.py`` runs at the main path's shapes."""

import dataclasses

import numpy as np
import pytest
import torch

from ics_wt_physicsengine_torch.core import chemistry as chem
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.models import make_monte_carlo_batch
from ics_wt_physicsengine_torch.models import plant as P
from ics_wt_physicsengine_torch.ops import fused_plant as FP
from ics_wt_physicsengine_torch.ops import fused_rollout as F
from ics_wt_physicsengine_torch.ops import kernel_checks as K
from ics_wt_physicsengine_torch.ops import ph_solver as PS

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU mode")
    return torch.device("cuda")


# Zone counts on both sides of the layout switch (warp layout up to 32
# zones, packed above) and batches of one plant, a few, and 50 (the last
# block partly empty in either layout: 13 warp blocks of 4 warps at 20
# zones, the last with 2; 25 packed blocks of 2 plants at 128 zones, 8 of 7
# at 33, the last with 1).
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_zones,n_plants", [
    (1, 1), (1, 50), (20, 1), (5, 37), (20, 7), (20, 50), (32, 7),
    (33, 1), (33, 50), (128, 7)])
@pytest.mark.parametrize("substeps,stages", [(3, None), (1, 4), (2, 3)])
def test_b1_matches_plain(cuda, dtype, n_zones, n_plants, substeps, stages):
    got, err = K.b1_vs_plain(n_zones, n_plants, dtype, cuda,
                             substeps=substeps, stages=stages, n_steps=40,
                             record_every=8)
    assert err == 0.0
    assert torch.equal(got[3][0][-1], got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["packed", "warp"])
@pytest.mark.parametrize("n_zones,n_plants", [(20, 50), (11, 13), (32, 1)])
def test_b1_either_layout_matches_plain(cuda, monkeypatch, dtype, layout,
                                        n_zones, n_plants):
    """Both layouts at the same sizes, whichever ``rollout_geometry``
    picks: bit-equal to the plain version and to each other."""
    make = F.packed_geometry if layout == "packed" else F.warp_geometry
    monkeypatch.setattr(F, "rollout_geometry", make)
    got, err = K.b1_vs_plain(n_zones, n_plants, dtype, cuda, substeps=2,
                             stages=None, n_steps=30, record_every=10)
    assert err == 0.0
    monkeypatch.undo()
    ptab, btab, y = K.tables(n_zones, n_plants, dtype, cuda)
    shipped = F.rollout_kernel(ptab, btab, *y, dt=K.DT, substeps=2,
                               n_steps=30, record_every=10)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], shipped[:3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_plants", [1, 13])
def test_b2_matches_plain_and_constant_schedule_equals_b1(cuda, dtype,
                                                          n_plants):
    _, err = K.b2_vs_plain(20, n_plants, dtype, cuda, substeps=3,
                           stages=None, n_steps=30, record_every=5)
    assert err == 0.0
    _, err = K.b2_vs_plain(20, n_plants, dtype, cuda, substeps=1, stages=4,
                           n_steps=30, record_every=5)
    assert err == 0.0
    for stages in (None, 4):
        assert K.constant_schedule_equals_b1(20, n_plants, dtype, cuda,
                                             substeps=3, stages=stages,
                                             n_steps=30)


@pytest.mark.parametrize("geometry", [
    F.RolloutGeometry(F.PACKED, 8, 150),    # threads not whole warps
    F.RolloutGeometry(F.PACKED, 8, 128),    # 8 x 20 zones need 160
    F.RolloutGeometry(F.PACKED, 8, 192),    # a whole warp of padding
    F.RolloutGeometry(F.PACKED, 16, 320),   # above 256 threads
    F.RolloutGeometry(F.WARP, 4, 64),       # 20 zones: one plant a warp
    F.RolloutGeometry(F.WARP, 5, 160),      # above 4 warps
    F.RolloutGeometry(2, 8, 160),           # no such layout
], ids=["ragged-warp", "too-few-threads", "padding-warp", "block-too-large",
        "plants-across-warps", "too-many-warps", "unknown-layout"])
def test_b1_b2_refuse_a_geometry_they_cannot_run(cuda, geometry,
                                                 monkeypatch):
    """The kernels return cudaErrorInvalidValue for a layout they cannot
    run (the wrapper raises and counts no launch); the wrapper's own
    geometry for the same tables runs."""
    ptab, btab, y = K.tables(20, 16, torch.float32, cuda)
    sched = btab[:, :1].T.expand(4, -1).contiguous()
    F.reset_launch_counts()
    monkeypatch.setattr(F, "rollout_geometry",
                        lambda n_zones, batch: geometry)
    with pytest.raises(RuntimeError, match="launch failed"):
        F.rollout_kernel(ptab, btab, *y, dt=1.0, substeps=3, n_steps=4)
    with pytest.raises(RuntimeError, match="launch failed"):
        F.scheduled_kernel(ptab, sched, *y, dt=1.0, substeps=3)
    assert F.LAUNCHES == {"rollout_fused": 0, "rollout_scheduled_fused": 0}
    monkeypatch.undo()
    F.rollout_kernel(ptab, btab, *y, dt=1.0, substeps=3, n_steps=4)
    F.scheduled_kernel(ptab, sched, *y, dt=1.0, substeps=3)
    torch.cuda.synchronize()
    assert F.LAUNCHES == {"rollout_fused": 1, "rollout_scheduled_fused": 1}
    # a 33-zone plant does not fit a warp
    ptab, btab, y = K.tables(33, 4, torch.float32, cuda)
    monkeypatch.setattr(F, "rollout_geometry", lambda n_zones, batch:
                        F.RolloutGeometry(F.WARP, 1, 32))
    with pytest.raises(RuntimeError, match="launch failed"):
        F.rollout_kernel(ptab, btab, *y, dt=1.0, substeps=3, n_steps=4)
    assert F.LAUNCHES["rollout_fused"] == 1


def test_wrappers_launch_the_kernels_on_cuda_tensors(cuda):
    params = R.make_params(R.ReactorConfiguration(n_zones=20), device=cuda)
    state = R.make_initial_state(R.ReactorConfiguration(n_zones=20),
                                 device=cuda)
    F.reset_launch_counts()
    out = F.rollout_fused(params, state, K.BC, dt=1.0, substeps=3,
                          n_steps=10)
    sched = R.BoundaryConditions(inlet_pH=np.full(10, 7.0))
    out2 = F.rollout_scheduled_fused(params, state, sched, dt=1.0,
                                     substeps=3)
    torch.cuda.synchronize()
    assert F.LAUNCHES == {"rollout_fused": 1, "rollout_scheduled_fused": 1}
    assert out.pH.is_cuda and out.pH.shape == (20,)
    assert bool(torch.isfinite(out2.chlorine).all())


def test_b1_float64_matches_the_cpu_path(cuda):
    """The kernel on the card against the plain version on the CPU, which
    the CPU suite holds to the JAX package."""
    assert K.b1_vs_cpu(16, cuda, substeps=2, n_steps=50) <= K.CPU_TOL


@pytest.mark.parametrize("case", sorted(K.B3_CASES))
def test_b3_matches_plain(cuda, case):
    """State, every carry column, rebuilt rings and readings; NaN in the
    same places; integer carries equal."""
    spec = K.B3_CASES[case]
    got, diff = K.b3_vs_plain(spec, cuda)
    plant, values = got[:2]
    assert diff["nan_equal"] and diff["ints_equal"], diff
    # the serving and fleet chunks' cases (the fault record) bit for bit
    tol = 0.0 if spec.get("faults") else \
        K.TOL[spec.get("dtype", torch.float32)]
    assert diff["max_abs_err"] <= tol, diff
    assert bool(torch.isfinite(plant.reactor.pH).all())
    n_rec = K.B3_STEPS // spec["record_every"]
    assert values.shape[:2] == (n_rec, len(FP.SENSORS))
    if spec["rng"] == "bits":   # the injected faults went dark
        column = [name for name, _, _ in FP.SENSORS].index
        assert bool(torch.isnan(values[-1, column("pH_outlet")]
                                .reshape(-1)[0]))
        assert bool(torch.isnan(values[-1, column("flow_main")]
                                .reshape(-1)[0]))


@pytest.mark.parametrize("n_zones,n_plants,integrator",
                         [(20, 1, "rk4"), (5, 37, "fast")])
def test_b3_constant_schedule_equals_constant_forcing(cuda, n_zones,
                                                      n_plants, integrator):
    assert K.b3_constant_schedule_equals_constant(
        n_zones, n_plants, cuda, integrator=integrator)


def test_b3_chained_with_the_plain_version(cuda):
    """plain -> kernel -> plain equals plain three times: lead-in from
    incoming rings and ring write-back."""
    diff = K.b3_chained(cuda)
    assert diff["nan_equal"] and diff["ints_equal"], diff
    assert diff["max_abs_err"] <= K.TOL[torch.float32], diff


@pytest.mark.parametrize("n_plants,rkc", [(1, False), (1024, False),
                                           (16384, True)])
def test_b3_at_the_bench_plant_widths(cuda, n_plants, rkc):
    """The bench_plant row's plants, forcing and plan, launched as
    plant_rollout_auto launches B3 at record=False (one record, Philox seed
    1), bit for bit against the plain version."""
    from ics_wt_physicsengine_torch import bench as BENCH

    config, params, plant, bc = BENCH.plant_bench_inputs(n_plants,
                                                         device=cuda)
    m, s = BENCH.plant_bench_plan(config, rkc)
    got, diff = K.b3_vs_plain_on(params, plant, bc, substeps=m, stages=s,
                                 n_steps=8, record_every=8, seed=1)
    assert diff["max_abs_err"] == 0.0, diff
    assert diff["nan_equal"] and diff["ints_equal"], diff
    assert bool(torch.isfinite(got[0].reactor.pH).all())


def test_philox_stream_of_the_kernel(cuda):
    stats = K.philox_statistics(cuda)
    assert stats["words_equal_plain"]
    for name, (centre, half_width) in K.PHILOX_BOUNDS.items():
        assert abs(stats[name] - centre) <= half_width, (name, stats)
    assert 0.0 <= stats["uniform_min"] and stats["uniform_max"] < 1.0


def test_plant_wrappers_launch_b3_on_cuda_tensors(cuda):
    cfg = R.ReactorConfiguration(n_zones=20)
    params, plant = P.make_plant(cfg, device=cuda)
    FP.reset_launch_counts()
    F.reset_launch_counts()
    new, readings = FP.plant_rollout_fused(params, plant, K.BC, dt=1.0,
                                           substeps=3, n_steps=20,
                                           record_every=5, seed=1)
    new, traj = P.plant_rollout_auto(params, new, K.bench_schedule(10), 1.0,
                                     3, 10, seed=2)
    torch.cuda.synchronize()
    assert FP.LAUNCHES == {"plant_rollout_fused": 2, "pack_tables": 2}
    assert F.LAUNCHES == {"rollout_fused": 0, "rollout_scheduled_fused": 0}
    assert readings["pH_outlet"].shape == (4,)
    assert readings["pH_outlet"].is_cuda
    assert traj["temp_inlet"].shape == (10,)
    assert float(new.reactor.time) == 30.0
    assert bool(torch.isfinite(new.reactor.pH).all())


def test_serve_chunk_kernel_matches_plain_bit_equal(cuda):
    """The serving chunk on the card: one B3 launch with the Philox
    counter from a step past 2^32 and the fault-code record, bit-equal to
    B3's plain version on the card (plant, values, fault codes)."""
    chunk, diff, launches = K.serve_chunk_vs_plain(cuda)
    assert launches == {"plant_rollout_fused": 1, "pack_tables": 1}
    assert diff["max_abs_err"] == 0.0 and diff["nan_equal"] \
        and diff["ints_equal"], diff
    assert chunk.values.shape == (120 // 7, 7)
    assert chunk.faults.dtype == torch.int32 and chunk.faults.is_cuda
    assert set(chunk.last) == {name for name, _, _ in FP.SENSORS}


def test_serve_chunks_are_invariant_on_the_card(cuda):
    """Two chunks of 16 steps give one chunk of 32 bit for bit on the
    card, and chunks of 8, 8, 12, 12 and 12 one of 52 (past the 30-step
    sample-line delay)."""
    assert K.serve_chunks_invariant(cuda)
    assert K.serve_chunks_invariant(cuda, sizes=(8, 8, 12, 12, 12))


@pytest.mark.parametrize("case", sorted(K.FLEET_CHUNK_CASES))
def test_fleet_chunk_on_the_card_matches_plain_and_shards_exactly(cuda,
                                                                  case):
    """A fleet's chunk on the card: one B3 launch over 8 lanes (one block)
    or 254 (32 blocks, the last partial) on their own clocks, delays and
    slewing schedules with one lane paused, bit-equal to B3's plain version
    with the paused lane put back; a shard of lanes alone with its
    ``plant0`` (4, or 127 inside a block) bit-equal to those lanes of the
    whole chunk."""
    lanes, paused, shard = K.FLEET_CHUNK_CASES[case]
    out = K.fleet_chunk_vs_plain(cuda, n_lanes=lanes, paused=paused,
                                 shard=shard)
    assert out["launches"] == {"plant_rollout_fused": 1, "pack_tables": 1}
    for key in ("whole", "shard"):
        d = out[key]
        assert d["max_abs_err"] == 0.0 and d["nan_equal"] \
            and d["ints_equal"], (key, d)


@pytest.mark.parametrize("cards", ["one", "all"])
def test_sharded_kernels_on_a_mesh_of_cards(cuda, cards):
    """``parallel.fused`` on a mesh of the first card, and of every visible
    card: one launch a card, each shard bit-equal to the single-device
    wrapper on that shard on the first card, and each instrumented shard
    to its lanes of the single-device call (every shard draws seed's
    Philox stream from its first plant, B3's plant0)."""
    from ics_wt_physicsengine_torch import parallel as PAR

    mesh = PAR.make_mesh(1 if cards == "one" else None)
    if cards == "all" and mesh.size < 2:
        pytest.skip("needs two CUDA cards")
    n = 16 * mesh.size
    params, state = make_monte_carlo_batch(R.ReactorConfiguration(
        n_zones=20), n, seed=0, device=cuda)
    F.reset_launch_counts()
    got = PAR.sharded_rollout_fused(mesh, dt=1.0, substeps=3,
                                    n_steps=50)(params, state, K.BC)
    assert F.LAUNCHES["rollout_fused"] == mesh.size
    pp, pl = K.plant_case(20, n, torch.float32, cuda)
    FP.reset_launch_counts()
    plants, readings = PAR.sharded_plant_rollout_fused(
        mesh, pp, dt=1.0, substeps=3, n_steps=40, record_every=10,
        seed=4)(pp, pl, K.BC)
    assert FP.LAUNCHES["plant_rollout_fused"] == mesh.size
    whole, rw = FP.plant_rollout_fused(pp, pl, K.BC, dt=1.0, substeps=3,
                                       n_steps=40, record_every=10, seed=4)
    for k, dev in enumerate(mesh.devices):
        lanes = slice(16 * k, 16 * (k + 1))
        assert got[k].pH.device == dev
        ref = F.rollout_fused(K._lanes(params, lanes), K._lanes(state, lanes),
                              K.BC, dt=1.0, substeps=3, n_steps=50)
        assert K.plant_diff(PAR.gather_batch([got[k]], cuda),
                            ref)["max_abs_err"] == 0.0
        d = K.plant_diff(
            PAR.gather_batch([(plants[k], readings[k])], cuda),
            (K._lanes(whole, lanes),
             {name: v[:, lanes] for name, v in rw.items()}))
        assert d["max_abs_err"] == 0.0 and d["nan_equal"] \
            and d["ints_equal"], (k, d)


@pytest.mark.parametrize("chunk", [1, 64])
def test_sharded_fleet_equals_the_one_card_fleet(cuda, chunk, tmp_path):
    """``--fleet 4`` over every visible card (lanes split, one B3 launch a
    card a chunk, each from its plant0; per-tick draws made on the first
    card and split) against ``--fleet-no-shard`` on the first: the
    checkpointed plants, the generator and the clock bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the fleet shards its lanes over "
                    "them")
    from ics_wt_physicsengine_torch import __main__ as orchestrator
    from ics_wt_physicsengine_torch.utils import checkpoint as CK

    cfg = R.ReactorConfiguration(n_zones=5)
    saved = []
    for extra in ([], ["--fleet-no-shard"]):
        path = str(tmp_path / f"fleet{len(saved)}.npz")
        orchestrator.running = True
        assert orchestrator.main([
            "--no-modbus", "--rtf", "0", "--zones", "5", "--fleet", "4",
            "--seed", "3", "--serve-chunk", str(chunk), "--duration",
            str(8 * chunk), "--checkpoint-file", path, *extra]) == 0
        params, plant = P.make_plant_batch(cfg, 4, seed=3, device=cuda)
        saved.append((CK.load_pytree(path, {
            "params": params, "plant": plant,
            "generator": torch.Generator(device=cuda)}),
            CK.load_metadata(path)))
    (a, meta_a), (b, meta_b) = saved
    assert meta_a["step_count"] == meta_b["step_count"] == 8 * chunk
    d = K.plant_diff(a["plant"], b["plant"])
    assert d["max_abs_err"] == 0.0 and d["nan_equal"] and d["ints_equal"], d
    assert torch.equal(a["generator"].get_state(),
                       b["generator"].get_state())


def test_b3_rejects_what_it_cannot_run(cuda):
    cfg = R.ReactorConfiguration(n_zones=5)
    params, plant = P.make_plant(cfg, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        FP.plant_rollout_fused(params, plant, K.BC, dt=1.0, substeps=3,
                               n_steps=10, record_every=3)
    with pytest.raises(ValueError, match="bits"):
        FP.plant_rollout_fused(params, plant, K.BC, dt=1.0, substeps=3,
                               n_steps=10, rng="bits")
    cpu_tables = FP.build_tables(*P.make_plant(cfg, device="cpu"), K.BC,
                                 dt=1.0, n_steps=4)
    with pytest.raises(ValueError, match="CUDA"):
        FP.plant_kernel(cpu_tables, dt=1.0, substeps=3, n_steps=4)


@pytest.mark.parametrize("geometry", [
    FP.PlantGeometry(8, 150, 8),    # physics threads not whole warps
    FP.PlantGeometry(8, 128, 8),    # 8 x 20 zones need 160
    FP.PlantGeometry(8, 160, 4),    # sensor lanes of two plants overlap
    FP.PlantGeometry(12, 256, 32),  # 256 + 7 x 32 threads exceed 448
], ids=["ragged-warp", "too-few-physics", "stride-below-plants",
        "block-too-large"])
def test_b3_refuses_a_geometry_it_cannot_run(cuda, geometry, monkeypatch):
    """The kernel returns cudaErrorInvalidValue for a layout it cannot run
    (the wrapper raises and counts no launch); the wrapper's own geometry
    for the same tables runs."""
    params, plant = K.plant_case(20, 16, torch.float32, cuda)
    tables = FP.build_tables(params, plant, K.BC, dt=1.0, n_steps=4)
    FP.reset_launch_counts()
    monkeypatch.setattr(FP, "plant_geometry", lambda n_zones, batch: geometry)
    with pytest.raises(RuntimeError, match="launch failed"):
        FP.plant_kernel(tables, dt=1.0, substeps=3, n_steps=4)
    assert FP.LAUNCHES["plant_rollout_fused"] == 0
    monkeypatch.undo()
    FP.plant_kernel(tables, dt=1.0, substeps=3, n_steps=4)
    torch.cuda.synchronize()
    assert FP.LAUNCHES["plant_rollout_fused"] == 1


@pytest.mark.parametrize("case", sorted(K.B4_CASES))
def test_b4_matches_plain(cuda, case):
    """The Newton pH kernel against its plain version: bit-equal, NaN in
    the same places (the degenerate waters), result in the guess's shape;
    each case's live iterations as its options make them."""
    spec = K.B4_CASES[case]
    got, diff = K.b4_vs_plain(spec, cuda)
    assert diff["nan_equal"] and diff["bit_equal"], diff
    assert got.shape == spec["shape"] and got.dtype == spec["dtype"]
    if spec.get("degenerate"):
        assert torch.isnan(got[1:3]).all() and torch.isfinite(got[0])
        assert int(torch.isnan(got).sum()) == 2
    elif "arrange" in spec:
        assert bool(((got >= 0.0) & (got <= 14.0)).all())
    else:
        assert bool(((got > 0.0) & (got < 14.0)).all())
    iters = spec.get("iters", PS.DEFAULT_ITERS)
    if iters == 0:
        assert torch.equal(got, torch.full_like(got, 7.0))
    if spec.get("tolerance") == 0.0:
        assert diff["mean_live"] == iters
    if spec.get("tolerance") == 1e30:
        assert diff["max_live"] == 1
    assert diff["max_live"] <= iters


@pytest.mark.parametrize("case", sorted(
    name for name, spec in K.B4_CASES.items() if "arrange" in spec))
def test_b4_never_done_cases_are_arranged(cuda, case):
    """The never-done elements of the arranged cases lie where the cases
    put them: all in one run of 32, or one at every 32nd element."""
    assert K.b4_never_done_in_place(K.B4_CASES[case], cuda)


def test_b4_back_to_back_and_on_two_streams(cuda):
    """Launches that draw on the work counter, twice on one stream and at
    once on two, all bit-equal to the plain version, and every counter left
    at zero for the next launch."""
    got = K.b4_streams(cuda)
    assert got == dict(back_to_back=True, two_streams=True,
                       counters_zero=True), got


def test_b4_geometry_on_this_card(cuda):
    """The wrapper's geometry on this card: ``PH_BLOCKS_PER_SM`` blocks on
    every SM (the card holds at least as many) when the elements outnumber
    those lanes, else one lane an element spread over every SM."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for is_double in (False, True):
        assert PS._blocks_per_sm(cuda.index or 0, is_double,
                                 PS.PH_THREADS) >= PS.PH_BLOCKS_PER_SM
        assert PS.kernel_geometry(1 << 20, cuda, is_double) == \
            PS.PhGeometry(sms * PS.PH_BLOCKS_PER_SM, PS.PH_THREADS)
        g = PS.kernel_geometry(65536, cuda, is_double)
        assert g.blocks >= sms and 65536 <= g.lanes < 65536 + g.blocks * 32


@pytest.mark.parametrize("geometry", [
    PS.PhGeometry(2, 48),       # threads not whole warps
    PS.PhGeometry(1, 512),      # above 256 threads
    PS.PhGeometry(0, 64),       # no block
    PS.PhGeometry(4, 0),        # no thread
], ids=["ragged-warp", "block-too-large", "no-block", "no-thread"])
def test_b4_refuses_a_geometry_it_cannot_run(cuda, geometry, monkeypatch):
    """The kernel returns cudaErrorInvalidValue for a launch it cannot run
    (the wrapper raises and counts nothing); the wrapper's own geometry
    for the same inputs runs."""
    args, _, _ = K.b4_case_inputs(K.B4_CASES["n1025-float32"], cuda)
    PS.reset_launch_counts()
    monkeypatch.setattr(PS, "ph_geometry", lambda *a, **kw: geometry)
    with pytest.raises(RuntimeError, match="launch failed"):
        PS.ph_kernel(*args)
    assert PS.LAUNCHES["solve_pH_kernel"] == 0
    monkeypatch.undo()
    assert torch.equal(PS.ph_kernel(*args), PS.ph_plain(*args))
    assert PS.LAUNCHES["solve_pH_kernel"] == 1


def test_b4_matches_the_loop_and_the_host_solver(cuda):
    assert K.b4_vs_loop(cuda) <= K.PH_LOOP_TOL
    assert K.b4_vs_host(cuda) <= K.PH_LOOP_TOL


def test_ph_wrappers_launch_b4_on_cuda_tensors(cuda):
    k = K.ph_waters((64, 1), torch.float32, cuda)
    shifts = torch.linspace(-1e-3, 1e-3, 9, device=cuda)
    PS.reset_launch_counts()
    with pytest.warns(RuntimeWarning, match="float32"):
        a = PS.solve_pH_kernel(k, torch.full((64, 1), 7.0, device=cuda))
    b = PS.solve_pH_auto(k, 7.0)
    curve = chem.pH_after_alkalinity_shift(k, shifts, b)
    torch.cuda.synchronize()
    assert PS.LAUNCHES == {"solve_pH_kernel": 3}
    assert torch.equal(a, b) and a.shape == (64, 1) and a.is_cuda
    assert curve.shape == (64, 9)
    assert torch.equal(curve, PS.solve_pH_plain(
        dataclasses.replace(k, alk_eq=k.alk_eq + shifts), b))
    cpu = [x.cpu() for x in PS.broadcast_inputs(k, b)[0]]
    with pytest.raises(ValueError, match="CUDA"):
        PS.ph_kernel(*cpu)


def test_ph_inputs_on_mixed_devices(cuda):
    """Constants on the card with a guess on the CPU (or the reverse) raise
    and launch nothing; a 0-dim CPU guess is a scalar and launches B4
    once, through every entry point."""
    k = K.ph_waters((64,), torch.float64, cuda)
    k_cpu = K.ph_waters((64,), torch.float64, "cpu")
    on_cpu = torch.full((64,), 7.0, dtype=torch.float64)
    PS.reset_launch_counts()
    for solve in (PS.solve_pH_kernel, PS.solve_pH_auto, PS.solve_pH_plain):
        with pytest.raises(ValueError, match="different devices"):
            solve(k, on_cpu)
        with pytest.raises(ValueError, match="different devices"):
            solve(k_cpu, on_cpu.to(cuda))
    assert PS.LAUNCHES == {"solve_pH_kernel": 0}
    ref = PS.solve_pH_kernel(k, on_cpu.to(cuda))
    for n, solve in enumerate((PS.solve_pH_auto, PS.solve_pH_kernel), 2):
        got = solve(k, torch.tensor(7.0, dtype=torch.float64))
        assert PS.LAUNCHES == {"solve_pH_kernel": n}
        assert got.is_cuda and torch.equal(got, ref)
    PS.reset_launch_counts()
    curve = chem.pH_after_alkalinity_shift(
        k, 1e-4, torch.tensor(7.0, dtype=torch.float64))
    assert PS.LAUNCHES == {"solve_pH_kernel": 1} and curve.is_cuda


def test_titration_curves_on_the_card(cuda):
    """``pH_after_alkalinity_shift`` through B4 on a small titration: the
    charge balance closes for most solves and the curves rise with the
    shift wherever it does (``kernel_checks.titration_check``)."""
    for dtype in (torch.float32, torch.float64):
        k, shifts = K.titration_waters(256, 64, dtype, cuda)
        curve = chem.pH_after_alkalinity_shift(k, shifts,
                                               PS.solve_pH_auto(k, 7.0))
        verdict = K.titration_check(k, shifts, curve)
        assert verdict["finite"] and verdict["in_range"], verdict
        assert verdict["rising"] and verdict["enough"], verdict


# ---------------------------------------------------------------------------
# the extension axes on the card (plain PyTorch: no kernel serves them)
# ---------------------------------------------------------------------------


def test_all_axes_step_on_the_card_matches_the_cpu(cuda):
    """One step of the six-axis plant batch in float64 on the card and on
    the CPU through the same plain code: rtol 1e-9, atol 1e-12 (the two
    devices' exp/pow may differ in the last ulp)."""
    cfg = P.full_chemistry_config(n_zones=20)
    bc = P.full_chemistry_boundary()
    card, host = (R.step(*make_monte_carlo_batch(
        cfg, 4, seed=0, dtype=torch.float64, device=dev), bc, 1.0, 3)
        for dev in (cuda, torch.device("cpu")))
    for f in dataclasses.fields(host):
        a, b = getattr(card, f.name), getattr(host, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-12,
                                       msg=f.name)


def test_ten_instrument_plant_step_on_the_card(cuda):
    """The six-axis plant with its ten instruments steps on the card
    through ``plant_step`` and launches no fused kernel."""
    params, plant = P.make_plant(P.full_chemistry_config(n_zones=20),
                                 device=cuda)
    assert FP.unsupported_reason(params) is not None
    FP.reset_launch_counts()
    g = torch.Generator(device=cuda).manual_seed(0)
    for _ in range(3):
        plant, readings = P.plant_step(params, plant,
                                       P.full_chemistry_boundary(), 1.0, 3,
                                       generator=g)
    assert len(readings) == 10
    for name in ("ammonia_outlet", "oxygen_outlet", "turbidity_outlet"):
        assert bool(torch.isfinite(readings[name].value))
    assert bool(torch.isfinite(plant.reactor.pathogens).all())
    assert not any(FP.LAUNCHES.values())


@pytest.mark.parametrize("case", ["closed loop", "EKF step", "MHE step"])
def test_control_on_the_card_matches_the_cpu(cuda, case):
    """The control path (plain PyTorch, no fused kernel) in float64 on the
    card and on the CPU: a closed-loop gain sweep, a bank of EKF steps
    (vmap of jacfwd of the plant step) and an MHE step, every output
    within rtol 1e-9, atol 1e-12."""
    from ics_wt_physicsengine_torch.control import device_checks as DC

    for counts in (F.reset_launch_counts, FP.reset_launch_counts,
                   PS.reset_launch_counts):
        counts()
    card = DC.CASES[case](cuda)
    assert not any({**F.LAUNCHES, **FP.LAUNCHES, **PS.LAUNCHES}.values())
    host = DC.CASES[case](torch.device("cpu"))
    assert card.keys() == host.keys()
    for name in host:
        torch.testing.assert_close(card[name].cpu(), host[name], rtol=1e-9,
                                   atol=1e-12, msg=name)


def test_surrogate_on_the_card_matches_the_cpu(cuda):
    """The surrogate (plain PyTorch, no fused kernel) at bench.py's 6-zone
    (128, 128) network: one step (a residual at the state's full spread)
    and an 8-step rollout (bench.py's network) of 4096 states on the card
    against the CPU, float32 products within 1e-5 of x_std and bfloat16
    ones (bfloat16 operands multiplied in float32 on both) within 1e-4."""
    from ics_wt_physicsengine_torch.models import surrogate_checks as SC

    for counts in (F.reset_launch_counts, FP.reset_launch_counts,
                   PS.reset_launch_counts):
        counts()
    worst = SC.card_vs_cpu(cuda)
    assert not any({**F.LAUNCHES, **FP.LAUNCHES, **PS.LAUNCHES}.values())
    for name, err in worst.items():
        dtype = getattr(torch, name.split()[1])
        assert err <= SC.TOLERANCE[dtype], (name, err)


def test_checkpoints_from_the_card_reload_bit_equal(cuda, tmp_path):
    """SurrogateParams and a reactor with its seven sensors, saved from
    CUDA tensors and reloaded into CUDA templates: every leaf equal, on the
    card, and the resumed simulation reads as the one that never
    stopped."""
    from ics_wt_physicsengine_torch.models import surrogate_checks as SC
    from ics_wt_physicsengine_torch.sensors import (
        create_realistic_sensor_suite)
    from ics_wt_physicsengine_torch.utils import checkpoint as CK

    sp = SC.bench_params(device=cuda)
    path = str(tmp_path / "sp.npz")
    CK.save_pytree(path, sp)
    back = CK.load_pytree(path, sp)
    for a, b in zip(CK.tree_leaves(back), CK.tree_leaves(sp)):
        assert a.device.type == "cuda" and torch.equal(a, b)

    config = R.ReactorConfiguration(n_zones=5)
    bc = R.BoundaryConditions(acid_flow_rate=0.2, chlorine_flow_rate=0.05)

    def suite(seed):
        sensors = create_realistic_sensor_suite(config, seed=seed,
                                                device=cuda)
        for s in sensors.values():
            s.calibrate(7.0, 0.0)
        return sensors

    def ticks(r, sensors, t0, n):
        out = []
        for i in range(n):
            r.step(1.0, bc)
            out.append([s.read(r.state, t0 + i).value
                        for s in sensors.values()])
        return np.asarray(out), r.state.chlorine.cpu()

    r1 = R.IntegratedCSTR(config, device=cuda)
    s1 = suite(3)
    ticks(r1, s1, 2000.0, 10)
    path = str(tmp_path / "sim.npz")
    CK.save_simulation(path, r1, sensors=s1)
    want = ticks(r1, s1, 2010.0, 20)
    r2 = R.IntegratedCSTR(config, device=cuda)
    s2 = suite(999)
    CK.load_simulation(path, r2, sensors=s2)
    assert r2.state.pH.device.type == "cuda"
    got = ticks(r2, s2, 2010.0, 20)
    assert np.isfinite(got[0]).all()
    np.testing.assert_array_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def _zone_column(n_zones, dtype, device):
    """examples/zone_sharded_highres.py's plant at ``n_zones``: a warm
    inflow over a cold tank, stratification on."""
    cfg = R.ReactorConfiguration(volume=2000.0, height=4.0,
                                 diameter=2 * np.sqrt(2.0 / (np.pi * 4.0)),
                                 n_zones=n_zones, flow_rate=8.0,
                                 initial_pH=7.3, initial_chlorine=1.5,
                                 temperature=18.0)
    state = R.make_initial_state(cfg, dtype=dtype, device=device)
    state = R._update_derived(dataclasses.replace(
        state, temperature=state.temperature + torch.linspace(
            6.0, 0.0, n_zones, dtype=dtype, device=device)))
    bc = R.BoundaryConditions(inlet_flow_rate=8.0, inlet_pH=7.6,
                              inlet_chlorine=0.8, inlet_temperature=24.0,
                              ambient_temperature=8.0,
                              heat_loss_coefficient=120.0)
    return cfg, R.make_params(cfg, dtype=dtype, device=device), state, bc


def test_zone_sharded_column_on_the_card_matches_the_unsharded(cuda):
    """ZONE-256-4 at small depth: the 256-zone column over the card listed
    four times (64-zone shards, halos every stage), float64, one RK4 step
    against the unsharded step on the card; no kernel launch."""
    from ics_wt_physicsengine_torch import parallel as PAR

    cfg, params, state, bc = _zone_column(256, torch.float64, cuda)
    m = R.default_substeps(cfg, 1.0)
    mesh = PAR.make_zone_mesh(devices=[cuda] * 4)
    F.reset_launch_counts()
    got = PAR.gather_zones(PAR.zone_sharded_step(mesh, 256, 1.0, m)(
        params, state, bc))
    want = R.step(params, state, bc, dt=1.0, substeps=m)
    assert got.pH.device == state.pH.device
    for field, atol in (("pH", 1e-10), ("chlorine", 1e-10),
                        ("temperature", 1e-8)):
        err = float((getattr(got, field) - getattr(want, field)).abs().max())
        assert err <= atol, (field, err)
    assert not any(F.LAUNCHES.values())


def test_plant_zone_mesh_on_the_card_matches_the_unsharded(cuda):
    """PZ-2x2: a 2 x 2 plants-by-zones mesh of the card at
    ``__graft_entry__.py``'s 8-zone batch, float64, equal to the unsharded
    batched step within 1e-10."""
    from ics_wt_physicsengine_torch import parallel as PAR

    cfg = R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                 n_zones=8)
    params, state = make_monte_carlo_batch(cfg, 4, seed=1,
                                           dtype=torch.float64, device=cuda)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, acid_flow_rate=0.1)
    mesh = PAR.make_plant_zone_mesh(2, 2, devices=[cuda] * 4)
    fn = PAR.plant_zone_sharded_step(mesh, 8, 1.0, 4, params_example=params)
    got = PAR.gather_zones(fn(PAR.shard_batch_zones(params, mesh),
                              PAR.shard_batch_zones(state, mesh), bc))
    want = R.step(params, state, bc, dt=1.0, substeps=4)
    for field in ("pH", "chlorine", "temperature"):
        err = float((getattr(got, field) - getattr(want, field)).abs().max())
        assert err <= 1e-10, (field, err)


def _tools(name="torch_soak"):
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    return importlib.import_module(name)


def test_quick_bench_on_the_card(cuda, tmp_path):
    """Every row of the port's bench at --quick: every rate > 0, and each
    kernel row launches its kernel once a call (B3's with its table pack)
    and no other."""
    from ics_wt_physicsengine_torch import bench as B

    run = B.BenchRun(cuda, quick=True, log=lambda msg: None)
    result = B.bench(run)
    extra = result["extra"]
    rates = [result["value"]] + [extra[k] for k in B.RATES[1:]]
    assert all(np.isfinite(r) and r > 0 for r in rates)
    assert result["ok"] and extra["device"]["platform"] == "gpu"
    for row, r in extra["rows"].items():
        want = B.KERNEL_ROWS.get(row)
        assert r["launches"] == r["calls"], row
        assert set(r["calls"]) == (set(B.WRAPPER_LAUNCHES.get(want, (want,)))
                                   if want else set()), row


def test_philox_stats_on_the_card(cuda):
    """B3's Philox readings against the plain path's generator at bench.py's
    full size: mean, spread and NaN share within bench.py's bounds."""
    from ics_wt_physicsengine_torch import bench as B

    stats = B.bench_philox_stats(device=cuda)
    assert stats["philox_prng_reads"] == 64 * 16 * 128
    assert stats["philox_prng_ok"], stats


def test_soak_on_the_card(cuda):
    """The soak at tools/soak.py's 1M steps (the drift check needs the tank
    settled after the first 250,000-step segment), its instrumented and
    nitrogen phases cut short: every check true, B1 once a call."""
    torch_soak = _tools()
    F.reset_launch_counts()
    result = torch_soak.soak(1_000_000, cuda, plant_steps=40,
                             nitrogen_steps=16, log=lambda msg: None)
    checks = {k: v for k, v in result.items() if isinstance(v, bool)}
    assert result["ok"], checks
    assert F.LAUNCHES["rollout_fused"] == result["b1_calls"] == 9


def _examples():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from examples_torch import dosing_program_hil, monte_carlo_uq

    return monte_carlo_uq, dosing_program_hil


def test_kernel_examples_launch_their_kernels_on_the_card(cuda, capsys):
    """examples_torch/monte_carlo_uq.py (B1, once) and dosing_program_hil.py
    (B3, once an hourly segment) on the card at tiny sizes: finite
    results, and each launched its kernel and no other."""
    monte_carlo_uq, dosing_program_hil = _examples()
    F.reset_launch_counts()
    FP.reset_launch_counts()
    PS.reset_launch_counts()
    report = monte_carlo_uq.main(["--plants", "64", "--hours", "0.02"])
    assert all(np.isfinite(v)
               for v in report["outlet_chlorine_mg_L"].values())
    assert report["device"]["platform"] == "gpu"
    counts = {**F.LAUNCHES, **FP.LAUNCHES, **PS.LAUNCHES}
    assert counts == {k: int(k == "rollout_fused") for k in counts}
    F.reset_launch_counts()
    out = dosing_program_hil.main(["--hours", "2"])
    assert out["n_segments"] == 2 and len(out["series"]["pH_outlet"]) == 120
    assert any(np.isfinite(v).any() for v in out["series"].values())
    counts = {**F.LAUNCHES, **FP.LAUNCHES, **PS.LAUNCHES}
    assert counts == {k: 2 * int(k in ("plant_rollout_fused", "pack_tables"))
                      for k in counts}
    assert "instrument health after the program" in capsys.readouterr().out


def test_ablate_fused_plant_on_the_card(cuda):
    """tools/torch_ablate_fused_plant.py at 256 steps: the six ablated
    copies of B3 build and launch through plant_rollout_fused; every
    variant's physics bit-equal to the shipped build's, no_store's readings
    and one_sensor's sensor 0 bit-equal to it, no_rand within TOL of the
    plain plant_step loop fed the same constant draws; no_rand's, no_hist's
    and no_taps' readings differ from it; the packed B1 launched and
    bit-equal to the shipped B1; the shipped library bound again
    afterwards."""
    from ics_wt_physicsengine_torch.ops import _build

    ablate = _tools("torch_ablate_fused_plant")
    shipped = _build.load("fused_plant")
    result = ablate.ablate(cuda, n_steps=256, reps=1, check_steps=64,
                           log=lambda msg: None)
    assert result["ok"], result["checks"]
    assert len(result["checks"]) == 25
    assert _build.load("fused_plant") is shipped
    assert set(result["kernel_us_per_step"]) == \
        set(ablate.VARIANTS) | {"physics", "physics_packed"}
    assert all(v > 0 for v in result["kernel_us_per_step"].values())
    assert result["device"]["platform"] == "gpu"


def test_spans_leave_the_card_bit_equal_and_hold_the_launch(cuda):
    """The program's spans on the card (``utils/profiling.py``): a B3
    call's and a served chunk's outputs bit-equal with spans on and off,
    and under ``torch.profiler`` B3's kernel launched from inside
    ``wt.b3.launch``, on one clock."""
    from torch.profiler import ProfilerActivity, profile

    from ics_wt_physicsengine_torch import __main__ as M
    from ics_wt_physicsengine_torch.utils import profiling as PF

    substeps, _ = K.plant_plan(20, "rk4")
    params, plant = K.plant_case(20, 8, torch.float32, cuda)
    one = P.make_plant(R.ReactorConfiguration(n_zones=20), device=cuda)
    sched, _ = M.build_chunk_schedule(K.BC, K.BC, 64, 1.0, 0.0, device=cuda)

    def both():
        return (FP.plant_rollout_fused(params, plant, K.BC, dt=1.0,
                                       substeps=substeps, n_steps=64,
                                       record_every=4, seed=3),
                P.plant_serve_chunk(*one, sched, dt=1.0, substeps=substeps,
                                    seed=3, step0=64))

    off = _tensors(both())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with PF.recording() as spans:
            on = _tensors(both())
        torch.cuda.synchronize(cuda)
    assert len(on) == len(off) > 20
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    launch = [s for s in spans if s[0] == "wt.b3.launch"]
    assert len(launch) == 2 and spans.dropped == 0
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events if "plant_kernel" in e.name()]
    calls = [e.start_ns() for e in events
             if e.name().startswith("cudaLaunchKernel")]
    assert len(kernels) == 2
    for (_, start, end, _, _), kernel in zip(launch, kernels):
        assert any(start <= t <= end for t in calls)
        assert start <= kernel.start_ns()


def test_b1_rkc_table_span_and_evaluation_count(cuda):
    """B1's RKC2 coefficient fold on the card: an RKC call records
    ``wt.b1.rkc_table`` inside ``wt.b1.launch`` and an RK4 call the same
    three spans as before, none inside its launch; B2's fold is the same
    span; ``EVALUATIONS`` advances by ``evaluations``'s count of each
    launch; RKC and RK4 outputs are bit-equal with spans on and off."""
    from ics_wt_physicsengine_torch.utils import profiling as PF

    cfg = R.ReactorConfiguration(n_zones=20)
    params, state = make_monte_carlo_batch(cfg, 64, seed=4,
                                           dtype=torch.float32, device=cuda)
    sched = R.BoundaryConditions(inlet_pH=np.full(30, 7.2))

    def calls():
        return (F.rollout_fused(params, state, K.BC, dt=K.DT, substeps=1,
                                stages=4, n_steps=50),
                F.rollout_fused(params, state, K.BC, dt=K.DT, substeps=3,
                                n_steps=50),
                F.rollout_scheduled_fused(params, state, sched, dt=K.DT,
                                          substeps=1, stages=4))

    F.reset_launch_counts()
    off = _tensors(calls())
    torch.cuda.synchronize(cuda)
    want = {"rollout_fused": F.evaluations(64, 50, 1, 4)
            + F.evaluations(64, 50, 3, None),
            "rollout_scheduled_fused": F.evaluations(64, 30, 1, 4)}
    assert F.EVALUATIONS == want
    assert want["rollout_fused"] == 64 * 50 * (4 + 12)
    with PF.recording() as spans:
        on = _tensors(calls())
    torch.cuda.synchronize(cuda)
    assert F.EVALUATIONS == {k: 2 * v for k, v in want.items()}
    assert F.LAUNCHES == {"rollout_fused": 4, "rollout_scheduled_fused": 2}
    assert len(on) == len(off) > 10
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    named = [(s[0], spans[s[3]][0] if s[3] >= 0 else None) for s in spans]
    assert named == [
        ("wt.b1.wrapper", None), ("wt.b1.tables", "wt.b1.wrapper"),
        ("wt.b1.launch", "wt.b1.wrapper"),
        ("wt.b1.rkc_table", "wt.b1.launch"),
        ("wt.b1.wrapper", None), ("wt.b1.tables", "wt.b1.wrapper"),
        ("wt.b1.launch", "wt.b1.wrapper"),
        ("wt.b1.rkc_table", None)]
    assert spans.dropped == 0
    launch, table = spans[2], spans[3]
    assert launch[1] <= table[1] <= table[2] <= launch[2]


def _tensors(x):
    """Every tensor of a result, in a fixed order: dataclass fields, dict
    keys sorted, tuple and list items."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrappers_make_no_host_sync_between_launches(cuda, dtype):
    """After one warm call, the B3 and B1 wrappers only enqueue work: under
    ``torch.cuda.set_sync_debug_mode("error")`` two chained
    ``plant_rollout_fused`` calls on an instrumented batch (per-plant
    delays; constant forcing, then a NumPy schedule), a served chunk
    (``plant_serve_chunk``, shorter than the sample lines, so its rings are
    joined with the ones before) up to its return, and two chained
    ``rollout_fused`` calls raise nothing. Each output equals, bit for bit,
    the same calls with the card synchronized between them."""
    from ics_wt_physicsengine_torch import __main__ as M

    cfg = R.ReactorConfiguration(n_zones=20)
    substeps, _ = K.plant_plan(20, "rk4")
    params, plant = K.plant_case(20, 8, dtype, cuda, delays=True)
    one_params, one = P.make_plant(cfg, dtype=dtype, device=cuda)
    sched, _ = M.build_chunk_schedule(
        K.BC, dataclasses.replace(K.BC, acid_flow_rate=0.3), 16, K.DT,
        30.0, device=cuda)
    mc, state = make_monte_carlo_batch(cfg, 16, seed=2, dtype=dtype,
                                       device=cuda)

    def b3(p, k, boundary=K.BC):
        return FP.plant_rollout_fused(params, p, boundary, dt=K.DT,
                                      substeps=substeps, n_steps=40,
                                      record_every=8, seed=3, step0=40 * k)

    def served(p, k):
        return P.plant_serve_chunk(one_params, p, sched, dt=K.DT,
                                   substeps=substeps, seed=3, step0=16 * k)

    def b1(s):
        return F.rollout_fused(mc, s, K.BC, dt=K.DT, substeps=substeps,
                               n_steps=40)

    warm, chunk, s0 = b3(plant, 0), served(one, 0), b1(state)
    torch.cuda.synchronize(cuda)

    def chained(between):
        a = b3(warm[0], 1)
        between()
        b = b3(a[0], 2, K.bench_schedule(40))
        between()
        c = served(chunk.plant, 1)
        between()
        d = b1(s0)
        between()
        return a, b, c, d, b1(d)

    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _tensors(chained(lambda: None))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = _tensors(chained(lambda: torch.cuda.synchronize(cuda)))
    assert len(got) == len(want) > 40
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_b3_histories_start_as_copies_of_the_lead_in(cuda, dtype):
    """B3 writes its sample-line histories into copies of the tables'
    lead-ins, never into the tables: the leads are unchanged after the
    launch, and the written-back histories equal the plain version's."""
    substeps, _ = K.plant_plan(20, "rk4")
    params, plant = K.plant_case(20, 8, dtype, cuda, delays=True)
    tables = FP.build_tables(params, plant, K.BC, dt=K.DT, n_steps=24)
    leads = [x.clone() for x in tables.lead]
    kw = dict(dt=K.DT, substeps=substeps, n_steps=24, record_every=8,
              seed=3)
    got = FP.plant_kernel(tables, **kw)
    want = FP.plant_plain(tables, **kw)
    for a, b in zip(tables.lead, leads):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(got.hist, want.hist):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
