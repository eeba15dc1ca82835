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
    (plant, readings), diff = K.b3_vs_plain(spec, cuda)
    assert diff["nan_equal"] and diff["ints_equal"], diff
    assert diff["max_abs_err"] <= K.TOL[spec.get("dtype", torch.float32)], \
        diff
    assert bool(torch.isfinite(plant.reactor.pH).all())
    n_rec = K.B3_STEPS // spec["record_every"]
    assert readings["pH_outlet"].shape[0] == n_rec
    if spec["rng"] == "bits":   # the injected faults went dark
        assert bool(torch.isnan(readings["pH_outlet"][-1].reshape(-1)[0]))
        assert bool(torch.isnan(readings["flow_main"][-1].reshape(-1)[0]))


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
    assert FP.LAUNCHES == {"plant_rollout_fused": 2}
    assert F.LAUNCHES == {"rollout_fused": 0, "rollout_scheduled_fused": 0}
    assert readings["pH_outlet"].shape == (4,)
    assert readings["pH_outlet"].is_cuda
    assert traj["temp_inlet"].shape == (10,)
    assert float(new.reactor.time) == 30.0
    assert bool(torch.isfinite(new.reactor.pH).all())


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
