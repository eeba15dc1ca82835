"""
The port's entry points: ``entry()``, one full plant step on the 20-zone
stratified configuration, RK4-substepped physics plus all seven instruments
(``models.plant.plant_step``), and ``dryrun_multichip``, every multi-device
path of the package on a mesh.

The configuration, boundary, seed and substeps are those of the JAX
package's ``__graft_entry__.entry()`` and ``dryrun_multichip``. The
instruments draw from a ``torch.Generator`` seeded with ``SEED``; a caller
that wants to inject the draws passes ``rand=`` to the returned function.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import fields, is_dataclass, replace

import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.device import DEFAULT_DTYPE, resolve_device
from ics_wt_physicsengine_torch.models.plant import make_plant, plant_step

SEED = 1
DT = 1.0


def entry(device=None, dtype=DEFAULT_DTYPE):
    """Return ``(fn, example_args)``: ``fn(params, plant, boundary)`` takes
    one plant step and gives ``(pH[20], chlorine_outlet value, pH_inlet
    value)``, on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    config = R.ReactorConfiguration(
        volume=1000, height=2.0, diameter=0.798, n_zones=20,
        flow_rate=5.0, initial_pH=7.0, initial_chlorine=2.0,
        temperature=20.0, enable_thermal_stratification=True)
    params, plant = make_plant(config, dtype=dtype, device=dev)
    bc = R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
        inlet_temperature=26.0, acid_flow_rate=0.1,
        ambient_temperature=15.0, heat_loss_coefficient=50.0)
    substeps = R.default_substeps(config, DT)
    generator = torch.Generator(device=dev).manual_seed(SEED)

    def fn(params, plant, boundary, rand=None):
        new_plant, readings = plant_step(params, plant, boundary, dt=DT,
                                         substeps=substeps, rand=rand,
                                         generator=generator)
        return (new_plant.reactor.pH,
                readings["chlorine_outlet"].value,
                readings["pH_inlet"].value)

    return fn, (params, plant, bc)


_T0 = time.monotonic()


def _log(msg: str) -> None:
    print(f"[+{time.monotonic() - _T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _finite(x) -> bool:
    return bool(torch.all(torch.isfinite(x)))


def _broadcast(tree, n: int, device):
    """Every tensor of ``tree`` (and every number of a boundary) repeated
    along a new leading ``[n]`` axis on ``device``."""

    def lane(x):
        if isinstance(x, torch.Tensor):
            return x.to(device).expand((n,) + tuple(x.shape)).clone()
        if isinstance(x, float):
            return torch.full((n,), x, dtype=torch.float32, device=device)
        if is_dataclass(x):
            return replace(x, **{f.name: lane(getattr(x, f.name))
                                 for f in fields(x)})
        return x

    return lane(tree)


def dryrun_multichip(n_devices: int, devices=None, log=None) -> list:
    """Every multi-device path of the port on an ``n_devices`` mesh, at the
    shapes and with the assertions of the JAX package's
    ``__graft_entry__.dryrun_multichip``. ``devices``: the mesh's devices
    (default: the visible CUDA cards; the CPU only when listed; one device
    may be listed more than once). Stages, each logged as it passes:

    - dp: a Monte-Carlo batch sharded over plants, one step, the ensemble
      mean;
    - sp, sp-particles: one plant's zones split over the mesh, halos at
      every stage (``parallel/spatial.py``), without and with particles;
    - fused: kernel B1 on each plant shard (one launch a shard on a card);
    - fleet, extensions, serve: the instrumented batch with per-lane
      boundaries, the full-chemistry fleet with its ten instruments, and a
      3-step masked chunk, each shard stepping its lanes;
    - dpxsp: the 2-D plants x zones mesh (when ``n_devices`` is even and at
      least 4);
    - closed-loop, ekf: a PID gain sweep and an EKF bank, sharded over
      lanes;
    - enkf, surrogate: a member-sharded EnKF and a trajectory-sharded
      surrogate dataset. Their steps couple every member or trajectory (the
      analysis, Adam on the minibatch), so the shards are gathered onto the
      first device for them; the JAX package's compiler puts the
      reductions across its devices instead.

    Returns the names of the stages that ran."""
    import numpy as np

    from ics_wt_physicsengine_torch import control as C
    from ics_wt_physicsengine_torch import parallel as PAR
    from ics_wt_physicsengine_torch.models import surrogate as SG
    from ics_wt_physicsengine_torch.models.monte_carlo import (
        make_monte_carlo_batch)
    from ics_wt_physicsengine_torch.models.plant import (make_plant_batch,
                                                         plant_step_batched)
    from ics_wt_physicsengine_torch.parallel.mesh import _zip_map

    log = log or _log
    log(f"dryrun_multichip(n_devices={n_devices}) start")
    mesh = PAR.make_mesh(n_devices, devices=devices)
    devs = mesh.devices
    dev0 = devs[0]
    f32 = torch.float32
    log(f"devices selected: {dev0.type} x{len(devs)}")
    stages = []

    def passed(name, msg, *checks):
        for k, ok in enumerate(checks):
            if not ok:
                raise AssertionError(f"dryrun_multichip: stage {name}, "
                                     f"check {k + 1} failed")
        stages.append(name)
        log(f"stage {name}: {msg} ok")

    def gens(seed):
        return [torch.Generator(device=d).manual_seed(seed + k)
                for k, d in enumerate(devs)]

    # dp: a Monte-Carlo batch sharded over the plant axis
    base = R.ReactorConfiguration(n_zones=4)
    n_plants = 2 * n_devices
    params, state = make_monte_carlo_batch(base, n_plants, seed=0,
                                           dtype=f32, device=dev0)
    params_s = PAR.shard_batch(params, mesh)
    state_s = PAR.shard_batch(state, mesh)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, acid_flow_rate=0.1)
    new_state = PAR.gather_batch(
        PAR.sharded_step(mesh, dt=1.0, substeps=4)(params_s, state_s, bc))
    mean_ph = float(torch.mean(new_state.pH))
    passed("dp", "sharded step + ensemble mean",
           new_state.pH.shape == (n_plants, 4),
           math.isfinite(mean_ph) and _finite(new_state.pH))

    # sp: one plant's zones split over the mesh
    zmesh = PAR.make_zone_mesh(n_devices, devices=devs)
    n_zones = 4 * n_devices
    cfg = R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                 n_zones=n_zones)
    sp_params = R.make_params(cfg, dtype=f32, device=dev0)
    sp_state = PAR.shard_state_zones(
        R.make_initial_state(cfg, dtype=f32, device=dev0), zmesh)
    sp_fn = PAR.zone_sharded_step(zmesh, n_zones=n_zones, dt=1.0,
                                  substeps=4)
    sp_out = PAR.gather_zones(sp_fn(sp_params, sp_state, bc))
    passed("sp", "zone-sharded halo step",
           sp_out.pH.shape == (n_zones,),
           _finite(sp_out.pH))

    # sp-particles: [C, Z] tss through the halos, the sludge tendency
    # summed over the shards
    cfg_p = R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                   n_zones=n_zones, enable_particles=True,
                                   initial_tss=20.0)
    pp_params = R.make_params(cfg_p, dtype=f32, device=dev0)
    pp_state = PAR.shard_state_zones(
        R.make_initial_state(cfg_p, dtype=f32, device=dev0), zmesh)
    pp_fn = PAR.zone_sharded_step(zmesh, n_zones=n_zones, dt=1.0,
                                  substeps=4, particles=True)
    pp_out = PAR.gather_zones(pp_fn(
        pp_params, pp_state, R.BoundaryConditions(
            inlet_flow_rate=5.0, coagulant_dose=10.0, inlet_tss=20.0)))
    passed("sp-particles", "zone-sharded particle classes",
           pp_out.tss.shape[-1] == n_zones,
           _finite(pp_out.tss) and _finite(pp_out.sludge))

    # fused: kernel B1 on each plant shard
    fused_out = PAR.gather_batch(PAR.sharded_rollout_fused(
        mesh, dt=1.0, substeps=4, n_steps=5)(params_s, state_s, bc))
    passed("fused", "sharded whole-rollout kernel",
           fused_out.pH.shape == (n_plants, 4),
           _finite(fused_out.pH))

    # fleet: the instrumented batch with per-lane boundaries
    fp, fs = make_plant_batch(base, n_plants, seed=2, dtype=f32,
                              device=dev0)
    fp_s, fs_s = PAR.shard_batch(fp, mesh), PAR.shard_batch(fs, mesh)
    bc_lane = PAR.shard_batch(_broadcast(bc, n_plants, dev0), mesh)
    outs = [plant_step_batched(p, s, b, 1.0, 4, boundary_axes=0,
                               generator=g)
            for p, s, b, g in zip(fp_s, fs_s, bc_lane, gens(2))]
    readings = {name: torch.cat([o[1][name].value.to(dev0) for o in outs])
                for name in ("pH_outlet", "chlorine_outlet")}
    passed("fleet", "integrated plant batch with per-lane boundaries",
           readings["pH_outlet"].shape == (n_plants,),
           _finite(readings["chlorine_outlet"]))

    # extensions: the full-chemistry fleet with its ten instruments
    ext_cfg = R.ReactorConfiguration(
        volume=1000, height=2.0, diameter=0.798, n_zones=4,
        enable_nitrogen=True, enable_gas=True, enable_particles=True,
        initial_ammonia=1.0, initial_tss=20.0,
        enable_disinfection=True, initial_pathogens=1e4,
        enable_biofilm=True, initial_bacteria=1e-3, initial_bdoc=0.5,
        enable_phase=True)
    ep, es = make_plant_batch(ext_cfg, n_plants, seed=3, dtype=f32,
                              device=dev0)
    ext_bc = R.BoundaryConditions(aeration_kla=1e-3, coagulant_dose=10.0,
                                  inlet_tss=20.0, inlet_ammonia=1.0,
                                  inlet_pathogens=1e4, uv_intensity=10.0,
                                  inlet_bacteria=1e-3, inlet_bdoc=0.5,
                                  ambient_temperature=2.0,
                                  ambient_humidity=0.4, wind_speed=3.0,
                                  heat_loss_coefficient=100.0)
    outs = [plant_step_batched(p, s, ext_bc, 1.0, 4, generator=g)
            for p, s, g in zip(PAR.shard_batch(ep, mesh),
                               PAR.shard_batch(es, mesh), gens(3))]
    ext_st = PAR.gather_batch([o[0].reactor for o in outs], dev0)
    ext_rd = {name: torch.cat([o[1][name].value.to(dev0) for o in outs])
              for name in ("oxygen_outlet", "turbidity_outlet",
                           "ammonia_outlet")}
    passed("extensions", "full-chemistry fleet "
           "(N+gas+particles+disinfection+biofilm+phase)",
           ext_rd["oxygen_outlet"].shape == (n_plants,),
           ext_rd["turbidity_outlet"].shape == (n_plants,),
           _finite(ext_rd["ammonia_outlet"]),
           ext_st.pathogens.shape[-2:] == (3, 4),
           _finite(ext_st.ct),
           ext_st.biofilm.shape == (n_plants, 4),
           _finite(ext_st.bacteria))

    # serve: a 3-step masked chunk over the per-lane boundaries
    chunk, plants = [], []
    for p, s, b, g in zip(fp_s, fs_s, bc_lane, gens(4)):
        mask = torch.ones(s.reactor.pH.shape[0], dtype=torch.bool,
                          device=s.reactor.pH.device)
        rows = []
        for _ in range(3):
            new, out = plant_step_batched(p, s, b, 1.0, 4, boundary_axes=0,
                                          generator=g)
            s = _zip_map(lambda a, o: torch.where(
                mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, o)
                if isinstance(a, torch.Tensor) else a, [new, s])
            rows.append(out["pH_outlet"].value)
        chunk.append(torch.stack(rows).to(dev0))
        plants.append(s.reactor.pH.to(dev0))
    passed("serve", "chunked fleet rollout",
           torch.cat(chunk, dim=1).shape == (3, n_plants),
           _finite(torch.cat(plants)))

    # dpxsp: plants x zones, when the device count factors
    if n_devices % 2 == 0 and n_devices >= 4:
        n_sp = 2
        n_dp = n_devices // n_sp
        cfg2 = R.ReactorConfiguration(volume=1000, height=2.0,
                                      diameter=0.798, n_zones=8)
        p2, s2 = make_monte_carlo_batch(cfg2, 2 * n_dp, seed=1, dtype=f32,
                                        device=dev0)
        mesh2 = PAR.make_plant_zone_mesh(n_dp, n_sp, devices=devs)
        fn2 = PAR.plant_zone_sharded_step(mesh2, n_zones=8, dt=1.0,
                                          substeps=4, params_example=p2)
        out2 = PAR.gather_zones(fn2(PAR.shard_batch_zones(p2, mesh2),
                                    PAR.shard_batch_zones(s2, mesh2), bc))
        passed("dpxsp", "combined 2-D mesh",
               out2.pH.shape == (2 * n_dp, 8),
               _finite(out2.pH))
    else:
        log("stage dpxsp: skipped (the device count does not factor)")

    # closed-loop: every lane its own PID gain candidate
    n_gains = 2 * n_devices
    gains = C.make_gain_grid(kp_cl=np.linspace(0.1, 2.0, n_gains),
                             ki_cl=[0.02], kp_ph=[-0.8], ki_ph=[-0.05],
                             dtype=f32, device=dev0)
    cl_state = _broadcast(R.make_initial_state(base, dtype=f32,
                                               device=dev0), n_gains, dev0)
    carry = C.make_dual_pid_carry((n_gains,), f32, device=dev0)
    trajs = [C.rollout_closed_loop(
        R.make_params(base, dtype=f32, device=d), st, bc,
        C.dual_pid_controller, g, cc, dt=1.0, substeps=4, n_steps=3,
        record_obs=("chlorine_outlet",))[3]["chlorine_outlet"].to(dev0)
        for d, st, g, cc in zip(devs, PAR.shard_batch(cl_state, mesh),
                                PAR.shard_batch(gains, mesh),
                                PAR.shard_batch(carry, mesh))]
    traj = torch.cat(trajs, dim=1)
    passed("closed-loop", "sharded PID gain sweep",
           traj.shape == (3, n_gains),
           _finite(traj))

    # ekf: a bank of filters sharded over lanes
    n_filt = 2 * n_devices
    zones_e = 4
    e_cfg = R.ReactorConfiguration(volume=1000.0, n_zones=zones_e,
                                   flow_rate=5.0, initial_pH=7.2,
                                   initial_chlorine=2.0, temperature=20.0)
    taps = [("pH", 0), ("chlorine", -1)]
    e_state0 = R.make_initial_state(e_cfg, dtype=f32, device=dev0)
    e_carry = PAR.shard_batch(_broadcast(
        C.make_ekf_carry(e_state0, p0=1.0, n_zones=zones_e), n_filt, dev0),
        mesh)
    e_z = PAR.shard_batch(torch.tensor(
        [7.2, 2.0], dtype=f32, device=dev0).expand(n_filt, 2).clone(), mesh)
    e_bc = R.BoundaryConditions(inlet_flow_rate=5.0)
    e_x = torch.cat([C.make_ekf(
        R.make_params(e_cfg, dtype=f32, device=d), zones_e, taps, dt=1.0,
        substeps=2, measurement_noise=4e-4)(c, z, e_bc)[1].to(dev0)
        for d, c, z in zip(devs, e_carry, e_z)])
    passed("ekf", "sharded EKF filter bank",
           e_x.shape == (n_filt, 3 * zones_e),
           _finite(e_x))

    # enkf: the member axis sharded, gathered for the analysis
    n_mem = 4 * n_devices
    e_params = R.make_params(e_cfg, dtype=f32, device=dev0)
    enkf_step = C.make_enkf(e_params, zones_e, taps, dt=1.0, substeps=2,
                            measurement_noise=4e-4, inflation=1.02,
                            localization_radius=2.0)
    k_carry = C.make_enkf_carry(e_state0, p0=1.0, n_zones=zones_e,
                                n_ensemble=n_mem, generator=0)
    members = PAR.shard_batch(k_carry.ensemble, mesh)
    k_carry = C.EnKFCarry(ensemble=PAR.gather_batch(members, dev0),
                          generator=k_carry.generator)
    k_carry, k_x = enkf_step(k_carry, torch.tensor([7.2, 2.0], dtype=f32,
                                                   device=dev0), e_bc)
    passed("enkf", "member-sharded ensemble Kalman filter",
           k_x.shape == (3 * zones_e,),
           _finite(k_x))

    # surrogate: a trajectory-sharded dataset, Adam on the first device
    n_traj_s = 2 * n_devices
    Xs, Us = SG.make_surrogate_dataset(e_params, zones_e, e_bc, 2,
                                       n_traj_s, 8, dt=1.0, substeps=2)
    Xs = PAR.gather_batch(PAR.shard_batch(Xs, mesh), dev0)
    Us = PAR.gather_batch(PAR.shard_batch(Us, mesh), dev0)
    sp_s, info_s = SG.train_surrogate(Xs, Us, zones_e, seed=3,
                                      hidden=(32,), n_steps=10,
                                      batch_size=32, rollout_steps=0)
    x_pred = SG.surrogate_step(sp_s, Xs[0, 0], Us[0, 0])
    passed("surrogate", "dp-sharded surrogate training",
           x_pred.shape == (3 * zones_e,),
           _finite(x_pred),
           _finite(torch.as_tensor(info_s["one_step_loss"])))
    log("dryrun_multichip done")
    return stages
