"""The port's zone-sharded step (``parallel/spatial.py``), the reactor hooks
it rests on (``derivatives``' inlet/outlet masks, ``step``'s ``deriv_fn``
and ``uv_mask``) and ``entry.dryrun_multichip``, on the CPU in float64.

- The cases follow the JAX package's ``tests/test_spatial_parallel.py``:
  RK4 and RKC, 1, 2, 4 and 8 zone shards, batched plants, the 2-D (plants x
  zones) mesh, and the particle, gas, nitrogen, disinfection and biofilm
  axes (and the phase axis with all five). The inputs are the JAX
  package's states, graded along the column by NumPy draws from a seed so
  that stratification and every stencil term act, copied into the port.
- The port's zone-sharded trajectory matches the JAX package's
  ``zone_sharded_*`` on its 8-device virtual CPU mesh (``tests/
  conftest.py``) within ``JAX_ATOL`` 1e-10, and the port's own unsharded
  ``core.reactor.step`` within ``SELF_ATOL`` 1e-12 (PyTorch's CPU ``pow``
  rounds the last bit by tensor length, so a 4-zone shard and the
  16-zone column need not agree to the bit). A zone mesh lists the CPU
  once per shard.
- With the default layout, the masked ``derivatives`` equals the unmasked
  one within 1e-15 (the masks add the same terms in another order); a
  custom ``deriv_fn`` equal to the built-in evaluation gives ``step``'s
  result bit for bit, and one not declared capable of an enabled axis is
  refused.
- ``dryrun_multichip`` runs every stage on meshes of 2 and 4 CPU shards."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu import parallel as JP
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models.monte_carlo import (
    make_monte_carlo_batch as j_batch)

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch import parallel as P
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.entry import dryrun_multichip

from torch_port_util import to_numpy, tree_to_numpy

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
JAX_ATOL = 1e-10
SELF_ATOL = 1e-12
Z = 16
CFG = dict(volume=1000, height=2.0, diameter=0.798, n_zones=Z,
           flow_rate=5.0, initial_pH=7.2, initial_chlorine=2.0,
           temperature=20.0)
BC = dict(inlet_flow_rate=5.0, inlet_pH=7.5, inlet_chlorine=0.4,
          acid_flow_rate=0.2, chlorine_flow_rate=0.1,
          inlet_temperature=26.0, ambient_temperature=10.0,
          heat_loss_coefficient=50.0)
# axis -> (configuration fields, boundary, the sharded step's flags)
AXES = {
    "base": ({}, BC, {}),
    "particles": (
        dict(enable_particles=True, initial_tss=25.0),
        dict(inlet_flow_rate=5.0, inlet_pH=7.5, inlet_chlorine=0.4,
             inlet_temperature=26.0, inlet_tss=40.0, coagulant_dose=20.0,
             filter_flow_rate=2.0, sludge_blowdown=1e-5),
        dict(particles=True)),
    "gas": (
        dict(enable_gas=True, initial_oxygen=5.0,
             gas_params={"kl_surface": 2e-4}),
        dict(inlet_flow_rate=5.0, inlet_pH=7.5, inlet_oxygen=7.0,
             aeration_kla=1e-3, inlet_temperature=22.0),
        dict(gas=True)),
    "disinfection": (
        dict(enable_disinfection=True, initial_pathogens=1e4,
             initial_toc=3.0),
        dict(inlet_flow_rate=5.0, inlet_pH=7.5, inlet_chlorine=0.5,
             inlet_pathogens=5e4, inlet_toc=4.0, uv_intensity=3.0),
        dict(disinfection=True)),
    "nitrogen+biofilm": (
        dict(enable_nitrogen=True, initial_ammonia=1.0, enable_biofilm=True,
             initial_bacteria=1e-3, initial_bdoc=0.5),
        dict(BC, inlet_ammonia=1.0, inlet_bacteria=1e-3, inlet_bdoc=0.5),
        dict(nitrogen=True, biofilm=True)),
    "full": (
        dict(enable_nitrogen=True, initial_ammonia=1.0, enable_gas=True,
             enable_particles=True, initial_tss=20.0,
             enable_disinfection=True, initial_pathogens=1e4,
             enable_biofilm=True, initial_bacteria=1e-3, initial_bdoc=0.5,
             enable_phase=True),
        dict(aeration_kla=1e-3, coagulant_dose=10.0, inlet_tss=20.0,
             inlet_ammonia=1.0, inlet_pathogens=1e4, uv_intensity=10.0,
             inlet_bacteria=1e-3, inlet_bdoc=0.5, ambient_temperature=2.0,
             ambient_humidity=0.4, wind_speed=3.0,
             heat_loss_coefficient=100.0),
        dict(nitrogen=True, gas=True, particles=True, disinfection=True,
             biofilm=True)),
}
# the ReactorState fields compared (the derived ones follow from these)
FIELDS = ("pH", "chlorine", "temperature", "ammonia", "nitrite", "nitrate",
          "chloramine", "oxygen", "carbonate", "tss", "sludge", "pathogens",
          "ct", "age", "toc", "thm", "bacteria", "bdoc", "biofilm")


def _graded(js, seed):
    """The JAX state graded along the column, with NumPy draws on top."""
    rng = np.random.default_rng(seed)
    z = js.pH.shape[-1]
    ramp = np.linspace(0.0, 1.0, z)

    def jitter(scale):
        return rng.uniform(-scale, scale, js.pH.shape)

    out = dict(pH=js.pH + 0.3 * ramp + jitter(0.02),
               chlorine=js.chlorine + 0.5 * ramp + jitter(0.05),
               temperature=js.temperature + 5.0 * ramp + jitter(0.2))
    if js.tss is not None:
        out["tss"] = js.tss * (1.0 + ramp)
    return JR._update_derived(dataclasses.replace(js, **out))


def _case(axis, batch=None, seed=0):
    """``(jax params, state, boundary), (port params, state, boundary),
    flags`` for an axis of ``AXES``, one plant or a Monte-Carlo batch."""
    cfg_kw, bc_kw, flags = AXES[axis]
    cfg = JR.ReactorConfiguration(**CFG, **cfg_kw)
    if batch is None:
        jp = JR.make_params(cfg, dtype=jnp.float64)
        js = JR.make_initial_state(cfg, dtype=jnp.float64)
    else:
        jp, js = j_batch(cfg, batch, seed=seed + 3, dtype=jnp.float64)
    js = _graded(js, seed)
    tp = convert.params_from_numpy(tree_to_numpy(jp), dtype=F64, device=CPU)
    ts = convert.state_from_numpy(tree_to_numpy(js), dtype=F64, device=CPU)
    return ((jp, js, JR.BoundaryConditions(**bc_kw)),
            (tp, ts, TR.BoundaryConditions(**bc_kw)), flags)


def _zone_mesh(n):
    return P.make_zone_mesh(devices=[CPU] * n)


def _compare(port, ref, atol, what):
    compared = 0
    for f in FIELDS:
        a = getattr(port, f)
        if a is None:
            continue
        np.testing.assert_allclose(to_numpy(a), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=atol, err_msg=f"{what}: {f}")
        compared += 1
    assert compared >= 3


def _unsharded(tp, ts, tbc, n_steps, substeps, stages=None):
    for _ in range(n_steps):
        ts = TR.step(tp, ts, tbc, dt=1.0, substeps=substeps, stages=stages)
    return ts


# ---------------------------------------------------------------------------
# the 1-D zone mesh: step and rollout
# ---------------------------------------------------------------------------

STEP_CASES = {
    # name: (axis, shards, batch, RKC, steps)
    "base-1": ("base", 1, None, False, 3),
    "base-2": ("base", 2, None, False, 3),
    "base-4": ("base", 4, None, False, 3),
    "base-8": ("base", 8, None, False, 3),
    "base-4-batched": ("base", 4, 2, False, 2),
    "base-8-rkc": ("base", 8, None, True, 3),
    "particles-8": ("particles", 8, None, False, 3),
    "gas-8": ("gas", 8, None, False, 3),
    "disinfection-8": ("disinfection", 8, None, False, 3),
    "nitrogen+biofilm-4": ("nitrogen+biofilm", 4, None, False, 3),
    "full-4-batched": ("full", 4, 2, False, 2),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_zone_sharded_step_matches_jax_and_the_unsharded_step(name):
    axis, shards, batch, rkc, n_steps = STEP_CASES[name]
    (jp, js, jbc), (tp, ts, tbc), flags = _case(axis, batch)
    cfg = TR.ReactorConfiguration(**CFG)
    m, s = TR.default_rkc_plan(cfg, 1.0, mode="fast") if rkc else (4, None)
    ndim = 1 if batch is None else 2

    fn = P.zone_sharded_step(_zone_mesh(shards), Z, 1.0, m, state_ndim=ndim,
                             stages=s, **flags)
    st = P.shard_state_zones(ts, _zone_mesh(shards))
    assert [x.pH.shape[-1] for x in st] == [Z // shards] * shards
    for _ in range(n_steps):
        st = fn(tp, st, tbc)
    got = P.gather_zones(st)

    jmesh = JP.make_zone_mesh(shards)
    jfn = JP.zone_sharded_step(jmesh, Z, 1.0, m, state_ndim=ndim, stages=s,
                               **flags)
    jst = JP.shard_state_zones(js, jmesh)
    for _ in range(n_steps):
        jst = jfn(jp, jst, jbc)

    _compare(got, jst, JAX_ATOL, "against JAX")
    _compare(got, _unsharded(tp, ts, tbc, n_steps, m, s),
             SELF_ATOL, "against the unsharded step")
    np.testing.assert_allclose(to_numpy(got.time), n_steps * 1.0)


ROLLOUT_CASES = {
    "base-8": ("base", 8, None, 5),
    "base-4-rkc": ("base", 4, True, 5),
    "particles-4": ("particles", 4, None, 4),
    "disinfection-8": ("disinfection", 8, None, 4),
}


@pytest.mark.parametrize("name", list(ROLLOUT_CASES))
def test_zone_sharded_rollout_matches_jax_and_the_unsharded_rollout(name):
    axis, shards, rkc, n_steps = ROLLOUT_CASES[name]
    (jp, js, jbc), (tp, ts, tbc), flags = _case(axis, seed=1)
    cfg = TR.ReactorConfiguration(**CFG)
    m, s = TR.default_rkc_plan(cfg, 1.0, mode="fast") if rkc else (4, None)
    roll = P.zone_sharded_rollout(_zone_mesh(shards), Z, 1.0, m, n_steps,
                                  stages=s, **flags)
    got = P.gather_zones(roll(tp, ts, tbc))       # a whole state in
    jmesh = JP.make_zone_mesh(shards)
    jroll = JP.zone_sharded_rollout(jmesh, Z, 1.0, m, n_steps, stages=s,
                                    **flags)
    ref = jroll(jp, JP.shard_state_zones(js, jmesh), jbc)
    _compare(got, ref, JAX_ATOL, "against JAX")
    want, _ = TR.rollout(tp, ts, tbc, dt=1.0, substeps=m, n_steps=n_steps,
                         record=False, stages=s)
    _compare(got, want, SELF_ATOL, "against the unsharded rollout")


# ---------------------------------------------------------------------------
# the 2-D (plants x zones) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["base", "particles", "disinfection"])
def test_plant_zone_mesh_matches_jax_and_the_unsharded_step(axis):
    (jp, js, jbc), (tp, ts, tbc), flags = _case(axis, batch=4, seed=2)
    mesh = P.make_plant_zone_mesh(2, 4, devices=[CPU] * 8)
    assert mesh.shape == {"plants": 2, "zone": 4}
    fn = P.plant_zone_sharded_step(mesh, Z, 1.0, 4, params_example=tp,
                                   **flags)
    rows = fn(P.shard_batch_zones(tp, mesh), P.shard_batch_zones(ts, mesh),
              tbc)
    assert len(rows) == 2 and all(len(r) == 4 for r in rows)
    assert rows[1][3].pH.shape == (2, Z // 4)
    if ts.sludge is not None:      # split over plants only
        assert rows[1][3].sludge.shape == ts.sludge[2:].shape
    rows = fn(tp, rows, tbc)        # whole params: split over plants here
    got = P.gather_zones(rows)

    jmesh = JP.make_plant_zone_mesh(2, 4)
    jfn = JP.plant_zone_sharded_step(jmesh, Z, 1.0, 4, params_example=jp,
                                     **flags)
    jout = jfn(JP.shard_batch_zones(jp, jmesh),
               JP.shard_batch_zones(js, jmesh), jbc)
    jout = jfn(JP.shard_batch_zones(jp, jmesh), jout, jbc)
    _compare(got, jout, JAX_ATOL, "against JAX")
    _compare(got, _unsharded(tp, ts, tbc, 2, 4), SELF_ATOL,
             "against the unsharded step")


def test_shard_batch_zones_splits_class_leaves_over_plants_only():
    _, (tp, ts, _), _ = _case("full", batch=4, seed=3)
    mesh = P.make_plant_zone_mesh(2, 2, devices=[CPU] * 4)
    prow, srow = P.shard_batch_zones(tp, mesh), P.shard_batch_zones(ts, mesh)
    p11, s11 = prow[1][1], srow[1][1]
    assert torch.equal(s11.pH, ts.pH[2:, 8:])
    assert torch.equal(s11.tss, ts.tss[2:, :, 8:])
    assert torch.equal(s11.sludge, ts.sludge[2:])
    assert torch.equal(s11.time, ts.time[2:])
    assert torch.equal(p11.particles.filter_eff, tp.particles.filter_eff[2:])
    assert torch.equal(p11.disinfection.k_cl, tp.disinfection.k_cl[2:])
    assert torch.equal(p11.k_exchange, tp.k_exchange[2:])
    assert torch.equal(P.gather_zones(srow).tss, ts.tss)


# ---------------------------------------------------------------------------
# refusals and layout
# ---------------------------------------------------------------------------

def test_refusals():
    mesh = _zone_mesh(8)
    for make in (lambda: P.zone_sharded_step(mesh, 20, 1.0, 2),
                 lambda: P.zone_sharded_rollout(mesh, 20, 1.0, 2, 3),
                 lambda: P.plant_zone_sharded_step(
                     P.make_plant_zone_mesh(1, 3, devices=[CPU] * 3), 16,
                     1.0, 2)):
        with pytest.raises(ValueError, match="not divisible"):
            make()
    with pytest.raises(ValueError, match="need 16 devices"):
        P.make_plant_zone_mesh(4, 4, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="1-D mesh"):
        P.zone_sharded_step(P.make_plant_zone_mesh(2, 2, devices=[CPU] * 4),
                            16, 1.0, 2)
    _, (tp, ts, tbc), _ = _case("nitrogen+biofilm")
    with pytest.raises(ValueError, match="not declared nitrogen-capable"):
        P.zone_sharded_step(_zone_mesh(2), Z, 1.0, 2)(tp, ts, tbc)
    with pytest.raises(ValueError, match="rank 2"):
        P.zone_sharded_step(_zone_mesh(2), Z, 1.0, 2, state_ndim=2,
                            nitrogen=True, biofilm=True)(tp, ts, tbc)


def test_zone_mesh_layout_and_default_devices(monkeypatch):
    mesh = P.make_zone_mesh(2, devices=[CPU] * 4)
    assert mesh.shape == {"zone": 2} and mesh.devices == (CPU, CPU)
    _, (_, ts, _), _ = _case("particles")
    shards = P.shard_state_zones(ts, _zone_mesh(4))
    assert torch.equal(shards[2].tss, ts.tss[..., 8:12])
    assert torch.equal(shards[3].sludge, ts.sludge)
    assert all(torch.equal(getattr(P.gather_zones(shards), f),
                           getattr(ts, f)) for f in ("pH", "tss", "density"))
    with pytest.raises(ValueError, match="not divisible"):
        P.shard_state_zones(ts, _zone_mesh(3))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.make_zone_mesh()


# ---------------------------------------------------------------------------
# the reactor hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["base", "full"])
def test_masked_derivatives_match_the_default_layout_and_jax(axis):
    (jp, js, jbc), (tp, ts, tbc), _ = _case(axis, batch=2, seed=4)
    y, spans = TR.species_layout(tp, ts)
    kw = {a: y[sl] for a, sl in spans.items()}
    pos = torch.arange(Z)
    inlet = (pos == 0).to(F64)
    outlet = (pos == Z - 1).to(F64)
    plain = TR.derivatives(tp, y[0], y[1], y[2], tbc, **kw)
    masked = TR.derivatives(tp, y[0], y[1], y[2], tbc, inlet_mask=inlet,
                            outlet_mask=outlet, **kw)
    jkw = {a: tuple(getattr(js, n) for n in TR.EXTENSION_STATE[a])
           for a in spans}
    jmasked = JR.derivatives(jp, js.pH, js.chlorine, js.temperature, jbc,
                             inlet_mask=jnp.asarray(to_numpy(inlet)),
                             outlet_mask=jnp.asarray(to_numpy(outlet)),
                             **jkw)
    assert len(plain) == len(masked) == len(jmasked) == len(y)
    for a, b, c in zip(plain, masked, jmasked):
        np.testing.assert_allclose(to_numpy(b), to_numpy(a), rtol=1e-15,
                                   atol=1e-15)
        np.testing.assert_allclose(to_numpy(b), np.asarray(c), rtol=1e-13,
                                   atol=JAX_ATOL)


def test_step_takes_a_declared_deriv_fn_and_a_uv_mask():
    _, (tp, ts, tbc), _ = _case("full", seed=5)
    y, spans = TR.species_layout(tp, ts)

    def deriv(y):
        return TR.derivatives(tp, y[0], y[1], y[2], tbc,
                              **{a: y[sl] for a, sl in spans.items()})

    flags = {f"deriv_fn_{a}": True for a in spans}
    last = torch.zeros(Z, dtype=F64)
    last[-1] = 1.0
    ref = TR.step(tp, ts, tbc, dt=1.0, substeps=2)
    got = TR.step(tp, ts, tbc, dt=1.0, substeps=2, deriv_fn=deriv,
                  uv_mask=last, **flags)
    for f in FIELDS + ("H_concentration", "density"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    # the UV bank moved to zone 0: the outlet's pathogens escape it
    first = torch.flip(last, [0])
    moved = TR.step(tp, ts, tbc, dt=1.0, substeps=2, uv_mask=first)
    assert bool(torch.all(moved.pathogens[:, -1] > ref.pathogens[:, -1]))
    assert bool(torch.all(moved.pathogens[:, 0] < ref.pathogens[:, 0]))
    flags["deriv_fn_gas"] = False
    with pytest.raises(ValueError, match="not declared gas-capable"):
        TR.step(tp, ts, tbc, dt=1.0, substeps=2, deriv_fn=deriv, **flags)


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_runs_every_stage_on_cpu_shards(n):
    lines = []
    stages = dryrun_multichip(n, devices=[CPU] * n, log=lines.append)
    want = ["dp", "sp", "sp-particles", "fused", "fleet", "extensions",
            "serve", "dpxsp", "closed-loop", "ekf", "enkf", "surrogate"]
    if n == 2:
        want.remove("dpxsp")
    assert stages == want
    assert lines[-1] == "dryrun_multichip done"
    with pytest.raises(ValueError, match="n_devices"):
        dryrun_multichip(n + 1, devices=[CPU] * n, log=lines.append)
