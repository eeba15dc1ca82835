"""The port's data-parallel ``parallel/`` modules (``mesh.py``, ``fused.py``,
``multihost.py``) on the CPU.

- On a mesh of two CPU devices, ``shard_batch``/``gather_batch``,
  ``sharded_step``, ``sharded_rollout``, ``sharded_rollout_fused`` and
  ``sharded_plant_rollout_fused`` (``rng="bits"``) give each shard bit for
  bit what the single-device function gives on that shard: no collective
  runs, each block of plants does the arithmetic it does alone. Against
  the whole batch on one device they agree to ``ATOL``, not bit for bit:
  PyTorch's CPU ``pow`` rounds the last bit of a few elements by the
  tensor's length (the derived ``H_concentration`` differs by ~3e-23 after
  six steps), which a CUDA card's elementwise kernels do not.
- Per shard they equal the JAX package's functions on the virtual CPU
  mesh its own tests use (``tests/conftest.py``: 8 devices, the first two
  here): the reactor step and rollout and the fused rollout (B1/B2 in
  interpret mode) in float64 at ``ATOL`` 1e-10, the tolerance of
  ``tests/test_torch_fused_rollout.py``; the fused plant (B3 in interpret
  mode, float32, the same words) at ``tests/test_torch_fused_plant.py``'s
  ``PHYS`` 2e-5 and ``READ`` 1e-4.
- ``rng="philox"``: every shard draws ``seed``'s stream from its first
  plant's index (B3's ``plant0``), so each shard equals its lanes of the
  one-device call bit for bit (the JAX package seeds device k with ``seed
  + k * 1_000_003``); an extension axis is refused before any launch.
- ``multihost``: two processes joined with gloo on the CPU (``torch.
  distributed``, a free localhost port) each step their slice of one global
  batch; every process's slice equals the single-process rollout bit for
  bit (a subprocess run under a 120 s timeout, in the manner of
  ``tests/test_multihost.py``)."""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu import parallel as JP
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL
from ics_wt_physicsengine_tpu.models.monte_carlo import (
    make_monte_carlo_batch as j_batch)
from ics_wt_physicsengine_tpu.ops import fused_plant as JFP
from ics_wt_physicsengine_tpu.ops import fused_rollout as JFR
from ics_wt_physicsengine_tpu.ops.fused_rollout import (_LANES,
                                                        _unpack_state)
from ics_wt_physicsengine_tpu.parallel import fused as JPF

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch import parallel as P
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.models import plant as TPL
from ics_wt_physicsengine_torch.models.monte_carlo import (
    make_monte_carlo_batch as t_batch)
from ics_wt_physicsengine_torch.ops import fused_plant as TFP
from ics_wt_physicsengine_torch.ops import fused_rollout as TFR
from ics_wt_physicsengine_torch.ops import kernel_checks as K
from ics_wt_physicsengine_torch.parallel import mesh as PM

from torch_port_util import to_numpy, tree_to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-10
PHYS, READ = 2e-5, 1e-4
CPU = torch.device("cpu")
F64 = torch.float64
BC = dict(inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
          acid_flow_rate=0.1)


def _mesh():
    return P.make_mesh(devices=[CPU, CPU])


def _batch(n=4, zones=4, seed=2, dtype=F64):
    return t_batch(TR.ReactorConfiguration(n_zones=zones), n, seed=seed,
                   dtype=dtype, device="cpu")


def _bit_equal(a, b):
    d = K.plant_diff(a, b)
    return d["max_abs_err"] == 0.0 and d["nan_equal"] and d["ints_equal"]


def _shard(tree, k, per):
    return PM._map(lambda x: x[k * per:(k + 1) * per] if x.ndim else x,
                   tree)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_and_shard_layout(monkeypatch):
    mesh = _mesh()
    assert mesh.size == 2 and PM.PLANTS_AXIS == "plants"
    params, state = _batch()
    shards = P.shard_batch(state, mesh)
    assert [s.pH.shape for s in shards] == [(2, 4), (2, 4)]
    assert torch.equal(shards[1].pH, state.pH[2:])
    assert _bit_equal(P.gather_batch(shards), state)
    assert P.shard_batch(shards, mesh) is shards
    with pytest.raises(ValueError, match="divide"):
        P.shard_batch(_batch(n=3)[1], mesh)
    assert P.make_mesh(1, devices=[CPU, CPU]).size == 1
    # the default mesh is the visible cards; with none it raises (the CPU
    # only when named)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.make_mesh()


def _close_trees(a, b, atol=ATOL):
    for (path, x), (_, y) in zip(K.tree_leaves(a), K.tree_leaves(b)):
        np.testing.assert_allclose(to_numpy(x), to_numpy(y), rtol=0,
                                   atol=atol, equal_nan=True, err_msg=path)


def test_sharded_step_and_rollout_are_bit_equal_to_one_device():
    mesh = _mesh()
    params, state = _batch()
    bc = TR.BoundaryConditions(**BC)
    steps = P.sharded_step(mesh, 1.0, 4)(params, state, bc)
    states, trajs = P.sharded_rollout(mesh, 1.0, 4, 6, record=True)(
        params, state, bc)
    for k in range(2):
        p, s = _shard(params, k, 2), _shard(state, k, 2)
        assert _bit_equal(steps[k], TR.step(p, s, bc, dt=1.0, substeps=4))
        assert _bit_equal((states[k], trajs[k]), TR.rollout(
            p, s, bc, dt=1.0, substeps=4, n_steps=6, record=True))
    assert trajs[0]["pH"].shape == (6, 2, 4)      # the plant axis second
    ref, ref_traj = TR.rollout(params, state, bc, dt=1.0, substeps=4,
                               n_steps=6, record=True)
    _close_trees(P.gather_batch(states), ref)
    _close_trees(P.gather_batch(trajs, dim=1), ref_traj)


def test_sharded_step_and_rollout_match_jax_per_shard():
    jmesh = JP.make_mesh(2)
    jparams, jstate = j_batch(JR.ReactorConfiguration(n_zones=4), 4, seed=2,
                              dtype=jnp.float64)
    params, state = _batch()
    jbc, bc = JR.BoundaryConditions(**BC), TR.BoundaryConditions(**BC)
    jout = JP.sharded_step(jmesh, dt=1.0, substeps=4)(
        JP.shard_batch(jparams, jmesh), JP.shard_batch(jstate, jmesh), jbc)
    shards = P.sharded_step(_mesh(), 1.0, 4)(params, state, bc)
    jroll, jtraj = JP.sharded_rollout(jmesh, dt=1.0, substeps=4, n_steps=5,
                                      record=True)(
        JP.shard_batch(jparams, jmesh), JP.shard_batch(jstate, jmesh), jbc)
    rolls, trajs = P.sharded_rollout(_mesh(), 1.0, 4, 5, record=True)(
        params, state, bc)
    for k in range(2):
        sl = slice(2 * k, 2 * k + 2)
        for f in ("pH", "chlorine", "temperature"):
            np.testing.assert_allclose(
                to_numpy(getattr(shards[k], f)),
                np.asarray(getattr(jout, f))[sl], rtol=0, atol=ATOL)
            np.testing.assert_allclose(
                to_numpy(getattr(rolls[k], f)),
                np.asarray(getattr(jroll, f))[sl], rtol=0, atol=ATOL)
        np.testing.assert_allclose(to_numpy(trajs[k]["pH"]),
                                   np.asarray(jtraj["pH"])[:, sl], rtol=0,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# the fused kernels over the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduled", [False, True])
def test_sharded_rollout_fused_is_bit_equal_and_matches_jax(scheduled):
    params, state = _batch()
    if scheduled:
        bc = K.bench_schedule(10)
        run = TFR.rollout_scheduled_fused
        ref = run(params, state, bc, dt=1.0, substeps=4, record_every=5)
    else:
        bc = TR.BoundaryConditions(**BC)
        run = TFR.rollout_fused
        ref = run(params, state, bc, dt=1.0, substeps=4, n_steps=10,
                  record_every=5)
    states, trajs = P.sharded_rollout_fused(
        _mesh(), dt=1.0, substeps=4, n_steps=10, record_every=5)(
        params, state, bc)
    for k in range(2):
        p, s = _shard(params, k, 2), _shard(state, k, 2)
        one = run(p, s, bc, dt=1.0, substeps=4, record_every=5) \
            if scheduled else run(p, s, bc, dt=1.0, substeps=4, n_steps=10,
                                  record_every=5)
        assert _bit_equal((states[k], trajs[k]), one)
    _close_trees(P.gather_batch(states), ref[0])
    _close_trees(P.gather_batch(list(trajs), dim=1), ref[1])

    jmesh = JP.make_mesh(2)
    jparams, jstate = j_batch(JR.ReactorConfiguration(n_zones=4), 4, seed=2,
                              dtype=jnp.float64)
    jbc = JR.BoundaryConditions(**{f.name: getattr(bc, f.name)
                                   for f in dataclasses.fields(bc)})
    if scheduled:
        # the JAX sharded wrapper takes constant forcing only; its shards'
        # counterpart is the single-device scheduled kernel
        jout = [JFR.rollout_scheduled_fused(
            _jshard(jparams, k), _jshard(jstate, k), jbc, dt=1.0,
            substeps=4, interpret=True) for k in range(2)]
    else:
        whole = JPF.sharded_rollout_fused(jmesh, dt=1.0, substeps=4,
                                          n_steps=10)(
            JP.shard_batch(jparams, jmesh), JP.shard_batch(jstate, jmesh),
            jbc)
        jout = [_jshard(whole, k) for k in range(2)]
    for k in range(2):
        for f in ("pH", "chlorine", "temperature"):
            np.testing.assert_allclose(
                to_numpy(getattr(states[k], f)),
                np.asarray(getattr(jout[k], f)), rtol=0, atol=ATOL)


def _jshard(tree, k, per=2):
    return jax.tree_util.tree_map(
        lambda x: x[k * per:(k + 1) * per] if np.ndim(x) else x, tree)


def _jax_words(planes, batch, n_zones):
    """``[n_steps, 76, B]``: the words the JAX kernel reads on each plant's
    zone-0 lane from a ``[n_steps, 76, 8, 128]`` plane."""
    per_row = _LANES // n_zones
    unpack = jax.vmap(jax.vmap(
        lambda plane: _unpack_state(plane, batch, n_zones, per_row)[:, 0]))
    return torch.from_numpy(np.array(unpack(jnp.asarray(planes))))


def test_sharded_plant_rollout_fused_bits_is_bit_equal_and_matches_jax():
    n_zones, per, steps = 4, 2, 6
    cfg = JR.ReactorConfiguration(n_zones=n_zones)
    jparams, jplant = JPL.make_plant_batch(cfg, 2 * per, seed=4,
                                           dtype=jnp.float32)
    params = convert.plant_params_from_numpy(
        tree_to_numpy(jparams), dtype=torch.float32, device="cpu")
    plant = convert.plant_state_from_numpy(
        tree_to_numpy(jplant), dtype=torch.float32, device="cpu")
    planes = np.random.default_rng(3).integers(
        -2 ** 31, 2 ** 31, size=(steps, JFP.N_WORDS, 8, _LANES),
        dtype=np.int32)
    words = _jax_words(planes, per, n_zones)
    bc = TR.BoundaryConditions(**BC)
    fn = P.sharded_plant_rollout_fused(_mesh(), params, dt=1.0, substeps=4,
                                       n_steps=steps, rng="bits", bits=words)
    plants, readings = fn(params, plant, bc)
    jfn = JPF.sharded_plant_rollout_fused(JP.make_mesh(2), jparams, dt=1.0,
                                          substeps=4, n_steps=steps,
                                          rng="bits", bits=planes)
    jmesh = JP.make_mesh(2)
    jout, jread = jfn(JP.shard_batch(jparams, jmesh),
                      JP.shard_batch(jplant, jmesh), JR.BoundaryConditions(
                          **BC))
    for k in range(2):
        ref = TFP.plant_rollout_fused(_shard(params, k, per),
                                      _shard(plant, k, per), bc, dt=1.0,
                                      substeps=4, n_steps=steps, rng="bits",
                                      bits=words)
        assert _bit_equal((plants[k], readings[k]), ref)
        sl = slice(k * per, (k + 1) * per)
        for f in ("pH", "chlorine", "temperature"):
            np.testing.assert_allclose(
                to_numpy(getattr(plants[k].reactor, f)),
                np.asarray(getattr(jout.reactor, f))[sl], rtol=0, atol=PHYS)
        for name in readings[k]:
            assert readings[k][name].shape == (steps, per)
            np.testing.assert_allclose(
                to_numpy(readings[k][name]), np.asarray(jread[name])[:, sl],
                rtol=0, atol=READ, equal_nan=True, err_msg=name)


def test_sharded_plant_philox_seeds_each_device_and_refuses_extensions():
    params, plant = K.plant_case(4, 4, torch.float32, CPU)
    bc = K.BC
    plants, readings = P.sharded_plant_rollout_fused(
        _mesh(), params, dt=1.0, substeps=2, n_steps=5, seed=9)(
        params, plant, bc)
    whole, rw = TFP.plant_rollout_fused(params, plant, bc, dt=1.0,
                                        substeps=2, n_steps=5, seed=9)
    for k in range(2):
        lanes = slice(2 * k, 2 * k + 2)
        ref = (_shard(whole, k, 2),
               {name: v[:, lanes] for name, v in rw.items()})
        assert _bit_equal((plants[k], readings[k]), ref)
    xcfg = TR.ReactorConfiguration(n_zones=3, enable_gas=True)
    xp, _ = TPL.make_plant_batch(xcfg, 2, device="cpu")
    with pytest.raises(ValueError, match="extensions"):
        P.sharded_plant_rollout_fused(_mesh(), xp, dt=1.0, substeps=2,
                                      n_steps=5)
    with pytest.raises(ValueError, match="rng"):
        P.sharded_plant_rollout_fused(_mesh(), params, dt=1.0, substeps=2,
                                      n_steps=5, rng="bits")


# ---------------------------------------------------------------------------
# multihost: two gloo processes on the CPU
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from ics_wt_physicsengine_torch import parallel as P
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.models.monte_carlo import (
        make_monte_carlo_batch)

    torch.set_num_threads(1)
    addr, rank = sys.argv[1], int(sys.argv[2])
    P.initialize_multihost(addr, 2, rank, device="cpu")
    assert (dist.get_backend(), dist.get_world_size()) == ("gloo", 2)
    cfg = R.ReactorConfiguration(n_zones=4)
    params, state = make_monte_carlo_batch(cfg, 8, seed=5,
                                           dtype=torch.float64, device="cpu")
    host = lambda t: P.mesh._map(lambda x: x.numpy(), t)   # noqa: E731
    mesh = P.make_mesh(devices=[torch.device("cpu")])
    sl = P.local_plant_slice(8)
    assert sl == slice(4 * rank, 4 * rank + 4)
    (p,) = P.shard_batch_multihost(host(params), mesh)
    (s,) = P.shard_batch_multihost(host(state), mesh)
    bc = R.BoundaryConditions(acid_flow_rate=0.1)
    (out,), _ = P.sharded_rollout(mesh, 1.0, 4, 12)(p, s, bc)
    ref, _ = R.rollout(params, state, bc, dt=1.0, substeps=4, n_steps=12,
                       record=False)
    gathered = [torch.empty_like(out.pH) for _ in range(2)]
    dist.all_gather(gathered, out.pH)
    assert torch.equal(torch.cat(gathered), ref.pH)
    assert torch.equal(out.chlorine, ref.chlorine[sl])
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} OK")
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_gloo_processes_match_one_process(tmp_path):
    assert torch.distributed.is_gloo_available()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), addr, str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"rank {r} OK" in out


def test_local_plant_slice_without_a_process_group():
    assert P.local_plant_slice(6) == slice(0, 6)
    (tree,) = P.shard_batch_multihost({"x": np.arange(6.0)},
                                      P.make_mesh(devices=[CPU]))
    assert torch.equal(tree["x"], torch.arange(6.0, dtype=torch.float64))
