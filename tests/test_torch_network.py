"""The port's reactor network (``core/network.py``) against the JAX
package's, on the CPU in float64.

The same topologies, configurations and seeded boundaries go into both:
the topology's checks and their messages; ``make_network``'s stacked
parameters and initial state (bit-equal: both stack the same NumPy
values); one ``network_step``; ``rollout_network`` and
``rollout_network_scheduled`` over a recirculating three-stage train; a
network with all six extension axes, whose per-class routing (the blended
``inlet_tss_classes`` and ``inlet_pathogen_classes``) is checked; and a
batch of network realizations (a leading axis in the port) against
``jax.vmap``. Tolerance: atol 1e-10 + rtol 1e-10 on every field (float64
rounding over at most 10 steps; the packages evaluate ``exp``/``pow`` with
different libraries).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import network as JN
from ics_wt_physicsengine_tpu.core import reactor as JR

from ics_wt_physicsengine_torch import core as tcore
from ics_wt_physicsengine_torch.core import network as TN
from ics_wt_physicsengine_torch.core import reactor as TR

from torch_port_util import assert_tree_close, to_numpy

torch.set_num_threads(1)

ATOL = RTOL = 1e-10
F64 = torch.float64

# three stages, 15% clearwell recycle, delays 2 and 5
#            from:  0     1     2
TRAIN_W = np.array([[0.0, 0.0, 0.0],
                    [1.0, 0.0, 0.15],
                    [0.0, 1.0, 0.0]])
TRAIN_D = np.array([[1, 1, 1], [2, 1, 5], [1, 5, 1]])
BC = dict(inlet_pH=7.6, inlet_chlorine=0.05, inlet_temperature=18.0,
          chlorine_concentration=50.0)
FULL = dict(enable_nitrogen=True, enable_gas=True, enable_particles=True,
            enable_disinfection=True, enable_biofilm=True, enable_phase=True,
            initial_ammonia=1.0, initial_tss=20.0, initial_pathogens=1e4,
            initial_bacteria=1e-3, initial_bdoc=0.5)
FULL_BC = dict(inlet_ammonia=1.0, aeration_kla=1e-3, inlet_tss=20.0,
               coagulant_dose=20.0, filter_flow_rate=10.0,
               sludge_blowdown=1e-5, inlet_pathogens=1e4, uv_intensity=10.0,
               inlet_bacteria=1e-3, inlet_bdoc=0.5, ambient_temperature=2.0,
               ambient_humidity=0.4, wind_speed=3.0,
               heat_loss_coefficient=100.0)


def _close(port, ref, what=""):
    np.testing.assert_allclose(to_numpy(port), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _state_close(port, ref):
    _close(port.ring, ref.ring, "ring")
    np.testing.assert_array_equal(to_numpy(port.ring_index),
                                  np.asarray(ref.ring_index))
    for f in dataclasses.fields(port.reactor):
        a, b = getattr(port.reactor, f.name), getattr(ref.reactor, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            _close(a, b, f.name)


def _configs(mod, n_zones=4, **extra):
    """The treatment train's three stages: volumes 800, 4000 and 2500 L
    on the 0.798 m tank, with their heights."""
    def cfg(volume):
        height = volume / 1000.0 / (np.pi * (0.798 / 2) ** 2)
        return mod.ReactorConfiguration(n_zones=n_zones, volume=volume,
                                        height=height, initial_chlorine=0.2,
                                        **extra)
    return [cfg(800.0), cfg(4000.0), cfg(2500.0)]


def _pair(n_zones=4, **extra):
    """(port params, port state, port topology arrays, JAX params, JAX
    state, JAX topology arrays) of the three-stage train."""
    jt = JN.NetworkTopology(routing=TRAIN_W, delay_steps=TRAIN_D)
    tt = TN.NetworkTopology(routing=TRAIN_W, delay_steps=TRAIN_D)
    jp, js = JN.make_network(_configs(JR, n_zones, **extra), jt,
                             dtype=jnp.float64)
    tp, ts = TN.make_network(_configs(TR, n_zones, **extra), tt, dtype=F64,
                             device="cpu")
    return (tp, ts, TN.topology_arrays(tt, F64, "cpu"), jp, js,
            JN.topology_arrays(jt, jnp.float64))


def _boundaries(seed, **extra):
    """Seeded per-plant boundaries: (port, JAX)."""
    rng = np.random.default_rng(seed)
    kw = dict(BC, **extra,
              inlet_flow_rate=np.array([8.0, 0.0, 0.0])
              * rng.uniform(0.8, 1.2),
              chlorine_flow_rate=np.array([0.25, 0.0, 0.1])
              * rng.uniform(0.8, 1.2, 3),
              acid_flow_rate=np.array([0.05, 0.0, 0.0]))
    return (TR.BoundaryConditions(**{k: (torch.from_numpy(v)
                                         if isinstance(v, np.ndarray) else v)
                                     for k, v in kw.items()}),
            JR.BoundaryConditions(**{k: (jnp.asarray(v)
                                         if isinstance(v, np.ndarray) else v)
                                     for k, v in kw.items()}))


def test_topology_checks_match_jax():
    for routing, delays in (
            (np.zeros((2, 3)), 1),                            # not square
            (np.array([[0.0, -0.1], [0.5, 0.0]]), 1),         # < 0
            (np.array([[0.0, 0.0], [1.2, 0.0]]), 1),          # > 1
            (np.array([[0.0, 0.7], [0.0, 0.0]]),
             np.array([[1, 0], [1, 1]])),                     # delay 0
            (np.array([[0.6, 0.0], [0.7, 0.0]]), 1),          # > 100% out
            (np.array([[0.0, 1.0], [1.0, 0.0]]), 1),          # radius 1
            (np.array([[1.0 - 1e-12, 0.0], [0.0, 0.0]]), 1)):
        with pytest.raises(ValueError) as got:
            TN.NetworkTopology(routing=routing, delay_steps=delays)
        with pytest.raises(ValueError) as want:
            JN.NetworkTopology(routing=routing, delay_steps=delays)
        assert str(got.value) == str(want.value)
    tt = TN.NetworkTopology(routing=TRAIN_W, delay_steps=TRAIN_D)
    jt = JN.NetworkTopology(routing=TRAIN_W, delay_steps=TRAIN_D)
    np.testing.assert_array_equal(tt.delay_steps, jt.delay_steps)
    np.testing.assert_array_equal(tt.resolvent(), jt.resolvent())
    assert (tt.n_plants, tt.max_delay) == (jt.n_plants, jt.max_delay) \
        == (3, 5)
    with pytest.raises(ValueError, match="configs for 3 plants"):
        TN.make_network(_configs(TR)[:2], tt, dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="share n_zones"):
        TN.make_network(_configs(TR)[:2] + _configs(TR, 5)[:1], tt,
                        dtype=F64, device="cpu")
    mixed = _configs(TR)
    mixed[1] = dataclasses.replace(mixed[1], enable_gas=True)
    with pytest.raises(ValueError, match="enable_gas must match"):
        TN.make_network(mixed, tt, dtype=F64, device="cpu")
    for name in ("NetworkState", "NetworkTopology", "make_network",
                 "network_step", "rollout_network",
                 "rollout_network_scheduled", "topology_arrays"):
        assert getattr(tcore, name) is getattr(TN, name)


def test_make_network_and_one_step_match_jax():
    tp, ts, ta, jp, js, ja = _pair()
    assert_tree_close(tp, jp)                  # bit-equal stacked params
    _state_close(ts, js)
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    tb, jb = _boundaries(1)
    _state_close(TN.network_step(tp, ta, ts, tb, 5.0, 8),
                 JN.network_step(jp, ja, js, jb, 5.0, 8))


@pytest.mark.parametrize("stages", [None, 3])
def test_rollout_network_matches_jax(stages):
    tp, ts, ta, jp, js, ja = _pair()
    tb, jb = _boundaries(2)
    m = 8 if stages is None else 2
    tf, tt = TN.rollout_network(tp, ta, ts, tb, 5.0, m, 10, stages=stages)
    jf, jt = jax.jit(functools.partial(
        JN.rollout_network, dt=5.0, substeps=m, n_steps=10,
        stages=stages))(jp, ja, js, jb)
    _state_close(tf, jf)
    for key in jt:
        _close(tt[key], jt[key], key)
    tf, none = TN.rollout_network(tp, ta, ts, tb, 5.0, m, 2, record=False,
                                  stages=stages)
    assert none is None and int(tf.ring_index) == 2


def test_rollout_network_scheduled_matches_jax():
    tp, ts, ta, jp, js, ja = _pair()
    rng = np.random.default_rng(3)
    booster = rng.uniform(0.0, 0.4, 10)
    inflow = rng.uniform(6.0, 10.0, 10)
    base = dict(BC, acid_flow_rate=np.tile([0.05, 0.0, 0.0], (10, 1)),
                chlorine_flow_rate=np.stack([np.array([0.25, 0.0, b])
                                             for b in booster]),
                inlet_flow_rate=np.stack([np.array([q, 0.0, 0.0])
                                          for q in inflow]),
                inlet_temperature=np.linspace(18.0, 21.0, 10))
    tsched = TR.BoundaryConditions(**base)
    jsched = JR.BoundaryConditions(**{k: (jnp.asarray(v) if isinstance(
        v, np.ndarray) else v) for k, v in base.items()})
    tf, tt = TN.rollout_network_scheduled(tp, ta, ts, tsched, 5.0, 8)
    jf, jt = jax.jit(functools.partial(
        JN.rollout_network_scheduled, dt=5.0, substeps=8))(jp, ja, js,
                                                             jsched)
    _state_close(tf, jf)
    for key in jt:
        _close(tt[key], jt[key], key)
    with pytest.raises(ValueError, match="inconsistent schedule lengths"):
        TN.rollout_network_scheduled(tp, ta, ts, TR.BoundaryConditions(
            inlet_flow_rate=np.ones(4), inlet_pH=np.full(6, 7.0)), 5.0, 8)


def test_all_six_axes_route_class_resolved_like_jax():
    tp, ts, ta, jp, js, ja = _pair(n_zones=3, **FULL)
    tb, jb = _boundaries(4, **FULL_BC)
    # the blended inlets after 6 steps, when every pipe carries effluent
    tf, _ = TN.rollout_network(tp, ta, ts, tb, 5.0, 4, 6, record=False)
    jf, _ = jax.jit(functools.partial(
        JN.rollout_network, dt=5.0, substeps=4, n_steps=6,
        record=False))(jp, ja, js, jb)
    _state_close(tf, jf)
    got, q_t = TN._blended_boundary(*ta, tf, tb, True,
                                    tp.particles.inlet_fractions)
    want, q_j = JN._blended_boundary(*ja, jf, jb, True,
                                     jp.particles.inlet_fractions)
    _close(q_t, q_j, "q_out")
    for name in ("inlet_flow_rate", "inlet_pH", "inlet_chlorine",
                 "inlet_temperature", "inlet_ammonia", "inlet_oxygen",
                 "inlet_carbonate", "inlet_tss", "inlet_tss_classes",
                 "inlet_pathogen_classes", "inlet_ct", "inlet_age",
                 "inlet_toc", "inlet_thm", "inlet_bacteria", "inlet_bdoc"):
        _close(getattr(got, name), getattr(want, name), name)
    # the downstream stages see the upstream effluent's own class split,
    # not the source water's fractions
    split = to_numpy(got.inlet_tss_classes)
    split = split / split.sum(-1, keepdims=True)
    fr = to_numpy(tp.particles.inlet_fractions)[0]
    assert np.abs(split[1] - fr).max() > 1e-3
    assert got.inlet_pathogen_classes.shape == (3, 3)
    assert ts.ring.shape[-1] == 7 + 2 + 3 + 3 + 4 + 2


def test_batch_of_realizations_matches_jax_vmap():
    tp, ts, ta, jp, js, ja = _pair()
    doses = np.linspace(0.0, 0.5, 4)
    base = np.array([0.25, 0.0, 0.0])
    e2 = np.array([0.0, 0.0, 1.0])

    def jbc(d):
        return JR.BoundaryConditions(
            **BC, inlet_flow_rate=jnp.array([8.0, 0.0, 0.0]),
            chlorine_flow_rate=jnp.asarray(base) + d * jnp.asarray(e2))

    roll = functools.partial(JN.rollout_network, dt=5.0, substeps=8,
                             n_steps=6, record=False)
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x), (4,) + np.shape(x)), js)
    jf = jax.jit(jax.vmap(lambda ns, d: roll(jp, ja, ns, jbc(d))[0]))(
        batched, jnp.asarray(doses))

    tb = TR.BoundaryConditions(
        **BC, inlet_flow_rate=torch.tensor([8.0, 0.0, 0.0], dtype=F64),
        chlorine_flow_rate=torch.from_numpy(base + doses[:, None] * e2))
    tsb = TN.NetworkState(
        reactor=TR.ReactorState(**{
            f.name: (None if getattr(ts.reactor, f.name) is None else
                     getattr(ts.reactor, f.name).expand(
                         (4,) + getattr(ts.reactor, f.name).shape))
            for f in dataclasses.fields(ts.reactor)}),
        ring=ts.ring.expand((4,) + ts.ring.shape),
        ring_index=ts.ring_index.expand((4,)))
    tf, _ = TN.rollout_network(tp, ta, tsb, tb, 5.0, 8, 6, record=False)
    assert tf.reactor.chlorine.shape == (4, 3, 4)
    _state_close(tf, jf)
    # each realization equals its own unbatched run
    one, _ = TN.rollout_network(tp, ta, ts, TR.BoundaryConditions(
        **BC, inlet_flow_rate=torch.tensor([8.0, 0.0, 0.0], dtype=F64),
        chlorine_flow_rate=torch.from_numpy(base + doses[2] * e2)), 5.0, 8,
        6, record=False)
    _close(tf.reactor.chlorine[2], one.reactor.chlorine)


def test_gradient_through_the_ring_matches_jax():
    """Reverse mode through the routing, the ring's reads and its out of
    place writes: d(finished-water chlorine)/d(booster dose) over 7 steps
    (rtol 1e-9)."""
    tp, ts, ta, jp, js, ja = _pair(n_zones=3)

    def t_loss(d):
        bc = TR.BoundaryConditions(
            **BC, inlet_flow_rate=torch.tensor([8.0, 0.0, 0.0], dtype=F64),
            chlorine_flow_rate=torch.stack(
                [torch.tensor(0.25, dtype=F64), d * 0.0, d]))
        f, _ = TN.rollout_network(tp, ta, ts, bc, 5.0, 4, 7, record=False)
        return f.reactor.chlorine[2, -1] + f.ring[..., 1].sum()

    def j_loss(d):
        bc = JR.BoundaryConditions(
            **BC, inlet_flow_rate=jnp.array([8.0, 0.0, 0.0]),
            chlorine_flow_rate=jnp.stack([jnp.asarray(0.25), d * 0.0, d]))
        f, _ = JN.rollout_network(jp, ja, js, bc, 5.0, 4, 7, record=False)
        return f.reactor.chlorine[2, -1] + f.ring[..., 1].sum()

    d = torch.tensor(0.3, dtype=F64, requires_grad=True)
    (got,) = torch.autograd.grad(t_loss(d), d)
    want = jax.jit(jax.grad(j_loss))(jnp.asarray(0.3))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-9, atol=0)
    assert float(want) != 0.0


def test_particle_realizations_equal_their_own_runs():
    """A batch of realizations of a particle-carrying network, with
    per-plant ``[P]`` boundary fields (``sludge_blowdown``,
    ``filter_flow_rate``) and a ``[doses, P]`` coagulant dose: each
    realization equals its own unbatched run (examples_torch/
    clarifier_train.py's sweep). Before the repair the batched step raised:
    the class fractions were broadcast to ``[P, C]`` only, and a ``[P]``
    field was aligned with the ``[doses, P, C]`` sludge by its leading
    axis."""
    extra = dict(enable_particles=True, initial_tss=2.0)
    tt = TN.NetworkTopology(routing=TRAIN_W, delay_steps=TRAIN_D)
    tp, ts = TN.make_network(_configs(TR, 4, **extra), tt, dtype=F64,
                             device="cpu")
    ta = TN.topology_arrays(tt, F64, "cpu")

    def bc(dose):
        return TR.BoundaryConditions(
            **BC, inlet_flow_rate=torch.tensor([8.0, 0.0, 0.0], dtype=F64),
            inlet_tss=torch.tensor([60.0, 0.0, 0.0], dtype=F64),
            coagulant_dose=dose * torch.tensor([1.0, 0.0, 0.0], dtype=F64),
            filter_flow_rate=torch.tensor([0.0, 0.0, 10.0], dtype=F64),
            sludge_blowdown=torch.tensor([0.0, 2e-5, 0.0], dtype=F64))

    doses = torch.tensor([0.0, 25.0, 40.0], dtype=F64)
    tsb = TN.NetworkState(
        reactor=TR.ReactorState(**{
            f.name: (None if getattr(ts.reactor, f.name) is None else
                     getattr(ts.reactor, f.name).expand(
                         (3,) + getattr(ts.reactor, f.name).shape))
            for f in dataclasses.fields(ts.reactor)}),
        ring=ts.ring.expand((3,) + ts.ring.shape),
        ring_index=ts.ring_index.expand((3,)))
    tf, _ = TN.rollout_network(tp, ta, tsb, bc(doses[:, None]), 10.0, 8, 5,
                               record=False)
    assert tf.reactor.tss.shape == (3, 3, 3, 4)
    for i in range(3):
        one, _ = TN.rollout_network(tp, ta, ts, bc(float(doses[i])), 10.0,
                                    8, 5, record=False)
        for name in ("tss", "sludge", "chlorine", "pH"):
            _close(getattr(tf.reactor, name)[i], getattr(one.reactor, name),
                   f"{name}[{i}]")
    assert not torch.equal(tf.reactor.tss[0], tf.reactor.tss[1])
