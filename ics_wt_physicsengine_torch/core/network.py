"""
Connected multi-reactor networks: treatment trains and distribution loops
(port of ``ics_wt_physicsengine_tpu/core/network.py``).

- **Plants are a batch axis, routing is a matmul.** The P plants advance as
  one stacked ``[P, Z]`` reactor batch (``core/reactor.py`` is natively
  batched); the coupling is a dense ``[P, P]`` routing contraction a step.
- **Pipe transport delays are a ring**: a ``[D, P, S]`` history of every
  plant's outlet composition, read per edge at ``(index - delay) mod D``
  and written out of place (``torch.where`` on the slot), so autograd and
  ``torch.func`` pass through it.
- **Hydraulics are solved once on the host.** Steady routing gives
  ``q_out = ext + dose + W q_out``; the resolvent ``(I - W)^-1`` is a
  float64 NumPy inverse and each step's flows are one matvec.
- **Realizations are a leading batch axis.** Every function takes states
  with leading axes ``[B...]`` ahead of ``[P, Z]`` (ring ``[B..., D, P,
  S]``, ``ring_index`` ``[B...]``) and boundaries whose per-plant fields are
  ``[B..., P]``; this takes the place of the JAX package's ``jax.vmap``
  over network realizations.

Coupling: an edge ``i -> j`` with delay ``d`` (>= 1 step) blends plant i's
outlet-zone composition as it was after step ``k - d`` into plant j's inlet
at step k, flow-weighted and linear in chlorine, temperature, the nitrogen
species, the dissolved gases and the per-class solids; pH mixes in H+
space. Particle classes and pathogen classes ride the pipes class-resolved
(``inlet_tss_classes`` / ``inlet_pathogen_classes``), with the CT credit,
water age, TOC, THMs, planktonic biomass and BDOC beside them. External
nitrite / nitrate / chloramine inflows are zero.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, numpy_dtype,
                                               resolve_device)
from ics_wt_physicsengine_torch.utils.dispatch import (clip, filled,
                                                       map_tensors)

__all__ = [
    "NetworkTopology", "NetworkState", "make_network", "network_step",
    "rollout_network", "rollout_network_scheduled",
]


# ---------------------------------------------------------------------------
# Topology (host-side, static)
# ---------------------------------------------------------------------------


@dataclass
class NetworkTopology:
    """Static plant-interconnection graph.

    ``routing[j, i]`` is the fraction of plant i's outflow piped into plant
    j's inlet (0 = no edge). Fractions out of one plant may sum to < 1 —
    the remainder leaves the network (finished water). ``delay_steps[j, i]``
    is that pipe's transport delay in whole steps (>= 1; ignored where
    ``routing`` is 0). Loops (recirculation) are allowed as long as the
    routing spectral radius stays < 1 so the steady hydraulics are solvable.
    """

    routing: np.ndarray
    delay_steps: Union[int, np.ndarray] = 1

    def __post_init__(self):
        W = np.asarray(self.routing, np.float64)
        if W.ndim != 2 or W.shape[0] != W.shape[1]:
            raise ValueError(f"routing must be [P, P], got {W.shape}")
        if np.any(W < 0.0) or np.any(W > 1.0):
            raise ValueError("routing fractions must be in [0, 1]")
        out_frac = W.sum(axis=0)  # total fraction leaving each plant
        if np.any(out_frac > 1.0 + 1e-9):
            raise ValueError(
                f"plant(s) {np.nonzero(out_frac > 1.0 + 1e-9)[0].tolist()} "
                f"route more than 100% of their outflow")
        rho = np.max(np.abs(np.linalg.eigvals(W))) if W.size else 0.0
        if rho >= 1.0 - 1e-9:
            raise ValueError(
                f"routing spectral radius {rho:.3f} >= 1: the recirculation "
                f"loop feeds back its full flow and steady hydraulics have "
                f"no solution")
        D = np.broadcast_to(np.asarray(self.delay_steps, np.int64), W.shape)
        if np.any((W > 0.0) & (D < 1)):
            raise ValueError("edge delays must be >= 1 step")
        self.routing = W
        self.delay_steps = np.where(W > 0.0, D, 1).astype(np.int64)

    @property
    def n_plants(self) -> int:
        return self.routing.shape[0]

    @property
    def max_delay(self) -> int:
        """Ring length: the longest delay on any live edge."""
        live = self.delay_steps[self.routing > 0.0]
        return int(live.max()) if live.size else 1

    def resolvent(self) -> np.ndarray:
        """(I - W)^-1 — one host-side solve; flows per step are a matvec."""
        return np.linalg.inv(np.eye(self.n_plants) - self.routing)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


@dataclass
class NetworkState:
    """Stacked plant states + the pipe-delay ring.

    ``reactor`` fields are ``[B..., P, Z]``; ``ring`` is ``[B..., D, P, S]``
    where the species columns are [H+, Cl, T] (+4 nitrogen) (+2 gas: O2,
    C_T) (+C particle classes) (+pathogen classes, CT, age, TOC, THM)
    (+bacteria, BDOC); ``ring_index`` (int64, ``[B...]``) counts pushes
    (slot ``ring_index % D`` is written after each step).
    """

    reactor: R.ReactorState
    ring: torch.Tensor
    ring_index: torch.Tensor


def _outlet_sample(state: R.ReactorState) -> torch.Tensor:
    """[..., P, S] outlet-zone composition, pH already in H+ space."""
    cols = [10.0 ** (-state.pH[..., -1]),
            state.chlorine[..., -1],
            state.temperature[..., -1]]
    if state.ammonia is not None:
        cols += [state.ammonia[..., -1], state.nitrite[..., -1],
                 state.nitrate[..., -1], state.chloramine[..., -1]]
    if state.oxygen is not None:
        cols += [state.oxygen[..., -1], state.carbonate[..., -1]]
    parts = [torch.stack(cols, dim=-1)]
    if state.tss is not None:
        # per-class outlet solids [..., P, C] — piped class-resolved
        parts.append(state.tss[..., -1])
    if state.pathogens is not None:
        parts += [state.pathogens[..., -1],
                  torch.stack([state.ct[..., -1], state.age[..., -1],
                               state.toc[..., -1], state.thm[..., -1]],
                              dim=-1)]
    if state.bacteria is not None:
        # the wall film stays on each plant's own surfaces: not routed
        parts.append(torch.stack([state.bacteria[..., -1],
                                  state.bdoc[..., -1]], dim=-1))
    return torch.cat(parts, dim=-1)


def _stack_numpy(values):
    """Nested mappings of NumPy values, one per plant -> one mapping of
    ``[P, ...]`` arrays (Python ints and None pass through)."""
    first = values[0]
    if isinstance(first, dict):
        return {k: _stack_numpy([v[k] for v in values]) for k in first}
    if first is None or isinstance(first, int):
        return first
    return np.stack([np.asarray(v) for v in values], axis=0)


def make_network(configs: Union[R.ReactorConfiguration,
                                Sequence[R.ReactorConfiguration]],
                 topology: NetworkTopology,
                 dtype=DEFAULT_DTYPE, device=None):
    """Stacked params + initial network state on ``device`` (``None``: the
    CUDA card).

    ``configs``: one configuration shared by every plant, or a sequence of
    ``topology.n_plants`` configurations (heterogeneous volumes / chemistry
    per stage). All must share ``n_zones`` and agree on the extension axes.
    """
    from ics_wt_physicsengine_torch.convert import (params_from_numpy,
                                                    state_from_numpy)

    dev = resolve_device(device)
    P = topology.n_plants
    if isinstance(configs, R.ReactorConfiguration):
        configs = [configs] * P
    configs = list(configs)
    if len(configs) != P:
        raise ValueError(f"{len(configs)} configs for {P} plants")
    zs = {c.n_zones for c in configs}
    if len(zs) != 1:
        raise ValueError(f"all plants must share n_zones, got {sorted(zs)}")
    for flag in ("enable_nitrogen", "enable_gas", "enable_particles",
                 "enable_disinfection", "enable_biofilm"):
        if len({bool(getattr(c, flag, False)) for c in configs}) != 1:
            raise ValueError(f"{flag} must match across plants")

    np_dtype = numpy_dtype(dtype)
    params = params_from_numpy(
        _stack_numpy([R.params_numpy(c, np_dtype) for c in configs]),
        dtype=dtype, device=dev)
    reactor = state_from_numpy(
        _stack_numpy([R.initial_state_numpy(c, np_dtype) for c in configs]),
        dtype=dtype, device=dev)
    sample = _outlet_sample(reactor).to(dtype)              # [P, S]
    ring = sample.expand((topology.max_delay,) + sample.shape).clone()
    return params, NetworkState(
        reactor=reactor, ring=ring,
        ring_index=torch.zeros((), dtype=torch.int64, device=dev))


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


def _delayed(ring, rows):
    """``out[..., j, i, :] = ring[..., rows[..., j, i], i, :]``: each edge's
    delayed outlet sample. ``ring`` is ``[B..., D, P, S]``, ``rows``
    ``[B..., P, P]``."""
    P, S = ring.shape[-2:]
    src = ring.unsqueeze(-4).expand(ring.shape[:-3] + (P,) + ring.shape[-3:])
    index = rows.unsqueeze(-2).unsqueeze(-1).expand(
        rows.shape[:-2] + (P, 1, P, S))
    return torch.gather(src, -3, index).squeeze(-3)


def _blended_boundary(topo_W, topo_Minv, topo_delay, nstate: NetworkState,
                      boundary: R.BoundaryConditions, has_nitrogen: bool,
                      particle_fractions=None):
    """Per-plant effective BoundaryConditions after routing + blending.

    ``particle_fractions`` ([P, C] or [C]) splits the external
    ``inlet_tss`` into classes on particle-carrying networks (ignored when
    ``boundary.inlet_tss_classes`` already gives the external split)."""
    ring, idx = nstate.ring, nstate.ring_index
    D = ring.shape[-3]
    Pn = ring.shape[-2]
    dtype, dev = ring.dtype, ring.device
    batch = tuple(ring.shape[:-3])
    reactor = nstate.reactor
    has_gas = reactor.oxygen is not None
    has_p = reactor.tss is not None
    has_d = reactor.pathogens is not None
    has_b = reactor.bacteria is not None
    g_off = 7 if has_nitrogen else 3
    p_off = g_off + (2 if has_gas else 0)
    n_classes = reactor.tss.shape[-2] if has_p else 0
    d_off = p_off + n_classes
    n_path = reactor.pathogens.shape[-2] if has_d else 0
    b_off = d_off + (n_path + 4 if has_d else 0)

    def v(x):  # [B..., P] view of a boundary field (number, [P], [B..., P])
        return filled(x, batch + (Pn,), dtype, dev)

    ext_q = v(boundary.inlet_flow_rate)
    dose_q = v(boundary.acid_flow_rate) + v(boundary.chlorine_flow_rate)

    # Steady hydraulics: q_out = (I - W)^-1 (ext + dose); routed flow on
    # edge i->j is W[j, i] * q_out[i].
    q_out = torch.einsum("ij,...j->...i", topo_Minv, ext_q + dose_q)
    routed_q = topo_W * q_out[..., None, :]                    # [..., P, P]
    q_in = ext_q + routed_q.sum(dim=-1)                        # [..., P]

    # Delayed outlet composition per edge: ring slot (idx - d) mod D of
    # source plant i (ring slot k%D holds the post-step-k sample).
    rows = torch.remainder(idx[..., None, None] - topo_delay, D)
    delayed = _delayed(ring, rows)                             # [..., P, P, S]

    ext_cols = [10.0 ** (-v(boundary.inlet_pH)),
                v(boundary.inlet_chlorine),
                v(boundary.inlet_temperature)]
    if has_nitrogen:
        zero = torch.zeros(batch + (Pn,), dtype=dtype, device=dev)
        ext_cols += [v(boundary.inlet_ammonia), zero, zero, zero]
    if has_gas:
        ext_cols += [v(boundary.inlet_oxygen), v(boundary.inlet_carbonate)]
    ext_parts = [torch.stack(ext_cols, dim=-1)]                # [..., P, S0]
    if has_p:
        if boundary.inlet_tss_classes is not None:
            ext_tss = torch.as_tensor(
                boundary.inlet_tss_classes, dtype=dtype,
                device=dev).broadcast_to(batch + (Pn, n_classes))
        elif particle_fractions is not None:
            fr = torch.as_tensor(particle_fractions, dtype=dtype,
                                 device=dev)
            # [C], [P, C], or [B..., P, C] once the step has given the
            # parameters the realizations' axes
            ext_tss = v(boundary.inlet_tss)[..., None] \
                * fr.broadcast_to(batch + (Pn, fr.shape[-1]))
        else:
            raise ValueError(
                "particle-carrying network needs particle_fractions (or "
                "boundary.inlet_tss_classes) to split the external "
                "inlet_tss into classes")
        ext_parts.append(ext_tss)
    if has_d:
        if boundary.inlet_pathogen_classes is not None:
            ext_path = torch.as_tensor(
                boundary.inlet_pathogen_classes, dtype=dtype,
                device=dev).broadcast_to(batch + (Pn, n_path))
        else:
            ext_path = v(boundary.inlet_pathogens)[..., None] \
                .expand(batch + (Pn, n_path))
        ext_parts += [ext_path,
                      torch.stack([v(boundary.inlet_ct),
                                   v(boundary.inlet_age),
                                   v(boundary.inlet_toc),
                                   v(boundary.inlet_thm)], dim=-1)]
    if has_b:
        ext_parts.append(torch.stack([v(boundary.inlet_bacteria),
                                      v(boundary.inlet_bdoc)], dim=-1))
    ext_c = torch.cat(ext_parts, dim=-1)                       # [..., P, S]

    num = ext_q[..., None] * ext_c \
        + torch.einsum("...ji,...jis->...js", routed_q, delayed)
    c_in = torch.where(q_in[..., None] > 0.0,
                       num / clip(q_in[..., None], 1e-30), ext_c)

    kw = dict(
        inlet_flow_rate=q_in,
        inlet_pH=clip(-torch.log10(clip(c_in[..., 0], 1e-30)), 0.0, 14.0),
        inlet_chlorine=c_in[..., 1],
        inlet_temperature=c_in[..., 2],
    )
    if has_nitrogen:
        kw["inlet_ammonia"] = c_in[..., 3]
    if has_gas:
        kw["inlet_oxygen"] = c_in[..., g_off]
        kw["inlet_carbonate"] = c_in[..., g_off + 1]
    if has_p:
        kw["inlet_tss_classes"] = c_in[..., p_off:d_off]
        kw["inlet_tss"] = torch.sum(c_in[..., p_off:d_off], dim=-1)
    if has_d:
        kw["inlet_pathogen_classes"] = c_in[..., d_off:d_off + n_path]
        kw["inlet_ct"] = c_in[..., d_off + n_path]
        kw["inlet_age"] = c_in[..., d_off + n_path + 1]
        kw["inlet_toc"] = c_in[..., d_off + n_path + 2]
        kw["inlet_thm"] = c_in[..., d_off + n_path + 3]
    if has_b:
        kw["inlet_bacteria"] = c_in[..., b_off]
        kw["inlet_bdoc"] = c_in[..., b_off + 1]
    return replace(boundary, **kw), q_out


# boundary fields whose last axis is a class, not a plant
_CLASS_FIELDS = ("inlet_tss_classes", "inlet_pathogen_classes")


def _tensor_fields(values: dict, like: torch.Tensor) -> dict:
    """Boundary fields with every array (NumPy or tensor) a tensor of
    ``like``'s dtype on its device; numbers and None stay as they are."""
    return {name: (torch.as_tensor(x, dtype=like.dtype, device=like.device)
                   if isinstance(x, (np.ndarray, torch.Tensor)) else x)
            for name, x in values.items()}


def network_step(params: R.ReactorParams, topo_arrays,
                 nstate: NetworkState, boundary: R.BoundaryConditions,
                 dt: float, substeps: int,
                 stages: Optional[int] = None) -> NetworkState:
    """Advance every plant by ``dt`` with routed, delayed inter-plant flow.

    ``topo_arrays`` is ``topology_arrays(topo, dtype, device)``.
    ``boundary`` fields are numbers, ``[P]`` per plant or ``[B..., P]`` per
    realization and plant (external inlet + dosing)."""
    W, Minv, delay = topo_arrays
    values = _tensor_fields(
        {f.name: getattr(boundary, f.name) for f in fields(boundary)},
        nstate.ring)
    batch = tuple(nstate.ring.shape[:-3])
    if batch:
        # realizations share the plants' parameters: every [P, ...] field
        # gains the leading axes, as the state's fields have them
        params = map_tensors(lambda x: x.expand(batch + x.shape), params)
        # and so does every per-plant [P] boundary field: the step aligns
        # a field with the zone arrays by its leading axes
        values = {name: (x.expand(batch + x.shape)
                         if isinstance(x, torch.Tensor) and x.ndim == 1
                         and name not in _CLASS_FIELDS else x)
                  for name, x in values.items()}
    boundary = R.BoundaryConditions(**values)
    has_n = nstate.reactor.ammonia is not None
    pf = (params.particles.inlet_fractions
          if nstate.reactor.tss is not None else None)
    eff_bc, _ = _blended_boundary(W, Minv, delay, nstate, boundary, has_n,
                                  particle_fractions=pf)
    reactor = R.step(params, nstate.reactor, eff_bc, dt, substeps,
                     stages=stages)
    ring = nstate.ring
    sample = _outlet_sample(reactor).to(ring.dtype)        # [..., P, S]
    D = ring.shape[-3]
    slot = torch.remainder(nstate.ring_index, D)
    mask = (torch.arange(D, device=ring.device)
            == slot[..., None])[..., None, None]          # [..., D, 1, 1]
    ring = torch.where(mask, sample.unsqueeze(-3), ring)
    return NetworkState(reactor=reactor, ring=ring,
                        ring_index=nstate.ring_index + 1)


def topology_arrays(topology: NetworkTopology, dtype=DEFAULT_DTYPE,
                    device=None):
    """Device constants for the step functions: (W, (I-W)^-1, delays),
    on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    return (torch.from_numpy(topology.routing.astype(np_dtype)).to(dev),
            torch.from_numpy(topology.resolvent().astype(np_dtype)).to(dev),
            torch.from_numpy(topology.delay_steps.astype(np.int64)).to(dev))


def _record(s: NetworkState) -> dict:
    return {"pH": s.reactor.pH, "chlorine": s.reactor.chlorine,
            "temperature": s.reactor.temperature}


def _stack(records):
    return {k: torch.stack([r[k] for r in records]) for k in records[0]}


def rollout_network(params, topo_arrays, nstate: NetworkState,
                    boundary: R.BoundaryConditions, dt: float,
                    substeps: int, n_steps: int, record: bool = True,
                    stages: Optional[int] = None):
    """Loop ``network_step`` over ``n_steps``. Returns ``(final_state,
    trajectory)``; the trajectory stacks the primary variables
    ``[n_steps, ..., P, Z]`` (``None`` when ``record=False``)."""
    records = []
    for _ in range(n_steps):
        nstate = network_step(params, topo_arrays, nstate, boundary, dt,
                              substeps, stages=stages)
        if record:
            records.append(_record(nstate))
    return nstate, (_stack(records) if record and records else None)


def rollout_network_scheduled(params, topo_arrays, nstate: NetworkState,
                              schedule: R.BoundaryConditions, dt: float,
                              substeps: int, record: bool = True,
                              stages: Optional[int] = None):
    """Per-step boundary schedule (fields ``[n_steps, ...]``; a field whose
    leading axis is not ``n_steps``, or a number, holds for every step),
    mirroring ``reactor.rollout_scheduled`` for the network (dosing
    programs over a treatment train)."""
    values = {f.name: getattr(schedule, f.name) for f in fields(schedule)}
    lengths = {np.shape(x)[0] for x in values.values()
               if x is not None and np.ndim(x) >= 1 and np.shape(x)[0] > 1}
    if len(lengths) > 1:
        raise ValueError(f"inconsistent schedule lengths: {sorted(lengths)}")
    n_steps = lengths.pop() if lengths else 1
    stepped = {name for name, x in values.items()
               if x is not None and np.ndim(x) >= 1
               and np.shape(x)[0] == n_steps}
    columns = _tensor_fields(values, nstate.ring)
    records = []
    for i in range(n_steps):
        bc = R.BoundaryConditions(**{
            name: (x[i] if name in stepped else x)
            for name, x in columns.items()})
        nstate = network_step(params, topo_arrays, nstate, bc, dt, substeps,
                              stages=stages)
        if record:
            records.append(_record(nstate))
    return nstate, (_stack(records) if record else None)
