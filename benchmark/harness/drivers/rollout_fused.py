"""``ops/fused_rollout.py::rollout_fused`` (kernel B1) over a Monte-Carlo
ensemble, each call fed the last state; at most two calls in flight."""

from __future__ import annotations

import numpy as np

from benchmark.harness import base
from benchmark.harness import state as S
from benchmark.reference import params as P
from benchmark.reference import physics as PH
from benchmark.reference.arith import F64, Arith


class Driver(base.Driver):
    KERNELS = ("rollout_kernel",)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        from ics_wt_physicsengine_torch.core import reactor as R
        from ics_wt_physicsengine_torch.models.monte_carlo import (
            ParameterRanges, make_monte_carlo_batch)
        from ics_wt_physicsengine_torch.ops import fused_rollout as F

        t = self.traffic
        mc = self.config["monte_carlo"]
        self.F = F
        self.batch, self.n_steps = int(t["plants"]), int(t["steps_per_call"])
        self.params, self.state0 = make_monte_carlo_batch(
            self.reactor_configuration(), self.batch, seed=self.seeds.plants,
            ranges=ParameterRanges(
                ranges={k: tuple(v) for k, v in mc["ranges"].items()},
                alkalinity_ratio=tuple(mc["alkalinity_ratio"])),
            dtype=self.dtype, device=self.device)
        self.boundary = R.BoundaryConditions(**t["boundary"])
        self.events = []

    def work_per_call(self) -> int:
        return self.batch * self.n_steps

    def _run(self, state):
        return self.F.rollout_fused(self.params, state, self.boundary,
                                    dt=self.dt, substeps=self.substeps,
                                    stages=self.stages, n_steps=self.n_steps)

    def warm(self):
        self._run(self.state0)
        self.sync()

    def begin(self):
        self.state, self.events = self.state0, []

    def call(self, k: int, spans=None) -> int:
        if self.cuda and len(self.events) >= 2:
            self.events[-2].synchronize()
        with self.span(self.WRAPPER, spans):
            state_in, self.state = self.state, self._run(self.state)
        if self.cuda:
            ev = self.torch.cuda.Event()
            ev.record()
            self.events = self.events[-1:] + [ev]
        self.keep(k, state_in=state_in, state_out=self.state)
        return self.work_per_call()

    def finish(self):
        self.sync()
        self.events = []

    def release(self):
        """Drop the program's state; keep only the host copies the check
        needs."""
        self.idx = self.sample_plants(self.batch)
        self.host = {key: {
            "in": S.reactor(v["state_in"], self.idx),
            "out": S.reactor(v["state_out"], self.idx), "k": v.get("k", 0)}
            for key, v in self.kept.items()}
        self.kept = self.params = self.state0 = self.state = None

    def check(self) -> dict:
        """Gaps of pH, chlorine and temperature over the sampled plants of
        the first and the kept later call: the program's (or, for a
        control, the reference's in the control's precision) against the
        float64 reference's."""
        cfg, idx = self.config, self.idx
        plants = P.sample_plants(cfg, self.batch, self.seeds.plants)
        rp = {k: v[idx] for k, v in P.reactor_params(cfg, plants).items()}
        start = P.initial_state(cfg, {k: v[idx] for k, v in plants.items()})
        calls = [(start, self.host[0]["out"])]
        if "later" in self.host:
            calls.append((self.host["later"]["in"],
                          self.host["later"]["out"]))
        m = len(calls)

        def reference(xp):
            return PH.rollout(
                {k: np.tile(v, m) for k, v in rp.items()},
                {k: np.concatenate([c[0][k] for c in calls])
                 for k in PH.FIELDS},
                self.traffic["boundary"], integ=self.integ,
                n_steps=self.n_steps, xp=xp)

        ref = reference(F64)
        prog = reference(Arith(self.control)) if self.control else {
            k: np.concatenate([c[1][k] for c in calls]) for k in PH.FIELDS}
        return base.state_gaps(prog, ref, len(idx))
