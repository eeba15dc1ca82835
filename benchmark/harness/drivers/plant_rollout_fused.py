"""``ops/fused_plant.py::plant_rollout_fused`` (kernel B3) over an
ensemble of instrumented plants (``models/plant.py::make_plant_batch``),
each call fed the last plant, its Philox stream from the global step, the
instruments maintained every ``maintenance_s`` of simulated time."""

from __future__ import annotations

import numpy as np

from benchmark.harness import base
from benchmark.harness import state as S
from benchmark.reference import instruments as I
from benchmark.reference import params as P
from benchmark.reference.arith import F64, Arith


class Driver(base.Instrumented):
    KERNELS = ("plant_kernel", "philox_words_kernel")

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        from ics_wt_physicsengine_torch.core import reactor as R
        from ics_wt_physicsengine_torch.models.plant import make_plant_batch
        from ics_wt_physicsengine_torch.ops import fused_plant as FP

        t = self.traffic
        self.FP, self.make_batch = FP, make_plant_batch
        self.batch, self.n_steps = int(t["plants"]), int(t["steps_per_call"])
        self.record_every = int(t["record_every"])
        self.params, self.plant0 = make_plant_batch(
            self.reactor_configuration(), self.batch,
            seed=self.seeds.plants, dtype=self.dtype, randomize=True,
            warmed_up=self.config["warmed_up"], device=self.device)
        self.boundary = R.BoundaryConditions(**t["boundary"])

    def work_per_call(self) -> int:
        return self.batch * self.n_steps

    def fresh_instruments(self, now: float):
        return self.make_batch(
            self.reactor_configuration(), self.batch, dtype=self.dtype,
            randomize=False, warmed_up=self.config["warmed_up"], t0=now,
            device=self.device)[1]

    def _run(self, plant, k):
        return self.FP.plant_rollout_fused(
            self.params, plant, self.boundary, dt=self.dt,
            substeps=self.substeps, stages=self.stages, n_steps=self.n_steps,
            record_every=self.record_every, seed=self.seeds.philox,
            step0=k * self.n_steps)

    def warm(self):
        self._run(self.plant0, 0)
        self.fresh_instruments(self.period)
        self.sync()

    def begin(self):
        self.plant = self.plant0
        self.begin_maintenance()

    def call(self, k: int, spans=None) -> int:
        plant_in, fresh = self.plant, self.fresh
        with self.span(self.WRAPPER, spans):
            plant_out, readings = self._run(plant_in, k)
        self.keep(k, fresh=fresh, plant_in=plant_in, plant_out=plant_out,
                  readings=readings)
        with self.span("maintenance", spans if self.due(k) else None):
            self.plant = self.maintain(plant_out, k)
        return self.work_per_call()

    def release(self):
        cfg = self.config
        self.idx = idx = self.sample_plants(self.batch)
        self.host = {}
        for key, v in self.kept.items():
            self.host[key] = dict(
                k=v.get("k", 0),
                plant_in=self.host_plant(v["plant_in"], idx),
                plant_out=self.host_plant(v["plant_out"], idx),
                values=np.stack([S.host(v["readings"][ins["name"]])[:, idx]
                                 for ins in cfg["instruments"]], axis=1))
        self.kept = self.params = self.plant0 = self.plant = None

    def check(self) -> dict:
        cfg, idx, n = self.config, self.idx, len(self.idx)
        plants = P.sample_plants(cfg, self.batch, self.seeds.plants)
        rp = {k: v[idx] for k, v in P.reactor_params(cfg, plants).items()}
        start = P.initial_state(cfg, {k: v[idx] for k, v in plants.items()})
        calls = self.plant_calls(start, n)
        d = int(round(I.line_delay_s(cfg) / self.dt))
        m = len(calls)

        def reference(xp):
            return I.plant_rollout(
                cfg, {k: np.tile(v, m) for k, v in rp.items()},
                *base.batched_inputs(calls, d, n), self.traffic["boundary"],
                integ=self.integ, n_steps=self.n_steps,
                seed=self.seeds.philox,
                step0=np.repeat([c[3] * self.n_steps for c in calls], n),
                plant_ids=np.tile(idx, m), record_every=self.record_every,
                xp=xp)

        ref = base.side(reference(F64))
        prog = base.side(reference(Arith(self.control))) if self.control \
            else base.program_side(cfg, [c[4] for c in calls])
        return base.plant_numbers(cfg, prog, ref, n)
