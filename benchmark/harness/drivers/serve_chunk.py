"""One served plant in fast time, as the serving loop runs it (``python -m
ics_wt_physicsengine_torch --fused-sensors --serve-chunk N``): each chunk
a controller command drawn from the seed (``harness/traffic.py``),
``__main__.build_chunk_schedule`` with instant actuation (the
orchestrator's default ``--actuator-tau 0``),
``models/plant.py::plant_serve_chunk`` (kernel B3) from the global step,
and ``__main__._readings_from_chunk`` (the register snapshot, on the
host); after the readings, the instruments' maintenance where it is due
(``__main__.py::maintain_sensors``)."""

from __future__ import annotations

from dataclasses import replace
from time import perf_counter

import numpy as np

from benchmark.harness import base
from benchmark.harness import state as S
from benchmark.harness import traffic as TR
from benchmark.reference import instruments as I
from benchmark.reference import params as P
from benchmark.reference.arith import F64, Arith

TAU_S = 0.0          # actuator lag: none, as the orchestrator by default


class Driver(base.Instrumented):
    unit = "sim-seconds"
    KERNELS = ("plant_kernel", "philox_words_kernel")
    WRAPPER = "chunk"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        from ics_wt_physicsengine_torch import __main__ as M
        from ics_wt_physicsengine_torch.core import reactor as R
        from ics_wt_physicsengine_torch.models.plant import (
            make_plant, plant_serve_chunk)

        t = self.traffic
        self.M, self.serve, self.make_plant = M, plant_serve_chunk, make_plant
        self.n_steps = int(t["steps_per_chunk"])
        self.record_every = int(t["record_every"])
        self.params, self.plant0 = make_plant(
            self.reactor_configuration(), dtype=self.dtype,
            warmed_up=self.config["warmed_up"], device=self.device)
        self.boundary0 = R.BoundaryConditions(**t["boundary"])
        self.commands = TR.commands(t["commands"], self.seeds.commands,
                                    int(t["max_chunks"]))
        self.chunk_s = []

    def work_per_call(self) -> float:
        return self.n_steps * self.dt

    def command(self, k: int) -> dict:
        """Chunk ``k``'s command (the drawn list repeats past its end)."""
        return {f: float(v[k % len(v)]) for f, v in self.commands.items()}

    def fresh_instruments(self, now: float):
        return self.make_plant(
            self.reactor_configuration(), dtype=self.dtype,
            warmed_up=self.config["warmed_up"], t0=now,
            device=self.device)[1]

    def _chunk(self, k: int, spans=None):
        """Chunk ``k``, from its command to its readings on the host;
        returns those and the chunk's host seconds."""
        t0 = perf_counter()
        commanded = replace(self.boundary0, **self.command(k))
        with self.span("schedule", spans):
            schedule, _ = self.M.build_chunk_schedule(
                self.boundary, commanded, self.n_steps, self.dt, TAU_S,
                device=self.device)
        with self.span(self.WRAPPER, spans):
            result = self.serve(
                self.params, self.plant, schedule, dt=self.dt,
                substeps=self.substeps, stages=self.stages,
                record_every=self.record_every, seed=self.seeds.philox,
                step0=k * self.n_steps)
        with self.span("readings", spans):
            readings = self.M._readings_from_chunk(
                result, (k + 1) * self.n_steps * self.dt)
        self.boundary = commanded
        return schedule, result, readings, perf_counter() - t0

    def warm(self):
        self.begin()
        self._chunk(0)
        self.fresh_instruments(self.period)
        self.sync()

    def begin(self):
        self.plant, self.boundary, self.chunk_s = \
            self.plant0, self.boundary0, []
        self.begin_maintenance()

    def call(self, k: int, spans=None) -> float:
        plant_in, fresh = self.plant, self.fresh
        schedule, result, readings, seconds = self._chunk(k, spans)
        self.chunk_s.append(seconds)
        self.keep(k, fresh=fresh, plant_in=plant_in, schedule=schedule,
                  result=result, readings=readings)
        with self.span("maintenance", spans if self.due(k) else None):
            self.plant = self.maintain(result.plant, k)
        return self.work_per_call()

    def release(self):
        cfg = self.config
        names = [ins["name"] for ins in cfg["instruments"]]
        self.host = {}
        for key, v in self.kept.items():
            res, rd = v["result"], v["readings"]
            if list(res.names) != names:
                raise ValueError(f"the chunk's instruments {res.names} are "
                                 f"not the configuration's {names}")
            self.host[key] = dict(
                k=v.get("k", 0),
                schedule={f: S.host(getattr(v["schedule"], f))
                          for f in self.commands},
                plant_in=self.host_plant(v["plant_in"], None),
                plant_out=self.host_plant(res.plant, None),
                values=S.host(res.values)[..., None],
                faults=S.host(res.faults)[..., None],
                snapshot=[(rd[n].value, rd[n].status.name, rd[n].fault.name)
                          for n in names])
        self.kept = self.params = self.plant0 = self.plant = None

    def check(self) -> dict:
        """As the ensembles', and besides: the schedule of each kept chunk
        against the held command, each recorded fault code, and the
        register snapshot (value, status, fault of every instrument's last
        read)."""
        cfg = self.config
        d = int(round(I.line_delay_s(cfg) / self.dt))
        calls = self.plant_calls(
            P.initial_state(cfg, P.sample_plants(cfg, 1, 0,
                                                 randomize=False)), 1)
        m = len(calls)
        rp = P.reactor_params(cfg, P.sample_plants(cfg, m, 0,
                                                   randomize=False))
        held = [self.command(c[3]) for c in calls]

        def reference(xp):
            boundary = dict(self.traffic["boundary"])
            for f in self.commands:        # held over the chunk
                boundary[f] = np.array([h[f] for h in held])
            out = base.side(I.plant_rollout(
                cfg, rp, *base.batched_inputs(calls, d, 1), boundary,
                integ=self.integ, n_steps=self.n_steps,
                seed=self.seeds.philox,
                step0=np.array([c[3] * self.n_steps for c in calls]),
                plant_ids=np.zeros(m, np.int64),
                record_every=self.record_every, xp=xp))
            out["schedule"] = [schedule_reference(h, self.n_steps, xp)
                               for h in held]
            out["snapshot"] = [[(out["values"][-1, i, j],
                                 I.STATUS_NAMES[out["status"][i, j]],
                                 I.FAULT_NAMES[out["faults"][-1, i, j]])
                                for i in range(len(cfg["instruments"]))]
                               for j in range(m)]
            return out

        ref = reference(F64)
        if self.control:
            prog = reference(Arith(self.control))
        else:
            hosts = [c[4] for c in calls]
            prog = base.program_side(cfg, hosts)
            prog["schedule"] = [h["schedule"] for h in hosts]
            prog["snapshot"] = [h["snapshot"] for h in hosts]
        out = base.plant_numbers(cfg, prog, ref, 1)
        codes = int(np.sum(prog["faults"] != ref["faults"]))
        spans = base.spans_of(cfg)
        for ps, rs in zip(prog["snapshot"], ref["snapshot"]):
            for i, ((pv, pst, pf), (rv, rst, rf)) in enumerate(zip(ps, rs)):
                if np.isnan(pv) != np.isnan(rv):
                    codes += 1
                elif np.isnan(rv):
                    pass
                elif cfg["instruments"][i]["kind"] == "ph":
                    out["ph_reading_gap"] = max(out["ph_reading_gap"],
                                                abs(pv - rv))
                else:
                    out["reading_gap"] = max(out["reading_gap"],
                                             abs(pv - rv) / spans[i])
                codes += int(pst != rst) + int(pf != rf)
        out["code_mismatches"] += codes
        out["schedule_gap"] = max(base.gap(ps[f], rs[f]) for ps, rs in zip(
            prog["schedule"], ref["schedule"]) for f in rs)
        return out


def schedule_reference(held: dict, n_steps: int, xp=F64) -> dict:
    """Each actuator's value at every step of a chunk: the command held,
    rounded to float32 (to the control's precision where that is
    lower)."""
    out = {f: np.full(n_steps, v, np.float32) for f, v in held.items()}
    if xp.name == "bfloat16":
        out = {f: np.asarray(xp.asarray(v)) for f, v in out.items()}
    return out
