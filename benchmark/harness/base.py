"""
What the drivers of the program's entries share (one file an entry,
``harness/drivers/<entry>.py``). A driver offers ``warm`` (one call of the
cell's shape, part of set-up), ``begin`` (back to the start), ``call``
(one call or chunk of the window, returning its work), ``finish`` (wait
for the device), ``release`` (host copies of what the check needs; the
program's state dropped) and ``check`` (the numbers that decide
``correct``, from the plain reference). Its class attributes name its
``KERNELS`` (the device kernels of its entry) and its ``WRAPPER`` span
(the part around the entry's call).

A traffic file names its entry (``"entry"``) and holds its parameters; a
configuration file holds the plant and its integrator. The program is
imported in the drivers, and nothing of it reaches the reference: the
reference gets the configuration, the traffic, the seeds and the program's
outputs.

Every driver keeps, for the check, the first call's inputs and outputs,
one later call drawn from the seed (reservoir sampling over the window's
calls) and, where instruments are maintained, one call drawn from those
that open a maintenance period: the first from the reference's own start,
the later one from the program's state at its input (the reference can
follow the program only from a state the program made), the maintained one
from the program's tank and the reference's own fresh instruments.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import replace
from time import perf_counter

import numpy as np

from benchmark.harness import state as S
from benchmark.reference import instruments as I
from benchmark.reference import params as P
from benchmark.reference import physics as PH


class Seeds:
    """The seeds of one run, derived from ``--seed``: the Monte-Carlo
    plants, the Philox key, the commands, the check's samples."""

    def __init__(self, seed: int):
        words = np.random.SeedSequence(int(seed) % 2 ** 64) \
            .generate_state(4, dtype=np.uint64)
        self.plants = int(words[0] >> np.uint64(33))
        self.philox = int(words[1])
        self.commands = int(words[2])
        self.check = int(words[3])


def gap(a, b) -> float:
    """The widest absolute difference of two arrays; NaN where only one
    side is NaN."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if np.any(np.isnan(a) != np.isnan(b)):
        return math.nan
    both = ~np.isnan(a)
    return float(np.max(np.abs(a - b)[both])) if both.any() else 0.0


def median_gap(a, b) -> float:
    """The median absolute difference over every element (NaN where only
    one side is NaN)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if np.any(np.isnan(a) != np.isnan(b)):
        return math.nan
    d = np.abs(a - b)[~np.isnan(a)]
    return float(np.median(d)) if d.size else 0.0


def state_gaps(prog: dict, ref: dict, first: int) -> dict:
    """The widest gap of each field over the sampled plants and zones, the
    median gap of pH, and the median gap of pH over the first call's
    plants (its first ``first`` rows)."""
    return {"ph_gap": gap(prog["pH"], ref["pH"]),
            "ph_gap_p50": median_gap(prog["pH"], ref["pH"]),
            "ph_gap_p50_first": median_gap(prog["pH"][:first],
                                           ref["pH"][:first]),
            "cl_gap": gap(prog["chlorine"], ref["chlorine"]),
            "temp_gap": gap(prog["temperature"], ref["temperature"])}


class Driver:
    """What the entries share: set-up from the files, the kept calls, the
    plants the check samples."""

    unit = "plant-steps"
    LABEL = "label"       # ``spans``: label the parts in the trace only
    KERNELS = ()
    WRAPPER = "call"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: str = None):
        import torch

        self.torch = torch
        self.config, self.traffic = config, traffic
        self.seeds = Seeds(seed)
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.integ = PH.integrator(config)
        self.dt, self.substeps = self.integ["dt"], self.integ["substeps"]
        self.stages = self.integ["stages"]
        self.rng = np.random.default_rng(self.seeds.check)
        self.kept, self.n_fresh = {}, 0
        self.marks = []
        self.control = control       # a precision: the reference in its place
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def finish(self):
        self.sync()

    @contextlib.contextmanager
    def span(self, name: str, spans):
        """With a dict ``spans``: the part's host seconds, ending
        synchronized, added to ``spans[name]``. With ``LABEL``: the part
        marked ``bench.<name>`` on the host's wall clock (``marks``), with
        no wait. Nothing where ``spans`` is None."""
        if spans is None:
            yield
        elif spans is self.LABEL:
            t0 = time.time_ns()
            yield
            self.marks.append(("bench." + name, t0, time.time_ns()))
        else:
            t0 = perf_counter()
            yield
            self.sync()
            spans.setdefault(name, []).append(perf_counter() - t0)

    def keep(self, k: int, fresh: bool = False, **items):
        """Keep call 0; call ``k`` as the later call with probability
        ``1 / k`` (one call drawn evenly from 1 .. the last); and a call
        that opens a maintenance period (``fresh``) likewise among
        those."""
        if k == 0:
            self.kept[0] = items
            return
        if self.rng.random() < 1.0 / k:
            self.kept["later"] = dict(items, k=k)
        if fresh:
            self.n_fresh += 1
            if self.rng.random() < 1.0 / self.n_fresh:
                self.kept["fresh"] = dict(items, k=k)

    def reactor_configuration(self):
        from ics_wt_physicsengine_torch.core import reactor as R

        return R.ReactorConfiguration(**self.config["reactor"])

    def sample_plants(self, batch: int) -> np.ndarray:
        n = min(int(self.traffic["check"]["plants"]), batch)
        return np.sort(self.rng.choice(batch, n, replace=False))


class Instrumented(Driver):
    """A driver of instrumented plants, maintained as the orchestrator
    maintains its served plant (``__main__.py::maintain_sensors``, every
    ``--recal-hours``): once the simulated time after a call reaches the
    next maintenance, every instrument is replaced by a fresh, calibrated
    one (``make_plant(..., t0=now)``'s carries), the tank kept. The
    traffic's ``maintenance_s`` sets the period."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.period = float(self.traffic["maintenance_s"])
        self.next_maintenance, self.fresh = self.period, False

    def begin_maintenance(self):
        self.next_maintenance, self.fresh = self.period, False

    def due(self, k: int) -> bool:
        """Whether maintenance is due after call ``k``."""
        return (k + 1) * self.n_steps * self.dt >= self.next_maintenance

    def maintain(self, plant, k: int):
        """``plant`` after call ``k``, maintained where it is due; sets
        ``fresh`` for the next call."""
        now = (k + 1) * self.n_steps * self.dt
        self.fresh = self.due(k)
        if not self.fresh:
            return plant
        self.next_maintenance += self.period
        return replace(self.fresh_instruments(now), reactor=plant.reactor)

    def host_plant(self, plant, idx) -> dict:
        return {"reactor": S.reactor(plant.reactor, idx),
                "carries": [S.carry(getattr(plant, ins["attr"]), idx)
                            for ins in self.config["instruments"]]}

    def plant_calls(self, start: dict, n: int) -> list:
        """``(state, carries, leads, k, host)`` of each kept call: call 0
        from ``start`` (the reference's own) with fresh instruments; the
        later call from the program's plant at its input; the maintained
        call from the program's tank and instruments the reference makes
        fresh at its start."""
        cfg = self.config
        sp = I.sensor_params(cfg)
        d = int(round(I.line_delay_s(cfg) / self.dt))
        none = [None] * len(cfg["instruments"])
        calls = [(start, I.initial_carries(cfg, sp, n), none, 0,
                  self.host[0])]
        if "later" in self.host:
            h = self.host["later"]
            carries, leads = reference_plant_inputs(cfg, h["plant_in"], d,
                                                    self.dt)
            calls.append((h["plant_in"]["reactor"], carries, leads, h["k"],
                          h))
        if "fresh" in self.host:
            h = self.host["fresh"]
            t0 = h["k"] * self.n_steps * self.dt
            calls.append((h["plant_in"]["reactor"],
                          I.initial_carries(cfg, sp, n, t0=t0), none, h["k"],
                          h))
        return calls


def spans_of(config) -> np.ndarray:
    """Each instrument's span (``max - min``)."""
    sp = I.sensor_params(config)
    return np.array([p["max_value"] - p["min_value"] for p in sp])


def reference_plant_inputs(config, host_plant, d, dt):
    """Carries and line lead-ins for the reference from the program's
    plant (host copies): ``host_plant`` holds ``reactor`` and per
    instrument ``(fields, ring)``."""
    carries, leads = [], []
    t0 = host_plant["reactor"]["time"]
    for ins, (flat, ring) in zip(config["instruments"],
                                 host_plant["carries"]):
        carries.append(flat)
        leads.append(I.lead_in(ring, I.line_delay_s(config), d, t0, dt)
                     if ins.get("sample_line") and d > 0 else None)
    return carries, leads


def batched_inputs(calls, d: int, n: int) -> tuple:
    """The reference's ``state``, ``carries`` and ``leads`` of the calls
    ``(state, carries, leads, ...)`` side by side, ``n`` plants each."""
    state = {k: np.concatenate([c[0][k] for c in calls])
             for k in ("pH", "chlorine", "temperature", "time")}
    carries = [{k: np.concatenate([c[1][i][k] for c in calls])
                for k in calls[0][1][i]} for i in range(len(calls[0][1]))]
    leads = [None if all(c[2][i] is None for c in calls) else
             np.concatenate([c[2][i] if c[2][i] is not None else
                             np.full((d, n), math.nan) for c in calls],
                            axis=1) for i in range(len(calls[0][2]))]
    return state, carries, leads


def side(out: dict) -> dict:
    """A reference rollout's outputs in the form the comparison takes:
    ``state``, ``values`` ``[n_rec, K, B]``, ``faults`` (the same) and
    per instrument the final carry's ``codes`` (status, fault) and the last
    read's ``status``."""
    return dict(state=out["state"], values=out["values"],
                faults=out["faults"], status=out["status"],
                codes=[(c["status"], c["fault"]) for c in out["carries"]])


def program_side(cfg, hosts) -> dict:
    """The program's kept calls (host copies) in ``side``'s form."""
    return dict(
        state={k: np.concatenate([h["plant_out"]["reactor"][k]
                                  for h in hosts]) for k in PH.FIELDS},
        values=np.concatenate([h["values"] for h in hosts], axis=-1),
        faults=np.concatenate([h["faults"] for h in hosts], axis=-1)
        if "faults" in hosts[0] else None,
        codes=[tuple(np.concatenate([h["plant_out"]["carries"][i][0][f]
                                     for h in hosts])
                     for f in ("status", "fault"))
               for i in range(len(cfg["instruments"]))])


def plant_numbers(cfg, prog: dict, ref: dict, first: int) -> dict:
    """Gaps of the final state and of the readings: the widest of the
    pH instruments' (in pH) and of the others' (as shares of each
    instrument's span), the median of all (as shares); and the count of
    mismatched codes: readings NaN on one side only, the final carries'
    status and fault."""
    spans = spans_of(cfg)[None, :, None]
    pv, rv = prog["values"], ref["values"]
    codes = int(np.sum(np.isnan(pv) != np.isnan(rv)))
    both = ~np.isnan(pv) & ~np.isnan(rv)
    diff = np.where(both, np.abs(pv - rv), 0.0)
    ph = np.array([i["kind"] == "ph" for i in cfg["instruments"]])
    for (ps, pf), (rs, rf) in zip(prog["codes"], ref["codes"]):
        codes += int(np.sum(ps != rs)) + int(np.sum(pf != rf))
    return dict(state_gaps(prog["state"], ref["state"], first),
                ph_reading_gap=float(diff[:, ph].max(initial=0.0)),
                reading_gap=float((diff / spans)[:, ~ph].max(initial=0.0)),
                reading_gap_p50=float(np.median((diff / spans)[both]))
                if both.any() else 0.0,
                readings_compared=float(np.sum(both)),
                code_mismatches=float(codes))
