#!/usr/bin/env python3
"""
Where kernel B3's time goes beyond its physics, on one CUDA card: the
port of ``tools/ablate_fused_plant.py``.

    python tools/torch_ablate_fused_plant.py [--steps 16384] [--reps 3]
        [--device cuda]

One 20-zone plant (volume 1000, height 2.0, diameter 0.798), RK4 at
``default_substeps``, float32, the Philox stream of seed 7 (the card's
``rng="hw"``), the readings recorded once at the end. Each variant below
is a copy of ``csrc/`` with one part of the sensor overlay taken out
(string replacements in ``ABLATIONS``, each matching once), built with the
shipped flags into ``dist/probe/`` (one nvcc process per variant, all
started together) and launched through the normal wrapper
``plant_rollout_fused`` with its library swapped in (``_build.use``), so
that each time difference is that part's cost inside the kernel:

  full        the shipped build: physics, 7 instruments, taps, Philox,
              sample lines, the carry store
  no_rand     no words and no Philox: normals 0, uniforms 0.5
  no_hist     the sample lines' circular histories skipped (tap used
              directly)
  no_store    the sensor lanes' end-of-launch carry store skipped (the
              lanes carry their state in registers: one store a launch)
  no_taps     every lane reads the pH of its plant's first zone in place
              of its own zone's pH, chlorine and temperature
  one_sensor  only sensor 0's lanes are active
  no_sensors  no sensor lane is active; they still meet every step's
              barrier with the physics warps (the hand-over the TPU kernel
              does not have)
  physics     B1 through ``rollout_fused`` on the same plant

Timed as the JAX tool times: whole wrapper calls, each fed the last
call's reactor state, after a warm-up (CUDA events; ``us_per_step``,
``subsystem_us``). The kernels alone on the same tables, B1 on B3's tables
for ``physics``, give ``kernel_us_per_step`` and ``kernel_subsystem_us``;
there B1 also runs in its packed layout (``physics_packed``: one plant on
one warp exchanging through shared memory at a barrier, as B3's physics
warp does, where the shipped B1 exchanges by warp shuffles), which splits
``no_sensors - physics`` into ``packed_exchange`` (packed B1 - B1) and
``block_coupling`` (``no_sensors`` - packed B1: the block barrier and tap
publish a step, and B3's register cap).

Before a time counts, every variant is checked on the card, over 256
steps recorded every step and on the timed runs: its
reactor state (pH, chlorine, temperature, clock) bit-equal to ``full``'s
(the overlay never feeds back into the physics); ``no_store``'s readings
bit-equal to ``full``'s; ``one_sensor``'s sensor-0 readings bit-equal to
``full``'s; ``no_rand``'s readings within ``kernel_checks.TOL`` of the
plain plant path (``models/plant.py::plant_step`` in a loop) fed the same
constant draws, NaN in the same places. That each edit removed work that
this plant does is checked too: its sample lines delay their taps (some
``d_max`` > 0); ``no_rand``'s, ``no_hist``'s (on the line sensors) and
``no_taps``' readings differ from ``full``'s; ``physics_packed`` launched
the packed layout where the shipped B1 takes another, and its result is
bit-equal to the shipped B1's. The shipped library is bound again at the
end, whatever happened.

Prints one JSON line (the JAX tool's keys, plus the card's name and power
limit under ``device``) and returns it from ``main``; exits non-zero when
a check fails or an edit does not match. The card is the default and the
only device: the variants are CUDA kernels, so ``--device cpu`` is
refused, as is a missing card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from ics_wt_physicsengine_torch.bench import device_info  # noqa: E402
from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402
from torch_b3_compare import nvcc_build, registers, timed  # noqa: E402
from torch_rollout_compare import ablated_sources  # noqa: E402

DT = 1.0
SEED = 7
# the JAX tool's order (ics_wt_physicsengine_tpu/ops/fused_plant.py's
# _ABLATE members after "full"); "physics" is B1
VARIANTS = ("full", "no_rand", "no_hist", "no_store", "no_taps",
            "one_sensor", "no_sensors")
PROBE = Path(ROOT) / "dist" / "probe" / "ablate_b3"

_ACTIVE = ("  const bool active = sensor < kSensors &&\n"
           "                      local_plant < a.plants_per_block && "
           "plant < batch;\n")
_TAPS = ("    const S ph_zone = in[0][tap_at];\n"
         "    const S cl_zone = in[1][tap_at];\n"
         "    const S t_zone = in[2][tap_at];\n")
_WORDS = """\
    uint32_t w[kMaxSensorWords];
    if (a.words != nullptr) {
      const uint32_t* src =
          a.words + (static_cast<int64_t>(step) * kWordsPerStep + word) *
                        batch + plant;
#pragma unroll
      for (int c = 0; c < kMaxSensorWords; ++c) {
        w[c] = c < n_words ? src[static_cast<int64_t>(c) * batch] : 0u;
      }
    } else {
      sensor_step_words(a.seed, a.step0 + static_cast<uint32_t>(step),
                        a.plant0 + static_cast<uint32_t>(plant), block,
                        n_blocks, skip, w);
    }
    S n[8], u[4];
    rand_from_words<S, 8, 3>(w, n, u);
    if (kind == kKindFlow) {
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = uniform_from_word<S>(w[6 + j]);
    }
"""
_CONSTANT_DRAWS = """\
    S n[8], u[4];
#pragma unroll
    for (int j = 0; j < 8; ++j) n[j] = S(0.0);
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = S(0.5);
"""
_STORE = ("  if (active) {\n    const int fcol = st.float_col[k];\n"
          "    store_base_carry(")

# One part of the sensor overlay taken out of a copy of csrc/ (file, text,
# replacement), the port's meaning of each JAX switch
# (ics_wt_physicsengine_tpu/ops/fused_plant.py:467-582).
ABLATIONS = {
    "no_rand": [("fused_plant.cu", _WORDS, _CONSTANT_DRAWS)],
    "no_hist": [("fused_plant.cu",
                 "    if (line >= 0) {\n      truth = delayed_tap(hist, "
                 "d_max, d, step, plant, batch, truth);\n    }\n", "")],
    "no_store": [("fused_plant.cu", _STORE,
                  _STORE.replace("if (active)", "if (false)"))],
    "no_taps": [("fused_plant.cu", _TAPS,
                 "    const S ph_zone = in[0][local_plant * a.n_zones];\n"
                 "    const S cl_zone = ph_zone;\n"
                 "    const S t_zone = ph_zone;\n")],
    "one_sensor": [("fused_plant.cu", _ACTIVE,
                    _ACTIVE.replace("sensor < kSensors", "sensor == 0"))],
    "no_sensors": [("fused_plant.cu", _ACTIVE,
                    "  const bool active = false;\n")],
}
# kernel_subsystem names (the JAX tool's subsystem_us), by the variant
# whose saving each is
SUBSYSTEMS = {"prng_conversion": "no_rand", "sample_line_hist": "no_hist",
              "carry_store": "no_store", "zone_taps": "no_taps",
              "six_extra_sensors": "one_sensor",
              "all_sensor_overlay": "no_sensors"}
STATE = ("pH", "chlorine", "temperature", "time")


def _log(msg):
    print(f"[ablate] {msg}", file=sys.stderr, flush=True)


def build_variants(log=_log) -> tuple:
    """Every ablated copy of ``csrc/`` built at once: ``({variant: library
    path}, {variant: nvcc log}, seconds)``."""
    from ics_wt_physicsengine_torch.ops import _build

    sources = {name: ablated_sources(_build.CSRC, PROBE / "src" / name,
                                     edits)
               for name, edits in ABLATIONS.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        jobs = {name: pool.submit(nvcc_build, src, ("fused_plant",),
                                  PROBE / "lib" / name, _build.NVCC_FLAGS)
                for name, src in sources.items()}
        built = {name: job.result()["fused_plant"]
                 for name, job in jobs.items()}
    seconds = time.perf_counter() - t0
    log(f"built {len(built)} ablated copies of fused_plant.cu in "
        f"{seconds:.1f} s")
    return ({n: path for n, (path, _) in built.items()},
            {n: text for n, (_, text) in built.items()}, seconds)


def _float32_rk4(log_text: str):
    """``(registers, spill bytes)`` of the float32 RK4 entry
    (``plant_kernel<float, false>``) in an nvcc -Xptxas -v log."""
    for kernel, regs, spills, _ in registers(log_text):
        if "plant_kernelIfLb0E" in kernel:
            return regs, spills
    return None


def _equal(a, b) -> bool:
    """Bit equality, NaN equal to NaN."""
    return a.shape == b.shape and bool(torch.equal(
        torch.isnan(a), torch.isnan(b))) and bool(torch.equal(
            torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)))


def _physics_equal(p, q) -> bool:
    return all(_equal(getattr(p.reactor, f), getattr(q.reactor, f))
               for f in STATE)


def _readings_equal(r, q, names) -> bool:
    return all(_equal(r[name], q[name]) for name in names)


def plain_constant_draws(params, plant, bc, substeps, n_steps):
    """``plant_step`` in a loop fed normals 0 and uniforms 0.5 (the widths
    of ``models/plant.py::_RAND_LAYOUT``): ``{sensor: [n_steps] readings}``
    and the final plant."""
    from ics_wt_physicsengine_torch.models import plant as P

    like = plant.reactor.pH
    rand = {name: (like.new_zeros((nn,)), like.new_full((nu,), 0.5))
            for name, nn, nu in P._RAND_LAYOUT}
    rows = []
    for _ in range(n_steps):
        plant, out = P.plant_step(params, plant, bc, DT, substeps, rand=rand)
        rows.append({k: v.value for k, v in out.items()})
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}, plant


def _max_err(a, b) -> float:
    d = torch.where(torch.isnan(a) | torch.isnan(b), torch.zeros_like(a),
                    (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def ablation_plant(device):
    """The JAX tool's plant: ``(config, substeps, bc, params, plant)``,
    float32."""
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.models import plant as P

    config = R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                    n_zones=20)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                              inlet_chlorine=0.5, acid_flow_rate=0.1)
    params, plant = P.make_plant(config, dtype=torch.float32, device=device)
    return config, R.default_substeps(config, DT), bc, params, plant


def line_sensors(tables) -> list:
    """The sensors whose sample line delays its tap in B3's ``tables``
    (``d_max`` > 0), by reading name."""
    from ics_wt_physicsengine_torch.ops import fused_plant as FP

    d_max = {attr: dm for attr, _, _, _, dm in tables.statics}
    return [name for name, attr, _ in FP.SENSORS if d_max[attr] > 0]


def ablate(device, n_steps=16384, reps=3, check_steps=256, log=_log) -> dict:
    """Build the variants, check each on the card, time them; the result
    dict ``main`` prints."""
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.ops import _build
    from ics_wt_physicsengine_torch.ops import fused_plant as FP
    from ics_wt_physicsengine_torch.ops import fused_rollout as F
    from ics_wt_physicsengine_torch.ops import kernel_checks as K

    f32 = torch.float32
    config, substeps, bc, params, plant = ablation_plant(device)
    names = [name for name, _, _ in FP.SENSORS]

    shipped = _build.load("fused_plant")
    paths, logs, build_s = build_variants(log)
    libs = {"full": shipped}
    libs.update({n: _build.bind("fused_plant", p) for n, p in paths.items()})
    logs["full"] = _build.build_info["fused_plant"]["log"]
    regs = {n: _float32_rk4(text) for n, text in logs.items()}

    def on(variant, fn):
        """``fn()`` with ``variant``'s library bound, the shipped one after."""
        _build.use({"fused_plant": libs[variant]})
        try:
            return fn()
        finally:
            _build.use({"fused_plant": shipped})

    def rollout(variant, start, steps, every):
        return on(variant, lambda: FP.plant_rollout_fused(
            params, start, bc, dt=DT, substeps=substeps, n_steps=steps,
            record_every=every, seed=SEED))

    checks = {}
    try:
        # ---- checks at check_steps, every step recorded -------------------
        short = {v: rollout(v, plant, check_steps, 1) for v in VARIANTS}
        full_p, full_r = short["full"]
        for v in VARIANTS[1:]:
            checks[f"{v}_physics_bit_equal"] = _physics_equal(short[v][0],
                                                              full_p)
        checks["no_store_readings_bit_equal"] = _readings_equal(
            short["no_store"][1], full_r, names)
        checks["one_sensor_sensor0_bit_equal"] = _readings_equal(
            short["one_sensor"][1], full_r, names[:1])
        plain_r, _ = plain_constant_draws(params, plant, bc, substeps,
                                          check_steps)
        no_rand_r = short["no_rand"][1]
        err = max(_max_err(no_rand_r[k], plain_r[k]) for k in names)
        nan_equal = all(torch.equal(torch.isnan(no_rand_r[k]),
                                    torch.isnan(plain_r[k])) for k in names)
        checks["no_rand_vs_plain_within_tol"] = err <= K.TOL[f32] \
            and nan_equal
        log(f"checks at {check_steps} steps: no_rand vs plant_step fed "
            f"constant draws max abs err {err:.3e} (tol {K.TOL[f32]:g}), "
            f"NaN equal {nan_equal}")
        # each edit that touches the readings changed them at this plant
        # (a path never taken here would time a build that removed
        # nothing): the sample lines delay their taps (d_max > 0), and
        # no_rand's, no_hist's and no_taps' readings differ from full's
        tables = FP.build_tables(params, plant, bc, dt=DT, n_steps=n_steps)
        lines = line_sensors(tables)
        checks["line_sensors_delayed"] = bool(lines)
        for v, touched in (("no_rand", names), ("no_hist", lines),
                           ("no_taps", names)):
            checks[f"{v}_readings_differ"] = bool(touched) and not \
                _readings_equal(short[v][1], full_r, touched)

        # ---- timed: whole calls, each fed the last reactor state ----------
        def chained(run):
            """``run(reactor) -> (plant, readings)``, warmed up, then
            ``reps`` calls each fed the last one's reactor state: mean ms
            and the last result."""
            last = [run(plant.reactor)]

            def again():
                last[0] = run(last[0][0].reactor)
                return last[0]
            return timed(again, reps)

        ms, timed_out = {}, {}
        for v in VARIANTS:
            ms[v], timed_out[v] = chained(
                lambda reactor, v=v: rollout(
                    v, dataclasses.replace(plant, reactor=reactor), n_steps,
                    n_steps))
            log(f"{v}: {1e3 * ms[v] / n_steps:.3f} us/step")
        rparams = R.make_params(config, dtype=f32, device=device)
        state = R.make_initial_state(config, dtype=f32, device=device)
        box = [F.rollout_fused(rparams, state, bc, dt=DT, substeps=substeps,
                               n_steps=n_steps)]

        def physics():
            box[0] = F.rollout_fused(rparams, box[0], bc, dt=DT,
                                     substeps=substeps, n_steps=n_steps)
            return box[0]
        ms["physics"], _ = timed(physics, reps)
        log(f"physics: {1e3 * ms['physics'] / n_steps:.3f} us/step")

        full_p, full_r = timed_out["full"]
        for v in VARIANTS[1:]:
            checks[f"{v}_physics_bit_equal_timed"] = _physics_equal(
                timed_out[v][0], full_p)
        checks["no_store_readings_bit_equal_timed"] = _readings_equal(
            timed_out["no_store"][1], full_r, names)
        checks["one_sensor_sensor0_bit_equal_timed"] = _readings_equal(
            timed_out["one_sensor"][1], full_r, names[:1])
        checks["full_state_finite"] = all(
            bool(torch.isfinite(getattr(full_p.reactor, f)).all())
            for f in STATE)

        # ---- the kernels alone on one plant's tables ----------------------
        kernel_ms = {}
        for v in VARIANTS:
            def run(v=v):
                return on(v, lambda: FP.plant_kernel(
                    tables, dt=DT, substeps=substeps, n_steps=n_steps,
                    record_every=n_steps, seed=SEED))
            run()
            kernel_ms[v], _ = timed(run, reps)
        y = (tables.ph, tables.cl, tables.t)
        physics_kernel = lambda: F.rollout_kernel(  # noqa: E731
            tables.ptab, tables.forcing, *y, dt=DT, substeps=substeps,
            n_steps=n_steps)
        warp_out = physics_kernel()
        kernel_ms["physics"], _ = timed(physics_kernel, reps)
        # B1 in the packed layout: one plant on one warp exchanging through
        # shared memory at a barrier, as B3's physics warp does. The
        # wrapper reads its geometry from the module, so the swap is
        # checked to have reached the launch, and the result to be B1's.
        geometry, used = F.rollout_geometry, []

        def packed(n_zones, batch):
            used.append(F.packed_geometry(n_zones, batch))
            return used[-1]
        F.rollout_geometry = packed
        try:
            packed_out = physics_kernel()
            kernel_ms["physics_packed"], _ = timed(physics_kernel, reps)
        finally:
            F.rollout_geometry = geometry
        checks["physics_packed_layout_launched"] = bool(used) and all(
            g.layout == F.PACKED for g in used) and geometry(
                config.n_zones, 1).layout != F.PACKED
        checks["physics_packed_bit_equal_to_warp"] = all(
            _equal(a, b) for a, b in zip(warp_out[:3], packed_out[:3]))
    finally:
        _build.use({"fused_plant": shipped})
    checks["shipped_library_bound_again"] = \
        _build.load("fused_plant") is shipped

    def us(t_ms):
        return round(1e3 * t_ms / n_steps, 3)

    def savings(times):
        full = us(times["full"])
        out = {name: round(full - us(times[v]), 3)
               for name, v in SUBSYSTEMS.items()}
        out["kernel_vs_physics_overhead"] = round(
            us(times["no_sensors"]) - us(times["physics"]), 3)
        return out

    result = {
        "ok": all(checks.values()),
        "backend": "cuda",
        "device": device_info(device),
        "n_steps": n_steps,
        "reps": reps,
        "check_steps": check_steps,
        "substeps": substeps,
        "physics_kernel_us_per_step": us(ms["physics"]),
        "physics_kernel_steps_per_sec": round(n_steps / (ms["physics"] / 1e3),
                                              1),
        "full_plant_us_per_step": us(ms["full"]),
        "full_plant_steps_per_sec": round(n_steps / (ms["full"] / 1e3), 1),
        "us_per_step": {v: us(ms[v]) for v in VARIANTS},
        # each ablation's saving = that subsystem's in-kernel cost
        "subsystem_us": savings(ms),
        "kernel_us_per_step": {v: us(t) for v, t in kernel_ms.items()},
        "kernel_subsystem_us": dict(
            savings(kernel_ms),
            packed_exchange=round(us(kernel_ms["physics_packed"])
                                  - us(kernel_ms["physics"]), 3),
            block_coupling=round(us(kernel_ms["no_sensors"])
                                 - us(kernel_ms["physics_packed"]), 3)),
        "build_seconds": round(build_s, 1),
        "registers_spills_f32_rk4": regs,
        "checks": checks,
    }
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="tools/torch_ablate_fused_plant.py",
                                 description=__doc__.strip().split("\n")[0])
    ap.add_argument("--steps", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default and only choice: the CUDA "
                         "card)")
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    if device.type != "cuda":
        raise SystemExit(f"--device {args.device}: the ablated builds are "
                         "CUDA kernels of B3, which have no CPU mode; run "
                         "this tool on the card")
    result = ablate(device, args.steps, args.reps)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
