#!/usr/bin/env python3
"""
Long-horizon soak and checkpoint/resume of the PyTorch port, one JSON line.

    python tools/torch_soak.py [--device {cuda,cpu}] [--steps 1000000]
        [--plant-steps 2000] [--nitrogen-steps 2048] [--out FILE]

The port of ``tools/soak.py``: the same four phases, the same seven
self-judging checks, its JSON keys and its exit code (0 when every check
holds, 1 otherwise).

1. A ``--steps`` soak of the 20-zone plant (float32, RK4 at
   ``default_substeps``) through ``rollout_fused`` (kernel B1 on the card),
   in four segments, with ``core.reactor.conservation_metrics`` at each
   segment's end and the trajectory recorded about 64 times a segment.
2. Bare-physics checkpoint and resume: half the steps, ``save_pytree``,
   ``load_pytree`` into a template, the other half; bit-equal to the run
   with no checkpoint and to the segmented soak.
3. The instrumented plant (``plant_rollout``: physics and seven
   instruments, their noise drawn from a ``torch.Generator``) checkpointed
   at half of ``--plant-steps``, the generator a leaf of the checkpoint;
   the resumed run bit-equal to the one that never stopped, a NaN reading
   equal to a NaN.
4. The nitrogen plant (nine instruments, ``plant_rollout``: no kernel
   serves the extension axes) over ``--nitrogen-steps`` in four segments,
   with finiteness and species-bound audits, and its own checkpoint and
   resume over two segment lengths.

The card is the default; ``--device cpu`` runs the plain PyTorch paths
(there is no fallback to it). The nitrogen plant's plain step is slow, so
its horizon is cut from ``soak.py``'s ``--steps`` to ``--nitrogen-steps``
(and its resume from 1000 + 1000 steps to two segments); ``--plant-steps``
may cut the instrumented resume from 2000. Each cut is listed in
``reduced``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ics_wt_physicsengine_torch.bench import device_info  # noqa: E402
from ics_wt_physicsengine_torch.core import reactor as R  # noqa: E402
from ics_wt_physicsengine_torch.core.nitrogen import (  # noqa: E402
    total_nitrogen_mgN)
from ics_wt_physicsengine_torch.models import plant as P  # noqa: E402
from ics_wt_physicsengine_torch.ops.fused_rollout import (  # noqa: E402
    rollout_fused)
from ics_wt_physicsengine_torch.utils import checkpoint as ckpt  # noqa: E402

METRIC = "1M-step soak + checkpoint/resume e2e (20 zones, f32)"
F32 = torch.float32
BC = R.BoundaryConditions(
    inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
    inlet_temperature=26.0, acid_flow_rate=0.1,
    ambient_temperature=15.0, heat_loss_coefficient=50.0)
N_SEGMENTS = 4
# soak.py's instrumented resume and the nitrogen resume halves
PLANT_STEPS = 2000
NITROGEN_RESUME = 1000
# the nitrogen horizon: soak.py runs --steps; the plain nitrogen plant
# step is too slow for that on the card
NITROGEN_STEPS = 2048


def _log(msg):
    print(f"[soak] {msg}", file=sys.stderr, flush=True)


def state_equal(a: R.ReactorState, b: R.ReactorState) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        (a.pH, a.chlorine, a.temperature), (b.pH, b.chlorine, b.temperature)))


def trees_equal(a, b) -> bool:
    """Every tensor leaf equal, a NaN equal to a NaN; generators by
    state."""
    la, lb = ckpt.tree_leaves(a), ckpt.tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            if not torch.equal(x.get_state(), y.get_state()):
                return False
        elif x.shape != y.shape or x.dtype != y.dtype or not torch.equal(
                torch.nan_to_num(x, nan=0.0), torch.nan_to_num(y, nan=0.0)) \
                or not torch.equal(torch.isnan(x), torch.isnan(y)):
            return False
    return True


def resumed(tree, template, name: str):
    """``tree`` saved with ``save_pytree`` and read back into ``template``
    (a checkpoint round trip through a file)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}.npz")
        ckpt.save_pytree(path, tree, metadata={"name": name})
        return ckpt.load_pytree(path, template)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def soak(n_steps: int, device="cuda", plant_steps: int = PLANT_STEPS,
         nitrogen_steps: int = NITROGEN_STEPS, log=_log) -> dict:
    dev = torch.device(device)
    reduced = []
    config = R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                    n_zones=20)
    substeps = R.default_substeps(config, 1.0)
    params = R.make_params(config, dtype=F32, device=dev)
    state0 = R.make_initial_state(config, dtype=F32, device=dev)
    b1_calls = 0

    def b1(state, n, **kw):
        nonlocal b1_calls
        b1_calls += 1
        return rollout_fused(params, state, BC, dt=1.0, substeps=substeps,
                             n_steps=n, **kw)

    seg = n_steps // N_SEGMENTS
    rec_every = max(1, seg // 64)
    while seg % rec_every:        # record_every must divide the segment
        rec_every -= 1

    # -- phase 1: segmented soak, conservation audit, trajectories (a
    # warm-up segment first: the kernel builds at first use)
    w, _ = b1(state0, seg, record_every=rec_every)
    float(R.conservation_metrics(params, w)["total_chlorine_mg"])
    state = state0
    audits = []
    finite_ok = True
    cl0 = None
    traj_points = 0
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(N_SEGMENTS):
        state, traj = b1(state, seg, record_every=rec_every)
        m = R.conservation_metrics(params, state)
        total_cl = float(m["total_chlorine_mg"])
        charge = float(m["charge_balance_mol"])
        traj_points += traj["pH"].shape[0]
        finite_ok = finite_ok and all(bool(torch.isfinite(x).all()) for x in (
            traj["pH"], state.pH, state.temperature))
        if cl0 is None:
            cl0 = total_cl
        audits.append({"t": float(state.time),
                       "total_chlorine_mg": round(total_cl, 3),
                       "charge_balance_mol": charge})
    _sync(dev)
    elapsed = time.perf_counter() - t0
    log(f"phase 1: {N_SEGMENTS} x {seg} steps in {elapsed:.1f} s")
    final_soak_state = state

    # -- phase 2: bare-physics checkpoint and bit-exact resume
    half = n_steps // 2
    a = b1(state0, half)
    restored = resumed({"params": params, "state": a},
                       {"params": params, "state": a}, "soak_ckpt")
    b = rollout_fused(restored["params"], restored["state"], BC, dt=1.0,
                      substeps=substeps, n_steps=n_steps - half)
    b1_calls += 1
    # the oracle: the same halves with no checkpoint between them; the
    # segmented soak must match too (segmenting cannot change bits)
    c = b1(b1(state0, half), n_steps - half)
    resume_bitexact = state_equal(b, c)
    if N_SEGMENTS * seg == n_steps:
        resume_bitexact = resume_bitexact and state_equal(b, final_soak_state)
    log(f"phase 2: resume bit-exact {resume_bitexact}")

    # -- phase 3: the instrumented plant's checkpoint and resume (sensor
    # carries, delay rings and the noise generator)
    if plant_steps < PLANT_STEPS:
        reduced.append(dict(phase=3, cut="plant_steps", value=plant_steps,
                            soak_py=PLANT_STEPS))
    pparams, plant0 = P.make_plant(config, dtype=F32, device=dev)
    h = plant_steps // 2

    def roll(p, n, gen):
        return P.plant_rollout(pparams, p, BC, 1.0, substeps, n,
                               record=False, generator=gen)[0]

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    mid = {"plant": roll(plant0, h, gen), "generator": gen}
    back = resumed(mid, {"plant": mid["plant"],
                         "generator": torch.Generator(device=dev)},
                   "plant_ckpt")
    end_resumed = {"plant": roll(back["plant"], plant_steps - h,
                                 back["generator"]),
                   "generator": back["generator"]}
    gen_o = torch.Generator(device=dev).manual_seed(7)
    end_oracle = {"plant": roll(roll(plant0, h, gen_o), plant_steps - h,
                                gen_o),
                  "generator": gen_o}
    inst_ok = trees_equal(end_resumed, end_oracle)
    log(f"phase 3: {2 * plant_steps} plant steps in "
        f"{time.perf_counter() - t0:.1f} s, resume bit-exact {inst_ok}")

    # -- phase 4: the nitrogen plant (plain: the fused kernels refuse the
    # extension axes), four segments with finiteness and bounds audits,
    # and its own checkpoint and resume
    if nitrogen_steps < n_steps:
        reduced.append(dict(phase=4, cut="nitrogen_steps",
                            value=nitrogen_steps, soak_py=n_steps))
    n_cfg = R.ReactorConfiguration(
        volume=1000, height=2.0, diameter=0.798, n_zones=20,
        enable_nitrogen=True, initial_ammonia=1.0)
    n_bc = R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
        inlet_temperature=26.0, acid_flow_rate=0.1,
        ambient_temperature=15.0, heat_loss_coefficient=50.0,
        inlet_ammonia=1.0)
    np_params, nplant0 = P.make_plant(n_cfg, dtype=F32, device=dev)
    n_sub = R.default_substeps(n_cfg, 1.0)

    def nroll(p, n, g):
        return P.plant_rollout(np_params, p, n_bc, 1.0, n_sub, n,
                               record=False, generator=g)[0]

    n_seg = nitrogen_steps // N_SEGMENTS
    ngen = torch.Generator(device=dev).manual_seed(11)
    nstate = nplant0
    nitro_finite = True
    nitro_bounded = True
    nitro_audits = []
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(N_SEGMENTS):
        nstate = nroll(nstate, n_seg, ngen)
        r = nstate.reactor
        nitro_finite = nitro_finite and all(
            bool(torch.isfinite(x).all()) for x in (
                r.pH, r.chlorine, r.temperature, r.ammonia, r.nitrite,
                r.nitrate, r.chloramine))
        nitro_bounded = nitro_bounded and all(
            bool((x >= -1e-6).all() and (x < 100.0).all())
            for x in (r.ammonia, r.nitrite, r.nitrate, r.chloramine))
        nitro_audits.append({
            "t": float(r.time),
            "total_N_mgN_per_L_mean": round(float(total_nitrogen_mgN(
                r.ammonia, r.nitrite, r.nitrate, r.chloramine).mean()), 4),
            "ammonia_outlet": round(float(r.ammonia[-1]), 4)})
    _sync(dev)
    nitro_elapsed = time.perf_counter() - t0
    log(f"phase 4: {N_SEGMENTS} x {n_seg} nitrogen steps in "
        f"{nitro_elapsed:.1f} s")

    if n_seg < NITROGEN_RESUME:
        reduced.append(dict(phase=4, cut="nitrogen_resume_steps",
                            value=2 * n_seg, soak_py=2 * NITROGEN_RESUME))
    ngen = torch.Generator(device=dev).manual_seed(13)
    nmid = {"plant": nroll(nplant0, n_seg, ngen), "generator": ngen}
    nback = resumed(nmid, {"plant": nmid["plant"],
                           "generator": torch.Generator(device=dev)},
                    "nitro_ckpt")
    nitro_resume_ok = trees_equal(
        {"plant": nroll(nback["plant"], n_seg, nback["generator"]),
         "generator": nback["generator"]},
        {"plant": nroll(nmid["plant"], n_seg, ngen), "generator": ngen})

    drift_pct = 100.0 * (audits[-1]["total_chlorine_mg"] - cl0) / cl0
    # self-judging bounds: chlorine drift within 0.5% over the soak, every
    # trajectory and state finite, every resume bit-exact
    checks = {
        "drift_within_bounds": bool(abs(drift_pct) < 0.5),
        "trajectories_finite": bool(finite_ok),
        "resume_bitexact_physics": bool(resume_bitexact),
        "resume_bitexact_instrumented": bool(inst_ok),
        "nitrogen_finite": bool(nitro_finite),
        "nitrogen_species_bounded": bool(nitro_bounded),
        "resume_bitexact_nitrogen": bool(nitro_resume_ok),
    }
    return {
        "metric": METRIC,
        "soak_steps": n_steps,
        "soak_steps_per_sec": n_steps / elapsed,
        "traj_points_recorded": traj_points,
        "conservation_audit": audits,
        "chlorine_drift_pct_over_soak": round(drift_pct, 4),
        "nitrogen_soak_steps": N_SEGMENTS * n_seg,
        "nitrogen_steps_per_sec": N_SEGMENTS * n_seg / nitro_elapsed,
        "nitrogen_audit": nitro_audits,
        "plant_resume_steps": plant_steps,
        **checks,
        "ok": all(checks.values()),
        "backend": dev.type,
        "b1_calls": b1_calls,
        "reduced": reduced,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/torch_soak.py")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=1_000_000)
    ap.add_argument("--plant-steps", type=int, default=PLANT_STEPS,
                    help="the instrumented plant's resume horizon")
    ap.add_argument("--nitrogen-steps", type=int, default=NITROGEN_STEPS,
                    help="the nitrogen plant's horizon (four segments)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        result = {"metric": METRIC, "ok": False,
                  "reason": "the card was asked for: no CUDA device is "
                            "available"}
    else:
        dev = torch.device(args.device)
        result = soak(args.steps, dev, args.plant_steps, args.nitrogen_steps)
        result["device"] = device_info(dev)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
