#!/usr/bin/env python3
"""What one derivative evaluation of kernels B1/B2 costs on the card, and
what the compiler made of it.

    python3 tools/torch_rollout_probe.py [--lib PATH]

1. Builds ``tools/torch_rollout_probe.cu`` (B1's physics and shared-memory
   exchange for one 20-zone plant, with clock64() stamps; the package's
   nvcc flags) and runs it in a block of 32 threads (one warp) and of 240
   (B1's block of twelve 20-zone plants, the layout B1 gave a batch of
   one before its geometry was sized by the batch): cycles per RK4
   substep unstamped, and the cycles of each part of an evaluation
   stamped (median over the recorded substeps).
2. Times B1 itself on the same plant (1 x 20, RK4, CUDA events) and
   converts to cycles per evaluation with the clock rate the probe's
   unstamped run shows (its cycles over its event time).
3. Runs the one-warp evaluation three ways: with IEEE divisions, with
   every division by ``fused_rollout.cuh::div_fast`` and no check at all
   (the ceiling), and as the kernels ship it (the header's ``deriv``: the
   plant's window check, one uniform branch an evaluation); cycles per
   evaluation of each and whether each plant's run is bit-equal to the
   IEEE one. Counts, over random operand pairs, where ``div_fast`` differs
   from a / b; then times a dependent chain of IEEE divisions by dividend
   (one, 1e-14 and zero over the divisors the kernels see), plain and
   through ``fused_rollout.cuh::div_rn``.
4. Reads the SASS of the fused-rollout library (``cuobjdump -sass``): per
   kernel, the instruction count, the opcodes that matter (MUFU, the
   division slow path's CALL, local memory LDL/STL, BAR, shared LDS/STS,
   SHFL) and the most frequent opcodes. ``--lib`` reads another build.

Prints the card's name and power limit; writes
chiprun_out/torch_rollout_probe.json and the SASS listing
chiprun_out/fused_rollout.sass. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_ZONES = 20
PROBE_ZONE = 10         # an interior zone: both interfaces, no sources
SUBSTEPS = 512
WARM = 64
PARTS = ("stage update", "clamps, density, h (exp)",
         "exchange: stores, barrier, loads", "two interface rates",
         "three stencils", "speciation, beta, 1/(beta ln10), dpH",
         "chlorine (exp)", "temperature")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build_probe(out_dir: Path) -> Path:
    from ics_wt_physicsengine_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libwt_probe.so"
    src = Path(ROOT) / "tools" / "torch_rollout_probe.cu"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(lib), str(src)], capture_output=True, text=True)
    print(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the probe")
    return lib


def sass_summary(lib: Path, dump: Path) -> dict:
    """Per kernel in ``lib``: instruction count and opcode histogram; the
    whole SASS listing goes to ``dump``."""
    from ics_wt_physicsengine_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    dump.write_text(text)
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and name:
            kernels[name][m.group(1)] += 1
    out = {}
    for name, ops in kernels.items():
        def count(prefix):
            return sum(n for op, n in ops.items() if op.startswith(prefix))
        out[name] = dict(
            instructions=sum(ops.values()) - ops["NOP"],
            mufu=count("MUFU"), call=count("CALL"), ret=count("RET"),
            local=count("LDL") + count("STL"), bar=count("BAR"),
            shared=count("LDS") + count("STS"), shfl=count("SHFL"),
            fp32=count("FADD") + count("FMUL") + count("FFMA")
            + count("FMNMX") + count("FSETP") + count("FSEL"),
            fp64=count("DADD") + count("DMUL") + count("DFMA")
            + count("DSETP") + count("DMNMX"),
            top=ops.most_common(12))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--lib", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_rollout_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    from ics_wt_physicsengine_torch.ops import _build
    from ics_wt_physicsengine_torch.ops import fused_rollout as F
    from ics_wt_physicsengine_torch.ops import kernel_checks as K

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    lib = ctypes.CDLL(str(build_probe(Path(ROOT) / "dist" / "probe" /
                                      "rollout_probe")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wt_probe.argtypes = [i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i32,
                             i32, i32, i32, ctypes.c_double, ptr, ptr, ptr]
    lib.wt_probe.restype = i32

    ptab, btab, (ph, cl, t) = K.tables(N_ZONES, 1, torch.float32, dev)
    m = 3
    h_step = 1.0 / m
    report = dict(card=card, substeps=SUBSTEPS - WARM, probes={})

    def probe(stamp, threads, mode=0, state=None):
        out = torch.zeros((SUBSTEPS - WARM, len(PARTS)), dtype=torch.int64,
                          device=dev)
        state = torch.empty(3 * N_ZONES, device=dev) if state is None \
            else state
        err = lib.wt_probe(stamp, mode, threads, ptab.data_ptr(),
                           btab.data_ptr(),
                           ph.data_ptr(), cl.data_ptr(), t.data_ptr(),
                           N_ZONES, SUBSTEPS, WARM, PROBE_ZONE, h_step,
                           out.data_ptr(), state.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe launch failed ({err})")
        return out

    clock_ghz = None
    for threads in (32, 240):
        probe(0, threads)                                    # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        whole = probe(0, threads)
        end.record()
        torch.cuda.synchronize()
        substep = float(whole[:, 0].double().median())
        ms = start.elapsed_time(end)
        # the recorded substeps cover (SUBSTEPS - WARM) / SUBSTEPS of the run
        ghz = float(whole[:, 0].double().sum()) / (
            ms * 1e6 * (SUBSTEPS - WARM) / SUBSTEPS)
        clock_ghz = clock_ghz or ghz
        parts = probe(1, threads).double().median(dim=0).values.tolist()
        row = dict(threads=threads, substep_cycles=substep,
                   evaluation_cycles=substep / 4, event_ms=ms,
                   implied_clock_ghz=ghz,
                   stamped_parts_per_evaluation={
                       name: (c / 3 if k == 0 else c / 4)
                       for k, (name, c) in enumerate(zip(PARTS, parts))})
        row["stamped_sum_per_evaluation"] = sum(
            row["stamped_parts_per_evaluation"].values())
        report["probes"][str(threads)] = row
        print(f"{threads} threads: {substep / 4:.0f} cycles per evaluation "
              f"unstamped (substep {substep:.0f}; clock {ghz:.3f} GHz by "
              f"events); stamped parts per evaluation "
              + ", ".join(f"{k} {v:.0f}" for k, v in
                          row["stamped_parts_per_evaluation"].items())
              + f"; sum {row['stamped_sum_per_evaluation']:.0f}", flush=True)

    # the evaluation with IEEE divisions (mode 0), with every division by
    # div_fast and no check (1: the ceiling) and as shipped (2): what the
    # branch regions cost, what the shipped check keeps of it, and whether
    # the plant's run stays bit-equal
    modes = {0: "IEEE", 1: "unchecked div_fast", 2: "shipped"}
    states = {mode: torch.empty(3 * N_ZONES, device=dev) for mode in modes}
    fast_rows = {}
    for mode in modes:
        probe(0, 32, mode, states[mode])                     # warm-up
        whole = probe(0, 32, mode, states[mode])
        torch.cuda.synchronize()
        fast_rows[mode] = float(whole[:, 0].double().median()) / 4
    parts = probe(1, 32, 1).double().median(dim=0).values.tolist()
    equal = {modes[m]: torch.equal(states[0], states[m]) for m in (1, 2)}
    report["fast_division"] = dict(
        evaluation_cycles=fast_rows[1], ieee_evaluation_cycles=fast_rows[0],
        shipped_evaluation_cycles=fast_rows[2], state_bit_equal=equal,
        stamped_parts_per_evaluation={
            name: (c / 3 if k == 0 else c / 4)
            for k, (name, c) in enumerate(zip(PARTS, parts))})
    print("divisions, 32 threads, cycles per evaluation: "
          + ", ".join(f"{modes[m]} {fast_rows[m]:.0f}" for m in modes)
          + f"; state after {SUBSTEPS} substeps bit-equal to IEEE: {equal};"
          " unchecked stamped "
          + ", ".join(f"{k} {v:.0f}" for k, v in report["fast_division"][
              "stamped_parts_per_evaluation"].items()), flush=True)
    lib.wt_div_check.argtypes = [ptr, ptr, ctypes.c_longlong, ptr, ptr]
    lib.wt_div_check.restype = i32
    gen = torch.Generator(device=dev).manual_seed(0)
    n_pairs = 1 << 24
    checks = {}
    for label, (lo_a, hi_a, lo_b, hi_b) in (
            ("kernel range: a 1e-30..1e4, b 1e-20..1e4",
             (-30, 4, -20, 4)),
            ("exponents -100..100", (-30.1, 30.1, -30.1, 30.1)),
            ("exponents -126..127", (-37.9, 38.2, -37.9, 38.2))):
        a = 10.0 ** (torch.rand(n_pairs, generator=gen, device=dev,
                                dtype=torch.float64) * (hi_a - lo_a) + lo_a)
        b = 10.0 ** (torch.rand(n_pairs, generator=gen, device=dev,
                                dtype=torch.float64) * (hi_b - lo_b) + lo_b)
        a, b = a.float(), b.float()
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        if lib.wt_div_check(a.data_ptr(), b.data_ptr(), n_pairs,
                            count.data_ptr(),
                            torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("division check launch failed")
        torch.cuda.synchronize()
        checks[label] = int(count[0])
        print(f"div_fast against a / b, {n_pairs} random pairs, {label}: "
              f"{int(count[0])} differ", flush=True)
    report["fast_division"]["mismatches"] = checks

    # one IEEE division, by its dividend (k_iface divides g drho dz, zero
    # where two densities are equal, by rho_avg u^2 ~ 2.8e-5)
    lib.wt_div_probe.argtypes = [ctypes.c_float, ctypes.c_float, i32, i32,
                                 ptr, ptr, ptr]
    lib.wt_div_probe.restype = i32
    report["division_cycles"] = {}
    n_div = 4096
    for a, b, guard in ((1.0, 2.8e-5, 0), (1e-14, 2.8e-5, 0),
                        (0.0, 2.8e-5, 0), (0.0, 2.8e-5, 1),
                        (1.0, 2.8e-5, 1), (0.0, 60.0, 0), (0.0, 60.0, 1)):
        out = torch.zeros(1, dtype=torch.int64, device=dev)
        sink = torch.zeros(1, device=dev)
        for _ in range(2):
            if lib.wt_div_probe(a, b, n_div, guard, out.data_ptr(),
                                sink.data_ptr(),
                                torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("division probe launch failed")
        torch.cuda.synchronize()
        cycles = float(out[0]) / n_div
        key = f"{a:g} / {b:g}" + (" (div_rn)" if guard else "")
        report["division_cycles"][key] = cycles
        print(f"division {key}: {cycles:.1f} cycles a link (with a multiply"
              " and an add)", flush=True)

    # B1 itself on the same plant, as the package launches it
    n_steps = 4096
    kw = dict(dt=1.0, substeps=m, n_steps=n_steps, stages=None)
    F.rollout_kernel(ptab, btab, ph, cl, t, **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    F.rollout_kernel(ptab, btab, ph, cl, t, **kw)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    per_eval_ns = ms * 1e6 / (n_steps * m * 4)
    report["b1_single_plant"] = dict(
        steps=n_steps, ms=ms, ns_per_evaluation=per_eval_ns,
        cycles_per_evaluation=per_eval_ns * clock_ghz)
    print(f"B1 1 x 20 x {n_steps} RK4 3x4: {ms:.3f} ms, {per_eval_ns:.1f} ns"
          f" = {per_eval_ns * clock_ghz:.0f} cycles per evaluation",
          flush=True)

    out_dir = Path(ROOT) / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = args.lib or _build.build()["fused_rollout"]
    report["sass"] = sass_summary(path, out_dir / "fused_rollout.sass")
    for name, s in report["sass"].items():
        print(f"SASS {name[:70]}: {s['instructions']} instructions, MUFU "
              f"{s['mufu']}, CALL {s['call']}, LDL/STL {s['local']}, BAR "
              f"{s['bar']}, LDS/STS {s['shared']}, SHFL {s['shfl']}, FP32 "
              f"{s['fp32']}, FP64 {s['fp64']}; top {s['top'][:8]}")

    with open(out_dir / "torch_rollout_probe.json", "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
