#!/usr/bin/env python3
"""chip_smoke.py's surrogate phases alone, in a fresh process, on one CUDA
card.

    python3 tools/torch_surrogate_probe.py

Runs the block of chip_smoke.py between ``# ---- 5n-5q.`` and
``# ---- 6.`` (SURR-INFER-65536, SURR-TRAIN-2048, SURR-MPC-6 and the
checkpoints on the card) with chip_smoke.py's own helpers and sizes, and
nothing before it: torch.profiler then sees one step's every kernel, which
it does not after the whole script's earlier phases. Prints the phases'
lines and the card's name and power limit; writes
chiprun_out/torch_surrogate_probe.json. Exits non-zero without a CUDA card
or when a check fails.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import textwrap
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_surrogate_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.ops import fused_plant as FP
    from ics_wt_physicsengine_torch.ops import fused_rollout as F
    from ics_wt_physicsengine_torch.ops import kernel_checks as K
    from ics_wt_physicsengine_torch.ops import ph_solver as PS

    torch.backends.cuda.matmul.allow_tf32 = False
    card = CS.card_line()
    print(f"== card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    block = textwrap.dedent(src[src.index("    # ---- 5n-5q."):
                                src.index("    # ---- 6. float32")])

    def kernel_counts():
        return {**F.LAUNCHES, **FP.LAUNCHES, **PS.LAUNCHES}

    def reset_kernel_counts():
        for module in (F, FP, PS):
            module.reset_launch_counts()

    def no_kernel(what, counts):
        CS.check(not any(counts.values()),
                 f"{what}: no B1-B4 launch in the window ({counts})")

    env = dict(
        np=np, os=os, tempfile=tempfile, time=time, torch=torch, R=R, K=K,
        dev=torch.device("cuda"), f32=torch.float32, HBM_RATE=K.HBM_RATE,
        report=CS.report, check=CS.check, phase=CS.phase, timed=CS.timed,
        step_profile=CS.step_profile, kernel_breakdown=CS.kernel_breakdown,
        fmt=CS.fmt, kernel_counts=kernel_counts,
        reset_kernel_counts=reset_kernel_counts, no_kernel=no_kernel,
        SURR_INFER=CS.SURR_INFER, SURR_TRAIN_STEPS=CS.SURR_TRAIN_STEPS,
        SURR_FIT=CS.SURR_FIT, SURR_MINUTES=CS.SURR_MINUTES)
    exec(compile(block, "chip_smoke.py (phases 5n-5q)", "exec"), env)
    CS.report["card"] = card
    CS.report["failures"] = CS.failures
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_surrogate_probe.json"), "w") as f:
        json.dump(CS.report, f, indent=1, default=str)
    print(card)
    return 1 if CS.failures else 0


if __name__ == "__main__":
    sys.exit(main())
