"""
The surrogate at bench.py's shapes (``bench_surrogate``), built the same way
on any device, so that the CUDA card can be held against the CPU
(``chip_smoke.py`` and ``tests/test_torch_gpu.py``): bench.py's random
network with its output layer un-zeroed and its statistics, a batch of
states and a control sequence. The draws are made on the CPU from a seed and
then moved, so every device gets the same numbers.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ics_wt_physicsengine_torch.control.ekf import _flat_bounds
from ics_wt_physicsengine_torch.models import surrogate as SG

F32 = torch.float32
CPU = torch.device("cpu")
# the largest error, as a share of x_std, of the card against the CPU
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


def bench_params(n_zones: int = 6, hidden: Sequence[int] = (128, 128),
                 m: int = 1, seed: int = 0, r_scale: float = 0.0,
                 device=CPU) -> SG.SurrogateParams:
    """bench.py's network: LeCun-normal layers, the output layer 0.01 x a
    normal draw; its statistics (pH | Cl | T means 7, 2, 20 and spreads
    0.7, 1, 5). ``r_std`` is bench.py's 1e-2, or ``r_scale * x_std`` when
    ``r_scale`` is given (a residual as large as the state's spread, which
    shows every difference of the MLP at full scale)."""
    n = 3 * n_zones
    g = torch.Generator().manual_seed(seed)
    ws = list(SG._init_mlp((n + m, *hidden, n), g, CPU))
    ws[-2] = 0.01 * torch.randn(ws[-2].shape, generator=g, dtype=F32)
    rep = lambda a, b, c: torch.tensor([a, b, c], dtype=F32) \
        .repeat_interleave(n_zones)
    x_std = rep(0.7, 1.0, 5.0)
    lo, hi = _flat_bounds(n_zones, False, False, False, 0, F32, CPU)
    sp = SG.SurrogateParams(
        weights=tuple(ws), x_mean=rep(7.0, 2.0, 20.0), x_std=x_std,
        u_scale=torch.ones(m), r_mean=torch.zeros(n),
        r_std=r_scale * x_std if r_scale else torch.full((n,), 1e-2),
        lo=lo, hi=hi)
    return sp.to(device)


def bench_inputs(sp: SG.SurrogateParams, n_batch: int, n_steps: int,
                 seed: int = 1, device=CPU):
    """bench.py's states ``x_mean + 0.3 x_std N(0, 1)`` ``[n_batch, n]``
    and controls ``0.5 U(0, 1)`` ``[n_steps, m]``."""
    g = torch.Generator().manual_seed(seed)
    n, m = sp.x_mean.shape[0], sp.u_scale.shape[0]
    x0 = sp.x_mean.cpu() + 0.3 * sp.x_std.cpu() * torch.randn(
        (n_batch, n), generator=g, dtype=F32)
    us = 0.5 * torch.rand((n_steps, m), generator=g, dtype=F32)
    return x0.to(device), us.to(device)


def step_flops(sp: SG.SurrogateParams, n_batch: int) -> int:
    """Multiply-adds x 2 of one step's three products."""
    return 2 * n_batch * sum(int(w.shape[0]) * int(w.shape[1])
                             for w in sp.weights[0::2])


def card_vs_cpu(device, n_batch: int = 4096, n_steps: int = 8
                ) -> Dict[str, float]:
    """The largest error, as a share of ``x_std``, of ``device`` against
    the CPU, with float32 and with bfloat16 products (on both, bfloat16
    operands multiplied in float32): one step of a residual as large as the
    state's spread (``r_scale=1``: the MLP's every difference at full
    scale), and an ``n_steps`` rollout of bench.py's network (the
    inference cell's; at full scale a rollout compounds the summation
    order's differences step after step)."""
    full, bench = bench_params(r_scale=1.0), bench_params()
    x0, us = bench_inputs(full, n_batch, n_steps)
    x0_d, us_d = x0.to(device), us.to(device)
    out = {}
    with torch.no_grad():
        for cd in (torch.float32, torch.bfloat16):
            name = str(cd).replace("torch.", "")
            for what, sp, fn in (
                    ("step", full, lambda p, x, u: SG.surrogate_step(
                        p, x, u[0], cd)),
                    ("rollout", bench, lambda p, x, u: SG.surrogate_rollout(
                        p, x, u, cd))):
                a = fn(sp.to(device), x0_d, us_d).cpu()
                b = fn(sp, x0, us)
                out[f"{what} {name}"] = float(((a - b).abs()
                                               / sp.x_std).max())
    return out
