"""
A small functional Adam and global-norm clip, in the order of operations of
``optax.adam`` and ``optax.clip_by_global_norm``, which the JAX package's
tuner, MPC and MHE use (``control/tuning.py``, ``mpc.py``, ``mhe.py``).

``torch.optim.Adam`` rounds in another order (and updates in place), so
the port keeps its own:

    mu    = (1 - b1) g + b1 mu
    nu    = (1 - b2) g^2 + b2 nu
    mu^   = mu / (1 - b1^t),   nu^ = nu / (1 - b2^t)
    step  = -lr * mu^ / (sqrt(nu^ + eps_root) + eps)

over a list of tensors (the optimized leaves, in a fixed order).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass
class AdamState:
    count: int                       # updates taken
    mu: List[torch.Tensor]           # first moments
    nu: List[torch.Tensor]           # second moments


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(count=0,
                     mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params])


def clip_by_global_norm(updates: Sequence[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """Every update scaled by ``max_norm / ||updates||`` when the global
    L2 norm is at or above ``max_norm`` (``optax.clip_by_global_norm``);
    decided on the device, without a host sync."""
    g_norm = torch.sqrt(sum(torch.sum(u * u) for u in updates))
    keep = g_norm < max_norm
    return [torch.where(keep, u, (u / g_norm.to(u.dtype)) * max_norm)
            for u in updates]


def adam_update(updates: Sequence[torch.Tensor], state: AdamState,
                learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, eps_root: float = 0.0,
                max_norm: Optional[float] = None
                ) -> Tuple[List[torch.Tensor], AdamState]:
    """One Adam update of ``updates`` (the gradients), after a global-norm
    clip at ``max_norm`` when it is given (``optax.chain(
    optax.clip_by_global_norm(max_norm), optax.adam(learning_rate))``).
    Returns the steps to add to the parameters and the new state."""
    if max_norm is not None:
        updates = clip_by_global_norm(updates, max_norm)
    count = state.count + 1
    mu = [(1 - b1) * g + b1 * m for g, m in zip(updates, state.mu)]
    nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(updates, state.nu)]
    c1 = 1 - b1 ** count
    c2 = 1 - b2 ** count
    steps = [-learning_rate * ((m / c1) / (torch.sqrt(v / c2 + eps_root)
                                            + eps))
             for m, v in zip(mu, nu)]
    return steps, AdamState(count=count, mu=mu, nu=nu)


def apply_updates(params: Sequence[torch.Tensor],
                  steps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [p + s for p, s in zip(params, steps)]
