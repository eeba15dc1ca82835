"""
Broadcasting and division helpers shared by the physics and sensor formulas.

Host-side construction (``make_params``, ``make_initial_state``) runs the
formulas in float64 NumPy, exactly as the JAX package does, so parameters
and initial states match it bit for bit; the hot path runs the same formulas
on torch tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


def align_trailing(c, like):
    """Right-pad ``c`` with singleton axes until it broadcasts against
    ``like`` by *leading* (batch) axes: per-plant ``[B]`` scalars against
    ``[B, Z]`` zone arrays become ``[B, 1]``. 0-d and equal-rank arrays
    pass through unchanged.

    On the NumPy path a Python scalar becomes a float64 0-d array, as
    ``np.asarray`` makes it in the JAX package's host path, so float32
    host formulas promote to float64 exactly where the reference's do. On
    the torch path it stays a Python scalar, which, like JAX's weakly typed
    scalars, takes the tensor's dtype."""
    if isinstance(like, torch.Tensor) or isinstance(c, torch.Tensor):
        if not isinstance(c, torch.Tensor):
            return c
    else:
        c = np.asarray(c)
    like_ndim = getattr(like, "ndim", 0)
    while c.ndim and c.ndim < like_ndim:
        c = c[..., None]
    return c


def ieee_div(x: torch.Tensor, k: float) -> torch.Tensor:
    """``x / k`` as an IEEE division. On a CUDA tensor PyTorch divides by a
    Python scalar by multiplying with its reciprocal, which can round one
    ulp away from the JAX package's (and the CUDA kernels') true division."""
    return x / torch.full_like(x, k)


# 0-d bound tensors, one per (value, dtype, device): made once, so a clip
# launches no fill kernel and copies nothing from the host after first use
_BOUNDS: dict = {}


def constant(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype and device, made once per
    value (tensors pass through)."""
    if isinstance(v, torch.Tensor):
        return v
    key = (float(v), like.dtype, like.device)
    b = _BOUNDS.get(key)
    if b is None:
        b = _BOUNDS[key] = torch.tensor(float(v), dtype=like.dtype,
                                        device=like.device)
    return b


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` (``lo`` or ``hi`` None: ``jnp.maximum`` /
    ``jnp.minimum``) built from ``torch.maximum`` then ``torch.minimum``.
    Its values equal ``torch.clip``'s bit for bit; its gradient follows
    JAX's tie rule, half the tangent where ``x`` sits on a bound, where
    ``torch.clip`` and ``torch.clamp`` pass all of it."""
    if lo is not None:
        x = torch.maximum(x, constant(lo, x))
    if hi is not None:
        x = torch.minimum(x, constant(hi, x))
    return x


def nonneg(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0.0)``: ``clip(x, 0.0)``."""
    return torch.maximum(x, constant(0.0, x))


def absolute(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs(x)`` with its gradient of 1 at 0 (``torch.abs`` has 0)."""
    return torch.where(x >= 0, x, -x)


def filled(x, shape, dtype, device) -> torch.Tensor:
    """``x`` (a number, a NumPy array or a tensor) broadcast to a ``shape``
    tensor of ``dtype`` on ``device``; a number becomes a fill on the
    device, not a copy from the host."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(x, dtype=dtype, device=device) \
            .broadcast_to(shape)
    return torch.full(shape, float(x), dtype=dtype, device=device)


def map_tensors(fn, obj):
    """``obj`` with ``fn`` applied to every tensor leaf: dataclasses are
    rebuilt field by field, dictionaries value by value; ``None`` and Python
    values (zone counts, sensor types) pass through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: map_tensors(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    return obj


def tensor_leaves(obj):
    """Every tensor of ``obj`` (dataclasses field by field, mappings value
    by value, sequences item by item), in order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensor_leaves(getattr(obj, f.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensor_leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensor_leaves(v)


def checkpointed(fn, *args, generator=None):
    """``fn(*args, generator=generator)`` under ``torch.utils.checkpoint``
    (``jax.checkpoint`` of a scan body): reverse mode keeps the inputs and
    recomputes ``fn`` in the backward pass. The checkpoint replays the
    global generators; a caller's ``generator`` is advanced by the forward
    pass, and the recomputation draws from a copy of its state at the
    call's start, so both passes see the same noise."""
    start = None if generator is None else generator.get_state()
    calls = []

    def run(*a):
        g = generator
        if calls and generator is not None:          # the recomputation
            g = torch.Generator(device=generator.device)
            g.set_state(start)
        calls.append(None)
        return fn(*a, generator=g)

    return checkpoint(run, *args, use_reentrant=False)
