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
