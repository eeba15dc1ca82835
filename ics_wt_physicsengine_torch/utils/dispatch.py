"""
Broadcasting helper shared by the physics formulas.

Host-side construction (``make_params``, ``make_initial_state``) runs the
formulas in float64 NumPy, exactly as the JAX package does, so parameters
and initial states match it bit for bit; the hot path runs the same formulas
on torch tensors.
"""

from __future__ import annotations

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
