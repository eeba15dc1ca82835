"""
The program's objects as plain NumPy data for the reference and the
comparisons: a reactor state's fields, an instrument carry's fields
(its base pipeline's and its overlay's, one flat dict), its sample-line
ring.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass

import numpy as np

RING = ("line_values", "line_times", "line_count", "line_ptr")


def host(x) -> np.ndarray:
    """A tensor (or number) as a NumPy array, float64 for floats."""
    a = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def reactor(state, index=None) -> dict:
    """``pH``, ``chlorine``, ``temperature`` ``[B, Z]`` and ``time``
    ``[B]`` of a reactor state, at plants ``index`` (None: an unbatched
    plant, as a batch of one)."""
    out = {}
    for name in ("pH", "chlorine", "temperature"):
        a = host(getattr(state, name))
        out[name] = a[None] if a.ndim == 1 else a[index]
    t = host(state.time)
    out["time"] = np.broadcast_to(t, (len(out["pH"]),)).copy() \
        if t.ndim == 0 else t[index]
    return out


def carry(sensor_carry, index=None) -> tuple:
    """``(fields, ring)`` of an instrument's carry at plants ``index``:
    every leaf of its base carry and its overlay in one dict, and the
    sample-line ring's four fields."""
    flat, ring = {}, {}
    for f in fields(sensor_carry):
        v = getattr(sensor_carry, f.name)
        if is_dataclass(v):
            for g in fields(v):
                leaf = getattr(v, g.name)
                if leaf is None:
                    continue
                a = host(leaf)
                if index is not None:
                    a = a[index]
                elif g.name in RING[:2]:
                    a = a[None]
                else:
                    a = a.reshape(1)
                (ring if g.name in RING else flat)[g.name] = a
        elif v is not None:
            a = host(v)
            flat[f.name] = a[index] if index is not None else a.reshape(1)
    return flat, ring
