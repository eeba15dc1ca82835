"""
The one generator of the traffic mixes' commands. A traffic file's
``commands`` maps each boundary field to how its value is drawn, once a
call, from the seed:

- ``{"choices": [...], "weights": [...]}``: one of the values, with those
  weights;
- ``{"sine": [mean, amplitude]}``: ``mean + amplitude * sin(2 pi u)``, ``u``
  uniform in [0, 1): a daily sine read at an instant drawn evenly.

The fields are drawn in the file's order, each for every call before the
next field.
"""

from __future__ import annotations

import numpy as np


def draw(spec, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` values of one field's ``spec``."""
    if "choices" in spec:
        w = np.asarray(spec["weights"], np.float64)
        return rng.choice(np.asarray(spec["choices"], np.float64), n,
                          p=w / w.sum())
    if "sine" in spec:
        mean, amplitude = spec["sine"]
        return mean + amplitude * np.sin(2.0 * np.pi * rng.random(n))
    raise ValueError(f"unknown command spec {spec!r}")


def commands(specs: dict, seed: int, n: int) -> dict:
    """``{field: [n] float64}``: every call's command, from ``seed``."""
    rng = np.random.default_rng(seed)
    return {f: draw(spec, rng, n) for f, spec in specs.items()}
