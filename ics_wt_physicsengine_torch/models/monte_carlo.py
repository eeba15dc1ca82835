"""
Monte-Carlo plant batches: parameter-randomized plants as batched tensors
(port of ``ics_wt_physicsengine_tpu/models/monte_carlo.py``).

A batch of plants is the same ``ReactorParams`` / ``ReactorState`` structure
with a leading ``[n_plants]`` axis, which the batched physics consumes
directly. Sampling happens host-side with ``numpy.random.default_rng(seed)``
in the JAX package's draw order, and the parameters are derived in float64
NumPy before the cast, so for a given seed the batch is bit-identical to the
JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from ics_wt_physicsengine_torch.convert import (params_from_numpy,
                                                state_from_numpy)
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.device import DEFAULT_DTYPE, numpy_dtype


@dataclass
class ParameterRanges:
    """Uniform sampling ranges for plant-to-plant parameter uncertainty.

    Keys are ``ReactorConfiguration`` field names; values are (low, high).
    Geometry is kept fixed across the batch.
    """

    ranges: Dict[str, Tuple[float, float]] = field(default_factory=lambda: {
        "flow_rate": (2.0, 8.0),            # [L/min]
        "impeller_speed": (40.0, 90.0),     # [rpm]
        "total_carbonate": (1.0, 4.0),      # [mmol/L]
        "temperature": (10.0, 30.0),        # [C]
        "initial_pH": (6.5, 8.0),
        "initial_chlorine": (0.5, 3.5),     # [mg/L]
    })
    # Alkalinity is sampled as a ratio of the carbonate capacity
    # (alk [mg/L CaCO3] = ratio * 50 * C_T [mmol/L]) so every sampled water
    # has a physical pH root.
    alkalinity_ratio: Tuple[float, float] = (0.5, 1.3)
    # Nitrogen kinetics (sampled only when the base configuration has
    # enable_nitrogen=True): nitrifier activity varies widely between
    # sites.
    nitrogen_ranges: Dict[str, Tuple[float, float]] = field(
        default_factory=lambda: {
            "k_nitrif": (1.0, 4.0),        # [mg N/L/day] @ 20 C
            "k_nitrat": (1.5, 6.0),        # [mg N/L/day]
            "K_nh": (0.5, 2.0),            # [mg N/L]
            "k_cm_decay": (0.01, 0.05),    # [1/day]
        })

# axes whose parameters mix 0-d fields with per-class vectors ([C], [P])
_CLASS_AXES = ("particles", "disinfection")


def make_monte_carlo_batch(base_config: R.ReactorConfiguration,
                           n_plants: int,
                           seed: int = 0,
                           ranges: ParameterRanges | None = None,
                           dtype: torch.dtype = DEFAULT_DTYPE,
                           device=None):
    """Sample ``n_plants`` configurations around ``base_config`` and build
    batched ``(params, state)`` with leading ``[n_plants]`` axes on
    ``device`` (``None``: the CUDA card)."""
    if n_plants < 1:
        raise ValueError(f"n_plants must be >= 1, got {n_plants}")
    if ranges is None:
        ranges = ParameterRanges()
    rng = np.random.default_rng(seed)

    samples = {name: rng.uniform(lo, hi, n_plants)
               for name, (lo, hi) in ranges.ranges.items()}
    if "alkalinity" not in samples:
        ratio = rng.uniform(*ranges.alkalinity_ratio, n_plants)
        samples["alkalinity"] = ratio * 50.0 * samples["total_carbonate"]

    # One configuration whose numeric fields are all [n_plants] float64
    # arrays, so the derived parameter/state fields come out batched.
    fields_ = dict(base_config.__dict__)
    for name, value in fields_.items():
        if name in samples:
            fields_[name] = samples[name]
        elif isinstance(value, float):
            fields_[name] = np.full(n_plants, value, np.float64)
    if base_config.enable_nitrogen:
        # per-plant kinetics; explicit overrides in nitrogen_kinetics stay
        # fixed across the batch
        n_kw = dict(base_config.nitrogen_kinetics or {})
        for name, (lo, hi) in ranges.nitrogen_ranges.items():
            if name not in n_kw:
                n_kw[name] = rng.uniform(lo, hi, n_plants)
        fields_["nitrogen_kinetics"] = n_kw
    config = R.ReactorConfiguration(**fields_)

    np_dtype = numpy_dtype(dtype)
    params = R.params_numpy(config, np_dtype)
    state = R.initial_state_numpy(config, np_dtype)

    # Fields that depend only on constants are still 0-d: give every field
    # the [n_plants] axis.
    def batched(x):
        if x is None:
            return None
        x = np.asarray(x)
        return np.broadcast_to(x, (n_plants,)).copy() if x.ndim == 0 else x

    # The particle and disinfection fields mix 0-d values with [C] / [P]
    # class vectors, so every one of them gets a leading [n_plants] axis:
    # a shape test cannot tell [C] from [n_plants] when n_plants == C.
    def class_batched(x):
        x = np.asarray(x)
        return np.broadcast_to(x, (n_plants,) + x.shape).copy()

    def batch_field(name, value):
        if name == "n_zones" or value is None:
            return value
        if isinstance(value, dict):
            each = class_batched if name in _CLASS_AXES else batched
            return {k: each(v) for k, v in value.items()}
        return batched(value)

    params = {k: batch_field(k, v) for k, v in params.items()}
    state = {k: batched(v) for k, v in state.items()}
    return (params_from_numpy(params, dtype=dtype, device=device),
            state_from_numpy(state, dtype=dtype, device=device))
