"""
Monte-Carlo ensemble statistics on one device (port of
``ics_wt_physicsengine_tpu/parallel/statistics.py``).

Reductions over the leading plant axis of a batched ``[B, Z]`` state.
``jnp.std`` is the population std (``correction=0`` here) and
``jnp.quantile``'s default linear interpolation is ``torch.quantile``'s.
"""

from __future__ import annotations

from typing import Dict

import torch

from ics_wt_physicsengine_torch.core import reactor as R


def ensemble_statistics(state: R.ReactorState,
                        quantiles=(0.05, 0.5, 0.95)) -> Dict:
    """Cross-plant statistics of a batched ``[B, Z]`` state: per-zone
    mean/std, the requested quantiles, min and max of each primary
    variable, and the plant count."""
    q = torch.as_tensor(quantiles, dtype=state.pH.dtype,
                        device=state.pH.device)

    def stats(x):
        return {
            "mean": torch.mean(x, dim=0),
            "std": torch.std(x, dim=0, correction=0),
            "quantiles": torch.quantile(x, q, dim=0),
            "min": torch.amin(x, dim=0),
            "max": torch.amax(x, dim=0),
        }

    return {
        "pH": stats(state.pH),
        "chlorine": stats(state.chlorine),
        "temperature": stats(state.temperature),
        "n_plants": state.pH.shape[0],
    }


def exceedance_probability(state: R.ReactorState, *, ph_low=6.5, ph_high=8.5,
                           chlorine_min=0.2) -> Dict:
    """Fraction of plants whose *outlet* zone violates drinking-water
    limits."""
    ph_out = state.pH[..., -1]
    cl_out = state.chlorine[..., -1]
    dtype = state.pH.dtype

    def frac(mask):
        return torch.mean(mask.to(dtype))

    return {
        "p_ph_low": frac(ph_out < ph_low),
        "p_ph_high": frac(ph_out > ph_high),
        "p_chlorine_low": frac(cl_out < chlorine_min),
        "p_any_violation": frac((ph_out < ph_low) | (ph_out > ph_high)
                                | (cl_out < chlorine_min)),
    }
