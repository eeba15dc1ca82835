"""
The port's flagship entry point: one full plant step on the 20-zone
stratified configuration, RK4-substepped physics plus all seven instruments
(``models.plant.plant_step``).

The configuration, boundary, seed and substeps are those of the JAX
package's ``__graft_entry__.entry()``. The instruments draw from a
``torch.Generator`` seeded with ``SEED``; a caller that wants to inject the
draws passes ``rand=`` to the returned function.
"""

from __future__ import annotations

import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.device import DEFAULT_DTYPE, resolve_device
from ics_wt_physicsengine_torch.models.plant import make_plant, plant_step

SEED = 1
DT = 1.0


def entry(device=None, dtype=DEFAULT_DTYPE):
    """Return ``(fn, example_args)``: ``fn(params, plant, boundary)`` takes
    one plant step and gives ``(pH[20], chlorine_outlet value, pH_inlet
    value)``, on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    config = R.ReactorConfiguration(
        volume=1000, height=2.0, diameter=0.798, n_zones=20,
        flow_rate=5.0, initial_pH=7.0, initial_chlorine=2.0,
        temperature=20.0, enable_thermal_stratification=True)
    params, plant = make_plant(config, dtype=dtype, device=dev)
    bc = R.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
        inlet_temperature=26.0, acid_flow_rate=0.1,
        ambient_temperature=15.0, heat_loss_coefficient=50.0)
    substeps = R.default_substeps(config, DT)
    generator = torch.Generator(device=dev).manual_seed(SEED)

    def fn(params, plant, boundary, rand=None):
        new_plant, readings = plant_step(params, plant, boundary, dt=DT,
                                         substeps=substeps, rand=rand,
                                         generator=generator)
        return (new_plant.reactor.pH,
                readings["chlorine_outlet"].value,
                readings["pH_inlet"].value)

    return fn, (params, plant, bc)
