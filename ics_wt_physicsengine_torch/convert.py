"""
Carry parameters, states and boundary conditions across from NumPy.

Each function takes a mapping from field name to NumPy value (``chem``
nested as a mapping) -- for example ``dataclasses.asdict`` of the JAX
package's objects -- and returns the port's objects on ``device``
(``None``: the CUDA card) in ``dtype`` (default float32). Values are cast to
``dtype`` in NumPy first, so float64 inputs and outputs agree bit for bit.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.core.chemistry import constants_from_numpy
from ics_wt_physicsengine_torch.device import (resolve_device,
                                               tensor_from_numpy)


def params_from_numpy(values, dtype=None, device=None) -> R.ReactorParams:
    """``ReactorParams`` from a mapping of its fields. An extension axis
    that is present and not ``None`` raises ``NotImplementedError``."""
    dev = resolve_device(device)
    for axis in R.EXTENSION_AXES:
        if values.get(axis) is not None:
            raise NotImplementedError(
                f"the {axis} extension axis is not ported to the PyTorch "
                "package yet")
    kw = {}
    for f in fields(R.ReactorParams):
        if f.name == "n_zones":
            kw[f.name] = int(values[f.name])
        elif f.name == "chem":
            kw[f.name] = constants_from_numpy(values["chem"], dtype=dtype,
                                              device=dev)
        elif f.name not in R.EXTENSION_AXES:
            kw[f.name] = tensor_from_numpy(values[f.name], dtype, dev)
    return R.ReactorParams(**kw)


_STATE_FIELDS = tuple(f.name for f in fields(R.ReactorState))


def state_from_numpy(values, dtype=None, device=None) -> R.ReactorState:
    """``ReactorState`` from a mapping of its fields (derived fields may be
    ``None`` or absent). Extension species that are present and not
    ``None`` raise ``NotImplementedError``."""
    dev = resolve_device(device)
    extra = [k for k, v in values.items()
             if k not in _STATE_FIELDS and v is not None]
    if extra:
        raise NotImplementedError(
            f"state fields {extra} belong to extension axes that are not "
            "ported to the PyTorch package yet")
    return R.ReactorState(**{
        name: (None if values.get(name) is None
               else tensor_from_numpy(values[name], dtype, dev))
        for name in _STATE_FIELDS})


def boundary_from_numpy(values, dtype=None,
                        device=None) -> R.BoundaryConditions:
    """``BoundaryConditions`` from a mapping of its fields. Scalars stay
    Python floats (they take the state's dtype in arithmetic, as JAX's
    weakly typed scalars do); arrays (``[B]`` per plant or ``[n_steps]``
    in a schedule) become ``dtype`` tensors. Keys of the JAX package's
    extension-axis inputs, which the core physics never reads, are
    ignored."""
    dev = resolve_device(device)
    kw = {}
    for f in fields(R.BoundaryConditions):
        if f.name not in values:
            continue
        v = values[f.name]
        kw[f.name] = (float(v) if np.ndim(v) == 0
                      else tensor_from_numpy(v, dtype, dev))
    return R.BoundaryConditions(**kw)
