"""
Carry parameters, states, boundary conditions, chemistry constants, sensors,
electrical stages and whole plants across from NumPy.

Each function takes a mapping from field name to NumPy value (``chem``, a
sensor's ``base`` and a plant's members nested as mappings) -- for example
``dataclasses.asdict`` of the JAX package's objects -- and returns the
port's objects on ``device`` (``None``: the CUDA card) in ``dtype`` (default
float32). Values are cast to ``dtype`` in NumPy first, so float64 inputs and
outputs agree bit for bit.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.core.chemistry import constants_from_numpy
from ics_wt_physicsengine_torch.device import (dataclass_from_numpy,
                                               resolve_device,
                                               tensor_from_numpy)
from ics_wt_physicsengine_torch.sensors import ammonia as SA
from ics_wt_physicsengine_torch.sensors import base as SB
from ics_wt_physicsengine_torch.sensors import chlorine as SC
from ics_wt_physicsengine_torch.sensors import electrical as SE
from ics_wt_physicsengine_torch.sensors import flow as SF
from ics_wt_physicsengine_torch.sensors import oxygen as SO
from ics_wt_physicsengine_torch.sensors import ph as SP
from ics_wt_physicsengine_torch.sensors import temperature as ST
from ics_wt_physicsengine_torch.sensors import turbidity as STB


def params_from_numpy(values, dtype=None, device=None) -> R.ReactorParams:
    """``ReactorParams`` from a mapping of its fields; ``chem`` and each
    extension axis that is present and not ``None`` nest as mappings of
    their own fields."""
    dev = resolve_device(device)
    kw = {}
    for f in fields(R.ReactorParams):
        if f.name == "n_zones":
            kw[f.name] = int(values[f.name])
        elif f.name == "chem":
            kw[f.name] = constants_from_numpy(values["chem"], dtype=dtype,
                                              device=dev)
        elif f.name in R.EXTENSION_PARAMS:
            if values.get(f.name) is not None:
                kw[f.name] = dataclass_from_numpy(
                    R.EXTENSION_PARAMS[f.name][0], values[f.name], dtype,
                    dev)
        else:
            kw[f.name] = tensor_from_numpy(values[f.name], dtype, dev)
    return R.ReactorParams(**kw)


def chemistry_constants_from_numpy(values, dtype=None, device=None):
    """``core.chemistry.ChemistryConstants`` from a mapping of its six
    fields (scalars or arrays of any shape)."""
    return constants_from_numpy(values, dtype=dtype, device=device)


_STATE_FIELDS = tuple(f.name for f in fields(R.ReactorState))


def state_from_numpy(values, dtype=None, device=None) -> R.ReactorState:
    """``ReactorState`` from a mapping of its fields; derived fields and
    the species of axes that are off may be ``None`` or absent."""
    dev = resolve_device(device)
    return R.ReactorState(**{
        name: (None if values.get(name) is None
               else tensor_from_numpy(values[name], dtype, dev))
        for name in _STATE_FIELDS})


def boundary_from_numpy(values, dtype=None,
                        device=None) -> R.BoundaryConditions:
    """``BoundaryConditions`` from a mapping of its fields. Scalars stay
    Python floats (they take the state's dtype in arithmetic, as JAX's
    weakly typed scalars do); arrays (``[B]`` per plant or ``[n_steps]``
    in a schedule, ``[..., C]`` per-class inlet vectors) become ``dtype``
    tensors; ``None`` stays ``None``."""
    dev = resolve_device(device)
    kw = {}
    for f in fields(R.BoundaryConditions):
        if f.name not in values:
            continue
        v = values[f.name]
        if v is None:
            kw[f.name] = None
        else:
            kw[f.name] = (float(v) if np.ndim(v) == 0
                          else tensor_from_numpy(v, dtype, dev))
    return R.BoundaryConditions(**kw)


# Fields that stay Python values on the sensor dataclasses.
_STATIC_SENSOR_FIELDS = ("line_capacity", "zone_index", "sensor_type",
                         "measurement_type")


def _sensor_tensor(value, dtype, dev):
    """A sensor leaf by its NumPy kind: bool stays bool, integers become
    int32, floats take ``dtype``."""
    value = np.asarray(value)
    if value.dtype.kind == "b":
        return torch.from_numpy(np.array(value)).to(dev)
    if value.dtype.kind in "iu":
        return torch.from_numpy(value.astype(np.int32)).to(dev)
    return tensor_from_numpy(value, dtype, dev)


def _sensor_object(cls, base_cls, values, dtype, dev):
    kw = {}
    for f in fields(cls):
        if f.name not in values:
            continue                  # keeps the dataclass default
        v = values[f.name]
        if f.name == "base" and base_cls is not None:
            kw[f.name] = _sensor_object(base_cls, None, v, dtype, dev)
        elif f.name in _STATIC_SENSOR_FIELDS or v is None:
            kw[f.name] = v
        else:
            kw[f.name] = _sensor_tensor(v, dtype, dev)
    return cls(**kw)


def sensor_params_from_numpy(cls, values, dtype=None, device=None):
    """Sensor parameters of class ``cls`` (``sensors.base.SensorParams`` or
    an overlay's params class, whose ``base`` entry nests) from a mapping
    of its fields. ``line_capacity``, ``zone_index``, ``sensor_type`` and
    ``measurement_type`` are Python values."""
    base_cls = None if cls is SB.SensorParams else SB.SensorParams
    return _sensor_object(cls, base_cls, values, dtype,
                          resolve_device(device))


def sensor_carry_from_numpy(cls, values, dtype=None, device=None):
    """A sensor carry of class ``cls`` (``sensors.base.SensorCarry`` or an
    overlay's carry class) from a mapping of its fields. A ``key`` entry
    (the JAX package's carried PRNG key) is ignored: the port's carries
    hold no generator state."""
    base_cls = None if cls is SB.SensorCarry else SB.SensorCarry
    return _sensor_object(cls, base_cls, values, dtype,
                          resolve_device(device))


def electrical_params_from_numpy(values, dtype=None, device=None):
    """``sensors.electrical.ElectricalParams`` from a mapping of its
    fields."""
    return _sensor_object(SE.ElectricalParams, None, values, dtype,
                          resolve_device(device))


def electrical_carry_from_numpy(values, dtype=None, device=None):
    """``sensors.electrical.ElectricalCarry`` from a mapping of its fields
    (``cable_initialized`` stays boolean). A ``key`` entry is ignored, as
    in ``sensor_carry_from_numpy``."""
    return _sensor_object(SE.ElectricalCarry, None, values, dtype,
                          resolve_device(device))


_SENSOR_CLASSES = {
    "ph_inlet": (SP.PHSensorParams, SP.PHSensorCarry),
    "ph_outlet": (SP.PHSensorParams, SP.PHSensorCarry),
    "chlorine_inlet": (SC.ChlorineSensorParams, SC.ChlorineSensorCarry),
    "chlorine_outlet": (SC.ChlorineSensorParams, SC.ChlorineSensorCarry),
    "flow_main": (SF.FlowSensorParams, SF.FlowSensorCarry),
    "temp_inlet": (ST.TemperatureSensorParams, ST.TemperatureSensorCarry),
    "temp_outlet": (ST.TemperatureSensorParams, ST.TemperatureSensorCarry),
}
# the extension axes' instruments: None (or absent) when their axis is off
_EXTENSION_SENSOR_CLASSES = {
    "ammonia_outlet": (SA.AmmoniaSensorParams, SA.AmmoniaSensorCarry),
    "oxygen_outlet": (SO.OxygenSensorParams, SO.OxygenSensorCarry),
    "turbidity_outlet": (STB.TurbiditySensorParams,
                         STB.TurbiditySensorCarry),
}


def _sensors(values, which, build, dtype, device):
    """Every base sensor, and each extension sensor that is present."""
    out = {name: build(classes[which], values[name], dtype=dtype,
                       device=device)
           for name, classes in _SENSOR_CLASSES.items()}
    out.update({name: build(classes[which], values[name], dtype=dtype,
                            device=device)
                for name, classes in _EXTENSION_SENSOR_CLASSES.items()
                if values.get(name) is not None})
    return out


def plant_params_from_numpy(values, dtype=None, device=None):
    """``models.plant.PlantParams`` from a nested mapping: ``reactor`` as
    ``params_from_numpy`` takes it, each sensor as
    ``sensor_params_from_numpy`` does."""
    from ics_wt_physicsengine_torch.models.plant import PlantParams

    return PlantParams(
        reactor=params_from_numpy(values["reactor"], dtype=dtype,
                                  device=device),
        **_sensors(values, 0, sensor_params_from_numpy, dtype, device))


def plant_state_from_numpy(values, dtype=None, device=None):
    """``models.plant.PlantState`` from a nested mapping: ``reactor`` as
    ``state_from_numpy`` takes it, each sensor as
    ``sensor_carry_from_numpy`` does."""
    from ics_wt_physicsengine_torch.models.plant import PlantState

    return PlantState(
        reactor=state_from_numpy(values["reactor"], dtype=dtype,
                                 device=device),
        **_sensors(values, 1, sensor_carry_from_numpy, dtype, device))


_SURROGATE_STATS = ("x_mean", "x_std", "u_scale", "r_mean", "r_std", "lo",
                    "hi")


def surrogate_params_from_numpy(values, dtype=None, device=None):
    """``models.surrogate.SurrogateParams`` from a mapping of its fields:
    ``weights``, the sequence ``(W, b, W, b, ...)``, becomes float32 (the
    MLP's type in both packages); the seven statistics take ``dtype``."""
    from ics_wt_physicsengine_torch.models.surrogate import SurrogateParams

    dev = resolve_device(device)
    return SurrogateParams(
        weights=tuple(tensor_from_numpy(w, torch.float32, dev)
                      for w in values["weights"]),
        **{name: tensor_from_numpy(values[name], dtype, dev)
           for name in _SURROGATE_STATS})
