"""Helpers shared by the PyTorch port's parity tests: JAX pytrees to the
nested NumPy mappings ``ics_wt_physicsengine_torch.convert`` takes, and
field-by-field comparisons of the port's objects with the JAX package's."""

import dataclasses

import numpy as np
import torch


def tree_to_numpy(obj):
    """A JAX-package dataclass pytree as a nested mapping of NumPy values
    (Python values and None pass through). The carried PRNG ``key`` is left
    out: NumPy cannot hold it and the port has no counterpart."""
    if dataclasses.is_dataclass(obj):
        return {f.name: tree_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name != "key"}
    if obj is None or isinstance(obj, (int, str)):
        return obj
    return np.asarray(obj)


def to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_tree_close(port, ref, atol=0.0, path=""):
    """Every field of a port dataclass against the JAX one: Python values
    equal, integer and boolean arrays equal, float arrays within ``atol``
    with NaN in the same places. ``atol=0`` asks for bit equality."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        where = f"{path}.{f.name}"
        if dataclasses.is_dataclass(a):
            assert_tree_close(a, b, atol, where)
        elif a is None or isinstance(a, (int, str)):
            assert a == b, where
        else:
            a, b = to_numpy(a), np.asarray(b)
            assert a.shape == b.shape, (where, a.shape, b.shape)
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=where)
            else:
                assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
                np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                           equal_nan=True, err_msg=where)
