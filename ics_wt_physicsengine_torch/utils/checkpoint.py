"""
Checkpoint / resume: tree serialization for simulation state (port of
``ics_wt_physicsengine_tpu/utils/checkpoint.py``).

A stopped simulation keeps its parameters, state and sensor carries in one
``.npz``: the leaves of the tree in order (``leaf_{i}``) and a ``__meta__``
JSON entry (``n_leaves``, ``kinds``, ``metadata``). The format is the JAX
package's, so a file written by either package loads into the other's
template of the same structure.

The leaf order is ``jax.tree_util.tree_flatten``'s: dataclass fields in
declaration order, nothing for a ``None`` field, dictionary values in the
order of their sorted keys, sequence items in order. Tensors are leaves;
Python values (zone counts, sensor types: the JAX package's static fields)
are structure. A ``torch.Generator`` is a leaf of its own kind, its
``get_state()`` bytes, where the JAX package stores a PRNG key: the port's
sensors carry their randomness in generators, and a resumed sensor must
read as the one that never stopped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

_GENERATOR_MARK = "torch_generator:"
# the JAX package's kind for a PRNG key, which the port cannot load
_KEY_MARK = "__prng_key__:"


def _children(tree):
    """The subtrees of ``tree`` in flattening order, or None for a leaf or
    a Python value."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, torch.Generator))


def tree_leaves(tree) -> list:
    """The tensors and generators of ``tree`` in flattening order."""
    if _is_leaf(tree):
        return [tree]
    kids = _children(tree)
    return [] if kids is None else [leaf for k in kids
                                    for leaf in tree_leaves(k)]


def _map2(fn, a, b):
    """``fn(leaf_a, leaf_b)`` over two trees of one structure, rebuilt in
    ``a``'s structure; Python values come from ``a``."""
    if _is_leaf(a):
        return fn(a, b)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return type(a)(**{f.name: _map2(fn, getattr(a, f.name),
                                        getattr(b, f.name))
                          for f in dataclasses.fields(a) if f.init})
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return a


def _unflatten(template, leaves):
    """``template`` with its leaves replaced, in flattening order, by the
    items of the iterator ``leaves``."""
    if _is_leaf(template):
        return next(leaves)
    if dataclasses.is_dataclass(template) and not isinstance(template,
                                                             type):
        return type(template)(**{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template) if f.init})
    if isinstance(template, dict):
        vals = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: vals[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, leaves) for x in template)
    return template


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def save_pytree(path: str, tree: Any, metadata: Optional[Dict] = None):
    """Serialize the tensors and generators of ``tree`` to ``path``
    (.npz)."""
    leaves = tree_leaves(tree)
    arrays = {}
    kinds = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Generator):
            arrays[f"leaf_{i}"] = leaf.get_state().numpy()
            kinds.append(_GENERATOR_MARK + leaf.device.type)
        else:
            arrays[f"leaf_{i}"] = leaf.detach().cpu().numpy()
            kinds.append("array")
    arrays["__meta__"] = np.frombuffer(
        json.dumps({
            "n_leaves": len(leaves),
            "kinds": kinds,
            "metadata": metadata or {},
        }).encode(), dtype=np.uint8)
    # Atomic write: serialize to a sibling temp file, then rename over the
    # target, so a crash mid-write never leaves a truncated checkpoint
    # where a good one used to be.
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=directory)
    try:
        # mkstemp creates 0600; restore umask-governed permissions so
        # other-user readers of checkpoints keep working.
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())   # data hits disk before the rename does
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _load_generator(arr, kind: str, template: torch.Generator, i: int):
    device_type = kind[len(_GENERATOR_MARK):]
    if device_type != template.device.type:
        raise ValueError(
            f"Checkpoint leaf {i} is a {device_type} generator; template "
            f"expects a {template.device.type} one")
    state = torch.from_numpy(np.array(arr, dtype=np.uint8))
    if state.shape != template.get_state().shape:
        raise ValueError(
            f"Checkpoint leaf {i} has a generator state of shape "
            f"{tuple(state.shape)}; template expects "
            f"{tuple(template.get_state().shape)}")
    g = torch.Generator(device=template.device)
    g.set_state(state)
    return g


def load_pytree(path: str, template: Any):
    """Restore a tree saved by ``save_pytree`` (by either package).

    ``template`` supplies the structure (and the Python values); its leaves
    are replaced by the stored values, each on the template leaf's device.
    """
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        leaves_t = tree_leaves(template)
        if len(leaves_t) != meta["n_leaves"]:
            raise ValueError(
                f"Checkpoint has {meta['n_leaves']} leaves; template has "
                f"{len(leaves_t)} — structure mismatch")
        leaves = []
        for i, kind in enumerate(meta["kinds"]):
            arr = data[f"leaf_{i}"]
            t = leaves_t[i]
            if kind.startswith(_KEY_MARK):
                raise ValueError(
                    f"Checkpoint leaf {i} is a JAX PRNG key ({kind}); the "
                    "port carries torch.Generator states instead")
            if kind.startswith(_GENERATOR_MARK) or isinstance(
                    t, torch.Generator):
                if not (kind.startswith(_GENERATOR_MARK)
                        and isinstance(t, torch.Generator)):
                    raise ValueError(
                        f"Checkpoint leaf {i} is of kind {kind!r}; template "
                        f"holds a {type(t).__name__} — structure mismatch")
                leaves.append(_load_generator(arr, kind, t, i))
                continue
            # Shape/dtype must match the template leaf: a checkpoint
            # written under a different configuration (e.g. another
            # n_zones) must fail fast, not silently install state that
            # disagrees with the reactor's static config.
            t_shape = tuple(t.shape)
            if arr.shape != t_shape:
                raise ValueError(
                    f"Checkpoint leaf {i} has shape {arr.shape}; "
                    f"template expects {t_shape} — configuration "
                    f"mismatch (was this saved with a different "
                    f"n_zones / batch size?)")
            t_dtype = _numpy_dtype(t.dtype)
            if arr.dtype != t_dtype:
                raise ValueError(
                    f"Checkpoint leaf {i} has dtype {arr.dtype}; "
                    f"template expects {t_dtype} — precision mismatch")
            leaves.append(torch.from_numpy(np.array(arr)).to(t.device))
        return _unflatten(template, iter(leaves))


def load_metadata(path: str) -> Dict:
    with np.load(path) as data:
        return json.loads(bytes(data["__meta__"]).decode())["metadata"]


def merge_lanes(restored: Any, fresh: Any) -> Any:
    """Lane-resize a restored batched tree into a differently sized one.

    ``restored`` carries ``[n_old, ...]`` lane-major leaves (a loaded fleet
    checkpoint); ``fresh`` carries ``[n_new, ...]`` leaves (a freshly built
    ensemble of the target size). The first ``min(n_old, n_new)`` lanes of
    every leaf come from the checkpoint; any extra lanes keep their fresh
    state (new units start as brand-new plants, not copies of existing
    lanes). Leaves whose shapes already agree pass through from the
    checkpoint; leaves with no lane axis (rank mismatch) keep the fresh
    value; generators come from the checkpoint.

    Used for explicit fleet-size resharding; without it a size mismatch
    fails fast in ``load_pytree``.
    """
    def m(r, f):
        if isinstance(r, torch.Generator):
            return r
        r_shape, f_shape = tuple(r.shape), tuple(f.shape)
        if r_shape == f_shape:
            return r
        if (len(r_shape) == len(f_shape) and len(r_shape) >= 1
                and r_shape[1:] == f_shape[1:]):
            k = min(r_shape[0], f_shape[0])
            if k == r_shape[0] and k < f_shape[0]:      # grow
                return torch.cat([r, f[k:].to(r.device)], dim=0)
            return r[:f_shape[0]]                       # shrink
        return f

    return _map2(m, restored, fresh)


# ---------------------------------------------------------------------------
# Whole-simulation checkpoints
# ---------------------------------------------------------------------------

def _bundle(reactor, sensors):
    bundle = {
        "params": reactor.params,
        "state": reactor.state,
    }
    if sensors:
        bundle["sensor_carries"] = {name: s.carry
                                    for name, s in sensors.items()}
        bundle["sensor_generators"] = {name: s._generator
                                       for name, s in sensors.items()}
    return bundle


def save_simulation(path: str, reactor, sensors: Optional[Dict] = None,
                    metadata: Optional[Dict] = None):
    """Checkpoint an IntegratedCSTR (params + state) and optional sensor
    wrapper dict (their carries and generators)."""
    meta = dict(metadata or {})
    meta["has_sensors"] = bool(sensors)
    save_pytree(path, _bundle(reactor, sensors), metadata=meta)


def load_simulation(path: str, reactor, sensors: Optional[Dict] = None):
    """Restore a checkpoint in place into ``reactor`` (and ``sensors``)."""
    bundle = load_pytree(path, _bundle(reactor, sensors))
    reactor.params = bundle["params"]
    reactor.state = bundle["state"]
    if sensors:
        for name, s in sensors.items():
            s.carry = bundle["sensor_carries"][name]
            s._generator = bundle["sensor_generators"][name]
    return reactor
