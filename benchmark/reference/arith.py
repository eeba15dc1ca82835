"""
Array arithmetic for the plain reference, in a stated precision.

The reference is written once against a small namespace (``Arith``) of
NumPy functions, so that the same code runs in float64 (the reference the
benchmark compares with), float32, or emulated bfloat16 (the control that
has to come out not correct). Python operators on the arrays work in all
three: for bfloat16 the arrays are ``BF16`` views whose every floating
result is rounded to the nearest bfloat16 (ties to even), inputs and
outputs held in float32.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32


def round_bf16(x) -> np.ndarray:
    """``x`` rounded to the nearest bfloat16, held as float32."""
    x = np.asarray(x, np.float32)
    u = x.view(_U32)
    r = (u + _U32(0x7FFF) + ((u >> _U32(16)) & _U32(1))) & _U32(0xFFFF0000)
    return np.where(np.isnan(x), x, r.view(np.float32))


class BF16(np.ndarray):
    """A float32 array whose ufunc results are rounded to bfloat16."""

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        args = [i.view(np.ndarray) if isinstance(i, BF16) else i
                for i in inputs]
        return _bf16(getattr(ufunc, method)(*args, **kwargs))


def _bf16(out):
    if isinstance(out, tuple):
        return tuple(_bf16(o) for o in out)
    if isinstance(out, np.ndarray) and out.dtype.kind == "f":
        return round_bf16(out).view(BF16)
    if isinstance(out, np.floating):
        return round_bf16(out).view(BF16)
    return out


class Arith:
    """NumPy in one floating precision: ``name`` is ``float64``,
    ``float32`` or ``bfloat16``."""

    def __init__(self, name: str):
        if name not in ("float64", "float32", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = np.float64 if name == "float64" else np.float32
        self._wrap = _bf16 if name == "bfloat16" else (lambda x: x)
        if name != "bfloat16":      # plain NumPy: no wrapper per call
            self.where, self.exp, self.log = np.where, np.exp, np.log
            self.sqrt, self.cos, self.sin = np.sqrt, np.cos, np.sin
            self.abs, self.minimum, self.maximum = np.abs, np.minimum, \
                np.maximum

    def cat(self, arrays, axis: int = -1):
        return self._wrap(np.concatenate(arrays, axis=axis))

    def stack(self, arrays):
        return self._wrap(np.stack(arrays))

    def asarray(self, x) -> np.ndarray:
        return self._wrap(np.array(x, dtype=self.dtype))

    def where(self, cond, a, b):
        return self._wrap(np.where(cond, a, b))

    def clip(self, x, lo, hi):
        return self._wrap(np.clip(x, lo, hi))

    def minimum(self, a, b):
        return self._wrap(np.minimum(a, b))

    def maximum(self, a, b):
        return self._wrap(np.maximum(a, b))

    def exp(self, x):
        return self._wrap(np.exp(x))

    def log(self, x):
        return self._wrap(np.log(x))

    def sqrt(self, x):
        return self._wrap(np.sqrt(x))

    def cos(self, x):
        return self._wrap(np.cos(x))

    def sin(self, x):
        return self._wrap(np.sin(x))

    def abs(self, x):
        return self._wrap(np.abs(x))


F64 = Arith("float64")
