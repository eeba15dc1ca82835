"""
Device and dtype policy of the PyTorch port.

- Entry points take ``device=None``, which means the CUDA card. Without a
  card they raise: the CPU is used only when the caller asks for it
  (``device="cpu"``), as the CPU tests do. There is no silent fallback.
- The default dtype is float32, the working type of the fused kernels.
  float64 is used where the caller asks for it (the CPU parity tests).
- The device of a tensor alone decides how a kernel wrapper runs: a CPU
  tensor takes the plain PyTorch version, a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import argparse
from dataclasses import fields

import numpy as np
import torch

DEFAULT_DTYPE = torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises when there is none); anything else
    is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def cli_device(name: str) -> torch.device:
    """A script's ``--device NAME`` as a ``torch.device``; exits with the
    reason when the card is asked for and there is none (no move to the
    CPU). The one refusal of the port's tools and examples."""
    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(f"--device {name}: {e}") from e


def module_device(argv=None, description=None) -> torch.device:
    """The ``--device NAME`` of a module's entry point (``python -m
    ics_wt_physicsengine_torch.<module> [--device NAME]``): the card unless
    NAME names another device, refused through ``cli_device``."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the CUDA card; no "
                             "fallback)")
    return cli_device(parser.parse_args(argv).device)


def numpy_dtype(dtype: torch.dtype):
    """The NumPy counterpart of a torch floating dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def tensor_from_numpy(value, dtype=None, device=None) -> torch.Tensor:
    """``value`` cast to ``dtype`` in NumPy (as the JAX package casts its
    host results), then moved to ``device`` (``None``: the CUDA card)."""
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    return torch.from_numpy(
        np.array(value, dtype=numpy_dtype(dtype))).to(resolve_device(device))


def dataclass_from_numpy(cls, values, dtype=None, device=None):
    """A dataclass of tensors from a mapping of its field names to NumPy
    values, each through ``tensor_from_numpy``."""
    dev = resolve_device(device)
    return cls(**{f.name: tensor_from_numpy(values[f.name], dtype, dev)
                  for f in fields(cls)})
