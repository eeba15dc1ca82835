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


def numpy_dtype(dtype: torch.dtype):
    """The NumPy counterpart of a torch floating dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def tensor_from_numpy(value, dtype=None, device=None) -> torch.Tensor:
    """``value`` cast to ``dtype`` in NumPy (as the JAX package casts its
    host results), then moved to ``device`` (``None``: the CUDA card)."""
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    return torch.from_numpy(
        np.array(value, dtype=numpy_dtype(dtype))).to(resolve_device(device))
