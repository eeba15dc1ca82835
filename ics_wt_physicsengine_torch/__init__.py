"""
ICS-WT-PhysicsEngine, PyTorch port for NVIDIA Hopper (H100).

A second implementation of ``ics_wt_physicsengine_tpu`` in PyTorch, with the
JAX package's Pallas TPU kernels rewritten by hand in CUDA C++ for sm_90a.
It imports neither JAX nor the JAX package.

- ``core/``     the multi-zone reactor physics on ``[..., n_zones]`` tensors.
- ``ops/``      integrators and the fused-rollout CUDA kernels (``csrc/``),
                each with its plain PyTorch version.
- ``models/``   Monte-Carlo parameter-randomized plant batches.
- ``parallel/`` ensemble statistics.
- ``convert``   carries NumPy values (e.g. from the JAX package) across.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``device.py``).
"""

__version__ = "0.1.0"

from ics_wt_physicsengine_torch.core.reactor import (  # noqa: F401
    BoundaryConditions,
    IntegratedCSTR,
    ReactorConfiguration,
    ReactorParams,
    ReactorState,
    make_initial_state,
    make_params,
    rollout,
    rollout_scheduled,
    stack_boundary_schedule,
    step,
)
