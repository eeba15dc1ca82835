"""
ICS-WT-PhysicsEngine, PyTorch port for NVIDIA Hopper (H100).

A second implementation of ``ics_wt_physicsengine_tpu`` in PyTorch, with the
JAX package's Pallas TPU kernels rewritten by hand in CUDA C++ for sm_90a.
It imports neither JAX nor the JAX package.

- ``core/``     the multi-zone reactor physics on ``[..., n_zones]`` tensors
                and the reference simulator's object API over it
                (``python -m ics_wt_physicsengine_torch.core``).
- ``sensors/``  the instrument suite as pure transforms, and the sensor
                classes (``python -m ics_wt_physicsengine_torch.sensors``).
- ``ops/``      integrators and the CUDA kernels (``csrc/``: fused rollout,
                fused plant, Newton pH solve), each with its plain PyTorch
                version.
- ``models/``   the instrumented plant, Monte-Carlo plant batches, the
                serving chunk and the learned surrogate.
- ``control/``  PID, closed loop, tuning, MPC and the state estimators.
- ``modbus/``, ``opcua/``  the serving planes (Modbus/TCP, RTU, TLS, the
                native C++ plane; the OPC UA bridge).
- ``__main__``  the serving orchestrator
                (``python -m ics_wt_physicsengine_torch``).
- ``parallel/`` ensemble statistics.
- ``utils/``    checkpoints, history, profiling, device selection.
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
