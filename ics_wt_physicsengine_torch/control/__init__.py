"""
Closed-loop control and state estimation on tensors (port of
``ics_wt_physicsengine_tpu/control``).

Controllers are pure transforms that step with the plant and its
instruments, so a 4096-gain PID sweep is one batched loop, gradient tuning
differentiates through the plant, and shooting MPC re-plans by Adam through
the plant step. Plain PyTorch: no hand-written kernel lies on this path.

Layers:
  - ``pid``: pure PID (the socket controller of examples/pid_controller.py,
    operation for operation) and the straight-through clips.
  - ``closed_loop``: controller + plant loop with the orchestrator's command
    validation; true-state or full-instrument observation.
  - ``tuning``: batched gain sweeps, robust sweeps, multi-start gradient
    tuning.
  - ``mpc``: receding-horizon shooting MPC for dosing programs.
  - ``estimator``: per-channel scalar Kalman filters (NaN-robust).
  - ``ekf``: full-state extended Kalman filter, its Jacobian
    ``torch.func.jacfwd`` of the plant step.
  - ``enkf``: ensemble Kalman filter: the members are a batch of plants.
  - ``mhe``: moving-horizon estimation by Adam through the window rollout.
  - ``optim``: the functional Adam and global-norm clip these use (optax's
    order of operations).
"""

from ics_wt_physicsengine_torch.control.closed_loop import (
    DualPIDCarry,
    DualPIDGains,
    apply_commands,
    dual_pid_controller,
    make_dual_pid_carry,
    observe_true,
    rollout_closed_loop,
    validate_commands,
)
from ics_wt_physicsengine_torch.control.enkf import (
    EnKFCarry,
    ensemble_spread,
    make_enkf,
    make_enkf_carry,
)
from ics_wt_physicsengine_torch.control.ekf import (
    EKFCarry,
    ekf_observer,
    flatten_state,
    make_augmented_carry,
    make_augmented_ekf,
    make_ekf,
    make_ekf_carry,
    nis_fault_monitor,
    tap_index,
    tss_index,
    unflatten_state,
)
from ics_wt_physicsengine_torch.control.mhe import (
    MHECarry,
    make_mhe,
    make_mhe_carry,
)
from ics_wt_physicsengine_torch.control.estimator import (
    KalmanCarry,
    KalmanParams,
    filtered_controller,
    kalman_step,
    make_kalman_carry,
    make_kalman_params,
)
from ics_wt_physicsengine_torch.control.mpc import (
    mpc_plan,
    run_mpc,
    run_mpc_output_feedback,
)
from ics_wt_physicsengine_torch.control.pid import (
    PIDCarry,
    PIDGains,
    make_gains,
    make_pid_carry,
    pid_step,
)
from ics_wt_physicsengine_torch.control.tuning import (
    gain_sweep,
    make_gain_grid,
    n_gains,
    robust_gain_sweep,
    tracking_scores,
    tune_pid_gradient,
)

__all__ = [
    "PIDCarry", "PIDGains", "make_gains", "make_pid_carry", "pid_step",
    "DualPIDCarry", "DualPIDGains", "apply_commands",
    "dual_pid_controller", "make_dual_pid_carry", "observe_true",
    "rollout_closed_loop", "validate_commands",
    "gain_sweep", "make_gain_grid", "n_gains", "robust_gain_sweep",
    "tracking_scores", "tune_pid_gradient",
    "mpc_plan", "run_mpc", "run_mpc_output_feedback",
    "KalmanCarry", "KalmanParams", "filtered_controller", "kalman_step",
    "make_kalman_carry", "make_kalman_params",
    "EKFCarry", "ekf_observer", "flatten_state", "make_augmented_carry",
    "make_augmented_ekf", "make_ekf", "make_ekf_carry",
    "nis_fault_monitor", "tap_index", "tss_index", "unflatten_state",
    "EnKFCarry", "ensemble_spread", "make_enkf", "make_enkf_carry",
    "MHECarry", "make_mhe", "make_mhe_carry",
]
