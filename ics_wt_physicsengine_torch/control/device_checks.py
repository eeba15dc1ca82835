"""
Small float64 runs of the control path, built the same way on any device,
so that the CUDA card can be held against the CPU (``chip_smoke.py`` and
``tests/test_torch_gpu.py``): a closed-loop gain sweep, a bank of EKF steps
(``torch.func.vmap`` of ``torch.func.jacfwd`` of the plant step) and an MHE
step (Adam through the window rollout). Each returns named tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ics_wt_physicsengine_torch.control import closed_loop as CL
from ics_wt_physicsengine_torch.control import ekf as E
from ics_wt_physicsengine_torch.control import mhe as MH
from ics_wt_physicsengine_torch.control.tuning import make_gain_grid
from ics_wt_physicsengine_torch.core import reactor as R

F64 = torch.float64
TAPS = [("pH", 0), ("pH", -1), ("chlorine", -1), ("temperature", -1)]
BOUNDARY = dict(inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5)


def _config(n_zones):
    return R.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                  n_zones=n_zones, initial_chlorine=0.5)


def _readings(n_steps, shape, seed):
    """Seeded readings near the 6-zone plant's values (host NumPy, so
    every device gets the same numbers)."""
    rng = np.random.default_rng(seed)
    return np.array([7.2, 7.2, 0.5, 20.0]) \
        + 0.02 * rng.standard_normal((n_steps,) + shape + (4,))


def closed_loop_case(device) -> Dict[str, torch.Tensor]:
    """A 16-gain sweep on the 20-zone plant, 20 steps of RKC-fast."""
    cfg = _config(20)
    m, s = R.default_rkc_plan(cfg, 1.0, mode="fast")
    gains = make_gain_grid(np.linspace(0.05, 3.0, 2), np.linspace(
        0.0, 0.25, 2), np.linspace(-2.0, -0.1, 2), np.linspace(-0.2, 0.0, 2),
        dtype=F64, device=device)
    params = R.make_params(cfg, dtype=F64, device=device)
    state = R.make_initial_state(cfg, dtype=F64, device=device)
    state = R.ReactorState(**{
        k: (None if v is None else v.expand((16,) + tuple(v.shape)))
        for k, v in vars(state).items()})
    st, _, bc, traj = CL.rollout_closed_loop(
        params, state, R.BoundaryConditions(**BOUNDARY),
        CL.dual_pid_controller, gains,
        CL.make_dual_pid_carry((16,), F64, device), 1.0, m, 20, stages=s)
    return {"pH": st.pH, "chlorine": st.chlorine,
            "temperature": st.temperature,
            "chlorine_flow_rate": bc.chlorine_flow_rate,
            "acid_flow_rate": bc.acid_flow_rate,
            "traj chlorine_outlet": traj["chlorine_outlet"]}


def ekf_case(device) -> Dict[str, torch.Tensor]:
    """Three steps of a bank of 8 EKFs on the 6-zone plant."""
    cfg = _config(6)
    params = R.make_params(cfg, dtype=F64, device=device)
    step = E.make_ekf(params, 6, TAPS, 1.0, R.default_substeps(cfg, 1.0),
                      measurement_noise=4e-4)
    one = E.make_ekf_carry(R.make_initial_state(cfg, dtype=F64,
                                                device=device),
                           (0.05, 1.0, 4.0), 6)
    carry = E.EKFCarry(x=one.x.expand(8, -1), P=one.P.expand(8, -1, -1))
    bc = R.BoundaryConditions(**BOUNDARY)
    for z in _readings(3, (8,), 1):
        carry, _ = step(carry, torch.from_numpy(z).to(device), bc)
    return {"x": carry.x, "P": carry.P}


def mhe_case(device) -> Dict[str, torch.Tensor]:
    """Two MHE ticks on the 6-zone plant: a 3-step window, 3 Adam
    iterations a tick."""
    cfg = _config(6)
    params = R.make_params(cfg, dtype=F64, device=device)
    step = MH.make_mhe(params, 6, TAPS, 1.0, R.default_substeps(cfg, 1.0),
                       horizon=3, iters=3, measurement_noise=4e-4)
    bc = R.BoundaryConditions(**BOUNDARY)
    carry = MH.make_mhe_carry(R.make_initial_state(cfg, dtype=F64,
                                                   device=device), 3, 4, bc)
    for z in _readings(2, (), 2):
        carry, x_hat = step(carry, torch.from_numpy(z).to(device), bc)
    return {"x_hat": x_hat, "x0": carry.x0}


CASES = {"closed loop": closed_loop_case, "EKF step": ekf_case,
         "MHE step": mhe_case}
