"""Kernels B1 and B2 on the CUDA card against their plain PyTorch versions
on the same inputs (the kernels have no CPU mode, so these tests skip
without a card). This file imports no JAX: the machine with the card has
none. Run it there with

    python -m pytest -m gpu --noconftest -p no:randomly tests/test_torch_gpu.py

The tables and tolerances are ``ops/kernel_checks.py``'s, which
``chip_smoke.py`` runs at the main path's shapes."""

import numpy as np
import pytest
import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.ops import fused_rollout as F
from ics_wt_physicsengine_torch.ops import kernel_checks as K

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_zones,n_plants", [(20, 1), (5, 37), (20, 50)])
@pytest.mark.parametrize("substeps,stages", [(3, None), (1, 4), (2, 3)])
def test_b1_matches_plain(cuda, dtype, n_zones, n_plants, substeps, stages):
    got, err = K.b1_vs_plain(n_zones, n_plants, dtype, cuda,
                             substeps=substeps, stages=stages, n_steps=40,
                             record_every=8)
    assert err <= K.TOL[dtype]
    assert torch.equal(got[3][0][-1], got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_b2_matches_plain_and_constant_schedule_equals_b1(cuda, dtype):
    _, err = K.b2_vs_plain(20, 13, dtype, cuda, substeps=3, stages=None,
                           n_steps=30, record_every=5)
    assert err <= K.TOL[dtype]
    assert K.constant_schedule_equals_b1(20, 13, dtype, cuda, substeps=3,
                                         stages=4, n_steps=30)


def test_wrappers_launch_the_kernels_on_cuda_tensors(cuda):
    params = R.make_params(R.ReactorConfiguration(n_zones=20), device=cuda)
    state = R.make_initial_state(R.ReactorConfiguration(n_zones=20),
                                 device=cuda)
    F.reset_launch_counts()
    out = F.rollout_fused(params, state, K.BC, dt=1.0, substeps=3,
                          n_steps=10)
    sched = R.BoundaryConditions(inlet_pH=np.full(10, 7.0))
    out2 = F.rollout_scheduled_fused(params, state, sched, dt=1.0,
                                     substeps=3)
    torch.cuda.synchronize()
    assert F.LAUNCHES == {"rollout_fused": 1, "rollout_scheduled_fused": 1}
    assert out.pH.is_cuda and out.pH.shape == (20,)
    assert bool(torch.isfinite(out2.chlorine).all())


def test_b1_float64_matches_the_cpu_path(cuda):
    """The kernel on the card against the plain version on the CPU, which
    the CPU suite holds to the JAX package."""
    assert K.b1_vs_cpu(16, cuda, substeps=2, n_steps=50) <= K.CPU_TOL
