"""The port's estimation and tuning studies (``examples_torch/
enkf_highres.py``, ``pid_tuning_sweep.py``) on the CPU, against the JAX
package, with the JAX side's random draws injected into the port.

- ``enkf_highres`` at the JAX test's arguments (``--zones 16 --members 32
  --steps 10``, ``tests/test_examples.py``): ``main`` prints ``OK`` and no
  ``NOT CONVERGED``. Then the example's run (``assimilate``) against the
  JAX example's loop in-process (examples/enkf_highres.py:60-140: the
  truth, its measurements from NumPy's ``default_rng(1)``, the jitted
  EnKF), with the JAX run's draws injected: the initial ensemble's
  perturbations from ``jax.random.PRNGKey(0)`` split as
  ``make_enkf_carry`` splits it, and every tick's model and observation
  draws from the carried key split as ``enkf_step`` splits it. The analysed
  states within 1e-10 at every tick, in float64: in float32 the two
  packages' roundings differ by up to 3.8e-6 in pH (8 ulp) at the first
  tick.
- ``pid_tuning_sweep`` at ``--gains 16 --steps 4 --refine-iters 1``, not
  the JAX test's ``--steps 20 --refine-iters 3``: the port's closed loop is
  plain PyTorch on the CPU, 121 RK4 substeps a 60-s step, and those
  arguments cost over two minutes there (the refinement's reverse passes
  most of it). The JAX example runs once on the same arguments; the port's
  ``main`` takes JAX's jitter draws (``jax.random.normal(key(k), (8,))``,
  k = 0..3). ``"n_gains": 64`` and the best candidate's index equal,
  ``sweep_best_score``, ``refined_score`` and the tuned gains within 1e-3
  relative.
- Every study of this file and of ``test_torch_examples_mpc.py`` /
  ``test_torch_examples_surrogate.py`` refuses ``--device cuda`` (its
  default) on a host without a card.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu import control as JC
from ics_wt_physicsengine_tpu.core import reactor as JR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from examples_torch import enkf_highres as EH  # noqa: E402
from examples_torch import mpc_dosing as MD  # noqa: E402
from examples_torch import parameter_estimation as PE  # noqa: E402
from examples_torch import pid_tuning_sweep as PT  # noqa: E402
from examples_torch import surrogate_from_historian as SH  # noqa: E402
from examples_torch import surrogate_mpc as SM  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
ENKF_ARGS = ["--zones", "16", "--members", "32", "--steps", "10"]
PID_ARGS = ["--gains", "16", "--steps", "4", "--refine-iters", "1"]


def run_jax_example(name, args, timeout=300):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name + ".py"),
         "--cpu"] + args, cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert out.returncode == 0, (name, out.stdout[-2000:],
                                 out.stderr[-2000:])
    return out.stdout


# ---------------------------------------------------------------------------
# enkf_highres
# ---------------------------------------------------------------------------

def test_enkf_highres_converges_on_the_cpu(capsys):
    text = EH.main(["--device", "cpu"] + ENKF_ARGS)
    printed = capsys.readouterr().out
    assert text == printed.rstrip("\n")
    assert "OK" in printed and "NOT CONVERGED" not in printed
    assert printed.startswith("plant: 16 zones x 9 fields = 144-dim state, "
                              "32-member EnKF on cpu")


def _jax_enkf_run(args, dtype):
    """The JAX example's truth and EnKF (examples/enkf_highres.py:60-140)
    in ``dtype`` (float32 there): the initial perturbations, each
    tick's draws (as the carried key gives them) and each tick's analysed
    mean."""
    Z, N = args.zones, args.members
    config = JR.ReactorConfiguration(
        volume=2000.0, height=4.0, diameter=0.798, n_zones=Z,
        flow_rate=5.0, initial_pH=7.2, initial_chlorine=2.0,
        temperature=20.0, enable_nitrogen=True, enable_gas=True,
        initial_ammonia=0.5)
    params = JR.make_params(config, dtype=dtype)
    substeps = JR.default_substeps(config, args.dt)
    bc = JR.BoundaryConditions(
        inlet_flow_rate=5.0, inlet_pH=7.4, inlet_chlorine=0.6,
        inlet_temperature=18.0, inlet_ammonia=0.8,
        chlorine_flow_rate=0.15)
    truth = dataclasses.replace(
        JR.make_initial_state(config, dtype=dtype),
        pH=jnp.linspace(6.9, 7.5, Z).astype(dtype),
        chlorine=jnp.linspace(2.8, 1.0, Z).astype(dtype),
        temperature=jnp.linspace(22.0, 19.0, Z).astype(dtype),
        ammonia=jnp.linspace(0.9, 0.2, Z).astype(dtype),
    ).update_derived()
    guess = dataclasses.replace(
        JR.make_initial_state(config, dtype=dtype),
        chlorine=jnp.full(Z, 0.4, dtype),
        ammonia=jnp.full(Z, 0.05, dtype),
    ).update_derived()
    enkf_step = jax.jit(JC.make_enkf(
        params, Z, EH.TAPS, args.dt, substeps,
        process_noise=(1e-7, 1e-6, 1e-5),
        measurement_noise=EH.SIGMA ** 2,
        inflation=1.02, localization_radius=max(4.0, Z / 3.0)))
    key = jax.random.PRNGKey(0)
    carry = JC.make_enkf_carry(guess, EH.P0, Z, N, key)
    n = carry.ensemble.shape[1]
    # make_enkf_carry's draw: the second half of the key's split
    pert = np.array(jax.random.normal(jax.random.split(key)[1], (N, n),
                                        dtype))
    tap_idx = [JC.tap_index(f, z, Z, nitrogen=True, gas=True)
               for f, z in EH.TAPS]
    step = jax.jit(lambda s: JR.step(params, s, bc, args.dt, substeps))
    rng = np.random.default_rng(1)
    draws, xs = [], []
    for _ in range(args.steps):
        truth = step(truth)
        zt = np.asarray(JC.flatten_state(truth))[tap_idx]
        z = jnp.asarray(zt + rng.normal(0.0, EH.SIGMA), dtype)
        # enkf_step's draws: key, k_q, k_r = split(carry.key, 3)
        _, k_q, k_r = jax.random.split(carry.key, 3)
        draws.append((np.array(jax.random.normal(k_q, (N, n), dtype)),
                      np.array(jax.random.normal(k_r, (len(EH.TAPS), N),
                                                   dtype))))
        carry, x = enkf_step(carry, z, bc)
        xs.append(np.asarray(x))
    return pert, draws, xs, np.asarray(carry.ensemble)


def test_enkf_highres_with_jax_draws_matches_jax():
    args = EH.parse_args(["--device", "cpu"] + ENKF_ARGS)
    pert, draws, want, _ = _jax_enkf_run(args, jnp.float64)
    got = EH.assimilate(
        args, CPU, dtype=torch.float64, pert=torch.from_numpy(pert),
        draws=[(torch.from_numpy(w), torch.from_numpy(e))
               for w, e in draws], say=lambda line: None)
    assert got["ok"]
    assert len(got["x"]) == len(want) == 10
    for tick, (g, w) in enumerate(zip(got["x"], want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10,
                                   err_msg=f"tick {tick + 1}")


# ---------------------------------------------------------------------------
# pid_tuning_sweep
# ---------------------------------------------------------------------------

def _best_index(printed):
    return int(re.search(r"^best #(\d+):", printed, re.M).group(1))


def test_pid_tuning_sweep_with_jax_jitter_matches_the_jax_example(capsys):
    want_text = run_jax_example("pid_tuning_sweep", PID_ARGS)
    want = json.loads(want_text.strip().splitlines()[-1])
    # examples/pid_tuning_sweep.py:89-91, in float32
    jitter = np.stack([np.array(jax.random.normal(
        jax.random.key(k), (8,), jnp.float32)) for k in range(4)])
    capsys.readouterr()
    got = PT.main(["--device", "cpu"] + PID_ARGS, jitter=jitter)
    printed = capsys.readouterr().out
    assert '"n_gains": 64' in printed and '"tuned"' in printed
    assert json.loads(printed.strip().splitlines()[-1]) == got
    assert got["n_gains"] == want["n_gains"] == 64
    assert _best_index(printed) == _best_index(want_text)
    for key in ("sweep_best_score", "refined_score"):
        assert got[key] == pytest.approx(want[key], rel=1e-3), key
    assert set(got["tuned"]) == set(want["tuned"])
    for key, value in want["tuned"].items():
        assert got["tuned"][key] == pytest.approx(value, rel=1e-3), key


def test_pid_jitter_draws_are_seeded_per_gain():
    draws = PT.jitter_draws(CPU)
    assert draws.shape == (4, PT.N_STARTS) and draws.dtype == torch.float32
    for k in range(4):
        want = torch.randn(PT.N_STARTS, generator=torch.Generator(
            device=CPU).manual_seed(k))
        assert torch.equal(draws[k], want)
    assert torch.equal(draws, PT.jitter_draws(CPU))


@pytest.mark.parametrize("module", [EH, PT, MD, PE, SM, SH],
                         ids=["enkf", "pid", "mpc_dosing",
                              "parameter_estimation", "surrogate_mpc",
                              "surrogate_from_historian"])
def test_the_card_is_the_default_and_is_refused_without_one(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit,
                       match="--device cuda: no CUDA device is available"):
        module.main([])
