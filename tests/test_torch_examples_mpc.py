"""The port's calibration and MPC studies (``examples_torch/
parameter_estimation.py``, ``mpc_dosing.py``) on the CPU, against the JAX
examples.

The two JAX examples run as subprocesses (a 300 s timeout each), started
together when the first test asks for them, while the port runs here.

- ``parameter_estimation`` at the JAX test's ``--steps 60 --iters 25``
  (``tests/test_examples.py``), float64 on both sides (the JAX example's
  ``--cpu`` turns x64 on; the port's ``--device cpu`` runs float64). The
  observation noise is NumPy's ``default_rng(0)`` in both, so nothing is
  injected. Every line the port prints equals the JAX example's, apart
  from the seconds of the "recovered in" line, and every number of the
  table and of the recovered ``k_ref`` and mixing scale lies within 1e-8
  relative of the JAX example's. Unrounded: each Adam step's loss and
  parameters against the JAX example's loop rebuilt here
  (examples/parameter_estimation.py:84-126, ``optax.adam(5e-2)``), within
  1e-8 relative.
- ``mpc_dosing`` at ``--zones 4 --minutes 20 --output-feedback``, the JAX
  test's arguments but for ``--minutes`` (40 there), with every MPC cut to
  2 Adam iterations a re-plan on both sides: the port through
  ``main(argv, mpc=(6, 10, 2))``, the JAX example through ``python -c``
  code that wraps ``control.run_mpc``, ``control.run_mpc_output_feedback``,
  ``control.mpc.run_mpc`` and ``models.surrogate.run_mpc_surrogate`` to
  force ``iters=2`` and then runs the example with ``runpy``; no JAX file
  changes. The example's fixed 20 iterations at 20 minutes cost minutes of
  plain PyTorch on the CPU (2 re-plans of 6 x 10 steps of 5 RK4 substeps,
  forward and reverse, per iteration). The PID's ``score_ISE`` and the MPC
  score within 1e-4 relative (float32), ``kp``, ``ki`` and
  ``mpc_beats_pid`` equal. The output-feedback branch draws its instrument
  noise from each package's own generator, so it is held to its keys and
  finite values; its parity with JAX's draws injected is
  ``test_torch_estimation.py::test_run_mpc_output_feedback_matches_jax``.
"""

import importlib.util
import json
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ics_wt_physicsengine_tpu.core import reactor as JR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from examples_torch import mpc_dosing as MD  # noqa: E402
from examples_torch import parameter_estimation as PE  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
PE_ARGS = ["--steps", "60", "--iters", "25"]
MD_ARGS = ["--zones", "4", "--minutes", "20", "--output-feedback"]
MPC_ITERS = 2
TIMEOUT_S = 300
REL = 1e-8
# runs a JAX example with every MPC's Adam iterations forced to argv[1]
CUT_ITERS = """
import functools, runpy, sys
iters, script = int(sys.argv[1]), sys.argv[2]
sys.argv = sys.argv[2:]
from ics_wt_physicsengine_tpu import control
from ics_wt_physicsengine_tpu.control import mpc
from ics_wt_physicsengine_tpu.models import surrogate

def cut(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        kwargs["iters"] = iters
        return fn(*args, **kwargs)
    return run

for module, name in ((control, "run_mpc"),
                     (control, "run_mpc_output_feedback"),
                     (mpc, "run_mpc"), (surrogate, "run_mpc_surrogate")):
    setattr(module, name, cut(getattr(module, name)))
runpy.run_path(script, run_name="__main__")
"""


class JaxRun:
    """A JAX example started as a subprocess; ``stdout()`` waits for it."""

    def __init__(self, name, args, iters=None):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["JAX_PLATFORMS"] = "cpu"
        script = os.path.join(REPO, "examples", name + ".py")
        cmd = [sys.executable, script, "--cpu"] + args if iters is None \
            else [sys.executable, "-c", CUT_ITERS, str(iters), script,
                  "--cpu"] + args
        self.name = name
        self.proc = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
        self.out = None

    def stdout(self):
        if self.out is None:
            try:
                out, err = self.proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                raise
            assert self.proc.returncode == 0, (self.name, out[-2000:],
                                               err[-2000:])
            self.out = out
        return self.out


@pytest.fixture(scope="module")
def jax_runs():
    runs = {"pe": JaxRun("parameter_estimation", PE_ARGS),
            "md": JaxRun("mpc_dosing", MD_ARGS, iters=MPC_ITERS)}
    yield runs
    for run in runs.values():
        if run.proc.poll() is None:
            run.proc.kill()
            run.proc.communicate()


# ---------------------------------------------------------------------------
# parameter_estimation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pe_port(jax_runs):
    """The port's calibration at PE_ARGS in float64: its printed lines and
    its unrounded history."""
    lines = []
    result = PE.calibrate(PE.parse_args(["--device", "cpu"] + PE_ARGS), CPU,
                          say=lines.append)
    return "\n".join(lines), result


def _numbers(text):
    """Every number printed, the seconds of the "recovered in" line left
    out."""
    text = re.sub(r"recovered in [0-9.]+s", "recovered in", text)
    return [float(x) for x in re.findall(
        r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", text)]


def test_parameter_estimation_prints_the_jax_example_table(jax_runs,
                                                           pe_port):
    text, _ = pe_port
    want = jax_runs["pe"].stdout().rstrip("\n")
    strip = re.compile(r"recovered in [0-9.]+s")
    assert strip.sub("", text).splitlines() == \
        strip.sub("", want).splitlines()
    got_n, want_n = _numbers(text), _numbers(want)
    assert len(got_n) == len(want_n) > 40
    np.testing.assert_allclose(got_n, want_n, rtol=REL, atol=0)
    assert "recovered in" in text and "mixing scale:" in text


def _load_jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_calibration(steps, iters, noise=0.02, seed=0):
    """The JAX example's loop in float64 (examples/parameter_estimation.py
    :84-126): each Adam step's loss and parameters, unrounded."""
    import dataclasses

    JPE = _load_jax_example("parameter_estimation")
    dtype = jnp.float64
    config, params, state, schedule = JPE.build_problem(steps, dtype=dtype)
    substeps = JR.default_substeps(config, 1.0)

    def simulate(log10_k, log_kx_scale):
        p = dataclasses.replace(
            params, cl_k_ref=10.0 ** log10_k,
            k_exchange=params.k_exchange * jnp.exp(log_kx_scale))
        _, traj = JR.rollout_scheduled(p, state, schedule, dt=1.0,
                                       substeps=substeps)
        return traj["chlorine"][:, -1], traj["temperature"][:, -1]

    theta_true = (jnp.log10(jnp.asarray(PE.K_TRUE, dtype)),
                  jnp.log(jnp.asarray(PE.KX_SCALE_TRUE, dtype)))
    cl_clean, temp_clean = jax.jit(simulate)(*theta_true)
    rng = np.random.default_rng(seed)
    cl_obs = jnp.asarray(np.asarray(cl_clean)
                         + rng.normal(0, noise, cl_clean.shape))
    temp_obs = jnp.asarray(np.asarray(temp_clean)
                           + rng.normal(0, 0.1, temp_clean.shape))

    def loss(theta):
        cl, temp = simulate(*theta)
        return (jnp.mean((cl - cl_obs) ** 2) / (noise ** 2)
                + jnp.mean((temp - temp_obs) ** 2) / (0.1 ** 2))

    opt = optax.adam(5e-2)
    theta = (jnp.asarray(-4.0, dtype), jnp.asarray(0.0, dtype))
    opt_state = opt.init(theta)

    @jax.jit
    def update(theta, opt_state):
        val, g = jax.value_and_grad(loss)(theta)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(theta, updates), opt_state, val

    history = []
    for _ in range(iters):
        theta, opt_state, val = update(theta, opt_state)
        history.append((float(val), float(theta[0]), float(theta[1])))
    return history


def test_parameter_estimation_history_matches_jax_in_float64(pe_port):
    _, got = pe_port
    want = _jax_calibration(60, 25)
    assert len(got["history"]) == len(want) == 25
    np.testing.assert_allclose(np.array(got["history"]), np.array(want),
                               rtol=REL, atol=0)
    assert got["k_hat"] == pytest.approx(10.0 ** want[-1][1], rel=REL)
    assert got["kx_hat"] == pytest.approx(math.exp(want[-1][2]), rel=REL)
    # the handbook start moved toward the truth
    assert 1e-4 < got["k_hat"] and got["kx_hat"] < 1.0


def test_parameter_estimation_main_prints_what_it_returns(capsys):
    text = PE.main(["--device", "cpu", "--steps", "8", "--iters", "3"])
    printed = capsys.readouterr().out
    assert text == printed.rstrip("\n")
    lines = text.splitlines()
    assert lines[0] == ("observations: 8 s of noisy outlet Cl + T "
                        "(sigma = 0.02 mg/L, 0.1 C)")
    assert [int(line.split()[0]) for line in lines[2:5]] == [0, 1, 2]
    assert "(3 Adam steps, each = 1 rollout + 1 backward)" in text


# ---------------------------------------------------------------------------
# mpc_dosing
# ---------------------------------------------------------------------------

def test_mpc_dosing_matches_the_jax_example(jax_runs, capsys):
    got = MD.main(["--device", "cpu"] + MD_ARGS,
                  mpc=MD.MPC[:2] + (MPC_ITERS,))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    want = json.loads(jax_runs["md"].stdout().strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["program"] == want["program"] == {"levels": [2.0, 1.0],
                                                 "minutes": 20}
    assert set(got["pid"]) == set(want["pid"])
    assert got["pid"]["kp"] == want["pid"]["kp"]
    assert got["pid"]["ki"] == want["pid"]["ki"]
    for part in ("pid", "mpc"):
        assert got[part]["score_ISE"] == pytest.approx(
            want[part]["score_ISE"], rel=1e-4), part
    assert got["mpc_beats_pid"] == want["mpc_beats_pid"]
    of, want_of = got["mpc_output_feedback"], want["mpc_output_feedback"]
    assert set(of) == set(want_of)
    assert all(math.isfinite(v) for v in of.values())
    assert 0.0 <= of["final_measured_Cl"] < 5.0


def test_mpc_settings_are_the_jax_examples():
    assert MD.MPC == (6, 10, 20)
