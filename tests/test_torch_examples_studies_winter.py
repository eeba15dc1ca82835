"""The port's winter-operations study (``examples_torch/
winter_operations.py``: the phase-change axis through a ``[n_steps]``
schedule) on the CPU, against the JAX example, as a user runs it:
``main(["--device", "cpu", "--days", "0.5", "--dt", "600"])`` in-process at
the JAX test's arguments (``tests/test_examples.py``), float32, its JSON
against ``python examples/winter_operations.py --cpu`` on the same
arguments, which runs beside it: every number within 1.5 units of its last
printed decimal, ``outlet_liquid_at_end`` and the plateau note's counts
equal, the JAX test's markers printed.

The float32 run takes most of a minute of plain PyTorch steps on the CPU
(72 steps of 193 RK4 substeps), so the float64 rollout against JAX's
(1e-9) is in ``tests/test_torch_examples_studies.py``.
"""

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from examples_torch import winter_operations as W  # noqa: E402

torch.set_num_threads(1)

ARGS = ["--days", "0.5", "--dt", "600"]


def start_jax_example(args):
    """``python examples/winter_operations.py --cpu ARGS``, started: it
    runs beside the port's in-process run."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples",
                                      "winter_operations.py"), "--cpu"]
        + args, cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _decimals(x):
    text = repr(x)
    return len(text.split(".")[1]) if "." in text else 0


def test_winter_operations_matches_the_jax_example(capsys):
    proc = start_jax_example(ARGS)
    try:
        capsys.readouterr()
        got = W.main(["--device", "cpu"] + ARGS)
        printed = capsys.readouterr().out
        want_text, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, (want_text[-2000:], err[-2000:])
    assert "hours_of_surface_ice" in printed and "plateau_note" in printed
    assert json.loads(printed) == got
    want = json.loads(want_text)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float):
            assert abs(got[k] - w) <= 1.5 * 10.0 ** -_decimals(w), (k, got,
                                                                    want)
        else:
            # outlet_liquid_at_end, the plateau note's step counts
            assert got[k] == w, (k, got[k], w)
