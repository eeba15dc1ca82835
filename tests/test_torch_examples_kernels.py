"""The port's examples that reach the card's kernels or shard the plant
(``examples_torch/monte_carlo_uq.py``, ``dosing_program_hil.py``,
``zone_sharded_highres.py``) and the bench's ``bench_plant`` row, on the CPU.

Each example runs as ``python examples_torch/<name>.py --device cpu`` at the
JAX example test's tiny arguments (``tests/test_examples.py``) and prints
its marker. Parity with the JAX package on the same seeded inputs:

- ``monte_carlo_uq`` without sensors (16 plants, 0.02 h, float32 on both
  sides: B1's plain version here, the JAX example's fused rollout there):
  the outlet chlorine quantiles within 2e-3 mg/L, the outlet pH median
  within 1e-2, each exceedance share within one plant (1/16);
- ``dosing_program_hil`` at 0.01 h (36 steps, B3's plain version here, the
  JAX kernel in interpret mode there), the instruments drawing the same
  words: every number of the printed extract within 1.5e-3 (three decimals
  printed) and the same health lines;
- the ``bench_plant`` row's plain rollout (``bench.plant_bench_plain``) on
  its own inputs against ``tools/bench_plant_tpu.py``'s ``plant_rollout``
  / ``plant_rollout_batched`` in float64: the physics within 1e-10 (the
  instruments' noise is drawn differently on each side and is not
  compared)."""

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

from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL
from ics_wt_physicsengine_tpu.ops import fused_plant as JFP
from ics_wt_physicsengine_tpu.ops.fused_rollout import (_LANES,
                                                        _unpack_state)

from ics_wt_physicsengine_torch import bench as B

from torch_port_util import assert_tree_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from examples_torch import dosing_program_hil as HIL  # noqa: E402
from examples_torch import monte_carlo_uq as MC  # noqa: E402

torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")


def run_script(directory, script, args, timeout=300, jax_side=False):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, directory, script)] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, (script, out.stdout[-2000:],
                                 out.stderr[-2000:])
    return out.stdout


# ---------------------------------------------------------------------------
# (a) each example as a user runs it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,marker", [
    (["--plants", "16", "--hours", "0.02"], '"plants": 16'),
    (["--plants", "8", "--hours", "0.02", "--with-sensors"],
     "measured-values"),
    (["--plants", "8", "--hours", "0.02", "--with-sensors",
      "--dosing-program"], "dosing-program"),
], ids=["true-state", "with-sensors", "dosing-program"])
def test_monte_carlo_uq_runs_on_the_cpu(args, marker):
    out = run_script("examples_torch", "monte_carlo_uq.py",
                     ["--device", "cpu"] + args)
    assert marker in out
    report = json.loads(out)
    assert report["backend"] == "cpu"
    assert report["device"]["platform"] == "cpu"


def test_dosing_program_hil_runs_on_the_cpu():
    out = run_script("examples_torch", "dosing_program_hil.py",
                     ["--device", "cpu", "--hours", "0.05"])
    assert "measured-value extract (every 3 s)" in out
    assert "instrument health after the program" in out


def test_zone_sharded_highres_runs_on_the_cpu():
    out = run_script("examples_torch", "zone_sharded_highres.py",
                     ["--device", "cpu", "--zones", "64", "--steps", "20",
                      "--shards", "4"])
    assert "zones" in out.lower()
    assert "using 4 shard(s) (16 zones each)" in out
    # four zone shards of the CPU, halos at every stage: the same bits
    assert "max |pH(sharded) - pH(single-device)| = 0.00e+00" in out


def test_asking_for_the_card_without_one_fails_with_a_message():
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples_torch",
                                      "monte_carlo_uq.py"),
         "--plants", "4", "--hours", "0.001"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "--device cuda: no CUDA device is available" in out.stderr
    assert not out.stdout.strip()


# ---------------------------------------------------------------------------
# (b) parity with the JAX package
# ---------------------------------------------------------------------------

def test_monte_carlo_uq_matches_the_jax_example():
    want = json.loads(run_script("examples", "monte_carlo_uq.py",
                                 ["--cpu", "--plants", "16", "--hours",
                                  "0.02"]))
    got = MC.main(["--device", "cpu", "--plants", "16", "--hours", "0.02"])
    for q in ("p05", "median", "p95"):
        assert abs(got["outlet_chlorine_mg_L"][q]
                   - want["outlet_chlorine_mg_L"][q]) <= 2e-3, q
    assert abs(got["outlet_pH"]["median"]
               - want["outlet_pH"]["median"]) <= 1e-2
    assert set(got["exceedance"]) == set(want["exceedance"])
    for k, v in want["exceedance"].items():
        assert abs(got["exceedance"][k] - v) <= 1 / 16 + 1e-9, k


def _extract(text):
    """The printed extract's rows (numbers) and health lines."""
    rows = [list(map(float, line.split()))
            for line in text.splitlines()
            if re.fullmatch(r"\s*\d+\.\d( +-?\d+\.\d{3}){4}\s*", line)]
    health = [line.split() for line in text.splitlines()
              if "finite" in line and "% of readings" in line]
    return np.array(rows), health


def test_dosing_program_hil_matches_the_jax_interpret_mode_run(capsys):
    hours, n_steps = 0.01, 36
    want_rows, want_health = _extract(run_script(
        "examples", "dosing_program_hil.py",
        ["--cpu", "--hours", str(hours)]))
    # the JAX script's words (default_rng(0), its lane-packed layout) as
    # the kernel reads them on the plant's zone-0 lane
    planes = np.random.default_rng(0).integers(
        -2 ** 31, 2 ** 31, size=(n_steps, JFP.N_WORDS, 8, _LANES),
        dtype=np.int32)
    unpack = jax.vmap(jax.vmap(lambda plane: _unpack_state(
        plane, 1, 20, _LANES // 20)[:, 0]))
    words = np.array(unpack(jnp.asarray(planes)))
    assert words.shape == (n_steps, JFP.N_WORDS, 1)
    capsys.readouterr()
    HIL.report(HIL.replay(hours, CPU, words=words))
    got_rows, got_health = _extract(capsys.readouterr().out)
    assert want_rows.shape == got_rows.shape == (5, 5)
    np.testing.assert_allclose(got_rows, want_rows, rtol=0, atol=1.5e-3)
    assert got_health == want_health and len(got_health) == 4


@pytest.mark.parametrize("tag", ["plant_single_rkc", "plant_batch1024_rk4"])
def test_bench_plant_plain_rollout_matches_bench_plant_tpu(tag):
    _, n_plants, _, rkc = next(c for c in B.PLANT_CONFIGS if c[0] == tag)
    n_steps = 5
    # tools/bench_plant_tpu.py:28-44
    config = JR.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                     n_zones=20)
    substeps = JR.default_substeps(config, 1.0)
    stages = None
    if rkc:
        substeps, stages = JR.default_rkc_plan(config, 1.0, mode="fast")
    bc = JR.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                               inlet_chlorine=0.5, inlet_temperature=26.0,
                               acid_flow_rate=0.1, ambient_temperature=15.0,
                               heat_loss_coefficient=50.0)
    tcfg, tparams, tplant, tbc = B.plant_bench_inputs(n_plants, dtype=F64,
                                                      device=CPU)
    assert dataclasses.asdict(tbc) == dataclasses.asdict(bc)
    if n_plants == 1:
        params, plant = JPL.make_plant(config, seed=1, dtype=jnp.float64)
        want = JPL.plant_rollout(params, plant, bc, 1.0, substeps, n_steps,
                                 record=False, stages=stages)[0]
    else:
        params, plant = JPL.make_plant_batch(config, n_plants, seed=1,
                                             dtype=jnp.float64)
        want = JPL.plant_rollout_batched(params, plant, bc, 1.0, substeps,
                                         n_steps, record=False,
                                         stages=stages)[0]
    # the same plants (bench_plant_tpu.py's seed 1), bit for bit
    assert_tree_close(tparams.reactor, params.reactor)
    assert_tree_close(tplant.reactor, plant.reactor)
    got = B.plant_bench_plain(tparams, tplant, tbc, substeps, stages,
                              n_steps,
                              generator=torch.Generator().manual_seed(1))
    for name in ("pH", "chlorine", "temperature"):
        np.testing.assert_allclose(
            getattr(got.reactor, name).numpy(),
            np.asarray(getattr(want.reactor, name)), rtol=0, atol=1e-10,
            err_msg=name)
    np.testing.assert_array_equal(got.reactor.time.numpy(),
                                  np.asarray(want.reactor.time))
