"""The port's network and axis studies (``examples_torch/treatment_train.py``,
``clarifier_train.py``, ``chloramine_curve.py``, ``jar_test.py``) on the
CPU, against the JAX examples on the same arguments.

Each JAX example runs once, as ``python examples/<name>.py --cpu ...`` at
its test's arguments (``tests/test_examples.py``); its output is shared by
the cases below. Each port example runs in-process through its
``main(argv)`` with ``--device cpu`` at the same arguments, prints the JAX
test's marker, and is held to the JAX example's numbers (float32 on both
sides):

- ``treatment_train`` and ``clarifier_train`` (``--hours 0.25 --doses 4``):
  the same lines, every printed number within 1.5e-3 (three decimals at
  most are printed), the same best dose; "one vmapped call" is "one
  batched call" in the port.
- ``chloramine_curve`` (``--doses 8 --contact-min 2``):
  ``"stoich_ratio_Cl2_N": 5.062`` exactly, every number of the curve and
  the knee within 1.5e-3.
- ``jar_test`` (no JAX test; here ``--doses 8 --settle-min 10
  --target-ntu 48``, a target that the third dose of the printed curve
  meets): every number of the JSON within 1.5 units of its last printed
  decimal, the optimal dose equal.

And ``winter_operations``'s rollout in float64, in-process: ``simulate``
against the JAX package's ``rollout_scheduled`` on the schedule the JAX
example builds, the temperature trajectory within 1e-9. A short, colder run
(``--days 0.05 --heat-loss 1000``, 7 steps) so that the tank crosses the
mushy band, pins on its plateau and freezes: the JAX test's arguments never
leave the liquid range, and float64 at their 72 steps would cost about a
minute of plain PyTorch steps more. The printed float32 run at the JAX
test's arguments is ``tests/test_torch_examples_studies_winter.py``.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import phase as JPH
from ics_wt_physicsengine_tpu.core import reactor as JR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from examples_torch import chloramine_curve as CHL  # noqa: E402
from examples_torch import clarifier_train as CLA  # noqa: E402
from examples_torch import jar_test as JAR  # noqa: E402
from examples_torch import treatment_train as TT  # noqa: E402
from examples_torch import winter_operations as W  # noqa: E402

torch.set_num_threads(1)

ARGS = {
    "treatment_train": ["--hours", "0.25", "--doses", "4"],
    "clarifier_train": ["--hours", "0.25", "--doses", "4"],
    "chloramine_curve": ["--doses", "8", "--contact-min", "2"],
    "jar_test": ["--doses", "8", "--settle-min", "10", "--target-ntu", "48"],
}
WINTER_SHORT = ["--days", "0.05", "--dt", "600", "--heat-loss", "1000"]
NUMBER = re.compile(r"-?\d+\.\d+|-?\d+")


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


@pytest.fixture(scope="module")
def jax_outputs():
    """Each JAX example's output at ``ARGS``, run on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_jax_example(name, ARGS[name])
        return cache[name]
    return get


def run_port(module, name, capsys):
    capsys.readouterr()
    result = module.main(["--device", "cpu"] + ARGS[name])
    return result, capsys.readouterr().out


def _numbers(text):
    return [float(x) for x in NUMBER.findall(text)]


def _lines_match(got, want, atol):
    """The same lines with the numbers masked, and every number within
    ``atol``."""
    got_lines = got.strip().splitlines()
    want_lines = want.strip().replace("one vmapped call",
                                      "one batched call").splitlines()
    assert len(got_lines) == len(want_lines), (got, want)
    for g, w in zip(got_lines, want_lines):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        gn, wn = _numbers(g), _numbers(w)
        assert len(gn) == len(wn), (g, w)
        for a, b in zip(gn, wn):
            assert abs(a - b) <= atol, (g, w)


def _json_close(got, want, path=""):
    """Every number within 1.5 units of its last printed decimal; other
    values equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        decimals = len(repr(want).split(".")[1]) if "." in repr(want) else 0
        assert abs(got - want) <= 1.5 * 10.0 ** -decimals, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name,module,markers", [
    ("treatment_train", TT, ("booster sweep", "finished-water residual")),
    ("clarifier_train", CLA, ("coagulant sweep", "class split")),
])
def test_network_study_matches_the_jax_example(name, module, markers,
                                               jax_outputs, capsys):
    text, printed = run_port(module, name, capsys)
    assert text == printed.rstrip("\n")
    assert all(m in printed for m in markers)
    want = jax_outputs(name)
    _lines_match(printed, want, atol=1.5e-3)
    # the best dose (the sweep's last line) is the same dose
    assert _numbers(printed.splitlines()[-1])[:2] == \
        _numbers(want.strip().splitlines()[-1])[:2]


def test_treatment_train_sweep_is_one_batched_rollout():
    """The sweep's realizations: the booster dose a ``[doses, 1]`` leaf,
    and each realization's finished water equals its own single-train run
    (float64, 6 steps: past the 5-step pipe delay)."""
    cpu = torch.device("cpu")
    params, ns0, ta = TT.make_train(torch.float64, cpu)
    doses = torch.linspace(0.0, 0.5, 3, dtype=torch.float64)
    with torch.no_grad():
        fs_all, _ = TT.N.rollout_network(
            params, ta, TT.realizations(ns0, 3),
            TT.boundary(doses[:, None], cpu), TT.DT, TT.SUBSTEPS, 6,
            record=False)
        for i in range(3):
            one, _ = TT.N.rollout_network(params, ta, ns0,
                                          TT.boundary(float(doses[i]), cpu),
                                          TT.DT, TT.SUBSTEPS, 6,
                                          record=False)
            torch.testing.assert_close(fs_all.reactor.chlorine[i],
                                       one.reactor.chlorine, rtol=1e-12,
                                       atol=1e-12)
    assert fs_all.reactor.chlorine.shape == (3, 3, 5)


def test_chloramine_curve_matches_the_jax_example(jax_outputs, capsys):
    got, printed = run_port(CHL, "chloramine_curve", capsys)
    assert '"stoich_ratio_Cl2_N": 5.062' in printed
    assert json.loads(printed) == got
    want = json.loads(jax_outputs("chloramine_curve"))
    assert got["stoich_ratio_Cl2_N"] == want["stoich_ratio_Cl2_N"] == 5.062
    assert abs(got["observed_knee_ratio"]
               - want["observed_knee_ratio"]) <= 1.5e-3
    assert len(got["curve"]) == len(want["curve"]) == 8
    for g, w in zip(got["curve"], want["curve"]):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= 1.5e-3, (k, g, w)
    assert (got["ammonia_mgN_L"], got["contact_min"]) == (1.0, 2.0)


def test_jar_test_matches_the_jax_example(jax_outputs, capsys):
    got, printed = run_port(JAR, "jar_test", capsys)
    assert json.loads(printed) == got
    want = json.loads(jax_outputs("jar_test"))
    _json_close(got, want)
    # the target is met, by the same dose
    assert got["optimal_dose_mgL"] is not None
    assert got["optimal_dose_mgL"] == want["optimal_dose_mgL"]
    ntu = [c["supernatant_ntu"] for c in got["curve"]]
    assert ntu == sorted(ntu, reverse=True)


def _jax_trajectory(args):
    """The JAX example's rollout (examples/winter_operations.py:66-100) in
    float64: the temperature trajectory [n_steps, Z]."""
    cfg = JR.ReactorConfiguration(
        volume=1000.0, height=2.0, diameter=0.798, n_zones=args.zones,
        flow_rate=1.0, temperature=4.0, enable_phase=True)
    params = JR.make_params(cfg, dtype=jnp.float64)
    state = JR.make_initial_state(cfg, dtype=jnp.float64)
    n_steps = int(args.days * 86400 / args.dt)
    t = np.arange(n_steps) * args.dt
    t_amb = (0.5 * (args.t_day + args.t_night)
             - 0.5 * (args.t_day - args.t_night)
             * np.cos(2 * np.pi * (t / 86400.0 - 4.0 / 24.0)))
    purge_on = (args.purge_c > 0) \
        & (t >= args.days * 86400.0 - args.purge_hours * 3600.0)
    base = JR.BoundaryConditions(
        inlet_flow_rate=1.0, inlet_temperature=4.0,
        heat_loss_coefficient=args.heat_loss,
        ambient_humidity=0.6, wind_speed=args.wind)
    schedule = {f.name: getattr(base, f.name)
                for f in dataclasses.fields(base)}
    schedule = JR.BoundaryConditions(**{
        k: (None if v is None else jnp.broadcast_to(
            jnp.asarray(v, jnp.float64), (n_steps,)))
        for k, v in schedule.items()})
    schedule = dataclasses.replace(
        schedule,
        ambient_temperature=jnp.asarray(t_amb, jnp.float64),
        inlet_temperature=jnp.where(jnp.asarray(purge_on), args.purge_c,
                                    4.0).astype(jnp.float64),
        inlet_flow_rate=jnp.where(jnp.asarray(purge_on), 20.0,
                                  1.0).astype(jnp.float64))
    substeps = max(JR.default_substeps(cfg, args.dt), 16)
    _, traj = JR.rollout_scheduled(params, state, schedule, dt=args.dt,
                                   substeps=substeps, record=True)
    return np.asarray(traj["temperature"]), params.phase


def test_scheduled_phase_rollout_matches_jax_in_float64():
    args = W.parse_args(["--device", "cpu"] + WINTER_SHORT)
    pp, T, t_amb = W.simulate(args, torch.float64, torch.device("cpu"))
    want, jpp = _jax_trajectory(args)
    assert T.shape == want.shape == (7, args.zones)
    np.testing.assert_allclose(T.numpy(), want, rtol=0, atol=1e-9)
    # the run crosses the band: liquid, mushy plateau, then ice
    phi = JPH.ice_fraction(jnp.asarray(want), jpp)
    assert float(phi[0, -1]) < 0.5 and float(phi[-1, -1]) > 0.9
    assert ((want > -0.5) & (want <= 0.0)).any()
    report = W.report(args, pp, T, t_amb)
    assert report["peak_surface_ice_fraction"] > 0.9
    assert report["outlet_liquid_at_end"] is False


@pytest.mark.parametrize("module", [TT, CLA, CHL, JAR],
                         ids=["treatment", "clarifier", "chloramine", "jar"])
def test_the_card_is_the_default_and_is_refused_without_one(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit,
                       match="--device cuda: no CUDA device is available"):
        module.main([])
