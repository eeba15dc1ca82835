"""The port's served examples (``examples_torch/pid_controller.py``,
``fleet_farm.py``, ``relay_autotune.py``, ``opcua_scada.py``,
``ekf_soft_sensor.py``) on the CPU.

Each spawns the port's orchestrator in a thread of its own process (with
``--device cpu`` passed through) and ends through ``shutdown_sim``, whose
last resort is ``os._exit(0)``; so each runs here as a subprocess, never
in-process, at the JAX example test's small iteration counts
(``tests/test_examples.py``), and must exit 0 with the same marker. Asking
for the card on a host without one fails at once with a message."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(script, args, timeout=300):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples_torch", script)]
        + args, cwd=REPO, capture_output=True, text=True, timeout=timeout)


def run_ok(script, args, timeout=300):
    out = run(script, args + ["--device", "cpu"], timeout)
    assert out.returncode == 0, (script, out.stdout[-2000:],
                                 out.stderr[-2000:])
    return out.stdout


@pytest.mark.parametrize("extra", [[], ["--feedforward"]],
                         ids=["pi", "feedforward"])
def test_pid_controller_spawn(extra):
    out = run_ok("pid_controller.py", ["--spawn", "--iterations", "15",
                                       "--period", "0.1"] + extra)
    assert "setpoint" in out.lower() or "iter" in out.lower()
    assert "final: Cl_out=" in out


def test_fleet_farm_spawn():
    out = run_ok("fleet_farm.py", ["--units", "2", "--iterations", "20"])
    assert '"fleet_units": 2' in out
    report = json.loads(out[out.index("{"):])
    assert [u["unit"] for u in report["per_unit_residual_control"]] == [1, 2]


def test_relay_autotune_spawn():
    out = run_ok("relay_autotune.py", ["--switches", "4",
                                       "--verify-iterations", "20"])
    assert "ultimate_gain_Ku" in out and "ziegler_nichols_PI" in out
    report = json.loads(out[out.index("{"):])
    assert report["relay"]["switches"] == 4
    assert report["ultimate_gain_Ku"] > 0


def test_opcua_scada_spawn():
    out = run_ok("opcua_scada.py", ["--spawn", "--publishes", "20",
                                    "--interval", "0.15"])
    assert "subscribed:" in out
    assert "pushed data changes" in out


def test_ekf_soft_sensor_spawn():
    out = run_ok("ekf_soft_sensor.py", ["--spawn", "--ticks", "8"])
    assert "estimated Cl profile" in out
    assert "soft sensor assimilated 8 ticks" in out


@pytest.mark.parametrize("script,args", [
    ("pid_controller.py", ["--spawn", "--iterations", "1"]),
    ("ekf_soft_sensor.py", ["--spawn", "--ticks", "1"]),
])
def test_asking_for_the_card_without_one_fails(script, args):
    out = run(script, args, timeout=120)
    assert out.returncode != 0
    assert "--device cuda: no CUDA device is available" in out.stderr
    assert not out.stdout.strip()
