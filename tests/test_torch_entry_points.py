"""The port's module entry points and the register addresses its served
examples use, on the CPU.

- ``python -m ics_wt_physicsengine_torch.core.<axis> --device cpu`` for the
  six extension axes and ``python -m ics_wt_physicsengine_torch.sensors.
  validation --device cpu`` run their suites and exit 0 (the seven run side
  by side, as processes of their own). With a suite made to fail, each
  block exits 1: an axis suite returning False (its clips made to return
  NaN, so that its checks fail rather than raise), the sensor suite raising
  (the ammonia suite made to fail). Without ``--device`` the card is asked
  for, and refused on a host without one.
- Every ``ADDR`` (input register) and ``HOLDING`` (holding register) table
  in ``examples_torch/*.py`` names each register at the address the port's
  ``modbus/register_map.py`` gives that name. The JAX
  ``examples/ekf_soft_sensor.py:48-50`` reads the two stock concentrations
  from holding registers 6 and 8, which the map leaves unassigned (it has
  them at 10 and 12); the port's example reads 10 and 12, and a copy of its
  table at 6 and 8 is caught.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ics_wt_physicsengine_torch.device import module_device
from ics_wt_physicsengine_torch.modbus.register_map import (
    ModbusRegisterMap, RegisterType)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PACKAGE = "ics_wt_physicsengine_torch"
AXES = ("nitrogen", "gas", "particles", "disinfection", "biofilm", "phase")
MODULES = {f"core.{axis}": "validation: ALL PASS" for axis in AXES}
MODULES["sensors.validation"] = "ALL SENSOR VALIDATIONS PASSED on cpu"
TIMEOUT_S = 240


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def entry_point_runs():
    """``python -m <module> --device cpu`` for each of ``MODULES``, started
    together: ``{module: (exit code, output)}``."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE}.{name}", "--device", "cpu"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in MODULES}
    runs = {}
    try:
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=TIMEOUT_S)
            runs[name] = (proc.returncode, out)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
    return runs


@pytest.mark.parametrize("name", sorted(MODULES))
def test_entry_point_runs_its_suite_on_the_cpu(name, entry_point_runs):
    rc, out = entry_point_runs[name]
    assert rc == 0, out[-2000:]
    assert MODULES[name] in out, out[-2000:]
    assert "FAIL" not in out


# Each axis block run as ``__main__`` (``runpy``, as ``python -m`` runs it)
# in one process, its exit code recorded, with the clips of
# ``utils/dispatch.py`` returning NaN (each axis module imports them when it
# runs); then the sensor block with the ammonia suite failing, its exception
# left to end the process as it ends ``python -m``.
FAILING = """
import json, runpy, sys
import ics_wt_physicsengine_torch.utils.dispatch as D
import ics_wt_physicsengine_torch.sensors.ammonia as A

def run(module):
    sys.argv = [module, "--device", "cpu"]
    runpy.run_module(module, run_name="__main__")

def exit_code(module):
    try:
        run(module)
    except SystemExit as e:
        return e.code
    except Exception as e:
        return f"raised {type(e).__name__}: {e}"
    return 0

codes = {}
clip, nonneg, absolute = D.clip, D.nonneg, D.absolute
D.clip = lambda x, lo=None, hi=None: x * float("nan")
D.nonneg = D.absolute = lambda x: x * float("nan")
for axis in %r:
    codes["core." + axis] = exit_code(
        "ics_wt_physicsengine_torch.core." + axis)
print("CODES " + json.dumps(codes), flush=True)
D.clip, D.nonneg, D.absolute = clip, nonneg, absolute
A.validate_ammonia_sensor = lambda verbose=True, device=None: False
run("ics_wt_physicsengine_torch.sensors.validation")
""" % (AXES,)


@pytest.fixture(scope="module")
def failing_runs():
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", FAILING],
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=TIMEOUT_S)
    line = [x for x in out.stdout.splitlines() if x.startswith("CODES ")]
    assert line, (out.stdout[-2000:], out.stderr[-2000:])
    codes = json.loads(line[-1][len("CODES "):])
    codes["sensors.validation"] = out.returncode
    return codes, out.stdout, out.stderr


@pytest.mark.parametrize("name", sorted(MODULES))
def test_a_failing_suite_exits_1(name, failing_runs):
    codes, stdout, stderr = failing_runs
    assert codes[name] == 1, (codes, stdout[-2000:], stderr[-2000:])
    if name.startswith("core."):
        # the suite returned False: it printed its failures, it did not
        # raise
        title = {"core.nitrogen": "Nitrogen chemistry",
                 "core.gas": "Gas exchange",
                 "core.particles": "Particle dynamics",
                 "core.disinfection": "Disinfection",
                 "core.biofilm": "Biofilm",
                 "core.phase": "Phase-change"}[name]
        assert f"{title} validation: FAILURES PRESENT" in stdout
    else:
        assert "ammonia sensor validation failed" in stderr


def test_the_entry_points_want_the_card_unless_told_otherwise():
    assert module_device(["--device", "cpu"]) == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit,
                       match="--device cuda: no CUDA device is available"):
        module_device([])


# ---------------------------------------------------------------------------
# register addresses in the served examples
# ---------------------------------------------------------------------------

TABLES = {"ADDR": RegisterType.INPUT_REGISTER,
          "HOLDING": RegisterType.HOLDING_REGISTER}
REGISTER_MAP = ModbusRegisterMap(
    extended_nitrogen=True, extended_gas=True, extended_particles=True,
    extended_disinfection=True, extended_biofilm=True, extended_phase=True)


def register_tables(path):
    """The module-level ``ADDR`` and ``HOLDING`` dicts of a script:
    ``{table name: {register name: address}}``."""
    tables = {}
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) in TABLES):
            tables[node.targets[0].id] = ast.literal_eval(node.value)
    return tables


def misplaced(table, register_type):
    """``(name, address in the table, address in the map)`` for every entry
    the port's register map puts elsewhere (or not at all, None)."""
    wrong = []
    for name, address in table.items():
        reg = REGISTER_MAP.get_register_by_name(name)
        want = (reg.address if reg is not None
                and reg.register_type == register_type else None)
        if address != want:
            wrong.append((name, address, want))
    return wrong


SCRIPTS = {p.name: register_tables(p)
           for p in sorted((REPO / "examples_torch").glob("*.py"))}
WITH_TABLES = sorted(name for name, tables in SCRIPTS.items() if tables)


def test_the_served_examples_have_register_tables():
    assert "ekf_soft_sensor.py" in WITH_TABLES
    assert set(SCRIPTS["ekf_soft_sensor.py"]) == set(TABLES)


@pytest.mark.parametrize("script", WITH_TABLES)
def test_register_tables_match_the_register_map(script):
    for table, values in SCRIPTS[script].items():
        assert values, (script, table)
        assert not misplaced(values, TABLES[table]), (script, table)


def test_the_jax_examples_holding_registers_are_caught():
    holding = dict(SCRIPTS["ekf_soft_sensor.py"]["HOLDING"])
    assert (holding["acid_concentration"],
            holding["chlorine_concentration"]) == (10, 12)
    # examples/ekf_soft_sensor.py:48-50
    holding.update(acid_concentration=6, chlorine_concentration=8)
    assert misplaced(holding, RegisterType.HOLDING_REGISTER) == [
        ("acid_concentration", 6, 10), ("chlorine_concentration", 8, 12)]
    # an input register's name in the holding table is caught too
    assert misplaced({"pH_outlet": 4}, RegisterType.HOLDING_REGISTER) == [
        ("pH_outlet", 4, None)]
