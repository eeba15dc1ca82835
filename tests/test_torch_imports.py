"""The PyTorch port, its smoke script, its tools (``tools/torch_*.py``), its
examples (``examples_torch/*.py``) and its GPU tests import neither JAX,
optax (the card's machine has none), the JAX package, nor the JAX side's
scripts: ``examples/`` (``from examples.pid_controller import ...``), the
JAX tools of ``tools/`` (imported by their file names once ``tools/`` is on
the path) or the root ``bench.py``. Checked on the source (an AST scan):
the interpreter may have imported JAX before any test runs, so
``sys.modules`` proves nothing. The same scan holds the kernels' wrappers
(``ops/``) below ``models/``: they import nothing from it."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "ics_wt_physicsengine_tpu",
             "examples", "bench")
# the JAX side's tools, by the module names they import under
JAX_TOOLS = tuple(sorted(p.stem for p in (ROOT / "tools").glob("*.py")
                         if not p.stem.startswith("torch_")))
SOURCES = sorted((ROOT / "ics_wt_physicsengine_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py"] + sorted(
    (ROOT / "tools").glob("torch_*.py")) + sorted(
    (ROOT / "examples_torch").glob("*.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return (top in FORBIDDEN or top in JAX_TOOLS
            or (top == "tools" and "." in module
                and not module.split(".")[1].startswith("torch_")))


def test_port_sources_exist():
    assert len(SOURCES) > 15
    assert all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("module", [
    "models/surrogate.py", "utils/checkpoint.py", "utils/history.py",
    "utils/netreap.py", "utils/profiling.py", "utils/backend_select.py",
    "utils/__init__.py", "models/__init__.py"])
def test_surrogate_and_utility_modules_are_scanned(module):
    assert ROOT / "ics_wt_physicsengine_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "__main__.py", "modbus/__init__.py", "modbus/__main__.py",
    "modbus/client.py", "modbus/native_slave.py", "modbus/protocols.py",
    "modbus/register_map.py", "modbus/rtu.py", "modbus/security.py",
    "modbus/slave.py", "opcua/__init__.py", "opcua/client.py",
    "opcua/encoding.py", "opcua/messages.py", "opcua/server.py"])
def test_serving_modules_are_scanned(module):
    assert ROOT / "ics_wt_physicsengine_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "fleet.py", "parallel/__init__.py", "parallel/mesh.py",
    "parallel/fused.py", "parallel/multihost.py"])
def test_fleet_and_parallel_modules_are_scanned(module):
    assert ROOT / "ics_wt_physicsengine_torch" / module in SOURCES


@pytest.mark.parametrize("path", [
    "ics_wt_physicsengine_torch/bench.py", "tools/torch_soak.py",
    "tools/torch_serve_bench.py", "tools/torch_rtf_sweep.py",
    "tools/torch_fleet_scale.py", "tools/torch_load_modbus.py",
    "tools/torch_load_opcua.py", "tools/torch_web_hmi.py",
    "tools/torch_multihost_demo.py", "tools/torch_ablate_fused_plant.py",
    "tools/torch_ablate_integrated.py", "examples_torch/monte_carlo_uq.py",
    "examples_torch/dosing_program_hil.py",
    "examples_torch/zone_sharded_highres.py",
    "examples_torch/pid_controller.py", "examples_torch/fleet_farm.py",
    "examples_torch/relay_autotune.py", "examples_torch/opcua_scada.py",
    "examples_torch/ekf_soft_sensor.py", "examples_torch/treatment_train.py",
    "examples_torch/clarifier_train.py",
    "examples_torch/winter_operations.py",
    "examples_torch/chloramine_curve.py", "examples_torch/jar_test.py",
    "examples_torch/enkf_highres.py", "examples_torch/pid_tuning_sweep.py",
    "examples_torch/mpc_dosing.py", "examples_torch/parameter_estimation.py",
    "examples_torch/surrogate_mpc.py",
    "examples_torch/surrogate_from_historian.py"])
def test_bench_and_tools_are_scanned(path):
    assert ROOT / path in SOURCES


@pytest.mark.parametrize("line,bad", [
    ("from examples.pid_controller import PID, free_port", True),
    ("import examples.fleet_farm", True),
    ("import web_hmi", True),
    ("import ablate_fused_plant", True),
    ("from ablate_integrated import SENSOR_DIMS", True),
    ("from tools.load_modbus import worker", True),
    ("import bench", True),
    ("from jax import numpy", True),
    ("from examples_torch.pid_controller import PID", False),
    ("import torch_serve_bench", False),
    ("from torch_rollout_compare import ablated_sources", False),
    ("from ics_wt_physicsengine_torch import bench", False)])
def test_the_scan_catches_the_jax_side(tmp_path, line, bad):
    """The JAX examples' sibling import (``examples/fleet_farm.py:37``) and
    the JAX tools are caught; the port's own siblings are not."""
    src = tmp_path / "script.py"
    src.write_text(line + "\n")
    assert any(map(_forbidden, _imported_modules(src))) == bad


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# ``ops/`` lies below ``models/``: the kernels' wrappers and table code take
# the plant objects they are handed and import nothing of ``models``
# (``kernel_checks.py`` is test support and exempt).
OPS_BELOW_MODELS = ("__init__.py", "fused_plant.py", "fused_rollout.py",
                    "ph_solver.py", "_build.py", "integrators.py")


def _models_imports(path):
    """The imports of ``path``, at any depth, that reach the port's
    ``models`` package, absolute or relative."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            names = [f"{base}.{alias.name}" for alias in node.names]
        else:
            continue
        for name in names:
            parts = name.lstrip(".").split(".")
            inside = name.startswith(".") \
                or parts[0] == "ics_wt_physicsengine_torch"
            if inside and "models" in parts:
                yield name


@pytest.mark.parametrize("module", OPS_BELOW_MODELS)
def test_the_ops_wrappers_import_nothing_from_models(module):
    path = ROOT / "ics_wt_physicsengine_torch" / "ops" / module
    bad = list(_models_imports(path))
    assert not bad, f"ops/{module} imports {bad}"


@pytest.mark.parametrize("line,bad", [
    ("from ics_wt_physicsengine_torch.models.plant import PlantState", True),
    ("from ics_wt_physicsengine_torch import models", True),
    ("import ics_wt_physicsengine_torch.models.plant as P", True),
    ("from ..models import plant", True),
    ("def f():\n    from ics_wt_physicsengine_torch.models import plant",
     True),
    ("from ics_wt_physicsengine_torch.ops import fused_rollout as F", False),
    ("from . import _build", False)])
def test_the_models_scan_catches_every_form(tmp_path, line, bad):
    src = tmp_path / "module.py"
    src.write_text(line + "\n")
    assert any(True for _ in _models_imports(src)) == bad
