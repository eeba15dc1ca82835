"""The PyTorch port, its smoke script, its card-side measurement scripts
(``tools/torch_*.py``) and its GPU tests import neither JAX, optax (the
card's machine has none) nor the JAX package. Checked on the source
(an AST scan): the interpreter may have imported JAX before any test runs,
so ``sys.modules`` proves nothing."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "ics_wt_physicsengine_tpu")
SOURCES = sorted((ROOT / "ics_wt_physicsengine_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py"] + sorted(
    (ROOT / "tools").glob("torch_*.py"))


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


def test_port_sources_exist():
    assert len(SOURCES) > 15
    assert all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("module", [
    "models/surrogate.py", "utils/checkpoint.py", "utils/history.py",
    "utils/netreap.py", "utils/profiling.py", "utils/backend_select.py",
    "utils/__init__.py", "models/__init__.py"])
def test_surrogate_and_utility_modules_are_scanned(module):
    assert ROOT / "ics_wt_physicsengine_torch" / module in SOURCES


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
