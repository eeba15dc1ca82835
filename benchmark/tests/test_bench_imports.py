"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name shares the JAX package's
prefix), and the plain reference loads nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import run as RUN

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PORT = "ics_wt_physicsengine_torch"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & set(RUN.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != PORT, (path, name)
            assert not name.startswith("benchmark.harness"), (path, name)


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_the_reference_alone_loads_no_port_module():
    line = _fresh(
        "import sys\n"
        "import benchmark.reference.instruments, "
        "benchmark.reference.physics, benchmark.reference.params, "
        "benchmark.reference.philox, benchmark.reference.arith\n"
        f"print(sorted({{m.split('.')[0] for m in sys.modules}} & "
        f"{{'{PORT}', 'jax', 'jaxlib', 'flax', "
        "'ics_wt_physicsengine_tpu'}))\n")
    assert line == "[]"


def test_a_run_loads_no_jax_module():
    line = _fresh(
        "import sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from test_bench_reference import tiny_run, TINY\n"
        "from benchmark import run\n"
        "for w in sorted(TINY):\n"
        "    assert tiny_run(w, seconds=0.5)['correct']\n"
        "print(run.forbidden_modules())\n")
    assert line == "[]"


def test_forbidden_names_are_compared_whole():
    import types

    sys.modules["ics_wt_physicsengine_tpux"] = types.ModuleType("x")
    try:
        assert "ics_wt_physicsengine_tpu" not in RUN.forbidden_modules()
        assert PORT not in RUN.forbidden_modules()
    finally:
        del sys.modules["ics_wt_physicsengine_tpux"]
