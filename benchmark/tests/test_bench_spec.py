"""BENCHMARK.json against the benchmark contract's rules, and every cell
loaded from the data alone: a new cell's files are picked up with no edit
to a file that is there."""

import json
import re
import shutil

import pytest

from benchmark.harness import cells, drivers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source", "workloads"},
    "layer": {"name", "unit", "better", "source", "layer", "moves",
              "workloads"},
}


def test_benchmark_json_keeps_the_contract():
    bench = cells.spec()
    assert set(bench) == KEYS["top"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and not c["reduced"]
        assert cells.load_json(cells.ROOT / c["file"])["name"] == c["name"]
    for w in bench["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) <= KEYS["e2e"] and m["source"] in ("host_clock",
                                                         "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:         # each listed cell reports `moves`
        moved = [e for e in bench["end_to_end"] if e["name"] == m["moves"]]
        assert moved and set(m["workloads"]) <= set(
            moved[0].get("workloads", m["workloads"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cells.spec()["workloads"]])
def test_every_cell_loads_from_its_files(workload):
    cell = cells.cell(workload)
    driver = drivers.load(cell.traffic["entry"])
    assert driver.KERNELS and driver.WRAPPER
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(m["name"]))
    assert all("limit" in v for v in cell.limits.values())


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A cell on a new RKC2 configuration, with a new metric: files and
    entries, no edit to a file that is there."""
    shutil.copytree(cells.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    bench = cells.spec()
    bench_dir = tmp_path / "benchmark"
    traffic = dict(cells.load_json(bench_dir / "traffic"
                                   / "mc4096_7200.json"), plants=8192)
    (bench_dir / "traffic" / "mc8192_7200.json").write_text(
        json.dumps(traffic))
    rkc = dict(cells.load_json(bench_dir / "configs" / "ctr20-physics.json"),
               name="ctr20-physics-rkc", integrator=dict(
                   method="rkc", substeps=1, stages_per_substep=4, dt_s=1.0))
    (bench_dir / "configs" / "ctr20-physics-rkc.json").write_text(
        json.dumps(rkc))
    bench["configs"].append({"name": "ctr20-physics-rkc", "source": "x",
                             "file": "benchmark/configs/ctr20-physics-rkc"
                                     ".json", "reduced": [], "why": "x"})
    shutil.copy(bench_dir / "limits" / "mc4096.b1.json",
                bench_dir / "limits" / "mc8192.b1.json")
    (bench_dir / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.calls / ctx.wall_s\n")
    bench["workloads"].append({"name": "mc8192.b1", "config":
                               "ctr20-physics-rkc", "traffic": "mc8192_7200",
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("plant_steps_per_s", "b1_roofline",
                         "idle_share.ensemble"):
            m["workloads"].append("mc8192.b1")
    bench["per_layer"].append({
        "name": "calls_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "wrapper",
        "moves": "plant_steps_per_s", "workloads": ["mc8192.b1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.cell("mc8192.b1", root=tmp_path)
    assert cell.traffic["plants"] == 8192
    assert [m["name"] for m in cell.end_to_end] == ["plant_steps_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "b1_roofline", "idle_share.ensemble", "calls_per_s"]
    assert "plant_steps_per_s.instrumented" not in [
        m["name"] for m in cell.end_to_end]
    assert cell.config["integrator"]["method"] == "rkc"
    ctx = cells.Context(cell=cell, setup_s=1.0, calls=10, work=1.0,
                        unit="plant-steps", wall_s=2.0, call_s=[])
    assert cells.reader("calls_per_s", root=tmp_path)(ctx) == 5.0
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(m["name"], root=tmp_path))
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_split_metric_falls_back_to_its_base_readers_file(tmp_path):
    metrics = tmp_path / "benchmark" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "rate.py").write_text("def read(ctx):\n    return 1.0\n")
    (metrics / "rate.fleet.py").write_text("def read(ctx):\n    return 2.0\n")
    assert cells.reader("rate.serve", root=tmp_path)(None) == 1.0
    assert cells.reader("rate.fleet", root=tmp_path)(None) == 2.0
    with pytest.raises(FileNotFoundError):
        cells.reader("other.serve", root=tmp_path)
