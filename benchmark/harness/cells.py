"""
A cell from the data: ``BENCHMARK.json`` names it, its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``) and
its metrics; each metric is read by ``metrics/<metric name>.py``, or
where there is none by ``metrics/<its name before the first dot>.py`` (a
metric split by cells, for bounds of their own, shares its reader); each
cell's comparison limits are ``limits/<cell name>.json``. Adding a cell,
a configuration or a metric adds files and entries; nothing here names
one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def cell(name: str, bench: dict = None, root: Path = ROOT) -> Cell:
    """Cell ``name`` of ``bench`` (``BENCHMARK.json`` under ``root``),
    its files read from ``root``."""
    root = Path(root)
    bench = bench or spec(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, workload=w,
                config=load_json(root / conf["file"]),
                traffic=load_json(root / "benchmark" / "traffic"
                                  / f"{w['traffic']}.json"),
                limits=load_json(root / "benchmark" / "limits"
                                 / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``, or of
    ``metrics/<metric up to its first dot>.py`` where the first is not
    there."""
    folder = Path(root) / "benchmark" / "metrics"
    path = folder / f"{metric}.py"
    if not path.exists():
        path = folder / f"{metric.split('.')[0]}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


@dataclass
class Context:
    """What a metric reads from one run: the cell, its window (calls,
    work, wall seconds, each call's host seconds), set-up seconds, the
    names of its entry's device kernels and of the span around the entry's
    call (``wrapper``), and in a traced run the parts' host seconds of its
    first half (``spans``, ``name -> [seconds, ...]``) and the
    ``trace.Trace`` of its second half over ``traced_calls`` calls."""

    cell: Cell
    setup_s: float
    calls: int
    work: float
    unit: str
    wall_s: float
    call_s: list
    kernels: tuple = ()
    wrapper: str = "call"
    spans: dict = field(default_factory=dict)
    trace: object = None
    traced_calls: int = 0
