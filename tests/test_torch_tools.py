"""The port's soak and serve-bench tools (``tools/torch_soak.py``,
``tools/torch_serve_bench.py``) on the CPU, at tiny horizons.

The soak's drift check compares total chlorine after the first of four
segments with the last; the tank sheds its initial 2 mg/L over ~100,000
steps, so below a ~400,000-step soak the check reports that start-up
transient (as ``tools/soak.py``'s does), and every other check must hold.
A checkpoint altered between save and load must turn each
``resume_bitexact_*`` false.
The serve bench starts ``python -m ics_wt_physicsengine_torch`` on the
CPU, measures the served rate over a live Modbus client, and bounds every
wait."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_serve_bench as TSB  # noqa: E402
import torch_soak as TSK  # noqa: E402

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--steps", "400", "--plant-steps", "20",
        "--nitrogen-steps", "8"]
# tools/soak.py's JSON keys
SOAK_KEYS = ("metric", "soak_steps", "soak_steps_per_sec",
             "traj_points_recorded", "conservation_audit",
             "chlorine_drift_pct_over_soak", "nitrogen_soak_steps",
             "nitrogen_steps_per_sec", "nitrogen_audit",
             "drift_within_bounds", "trajectories_finite",
             "resume_bitexact_physics", "resume_bitexact_instrumented",
             "nitrogen_finite", "nitrogen_species_bounded",
             "resume_bitexact_nitrogen", "ok", "backend")
RESUMES = ("resume_bitexact_physics", "resume_bitexact_instrumented",
           "resume_bitexact_nitrogen")


def run_soak(argv, capsys):
    rc = TSK.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_soak_at_a_tiny_horizon_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "soak.json"
    rc, result = run_soak(TINY + ["--out", str(out)], capsys)
    assert json.loads(out.read_text()) == result
    assert all(k in result for k in SOAK_KEYS)
    checks = {k: result[k] for k in (
        "trajectories_finite", "nitrogen_finite",
        "nitrogen_species_bounded") + RESUMES}
    assert all(checks.values()), checks
    # the start-up transient: chlorine falls segment after segment
    totals = [a["total_chlorine_mg"] for a in result["conservation_audit"]]
    assert all(b < a for a, b in zip(totals, totals[1:]))
    assert result["chlorine_drift_pct_over_soak"] < -0.5
    assert result["drift_within_bounds"] is False
    assert result["ok"] is False and rc == 1
    assert result["soak_steps"] == 400 and result["b1_calls"] == 9
    assert result["traj_points_recorded"] == 400   # every step of 4 x 100
    assert result["nitrogen_soak_steps"] == 8
    assert result["backend"] == "cpu"
    assert result["device"]["platform"] == "cpu"
    assert {(r["phase"], r["cut"]) for r in result["reduced"]} == {
        (3, "plant_steps"), (4, "nitrogen_steps"),
        (4, "nitrogen_resume_steps")}


def test_an_altered_checkpoint_fails_every_resume_check(monkeypatch, capsys):
    """Each checkpoint scaled by 1 + 2^-20 between save and load: the
    resumed runs differ from the ones that never stopped."""
    load = TSK.ckpt.load_pytree

    def altered(path, template):
        tree = load(path, template)
        for leaf in TSK.ckpt.tree_leaves(tree):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                leaf.mul_(1.0 + 2.0 ** -20)
        return tree

    monkeypatch.setattr(TSK.ckpt, "load_pytree", altered)
    rc, result = run_soak(["--device", "cpu", "--steps", "40",
                           "--plant-steps", "8", "--nitrogen-steps", "8"],
                          capsys)
    assert not any(result[k] for k in RESUMES), {k: result[k]
                                                 for k in RESUMES}
    assert result["trajectories_finite"] and result["nitrogen_finite"]
    assert rc == 1 and result["ok"] is False


def test_soak_resume_checks_see_nan_readings_as_equal():
    a = {"x": torch.tensor([1.0, float("nan")]),
         "g": torch.Generator().manual_seed(3)}
    b = {"x": torch.tensor([1.0, float("nan")]),
         "g": torch.Generator().manual_seed(3)}
    assert TSK.trees_equal(a, b)
    b["x"] = torch.tensor([float("nan"), 1.0])
    assert not TSK.trees_equal(a, b)
    b = {"x": a["x"].clone(), "g": torch.Generator().manual_seed(4)}
    assert not TSK.trees_equal(a, b)


@pytest.mark.parametrize("fleet", [1, 3])
def test_serve_bench_on_the_cpu(fleet, capsys, monkeypatch):
    monkeypatch.setattr(TSB, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(TSB, "FIRST_CHUNK_TIMEOUT_S", 60.0)
    t0 = time.monotonic()
    rc = TSB.main(["--device", "cpu", "--zones", "5", "--chunk", "64",
                   "--window", "2", "--fleet", str(fleet)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert time.monotonic() - t0 < 150
    assert result["client_polls"] > 0 and result["served_rtf"] > 0
    assert np.isclose(result["served_steps_per_sec"],
                      result["served_rtf"] * fleet)
    assert result["live_ph_samples_ok"] >= 1
    assert result["fleet"] == fleet
    assert result["device"]["platform"] == "cpu"
    assert rc == (0 if result["ok"] else 1)


@pytest.mark.parametrize("code", [
    "import sys; sys.exit(3)",            # the server dies at once
    "import time; time.sleep(60)",        # it never opens its port
])
def test_serve_bench_bounds_its_waits_and_stops_the_server(monkeypatch,
                                                            code):
    started = []

    def command(args, port):
        started.append(port)
        return [sys.executable, "-c", code]

    monkeypatch.setattr(TSB, "command", command)
    monkeypatch.setattr(TSB, "START_TIMEOUT_S", 3.0)
    args = TSB.parse_args(["--device", "cpu"])
    t0 = time.monotonic()
    result = TSB.serve_bench(args)
    assert time.monotonic() - t0 < 30
    assert started and result["ok"] is False
    assert "did not start" in result["reason"]


def test_tools_refuse_the_card_where_there_is_none(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for main in (TSK.main, TSB.main):
        assert main(["--device", "cuda"]) == 1
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert result["ok"] is False and "no CUDA device" in result["reason"]
