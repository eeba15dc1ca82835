"""The port's served tools on the CPU, at tiny sizes:
``tools/torch_rtf_sweep.py``, ``torch_fleet_scale.py``,
``torch_load_modbus.py``, ``torch_load_opcua.py``, ``torch_web_hmi.py`` and
``torch_multihost_demo.py``.

Each keeps its JAX tool's JSON keys and modes. The web HMI is held to
``tests/test_examples.py::test_web_hmi`` case for case against the port's
orchestrator (``python -m ics_wt_physicsengine_torch --device cpu`` in a
thread): the dashboard, the state, a command clamped HMI-side to 2.0, a
form post refused with 415 and an oversized body with 413, and the
Prometheus names. The multi-process demo joins two gloo processes and
must find max |diff| 0 against one process. Asking for the card on a host
without one fails with a message."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_fleet_scale as TFS  # noqa: E402
import torch_load_modbus as TLM  # noqa: E402
import torch_load_opcua as TLO  # noqa: E402
import torch_multihost_demo as TMD  # noqa: E402
import torch_rtf_sweep as TRS  # noqa: E402
import torch_web_hmi as HMI  # noqa: E402

from ics_wt_physicsengine_torch.modbus import (  # noqa: E402
    ModbusRegisterMap, ModbusServerConfig, ModbusSlave)
from ics_wt_physicsengine_torch.opcua import OPCUAServer  # noqa: E402

torch.set_num_threads(1)

# tools/load_modbus.py's and tools/load_opcua.py's JSON keys
LOAD_KEYS = ("plane", "clients_requested", "clients_served", "seconds",
             "total_requests", "requests_per_s", "latency_ms", "errors",
             "dt1s_budget_ok")


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_rtf_sweep_paces_and_reports_the_ceiling(capsys):
    assert TRS.main(["--device", "cpu", "--rtfs", "10", "0", "--steps",
                     "10"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert set(result) == {"sweep", "dt", "steps_per_point", "modbus",
                           "integrator", "device"}
    paced, free = result["sweep"]
    assert paced["requested_rtf"] == 10.0 and free["requested_rtf"] == 0.0
    assert 0 < paced["achieved_rtf"] <= 10.5
    assert free["achieved_rtf"] > 0 and free["steps_per_s"] > 0
    assert result["device"]["platform"] == "cpu"
    assert (result["modbus"], result["integrator"]) == ("python", "rk4")


def test_fleet_scale_fits_the_tick(capsys):
    assert TFS.main(["--device", "cpu", "--sizes", "2", "4", "--ticks",
                     "2"]) == 0
    result = last_json(capsys)
    assert set(result) == {"fleet_sizes", "tick_ms",
                           "max_realtime_units_dt1s", "backend", "device"}
    assert result["fleet_sizes"] == [2, 4] and len(result["tick_ms"]) == 2
    assert all(t > 0 for t in result["tick_ms"])
    assert result["max_realtime_units_dt1s"] > 0
    assert result["backend"] == "cpu"


@pytest.mark.parametrize("tool", ["rtf_sweep", "fleet_scale",
                                  "multihost_demo"])
def test_asking_for_the_card_without_one_fails(capsys, tool):
    main = {"rtf_sweep": TRS.main, "fleet_scale": TFS.main,
            "multihost_demo": TMD.main}[tool]
    with pytest.raises(SystemExit) as exc:
        main({"rtf_sweep": ["--steps", "1"], "fleet_scale": ["--sizes", "2"],
              "multihost_demo": ["--nprocs", "1"]}[tool])
    assert str(exc.value).startswith(
        "--device cuda: no CUDA device is available")
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("args,plane,mode", [
    (["--mode", "thread"], "python-asyncio", "thread"),
    (["--mode", "async"], "python-asyncio", "async"),
    (["--native"], "native-c++", "thread"),
], ids=["thread", "async", "native"])
def test_load_modbus_modes(capsys, args, plane, mode):
    result = TLM.main(["--clients", "4", "--seconds", "0.5"] + args)
    assert last_json(capsys) == result
    assert all(k in result for k in LOAD_KEYS + ("mode", "fc08_counters"))
    assert (result["plane"], result["mode"]) == (plane, mode)
    assert result["clients_served"] == 4 and result["errors"] == 0
    assert result["total_requests"] > 0
    assert result["fc08_counters"]["bus_message_count"] > 0


def test_load_modbus_attaches_to_a_running_server(capsys, tmp_path):
    slave = ModbusSlave(ModbusRegisterMap(),
                        ModbusServerConfig(host="127.0.0.1", port=0))
    slave.start(blocking=False)
    try:
        out = tmp_path / "load.json"
        result = TLM.main(["--clients", "2", "--seconds", "0.5",
                           "--attach-port", str(slave.port),
                           "--out", str(out)])
        assert json.loads(out.read_text()) == result
    finally:
        slave.stop()
    assert result["plane"] == "attached" and result["clients_served"] == 2
    assert result["total_requests"] > 0 and result["errors"] == 0


@pytest.mark.parametrize("workload", ["read", "subscribe"])
def test_load_opcua_workloads(capsys, workload):
    result = TLO.main(["--clients", "3", "--seconds", "1", "--workload",
                       workload])
    assert last_json(capsys) == result
    assert all(k in result for k in LOAD_KEYS + ("workload",))
    assert result["plane"] == "opcua" and result["workload"] == workload
    assert result["clients_served"] == 3 and result["errors"] == 0
    assert result["total_requests"] > 0
    if workload == "subscribe":
        assert result["sessions_shed_past_1s"] == 0
        assert result["granted_interval_s"]["min"] == pytest.approx(0.25)


def test_load_opcua_attaches_to_a_running_server(capsys):
    slave = ModbusSlave(ModbusRegisterMap(),
                        ModbusServerConfig(host="127.0.0.1", port=0))
    slave.update_input_register("pH_inlet", 7.2)
    server = OPCUAServer(slave, host="127.0.0.1", port=0)
    server.start()
    try:
        result = TLO.main(["--clients", "2", "--seconds", "0.5",
                           "--attach-port", str(server.actual_port)])
    finally:
        server.stop()
        slave.stop()
    assert result["clients_served"] == 2 and result["total_requests"] > 0


def test_web_hmi_against_the_port_orchestrator():
    """tests/test_examples.py::test_web_hmi, case for case, on the port."""
    import ics_wt_physicsengine_torch.__main__ as orch

    mb_port = free_port()
    orch.running = True
    sim = threading.Thread(
        target=orch.main,
        args=(["--port", str(mb_port), "--host", "127.0.0.1", "--dt", "30",
               "--duration", "1000000", "--rtf", "0", "--zones", "4",
               "--seed", "6", "--device", "cpu"],), daemon=True)
    sim.start()
    deadline = time.time() + 60
    server = None
    while time.time() < deadline:
        try:
            server = HMI.serve("127.0.0.1", mb_port, "127.0.0.1", 0)
            break
        except OSError:
            time.sleep(0.3)
    assert server is not None, "could not attach HMI to the plant"
    http = threading.Thread(target=server.serve_forever, daemon=True)
    http.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        page = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"Web HMI" in page
        state = json.loads(urllib.request.urlopen(
            base + "/api/state", timeout=10).read())
        assert "pH_inlet" in state["inputs"]
        assert state["coils"]["simulation_running"] is True

        req = urllib.request.Request(
            base + "/api/command",
            data=json.dumps({"register": "acid_flow_rate",
                             "value": 99.0}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        resp = json.loads(urllib.request.urlopen(req, timeout=10).read())

        # Write-path hardening: non-JSON content types (a cross-site form
        # post) and oversized bodies are rejected.
        for data, hdrs, want in [
            (b"register=acid_flow_rate&value=99",
             {"Content-Type": "application/x-www-form-urlencoded"}, 415),
            (b"{" + b" " * 8192 + b"}",
             {"Content-Type": "application/json"}, 413),
        ]:
            bad = urllib.request.Request(base + "/api/command", data=data,
                                         method="POST", headers=hdrs)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(bad, timeout=10)
            assert e.value.code == want
        assert resp["ok"] and resp["applied"] == 2.0   # HMI-side clamp
        state = json.loads(urllib.request.urlopen(
            base + "/api/state", timeout=10).read())
        assert state["commands"]["acid_flow_rate"] == pytest.approx(2.0)

        metrics = urllib.request.urlopen(
            base + "/metrics", timeout=10).read().decode()
        assert "# TYPE wt_sim_measurement gauge" in metrics
        assert 'wt_sim_command{register="acid_flow_rate"} 2.0' in metrics
        assert 'wt_sim_coil{coil="simulation_running"} 1' in metrics
        assert 'wt_sim_sensor_fault{sensor=' in metrics
        assert "# TYPE wt_sim_modbus_diagnostic counter" in metrics
        assert 'wt_sim_modbus_diagnostic{counter="bus_message_count"}' \
            in metrics
    finally:
        server.shutdown()
        server.hmi.close()
        orch.running = False
        sim.join(timeout=30)
    assert not sim.is_alive()


def _demo(args, timeout=300):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "torch_multihost_demo.py")] + args,
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def test_multihost_demo_two_gloo_processes_match_one_process():
    out = _demo(["--device", "cpu"])
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "multihost demo: all ranks OK" in out.stdout
    assert "[rank 0] gloo: 4 local shard(s) on cpu, 8 in all" in out.stdout
    assert "max |sharded - single-process| on local shards: 0\n" \
        in out.stdout
    assert "max local-shard |diff| vs single-process = 0\n" in out.stdout
    assert out.stdout.count("OK") == 3


def test_multihost_demo_refuses_more_ranks_than_cards(monkeypatch, capsys):
    # one card visible, two ranks asked for: NCCL refuses two ranks on one
    # card, so the demo refuses before it starts a process
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exc:
        TMD.main(["--nprocs", "2"])
    assert str(exc.value).startswith(
        "--device cuda: --nprocs 2 needs one card a rank and 1 are visible")
    assert capsys.readouterr().out == ""
