#!/usr/bin/env python3
"""
Served real-time factor of the PyTorch port's fast-time serving plane, one
JSON line.

    python tools/torch_serve_bench.py [--device {cuda,cpu}] [--chunk 1024]
        [--zones 20] [--window 20] [--fleet N] [--out FILE]

The port of ``tools/serve_bench.py``. It starts the orchestrator as a user
does, ``python -m ics_wt_physicsengine_torch --rtf 0 --serve-chunk N``
(``--fused-sensors`` for one plant, ``--fleet N`` for N), on a free port,
and attaches a live Modbus/TCP client (``ics_wt_physicsengine_torch.modbus
.ModbusTcpClient``) that polls pH and rewrites the acid command every
100 ms, as a SCADA scan would. The served rate is the ``simulation_time``
register (100) over the wall clock across ``--window`` seconds, after the
first chunk has been served (on the card it builds kernel B3, so the
tool waits on the register, not on a sleep).

``ok``: at least 1000x real time a lane, polls answered, and at least one
healthy pH reading (latched sensor faults may park the register at 0
between maintenances at these speeds). The card is the default; ``--device
cpu`` is an explicit request. Every socket and process wait is bounded,
and the orchestrator is killed on the way out. Exit code 0 when ``ok``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ics_wt_physicsengine_torch.bench import device_info  # noqa: E402

# seconds: the orchestrator's Modbus port coming up, its first chunk
START_TIMEOUT_S = 120.0
FIRST_CHUNK_TIMEOUT_S = 600.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 2000) -> str:
    with open(path, "rb") as f:
        f.seek(max(0, os.path.getsize(path) - n))
        return f.read().decode(errors="replace")


def command(args, port: int) -> list:
    cmd = [sys.executable, "-m", "ics_wt_physicsengine_torch",
           "--port", str(port), "--host", "127.0.0.1", "--dt", "1.0",
           "--duration", "1e18", "--rtf", "0", "--seed", "7",
           "--zones", str(args.zones), "--serve-chunk", str(args.chunk),
           "--device", args.device]
    return cmd + (["--fleet", str(args.fleet)] if args.fleet > 1
                  else ["--fused-sensors"])


def _connect(sim, port: int, deadline: float):
    from ics_wt_physicsengine_torch.modbus import ModbusTcpClient

    while time.monotonic() < deadline and sim.poll() is None:
        try:
            return ModbusTcpClient("127.0.0.1", port, timeout=5).connect()
        except OSError:
            time.sleep(0.3)
    return None


def serve_bench(args) -> dict:
    result = {"ok": False, "chunk": args.chunk, "zones": args.zones,
              "fleet": args.fleet, "dt": 1.0}
    port = _free_port()
    with tempfile.NamedTemporaryFile("w+b", suffix=".log",
                                     delete=False) as log:
        log_path = log.name
    sim = None
    client = None
    try:
        with open(log_path, "wb") as log:
            sim = subprocess.Popen(command(args, port), cwd=REPO,
                                   stdout=log, stderr=subprocess.STDOUT)
        client = _connect(sim, port, time.monotonic() + START_TIMEOUT_S)
        if client is None:
            result["reason"] = ("the orchestrator's Modbus server did not "
                                "start: " + _tail(log_path))
            return result
        # the first chunk (the kernel builds there on the card), then the
        # measured window
        deadline = time.monotonic() + FIRST_CHUNK_TIMEOUT_S
        while client.read_float32(100) < args.chunk:
            if time.monotonic() > deadline or sim.poll() is not None:
                result["reason"] = ("no chunk served before the deadline: "
                                    + _tail(log_path))
                return result
            time.sleep(0.2)
        t_sim0 = client.read_float32(100)
        t_wall0 = time.monotonic()
        polls = 0
        ph_samples = []
        while time.monotonic() - t_wall0 < args.window:
            ph_samples.append(client.read_float32(0))      # pH_inlet
            client.read_float32(4)                         # pH_outlet
            client.write_float32(0, 0.05 if polls % 2 else 0.0)
            polls += 1
            time.sleep(0.1)
        t_sim1 = client.read_float32(100)
        wall = time.monotonic() - t_wall0
        client.write_float32(0, 0.0)
        rtf = (t_sim1 - t_sim0) / wall     # dt 1 s: steps == simulated s
        healthy = [p for p in ph_samples if p == p and 0.0 < p < 14.0]
        result.update({
            "ok": rtf >= 1000.0 and polls > 0 and len(healthy) >= 1,
            "served_steps_per_sec": rtf * args.fleet,
            "served_rtf": rtf,
            "vs_reference_serving": rtf * args.fleet / 31.0,
            "wall_window_s": wall,
            "client_polls": polls,
            "live_ph_samples_ok": len(healthy),
        })
        return result
    finally:
        if client is not None:
            client.close()
        if sim is not None:
            sim.terminate()
            try:
                sim.wait(timeout=15)
            except subprocess.TimeoutExpired:
                sim.kill()
                sim.wait(timeout=15)
        os.unlink(log_path)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="tools/torch_serve_bench.py")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--zones", type=int, default=20)
    ap.add_argument("--window", type=float, default=20.0,
                    help="measurement window [wall seconds]")
    ap.add_argument("--fleet", type=int, default=1,
                    help="serve N plants on one endpoint (unit ids 1..N), "
                         "each advancing a chunk per exchange")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        result = {"ok": False, "reason": "the card was asked for: no CUDA "
                                         "device is available"}
    else:
        result = serve_bench(args)
        result["device"] = device_info(torch.device(args.device))
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
