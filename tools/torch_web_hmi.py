"""
Web HMI: a zero-dependency operator dashboard for a running simulator, on
the PyTorch port's Modbus client (the port of ``tools/web_hmi.py``).

A stdlib-only HTTP server that attaches to ANY running plant (the port's,
the JAX package's or the reference's: it is just another Modbus/TCP master,
``ics_wt_physicsengine_torch.modbus.ModbusTcpClient``) and serves:

  GET  /            single-page dashboard (fetch-polling, no build step)
  GET  /api/state   all input registers + fault bits + commands as JSON
  GET  /metrics     Prometheus text exposition of the same state (point a
                    Prometheus/Grafana stack at it for trending)
  POST /api/command {"register": name, "value": v} -> validated holding-
                    register write (same zero-trust clamps the orchestrator
                    applies on its side; the plant re-validates anyway)
  POST /api/coil    {"coil": name, "value": bool}

No device work of its own: the plant it attaches to runs where it was
started (``python -m ics_wt_physicsengine_torch`` on the card by default).

Usage:
  python -m ics_wt_physicsengine_torch --port 5020 &     # the plant
  python tools/torch_web_hmi.py --modbus-port 5020 --http-port 8080
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ics_wt_physicsengine_torch.modbus import ModbusTcpClient  # noqa: E402

# (name, input-register address) — the canonical map (modbus/register_map.py)
INPUTS = [
    ("pH_inlet", 0), ("pH_middle", 2), ("pH_outlet", 4),
    ("chlorine_inlet", 6), ("chlorine_outlet", 8), ("flow_rate", 10),
    ("temperature_inlet", 12), ("temperature_outlet", 14),
    ("simulation_time", 100),
]
NITROGEN_INPUTS = [
    ("ammonia_outlet", 20), ("nitrite_outlet", 22),
    ("nitrate_outlet", 24), ("chloramine_outlet", 26),
]
HOLDING = {
    "acid_flow_rate": (0, 2.0),
    "chlorine_flow_rate": (2, 1.0),
    "inlet_flow_rate": (4, 20.0),
    "acid_concentration": (10, 1.0),
    "chlorine_concentration": (12, 1000.0),
    "inlet_ammonia": (14, 50.0),
}
COILS = {"acid_pump_enable": 0, "chlorine_pump_enable": 1,
         "simulation_running": 2}
FAULTS = [("pH_inlet_fault", 0), ("pH_outlet_fault", 1),
          ("chlorine_fault", 2)]

_PAGE = """<!DOCTYPE html>
<html><head><title>WT Plant HMI</title><style>
body{font-family:system-ui,sans-serif;margin:2em;background:#f4f6f8}
h1{font-size:1.3em} table{border-collapse:collapse;margin:1em 0}
td,th{border:1px solid #ccd;padding:.35em .8em;text-align:right}
th{background:#e8ecf0;text-align:left} .fault{background:#fbb}
.ok{background:#cfc} input{width:6em} section{display:inline-block;
vertical-align:top;margin-right:2.5em}</style></head><body>
<h1>Water Treatment Plant &mdash; Web HMI</h1>
<section><h2>Process values</h2><table id="pv"></table>
<table id="faults"></table></section>
<section><h2>Commands</h2><table id="cmd"></table>
<div id="msg"></div></section>
<script>
async function refresh(){
 const r = await fetch('/api/state'); const s = await r.json();
 let pv = '<tr><th>Register</th><th>Value</th></tr>';
 for(const [k,v] of Object.entries(s.inputs))
   pv += `<tr><td style="text-align:left">${k}</td><td>${v.toFixed(3)}</td></tr>`;
 document.getElementById('pv').innerHTML = pv;
 let f = '<tr><th>Fault bit</th><th></th></tr>';
 for(const [k,v] of Object.entries(s.faults))
   f += `<tr><td style="text-align:left">${k}</td>`+
        `<td class="${v?'fault':'ok'}">${v?'FAULT':'ok'}</td></tr>`;
 document.getElementById('faults').innerHTML = f;
 let c = '<tr><th>Command</th><th>Current</th><th>New</th><th></th></tr>';
 for(const [k,v] of Object.entries(s.commands))
   c += `<tr><td style="text-align:left">${k}</td><td>${v.toFixed(3)}</td>`+
        `<td><input id="in_${k}" value="${v.toFixed(3)}"></td>`+
        `<td><button onclick="send('${k}')">write</button></td></tr>`;
 for(const [k,v] of Object.entries(s.coils))
   c += `<tr><td style="text-align:left">${k}</td><td>${v}</td>`+
        `<td></td><td><button onclick="coil('${k}',${!v})">`+
        `${v?'disable':'enable'}</button></td></tr>`;
 document.getElementById('cmd').innerHTML = c;
}
async function send(name){
 const v = parseFloat(document.getElementById('in_'+name).value);
 const r = await fetch('/api/command',{method:'POST',
   headers:{'Content-Type':'application/json'},
   body:JSON.stringify({register:name,value:v})});
 document.getElementById('msg').textContent = await r.text();
}
async function coil(name,v){
 await fetch('/api/coil',{method:'POST',
   headers:{'Content-Type':'application/json'},
   body:JSON.stringify({coil:name,value:v})});
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


class Hmi:
    """Thread-safe Modbus-backed state access for the HTTP handlers.

    ``nitrogen`` must be set EXPLICITLY (--nitrogen): the wire cannot
    reveal whether the extension registers are mapped — both data planes
    size their register blocks with headroom past the last mapped
    address, so reading an unmapped-but-in-block register succeeds and
    returns 0.0 (and a write to holding register 14 on a base-map plant
    would land in dead space the orchestrator never reads)."""

    def __init__(self, host: str, port: int, unit: int = 1,
                 nitrogen: bool = False):
        self._client = ModbusTcpClient(host, port, unit_id=unit,
                                       timeout=5).connect()
        self._lock = threading.Lock()
        self.has_nitrogen = nitrogen

    def state(self) -> dict:
        with self._lock:
            inputs = {n: self._client.read_float32(a) for n, a in INPUTS}
            if self.has_nitrogen:
                inputs.update({n: self._client.read_float32(a)
                               for n, a in NITROGEN_INPUTS})
            commands = {}
            for n, (a, _) in HOLDING.items():
                if n == "inlet_ammonia" and not self.has_nitrogen:
                    continue
                commands[n] = self._client.read_float32(
                    a, input_register=False)
            coils = {n: self._client.read_coils(a, 1)[0]
                     for n, a in COILS.items()}
            faults = {n: self._client.read_discrete_inputs(a, 1)[0]
                      for n, a in FAULTS}
            try:
                # FC 08 wire diagnostics (both data planes serve them);
                # older/foreign servers without FC 08 just omit the section
                diagnostics = self._client.diagnostic_counters()
            except Exception:  # noqa: BLE001
                diagnostics = {}
        return {"inputs": inputs, "commands": commands, "coils": coils,
                "faults": faults, "diagnostics": diagnostics}

    def write(self, register: str, value: float) -> float:
        if register not in HOLDING:
            raise KeyError(register)
        if register == "inlet_ammonia" and not self.has_nitrogen:
            raise KeyError(register)    # unmapped on base-map plants
        addr, vmax = HOLDING[register]
        value = float(value)
        if value != value or not -1e9 < value < 1e9:
            raise ValueError("non-finite value")
        value = max(0.0, min(value, vmax))     # zero-trust clamp HMI-side
        with self._lock:
            self._client.write_float32(addr, value)
        return value

    def write_coil(self, coil: str, value: bool) -> None:
        with self._lock:
            self._client.write_coil(COILS[coil], bool(value))

    def close(self):
        self._client.close()


def prometheus_metrics(state: dict) -> str:
    """Prometheus text exposition (v0.0.4) of the plant state, so a
    Grafana/Prometheus stack can scrape the HMI directly — the
    reference roadmap's 'Trending and visualization (Plotly/Grafana)'
    row (reference README.md:446) without adding any dependency."""
    out = [
        "# HELP wt_sim_measurement Published input-register value",
        "# TYPE wt_sim_measurement gauge",
    ]
    for name, v in state["inputs"].items():
        if v == v:   # NaN (warming up / faulted) has no sample
            out.append(f'wt_sim_measurement{{register="{name}"}} {v}')
    out += [
        "# HELP wt_sim_command Commanded holding-register value",
        "# TYPE wt_sim_command gauge",
    ]
    for name, v in state["commands"].items():
        if v == v:
            out.append(f'wt_sim_command{{register="{name}"}} {v}')
    out += [
        "# HELP wt_sim_coil Coil state (1 = on)",
        "# TYPE wt_sim_coil gauge",
    ]
    for name, v in state["coils"].items():
        out.append(f'wt_sim_coil{{coil="{name}"}} {int(bool(v))}')
    out += [
        "# HELP wt_sim_sensor_fault Sensor fault discrete input (1 = faulted)",
        "# TYPE wt_sim_sensor_fault gauge",
    ]
    for name, v in state["faults"].items():
        out.append(f'wt_sim_sensor_fault{{sensor="{name}"}} '
                   f'{int(bool(v))}')
    if state.get("diagnostics"):
        out += [
            "# HELP wt_sim_modbus_diagnostic FC 08 wire diagnostic "
            "counter (bus messages / comm errors / exceptions / ...)",
            "# TYPE wt_sim_modbus_diagnostic counter",
        ]
        for name, v in state["diagnostics"].items():
            out.append(f'wt_sim_modbus_diagnostic{{counter="{name}"}} '
                       f'{int(v)}')
    return "\n".join(out) + "\n"


def make_handler(hmi: Hmi):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/":
                self._send(200, _PAGE, "text/html")
            elif self.path == "/api/state":
                try:
                    self._send(200, json.dumps(hmi.state()))
                except Exception as e:  # noqa: BLE001
                    self._send(502, json.dumps(
                        {"error": type(e).__name__}))
            elif self.path == "/metrics":
                try:
                    self._send(200, prometheus_metrics(hmi.state()),
                               "text/plain; version=0.0.4")
                except Exception as e:  # noqa: BLE001
                    self._send(502, json.dumps(
                        {"error": type(e).__name__}))
            else:
                self._send(404, "{}")

        # Write-path hardening (docs/SECURITY.md): bound the body so a
        # hostile Content-Length cannot balloon memory, and require the
        # JSON content type — browsers cannot send that cross-site without
        # a CORS preflight (which this server never grants), so a page the
        # operator happens to have open cannot forge register writes.
        _MAX_BODY = 4096

        def do_POST(self):
            try:
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                if ctype.strip().lower() != "application/json":
                    self._send(415, json.dumps(
                        {"error": "Content-Type must be application/json"}))
                    return
                length = int(self.headers.get("Content-Length", 0))
                if not 0 <= length <= self._MAX_BODY:
                    self._send(413, json.dumps({"error": "body too large"}))
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/api/command":
                    applied = hmi.write(req["register"], req["value"])
                    self._send(200, json.dumps(
                        {"ok": True, "applied": applied}))
                elif self.path == "/api/coil":
                    hmi.write_coil(req["coil"], req["value"])
                    self._send(200, json.dumps({"ok": True}))
                else:
                    self._send(404, "{}")
            except Exception as e:  # noqa: BLE001
                self._send(400, json.dumps({"error": type(e).__name__}))

    return Handler


def serve(modbus_host: str, modbus_port: int, http_host: str,
          http_port: int, unit: int = 1,
          nitrogen: bool = False) -> ThreadingHTTPServer:
    """Build and return the HTTP server (caller runs serve_forever)."""
    hmi = Hmi(modbus_host, modbus_port, unit=unit, nitrogen=nitrogen)
    server = ThreadingHTTPServer((http_host, http_port), make_handler(hmi))
    server.hmi = hmi
    return server


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--modbus-host", default="127.0.0.1")
    ap.add_argument("--modbus-port", type=int, default=5020)
    ap.add_argument("--unit", type=int, default=1,
                    help="Modbus unit id (fleet mode: the plant to watch)")
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=8080)
    ap.add_argument("--nitrogen", action="store_true",
                    help="the plant was started with --enable-nitrogen: "
                         "show the extension registers (cannot be "
                         "auto-detected over the wire)")
    args = ap.parse_args(argv)

    server = serve(args.modbus_host, args.modbus_port, args.http_host,
                   args.http_port, unit=args.unit,
                   nitrogen=args.nitrogen)
    print(f"Web HMI on http://{args.http_host}:{server.server_port} "
          f"(plant at {args.modbus_host}:{args.modbus_port}, "
          f"unit {args.unit})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.hmi.close()


if __name__ == "__main__":
    main()
