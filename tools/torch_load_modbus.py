"""
Modbus data-plane load test of the PyTorch port's servers: many concurrent
masters hammering one server (the port of ``tools/load_modbus.py``).

The port's Python asyncio server (``ics_wt_physicsengine_torch/modbus/
slave.py``) or its C++ data plane (``--native``, ``native_slave.py``) is
created in this process, or ``--attach-port`` drives a running one (the
orchestrator's, ``python -m ics_wt_physicsengine_torch --port P``).
N worker threads each hold one connection and send back-to-back
read-input-register requests for a fixed duration; it reports aggregate
requests/s, per-request latency percentiles, and error counts. Connections beyond the server's cap are expected to be refused
(that is the hardening working, not a failure) — the tool reports how many
workers got slots.

No device work of its own: the plane is host code.

Usage:
  python tools/torch_load_modbus.py [--clients 32] [--seconds 5] [--native]
      [--mode auto|thread|async] [--attach-port P] [--out F]
"""

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ics_wt_physicsengine_torch.modbus import (  # noqa: E402
    ModbusRegisterMap,
    ModbusServerConfig,
    ModbusSlave,
    ModbusTcpClient,
)


def worker(port, stop, stats, idx):
    lat = []
    n = err = 0
    try:
        with ModbusTcpClient("127.0.0.1", port, timeout=5) as c:
            # one probe read proves we actually hold a slot
            c.read_input_registers(0, 2)
            stats["connected"][idx] = True
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    c.read_input_registers(0, 2)
                    lat.append(time.perf_counter() - t0)
                    n += 1
                except Exception:  # noqa: BLE001
                    err += 1
                    break
    except Exception:  # noqa: BLE001
        pass   # refused at the connection cap: reported via `connected`
    stats["requests"][idx] = n
    stats["errors"][idx] = err
    stats["latencies"][idx] = lat


def async_load(port, n_clients, seconds, ramp=200):
    """Asyncio load generator: one event loop holding ``n_clients`` live
    connections (1000+ feasible on one core, unlike one-thread-per-client),
    each issuing back-to-back FC4 reads with per-request latency capture.
    Connections ramp in batches of ``ramp`` so the listener's accept queue
    never overflows. Returns the same stats dict shape as the thread mode.
    """
    import asyncio
    import struct

    stats = {"requests": [0] * n_clients,
             "errors": [0] * n_clients,
             "latencies": [[] for _ in range(n_clients)],
             "connected": [False] * n_clients}
    req = struct.pack(">HHHBBHH", 1, 0, 6, 1, 4, 0, 2)

    async def run():
        stop = asyncio.Event()

        async def client(idx):
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1",
                                                               port)
            except OSError:
                return
            lat, n, err = stats["latencies"][idx], 0, 0
            try:
                # one probe proves the slot is actually served
                writer.write(req)
                await writer.drain()
                hdr = await asyncio.wait_for(reader.readexactly(7), 30)
                await reader.readexactly(
                    struct.unpack(">HHHB", hdr)[2] - 1)
                stats["connected"][idx] = True
                while not stop.is_set():
                    t0 = time.perf_counter()
                    writer.write(req)
                    await writer.drain()
                    hdr = await reader.readexactly(7)
                    await reader.readexactly(
                        struct.unpack(">HHHB", hdr)[2] - 1)
                    lat.append(time.perf_counter() - t0)
                    n += 1
            except (asyncio.IncompleteReadError, ConnectionError,
                    asyncio.TimeoutError, OSError):
                err += 1
            finally:
                stats["requests"][idx] = n
                stats["errors"][idx] = err
                writer.close()

        tasks = []
        for i in range(0, n_clients, ramp):
            tasks += [asyncio.create_task(client(j))
                      for j in range(i, min(i + ramp, n_clients))]
            await asyncio.sleep(0.05)
        await asyncio.sleep(seconds)
        stop.set()
        await asyncio.wait_for(
            asyncio.gather(*tasks, return_exceptions=True), 60)

    t0 = time.perf_counter()
    asyncio.run(run())
    return stats, time.perf_counter() - t0


def _raise_fd_limit(need: int):
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = min(max(soft, need), hard)
    if want > soft:
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--native", action="store_true",
                    help="load the C++ data plane instead of the Python "
                         "asyncio server")
    ap.add_argument("--max-connections", type=int, default=None,
                    help="server-side cap (default: fit the client count)")
    ap.add_argument("--mode", choices=("auto", "thread", "async"),
                    default="auto",
                    help="load-generator concurrency: one thread per "
                         "client (accurate isolated latency, <=~128 "
                         "clients on one core) or one asyncio loop "
                         "(1000+ clients); auto switches at 128")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the JSON result to this file")
    ap.add_argument("--attach-port", type=int, default=None,
                    help="drive an already-running Modbus/TCP server on "
                         "this port (e.g. the orchestrator's) instead of "
                         "creating one in-process")
    args = ap.parse_args(argv)
    mode = args.mode
    if mode == "auto":
        mode = "async" if args.clients > 128 else "thread"
    # server + in-process clients share the fd table
    _raise_fd_limit(2 * args.clients + 128)

    slave = None
    if args.attach_port is None:
        cap = args.max_connections or max(32, args.clients + 4)
        config = ModbusServerConfig(host="127.0.0.1", port=0,
                                    max_connections=cap)
        if args.native:
            from ics_wt_physicsengine_torch.modbus import native_slave

            if not native_slave.is_available():
                raise SystemExit("native library unavailable")
            slave = native_slave.NativeModbusSlave(ModbusRegisterMap(),
                                                   config)
        else:
            slave = ModbusSlave(ModbusRegisterMap(), config)
        slave.start(blocking=False)
        slave.update_input_register("pH_inlet", 7.2)
    port = args.attach_port if slave is None else slave.port

    if mode == "async":
        stats, wall = async_load(port, args.clients, args.seconds)
    else:
        stop = threading.Event()
        stats = {"requests": [0] * args.clients,
                 "errors": [0] * args.clients,
                 "latencies": [[] for _ in range(args.clients)],
                 "connected": [False] * args.clients}
        threads = [threading.Thread(target=worker,
                                    args=(port, stop, stats, i),
                                    daemon=True)
                   for i in range(args.clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(args.seconds)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        wall = time.perf_counter() - t0

    # Read the FC 08 diagnostics counters over the wire AFTER the load —
    # end-to-end proof the counters tracked the run on this plane (the
    # reference server keeps no diagnostics counters).
    try:
        with ModbusTcpClient("127.0.0.1", port, timeout=5) as c:
            diag = c.diagnostic_counters()
    except Exception as e:  # noqa: BLE001 - diagnostics are best-effort
        diag = {"error": type(e).__name__}
    if slave is not None:
        slave.stop()

    import numpy as np
    total = sum(stats["requests"])
    lats = np.array([x for ls in stats["latencies"] for x in ls])
    n_served = int(sum(stats["connected"]))
    result = {
        "plane": ("attached" if slave is None else
                  "native-c++" if args.native else "python-asyncio"),
        "mode": mode,
        "clients_requested": args.clients,
        "clients_served": n_served,
        "seconds": round(wall, 2),
        "total_requests": total,
        "requests_per_s": round(total / wall, 1),
        "latency_ms": {
            "p50": round(float(np.percentile(lats, 50)) * 1e3, 3),
            "p95": round(float(np.percentile(lats, 95)) * 1e3, 3),
            "p99": round(float(np.percentile(lats, 99)) * 1e3, 3),
            "max": round(float(lats.max()) * 1e3, 3),
        } if len(lats) else None,
        "errors": int(sum(stats["errors"])),
        # 16-bit wrapping values per the Modbus spec (FC 08 returns one
        # register) — at >65k requests the count is total mod 65536
        "fc08_counters": diag,
        # the serving budget: every master polling once per dt=1 s tick
        # needs p99 well under 1000 ms and requests_per_s >= clients
        "dt1s_budget_ok": bool(
            len(lats) and np.percentile(lats, 99) < 1.0
            and total / wall >= n_served),
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
