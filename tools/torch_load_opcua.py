"""
OPC UA plane load test of the PyTorch port's server: many concurrent
sessions hammering one server (the port of ``tools/load_opcua.py``).

Counterpart to tools/torch_load_modbus.py for the OPC UA plane
(``ics_wt_physicsengine_torch/opcua/server.py``): one asyncio
event loop holds N live sessions — each does the full handshake
(HEL/ACK, OpenSecureChannel, CreateSession, ActivateSession) — and then
drives one of two workloads:

- ``read`` (default): back-to-back Read requests on the Value attribute,
  the OPC UA equivalent of the Modbus FC4 polling load.
- ``subscribe``: every session creates a subscription + monitored item
  and loops Publish; latency is the publish round-trip (data change or
  keepalive), measuring the server's per-connection sampler tasks.

Reports aggregate requests/s, latency percentiles, and errors in the
same JSON shape as torch_load_modbus.py. Connections refused at the server cap
are expected (hardening working) and reported via ``clients_served``.

No device work of its own: the plane is host code.

Usage:
  python tools/torch_load_opcua.py [--clients 32] [--seconds 5]
      [--workload read|subscribe] [--attach-port P] [--out F]
"""

import argparse
import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ics_wt_physicsengine_torch.modbus import (  # noqa: E402
    ModbusRegisterMap,
    ModbusServerConfig,
    ModbusSlave,
)
from ics_wt_physicsengine_torch.opcua import messages as M  # noqa: E402
from ics_wt_physicsengine_torch.opcua.encoding import (  # noqa: E402
    Decoder,
    Encoder,
    NodeId,
    unix_to_filetime,
)
from ics_wt_physicsengine_torch.opcua.server import OPCUAServer  # noqa: E402


class _AsyncSession:
    """Minimal asyncio OPC UA session sharing the sync client's structs."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self._seq = 0
        self._handle = 0
        self.channel_id = 0
        self.token_id = 0
        self.auth_token = NodeId(0, 0)

    async def _recv(self):
        hdr = await self.reader.readexactly(8)
        size = int.from_bytes(hdr[4:8], "little")
        body = await self.reader.readexactly(size - 8)
        return hdr[0:3].decode("ascii"), body

    def _header(self):
        self._handle += 1
        return M.RequestHeader(auth_token=self.auth_token,
                               timestamp=unix_to_filetime(time.time()),
                               request_handle=self._handle,
                               timeout_hint=30_000)

    async def _service(self, req_id, req, rsp_id, decode_rsp):
        self._seq += 1
        e = Encoder()
        e.uint32(self.channel_id)
        e.uint32(self.token_id)
        M.SequenceHeader(self._seq, self._seq).encode(e)
        e.raw(M.encode_service(req_id, req))
        self.writer.write(M.frame("MSG", e.data()))
        await self.writer.drain()
        msg_type, body = await self._recv()
        if msg_type != "MSG":
            raise ConnectionError(f"expected MSG, got {msg_type}")
        d = Decoder(body)
        d.uint32()
        d.uint32()
        M.SequenceHeader.decode(d)
        got = M.decode_service_id(d)
        if got != rsp_id:
            raise ConnectionError(f"expected service {rsp_id}, got {got}")
        return decode_rsp(d)

    async def handshake(self, port):
        self.writer.write(M.Hello(
            endpoint_url=f"opc.tcp://127.0.0.1:{port}/plant").encode())
        await self.writer.drain()
        msg_type, body = await self._recv()
        if msg_type != "ACK":
            raise ConnectionError(f"expected ACK, got {msg_type}")
        # OPN
        self._seq += 1
        e = Encoder()
        M.AsymmetricHeader(0).encode(e)
        M.SequenceHeader(self._seq, self._seq).encode(e)
        e.raw(M.encode_service(M.ID_OPEN_CHANNEL_REQ,
                               M.OpenSecureChannelRequest(self._header())))
        self.writer.write(M.frame("OPN", e.data()))
        await self.writer.drain()
        msg_type, body = await self._recv()
        if msg_type != "OPN":
            raise ConnectionError(f"expected OPN, got {msg_type}")
        d = Decoder(body)
        M.AsymmetricHeader.decode(d)
        M.SequenceHeader.decode(d)
        M.decode_service_id(d)
        rsp = M.OpenSecureChannelResponse.decode(d)
        self.channel_id = rsp.token.channel_id
        self.token_id = rsp.token.token_id
        # session
        rsp = await self._service(
            M.ID_CREATE_SESSION_REQ,
            M.CreateSessionRequest(self._header(),
                                   session_name="load"),
            M.ID_CREATE_SESSION_RSP, M.CreateSessionResponse.decode)
        self.auth_token = rsp.auth_token
        await self._service(
            M.ID_ACTIVATE_SESSION_REQ,
            M.ActivateSessionRequest(self._header()),
            M.ID_ACTIVATE_SESSION_RSP, M.ActivateSessionResponse.decode)


async def _run_load(port, n_clients, seconds, workload, ramp=200):
    stats = {"requests": [0] * n_clients,
             "errors": [0] * n_clients,
             "latencies": [[] for _ in range(n_clients)],
             "connected": [False] * n_clients,
             "granted_s": [None] * n_clients}
    stop = asyncio.Event()

    async def client(idx):
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           port)
        except OSError:
            return
        s = _AsyncSession(reader, writer)
        lat, n, err = stats["latencies"][idx], 0, 0
        try:
            await asyncio.wait_for(s.handshake(port), 30)
            stats["connected"][idx] = True
            if workload == "subscribe":
                rsp = await s._service(
                    M.ID_CREATE_SUBSCRIPTION_REQ,
                    M.CreateSubscriptionRequest(
                        s._header(),
                        requested_publishing_interval_ms=250.0,
                        requested_max_keepalive_count=2),
                    M.ID_CREATE_SUBSCRIPTION_RSP,
                    M.CreateSubscriptionResponse.decode)
                sub_id = rsp.subscription_id
                # the server may REVISE the cadence under load (adaptive
                # shedding) — honor the granted interval when waiting
                granted_s = rsp.revised_publishing_interval_ms / 1000.0
                stats["granted_s"][idx] = granted_s
                pub_timeout = max(30.0, 3.0 * granted_s)
                await s._service(
                    M.ID_CREATE_MONITORED_ITEMS_REQ,
                    M.CreateMonitoredItemsRequest(
                        s._header(), subscription_id=sub_id,
                        items=[M.MonitoredItemCreateRequest(
                            item_to_monitor=M.ReadValueId(
                                NodeId(1, "u1.pH_inlet")),
                            requested_parameters=M.MonitoringParameters(
                                client_handle=1))]),
                    M.ID_CREATE_MONITORED_ITEMS_RSP,
                    M.CreateMonitoredItemsResponse.decode)
                while not stop.is_set():
                    t0 = time.perf_counter()
                    await asyncio.wait_for(s._service(
                        M.ID_PUBLISH_REQ,
                        M.PublishRequest(s._header()),
                        M.ID_PUBLISH_RSP, M.PublishResponse.decode),
                        pub_timeout)
                    lat.append(time.perf_counter() - t0)
                    n += 1
            else:
                req_nodes = [M.ReadValueId(NodeId(1, "u1.pH_inlet"))]
                while not stop.is_set():
                    t0 = time.perf_counter()
                    await asyncio.wait_for(s._service(
                        M.ID_READ_REQ,
                        M.ReadRequest(s._header(), nodes=req_nodes),
                        M.ID_READ_RSP, M.ReadResponse.decode), 30)
                    lat.append(time.perf_counter() - t0)
                    n += 1
        except asyncio.CancelledError:
            pass               # clean shutdown at stop time
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
    # shed sessions may legitimately be waiting out a long granted
    # cadence — cancel instead of waiting for their next publish
    await asyncio.sleep(0.5)
    for t in tasks:
        t.cancel()
    await asyncio.wait_for(
        asyncio.gather(*tasks, return_exceptions=True), 90)
    return stats


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
    ap.add_argument("--workload", choices=("read", "subscribe"),
                    default="read")
    ap.add_argument("--max-connections", type=int, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--attach-port", type=int, default=None,
                    help="drive an already-running OPC UA server on this "
                         "port instead of creating one in-process (e.g. "
                         "an orchestrator --opcua plane, or a server "
                         "under an external profiler)")
    args = ap.parse_args(argv)
    _raise_fd_limit(2 * args.clients + 128)

    server = slave = None
    if args.attach_port is None:
        slave = ModbusSlave(ModbusRegisterMap(),
                            ModbusServerConfig(host="127.0.0.1", port=0))
        slave.update_input_register("pH_inlet", 7.2)
        cap = args.max_connections or max(32, args.clients + 4)
        server = OPCUAServer(slave, host="127.0.0.1", port=0,
                             max_connections=cap)
        server.start()
    port = args.attach_port if server is None else server.actual_port
    t0 = time.perf_counter()
    stats = asyncio.run(_run_load(port, args.clients,
                                  args.seconds, args.workload))
    wall = time.perf_counter() - t0
    if server is not None:
        server.stop()
        slave.stop()

    import numpy as np
    total = sum(stats["requests"])
    lats = np.array([x for ls in stats["latencies"] for x in ls])
    n_served = int(sum(stats["connected"]))
    result = {
        "plane": "opcua",
        "workload": args.workload,
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
    }
    if args.workload == "subscribe":
        granted = [g for g in stats["granted_s"] if g is not None]
        # sessions the adaptive budget revised past the dt=1 s tick —
        # they serve at the granted cadence by design, so they are
        # reported separately, not counted against the 1 s budget
        shed = [g for g in granted if g > 1.05]
        result["sessions_shed_past_1s"] = len(shed)
        result["granted_interval_s"] = {
            "min": round(min(granted), 3) if granted else None,
            "max": round(max(granted), 3) if granted else None,
        }
        n_in_budget = len(granted) - len(shed)
    else:
        n_in_budget = n_served
    # same budget lens as the Modbus load: every in-budget client
    # polling (or publishing) once per dt=1 s tick needs p99 << 1000 ms
    result["dt1s_budget_ok"] = bool(
        len(lats) and np.percentile(lats, 99) < 1.0
        and result["errors"] == 0
        and total / wall >= n_in_budget)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
