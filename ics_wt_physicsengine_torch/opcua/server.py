"""
OPC UA server (binary transport, SecurityPolicy#None) for the plant.

Delivers the reference's last roadmap row — "OPC UA server (in addition
to Modbus)" (reference README.md:456) — without any external OPC UA
stack: transport, secure-channel, session and the Read/Write/Browse
services are implemented from the spec in this package.

Design: the OPC UA server does NOT own plant state. It bridges onto a
``ModbusSlave``'s thread-safe, name-based register API, so OPC UA clients
and Modbus masters always see the same values, writes from either plane
land in the same holding registers/coils the orchestrator validates, and
the simulation loop is untouched. The address space mirrors the register
map:

    Objects (i=85)
      Unit<u>                      ns=1;s=u<u>           (one per unit id)
        <input_register name>      ns=1;s=u<u>.<name>    Double, read-only
        <holding_register name>    ns=1;s=u<u>.<name>    Double, writable
        <coil name>                ns=1;s=u<u>.<name>    Boolean, writable
        <discrete_input name>      ns=1;s=u<u>.<name>    Boolean, read-only

TranslateBrowsePathsToNodeIds resolves Objects/Unit<u>/<register> paths
the way discovery-driven stacks expect; RegisterNodes/UnregisterNodes
answer the optimization-hint handshake (ids echoed) instead of faulting. Subscriptions (OPC 10000-4
§5.12/§5.13) are supported: CreateSubscription / ModifySubscription
/ CreateMonitoredItems / Publish / Republish / SetPublishingMode /
SetMonitoringMode /
DeleteMonitoredItems / DeleteSubscriptions, with data-change sampling at
the (revised) publishing interval, per-item queues, keepalives,
sequence-numbered retransmission buffers and acknowledgement handling —
the push path real SCADA clients use instead of polling Read.
DataChangeFilter absolute AND percent deadbands are applied at the
sampler (round 4): analog registers carry engineering-unit ranges
(register_map eu_range), exposed as EURange property nodes (Part 8),
and percent deadbands convert to absolute bands over that span —
Bad_FilterNotAllowed for nodes without an EURange. Scope (documented,
tested): anonymous auth over policy None only, single-chunk messages,
items sample at the publishing cadence (samplingInterval is revised up
to it), event notifications are not implemented. Certificate security
needs a crypto/PKI stack that is out of scope here; the Modbus planes'
hardening posture (cluster-internal, docs/SECURITY.md) applies to this
port too.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from ics_wt_physicsengine_torch.modbus.register_map import RegisterType
from ics_wt_physicsengine_torch.opcua import messages as M
from ics_wt_physicsengine_torch.opcua.encoding import (
    DataValue,
    DecodeError,
    Decoder,
    Encoder,
    ExtensionObject,
    LocalizedText,
    NodeId,
    QualifiedName,
    Variant,
    VT_BOOLEAN,
    VT_DOUBLE,
    VT_EXTENSIONOBJECT,
    unix_to_filetime,
)

logger = logging.getLogger(__name__)

NAMESPACE = 1
APPLICATION_URI = "urn:ics-wt-physicsengine-tpu:plant"
PRODUCT_URI = "urn:ics-wt-physicsengine-tpu"


@dataclass(frozen=True)
class _Node:
    """One variable in the mirrored address space."""

    unit: int
    register: str
    kind: RegisterType
    writable: bool
    units: str
    description: str
    eu_range: Optional[tuple] = None   # (low, high) engineering units

    @property
    def is_boolean(self) -> bool:
        return self.kind in (RegisterType.COIL,
                             RegisterType.DISCRETE_INPUT)


class OPCUAServer:
    """Serve the plant over OPC UA TCP, bridged onto a ModbusSlave.

    Same lifecycle pattern as the Modbus slave: asyncio loop in a daemon
    thread, Event-gated start/stop."""

    def __init__(self, slave, host: str = "0.0.0.0", port: int = 4840,
                 max_connections: int = 32,
                 idle_timeout_seconds: float = 300.0,
                 adaptive_tick_budget_per_s: float = 1250.0):
        self.slave = slave
        self.host = host
        self.port = port
        # Same abuse posture as the Modbus planes (modbus/slave.py:80-86):
        # excess clients are closed immediately (no queued server-side
        # state), idle cap-slot holders are dropped, and response drains
        # are bounded so a never-reading peer cannot pin a slot.
        self.max_connections = max_connections
        self.idle_timeout_seconds = idle_timeout_seconds
        self._n_clients = 0
        # Discovery-driven clients dial the advertised endpointUrl, so a
        # wildcard bind address must not leak into it (0.0.0.0 is not
        # connectable); advertise the machine's hostname instead.
        import socket as _socket
        self._adv_host = (host if host not in ("0.0.0.0", "::", "")
                          else _socket.gethostname())
        self._endpoint_url = f"opc.tcp://{self._adv_host}:{port}/plant"

        # Address space: unit folders + one node per register. Node ids
        # are u<unit>.<name>, so names must be unique across all four
        # register types — fail fast rather than silently aliasing two
        # registers onto one node.
        self._nodes: Dict[str, _Node] = {}
        self._children: Dict[str, list] = {}   # folder sid -> child sids
        self._properties: Dict[str, tuple] = {}  # EURange sid -> (lo, hi)
        rm = slave.register_map
        for u in slave.units:
            folder = f"u{u}"
            self._children[folder] = []
            for reg in (list(rm.input_registers)
                        + list(rm.holding_registers) + list(rm.coils)
                        + list(rm.discrete_inputs)):
                writable = reg.register_type in (
                    RegisterType.HOLDING_REGISTER, RegisterType.COIL)
                sid = f"{folder}.{reg.name}"
                if sid in self._nodes:
                    raise ValueError(
                        f"register name {reg.name!r} appears in more "
                        f"than one register type; OPC UA node ids "
                        f"require unique names")
                eu_range = getattr(reg, "eu_range", None)
                self._nodes[sid] = _Node(u, reg.name, reg.register_type,
                                         writable, reg.units,
                                         reg.description,
                                         eu_range=eu_range)
                self._children[folder].append(sid)
                # EURange property node (Part 8 AnalogItem property):
                # serves percent-deadband conversion and HMI scaling
                if eu_range is not None:
                    self._properties[f"{sid}.EURange"] = eu_range

        self._server_ready = threading.Event()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._actual_port: Optional[int] = None
        self._next_channel = 1
        self._next_session = 1
        self._next_subscription = 1
        self._lock = threading.Lock()
        self.request_count = 0
        # Load-adaptive publish shedding. The subscribe plane's cost
        # driver is the server-wide aggregate sample-tick rate
        # (sum over subscriptions of 1/interval): the 1000-session load
        # test measured p99 publish latency of 720 ms against a 1 s
        # publishing interval at 1000 ticks/s (LOADTEST_r03/r04
        # _opcua_subscribe.json) — passing, but with only 28% headroom.
        # Part 4 §5.13.2 lets the server REVISE the requested publishing
        # interval, so instead of degrading unboundedly past the measured
        # knee, CreateSubscription/ModifySubscription revise intervals up
        # whenever the aggregate would exceed this budget, falling back
        # to the ADAPTIVE_MAX_INTERVAL_S floor cadence once the budget is
        # exhausted — sessions are never refused for load (each
        # floor-granted subscription overshoots by only 1/60 tick/s, and
        # the per-session MAX_SUBSCRIPTIONS x connection caps bound the
        # total). The default sits just above the tested 1000 ticks/s
        # operating point, so the tested scale is served unrevised and
        # anything beyond it sheds cadence instead of latency or
        # sessions.
        self.adaptive_tick_budget_per_s = float(adaptive_tick_budget_per_s)
        self._sub_ticks_per_s = 0.0
        # Idle enforcement: handlers stamp activity on complete messages;
        # _serve sweeps (utils/netreap.py — shared with the Modbus plane)
        from ics_wt_physicsengine_torch.utils.netreap import IdleReaper
        self._reaper = IdleReaper(idle_timeout_seconds,
                                  log=lambda m: logger.debug("OPCUA: %s", m))

    # ------------------------------------------------------------------
    # Lifecycle (mirrors ModbusSlave.start/stop)
    # ------------------------------------------------------------------

    def start(self, blocking: bool = False) -> None:
        self._start_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="opcua-server")
        self._thread.start()
        deadline = time.monotonic() + 10.0
        while (not self._server_ready.wait(timeout=0.05)
               and self._thread.is_alive()
               and time.monotonic() < deadline):
            pass
        if not self._server_ready.is_set():
            if self._start_error is not None:     # e.g. EADDRINUSE
                raise RuntimeError(
                    f"OPC UA server failed to start: "
                    f"{self._start_error!r}") from self._start_error
            raise RuntimeError("OPC UA server failed to start within 10 s")
        logger.info("OPC UA server listening on %s", self._endpoint_url)
        if blocking:
            self._thread.join()

    def stop(self) -> None:
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=3.0)

    @property
    def actual_port(self) -> Optional[int]:
        return self._actual_port

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._serve())
        except BaseException as e:   # noqa: BLE001 — surface via start()
            self._start_error = e
            if self._server_ready.is_set():
                raise
        finally:
            self._loop.close()

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_client, self.host, self.port)
        self._actual_port = self._server.sockets[0].getsockname()[1]
        self._endpoint_url = (
            f"opc.tcp://{self._adv_host}:{self._actual_port}/plant")
        self._server_ready.set()
        try:
            loop = asyncio.get_running_loop()
            while not self._shutdown.is_set():
                await asyncio.sleep(0.1)
                # Idle/slow-reader reaper (utils/netreap.py, shared with
                # the Modbus plane): handlers stamp activity on complete
                # messages; over-idle transports are aborted here.
                self._reaper.maybe_sweep(loop.time())
        finally:
            self._server.close()
            pending = [t for t in asyncio.all_tasks()
                       if t is not asyncio.current_task()]
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
            await self._server.wait_closed()

    # ------------------------------------------------------------------
    # Connection handling
    # ------------------------------------------------------------------

    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        # Single-threaded event loop, so a plain counter is race-free.
        if self._n_clients >= self.max_connections:
            logger.warning("Rejecting OPC UA client %s: %d connections "
                           "already active (max_connections=%d)", peer,
                           self._n_clients, self.max_connections)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            return
        self._n_clients += 1
        state = _ClientState()
        state.writer = writer
        state.wlock = asyncio.Lock()
        # Idle enforcement via the _serve reaper sweep — per-read
        # wait_for timers are measurable churn at 1000-session request
        # rates. The stamp happens on COMPLETE messages below (not per
        # chunk), so a drip-feeding slow-loris still looks idle.
        loop = asyncio.get_running_loop()
        activity = self._reaper.register(writer, loop.time())
        buf = b""
        try:
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                buf += chunk
                if len(buf) > 32 * 1024 * 1024:
                    raise DecodeError("client buffer overrun")
                while True:
                    split = M.read_exact_message(buf)
                    if split is None:
                        break
                    msg_type, chunk_type, body, buf = split
                    activity[0] = loop.time()   # real protocol progress
                    reply = self._dispatch(msg_type, chunk_type, body,
                                           state)
                    if reply:
                        # The sampler task writes PublishResponses on
                        # the same stream; serialize with it. A peer that
                        # never reads parks this drain; its activity cell
                        # stops advancing and the reaper aborts it.
                        async with state.wlock:
                            writer.write(reply)
                            await writer.drain()
                    if state.closed:
                        return
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError):
            pass
        except DecodeError as e:
            logger.debug("OPC UA decode error from %s: %s", peer, e)
            try:
                writer.write(M.encode_error(M.BAD_DECODING_ERROR, str(e)))
                await asyncio.wait_for(writer.drain(), timeout=5.0)
            except (ConnectionError, asyncio.TimeoutError):
                pass
        except asyncio.CancelledError:
            raise
        except Exception:   # noqa: BLE001 — never kill the server thread
            logger.exception("OPC UA handler error from %s", peer)
        finally:
            self._reaper.pop(writer)
            self._n_clients -= 1
            for sub in state.subscriptions.values():
                self._sub_ticks_per_s -= 1.0 / sub.interval_s
            state.subscriptions.clear()
            if state.publisher_task is not None:
                state.publisher_task.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # ------------------------------------------------------------------
    # Message dispatch
    # ------------------------------------------------------------------

    def _dispatch(self, msg_type: str, chunk_type: str, body: bytes,
                  state: "_ClientState") -> bytes:
        self.request_count += 1
        if chunk_type != "F":
            return M.encode_error(M.BAD_TCP_MESSAGE_TYPE_INVALID,
                                  "multi-chunk messages not supported")
        if msg_type == "HEL":
            hello = M.Hello.decode(body)
            state.said_hello = True
            cap = 16 * 1024 * 1024
            # Single-chunk transport: never send a frame larger than the
            # peer's declared receive buffer (enforced in
            # _frame_response via Bad_ResponseTooLarge).
            state.max_out_frame = min(hello.receive_buffer_size or cap,
                                      cap)
            return M.Acknowledge(
                protocol_version=0,
                receive_buffer_size=cap,
                send_buffer_size=state.max_out_frame,
                max_message_size=cap,
                max_chunk_count=1).encode()
        if not state.said_hello:
            return M.encode_error(M.BAD_TCP_MESSAGE_TYPE_INVALID,
                                  "expected HEL first")
        if msg_type == "OPN":
            return self._handle_open(body, state)
        if msg_type == "CLO":
            state.closed = True
            return b""
        if msg_type == "MSG":
            return self._handle_msg(body, state)
        return M.encode_error(M.BAD_TCP_MESSAGE_TYPE_INVALID,
                              f"unknown message type {msg_type!r}")

    def _handle_open(self, body: bytes, state: "_ClientState") -> bytes:
        d = Decoder(body)
        asym = M.AsymmetricHeader.decode(d)
        if asym.policy_uri != M.SECURITY_POLICY_NONE:
            return M.encode_error(
                M.BAD_SECURITY_POLICY_REJECTED,
                f"only {M.SECURITY_POLICY_NONE} is supported")
        seq = M.SequenceHeader.decode(d)
        service_id = M.decode_service_id(d)
        if service_id != M.ID_OPEN_CHANNEL_REQ:
            return M.encode_error(M.BAD_DECODING_ERROR,
                                  "OPN must carry OpenSecureChannelRequest")
        req = M.OpenSecureChannelRequest.decode(d)
        with self._lock:
            if state.channel_id == 0:
                state.channel_id = self._next_channel
                self._next_channel += 1
            state.token_id += 1
        now = unix_to_filetime(time.time())
        rsp = M.OpenSecureChannelResponse(
            header=M.ResponseHeader(
                timestamp=now,
                request_handle=req.header.request_handle),
            token=M.ChannelSecurityToken(
                channel_id=state.channel_id, token_id=state.token_id,
                created_at=now,
                revised_lifetime_ms=req.requested_lifetime_ms or 3600_000))
        state.out_seq += 1
        e = Encoder()
        M.AsymmetricHeader(state.channel_id).encode(e)
        M.SequenceHeader(state.out_seq, seq.request_id).encode(e)
        e.raw(M.encode_service(M.ID_OPEN_CHANNEL_RSP, rsp))
        return M.frame("OPN", e.data())

    def _handle_msg(self, body: bytes, state: "_ClientState") -> bytes:
        d = Decoder(body)
        channel_id = d.uint32()
        token_id = d.uint32()
        if (channel_id != state.channel_id
                or token_id not in (state.token_id, 0)):
            return M.encode_error(M.BAD_SECURE_CHANNEL_ID_INVALID,
                                  "no such secure channel")
        seq = M.SequenceHeader.decode(d)
        service_id = M.decode_service_id(d)
        rsp_id, rsp = self._handle_service(service_id, d, state, seq)
        if rsp_id is None:
            return b""   # deferred (queued PublishRequest)
        return self._frame_response(state, seq, rsp_id, rsp)

    def _frame_response(self, state: "_ClientState",
                        seq: "M.SequenceHeader", rsp_id: int,
                        rsp) -> bytes:
        payload = M.encode_service(rsp_id, rsp)
        # Single-chunk transport: a response that would exceed the
        # peer's declared receive buffer becomes a ServiceFault the
        # client can react to (split the Read/Browse) instead of an
        # oversized chunk a conformant stack must treat as fatal.
        if (rsp_id != M.ID_SERVICE_FAULT
                and len(payload) + 24 > state.max_out_frame):
            hdr = getattr(rsp, "header", None)
            fault = M.ServiceFault(M.ResponseHeader(
                hdr.timestamp if hdr else 0,
                hdr.request_handle if hdr else 0,
                M.BAD_RESPONSE_TOO_LARGE))
            payload = M.encode_service(M.ID_SERVICE_FAULT, fault)
        # Outgoing sequence numbers are the server's own monotonic
        # counter (Part 6 §6.7.2) — deferred PublishResponses would
        # otherwise interleave stale echoed numbers after later
        # replies. The requestId is the correlation echo.
        state.out_seq += 1
        e = Encoder()
        e.uint32(state.channel_id)
        e.uint32(state.token_id)
        M.SequenceHeader(state.out_seq, seq.request_id).encode(e)
        e.raw(payload)
        return M.frame("MSG", e.data())

    # ------------------------------------------------------------------
    # Services
    # ------------------------------------------------------------------

    def _endpoints(self) -> list:
        app = M.ApplicationDescription(
            application_uri=APPLICATION_URI, product_uri=PRODUCT_URI,
            application_name=LocalizedText(
                "Water Treatment Simulator (PyTorch/CUDA)", "en"),
            discovery_urls=[self._endpoint_url])
        return [M.EndpointDescription(endpoint_url=self._endpoint_url,
                                      server=app)]

    def _fault(self, req_header: M.RequestHeader, status: int):
        return M.ID_SERVICE_FAULT, M.ServiceFault(
            M.ResponseHeader(timestamp=unix_to_filetime(time.time()),
                             request_handle=req_header.request_handle,
                             service_result=status))

    def _handle_service(self, service_id: int, d: Decoder,
                        state: "_ClientState",
                        seq: Optional["M.SequenceHeader"] = None):
        now = unix_to_filetime(time.time())

        if service_id == M.ID_GET_ENDPOINTS_REQ:
            req = M.GetEndpointsRequest.decode(d)
            return M.ID_GET_ENDPOINTS_RSP, M.GetEndpointsResponse(
                M.ResponseHeader(now, req.header.request_handle),
                self._endpoints())

        if service_id == M.ID_CREATE_SESSION_REQ:
            req = M.CreateSessionRequest.decode(d)
            with self._lock:
                sid = self._next_session
                self._next_session += 1
            state.session_id = NodeId(NAMESPACE, f"session-{sid}")
            state.auth_token = NodeId(NAMESPACE, f"token-{sid}")
            state.activated = False
            return M.ID_CREATE_SESSION_RSP, M.CreateSessionResponse(
                M.ResponseHeader(now, req.header.request_handle),
                session_id=state.session_id,
                auth_token=state.auth_token,
                revised_timeout_ms=req.requested_timeout_ms or 3600_000.0,
                endpoints=self._endpoints())

        if service_id == M.ID_ACTIVATE_SESSION_REQ:
            req = M.ActivateSessionRequest.decode(d)
            if req.header.auth_token != state.auth_token:
                return self._fault(req.header, M.BAD_SESSION_ID_INVALID)
            state.activated = True
            return M.ID_ACTIVATE_SESSION_RSP, M.ActivateSessionResponse(
                M.ResponseHeader(now, req.header.request_handle))

        if service_id == M.ID_CLOSE_SESSION_REQ:
            req = M.CloseSessionRequest.decode(d)
            state.activated = False
            state.session_id = None
            if req.delete_subscriptions:
                for sub in state.subscriptions.values():
                    self._sub_ticks_per_s -= 1.0 / sub.interval_s
                state.subscriptions.clear()
            return M.ID_CLOSE_SESSION_RSP, M.CloseSessionResponse(
                M.ResponseHeader(now, req.header.request_handle))

        if service_id == M.ID_READ_REQ:
            req = M.ReadRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            results = [self._read_attribute(n, now) for n in req.nodes]
            return M.ID_READ_RSP, M.ReadResponse(
                M.ResponseHeader(now, req.header.request_handle), results)

        if service_id == M.ID_WRITE_REQ:
            req = M.WriteRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            results = [self._write_attribute(n) for n in req.nodes]
            return M.ID_WRITE_RSP, M.WriteResponse(
                M.ResponseHeader(now, req.header.request_handle), results)

        if service_id == M.ID_BROWSE_REQ:
            req = M.BrowseRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            results = [self._browse_node(b, req.max_references)
                       for b in req.nodes]
            return M.ID_BROWSE_RSP, M.BrowseResponse(
                M.ResponseHeader(now, req.header.request_handle), results)

        if service_id == M.ID_REGISTER_NODES_REQ:
            req = M.RegisterNodesRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            if not req.nodes_to_register:
                return self._fault(req.header, M.BAD_NOTHING_TO_DO)
            # Optimization-hint service (Part 4 §5.8.5): node ids here
            # are already their cheapest form — echo them back, which a
            # conformant server may do. Discovery-driven stacks call
            # this before cyclic access; answering beats a ServiceFault.
            return (M.ID_REGISTER_NODES_RSP, M.RegisterNodesResponse(
                M.ResponseHeader(now, req.header.request_handle),
                registered_node_ids=req.nodes_to_register))

        if service_id == M.ID_UNREGISTER_NODES_REQ:
            req = M.UnregisterNodesRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            if not req.nodes_to_unregister:
                return self._fault(req.header, M.BAD_NOTHING_TO_DO)
            return (M.ID_UNREGISTER_NODES_RSP, M.UnregisterNodesResponse(
                M.ResponseHeader(now, req.header.request_handle)))

        if service_id == M.ID_TRANSLATE_BROWSE_PATHS_REQ:
            req = M.TranslateBrowsePathsRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            if not req.paths:
                return self._fault(req.header, M.BAD_NOTHING_TO_DO)
            results = [self._translate_path(p) for p in req.paths]
            return (M.ID_TRANSLATE_BROWSE_PATHS_RSP,
                    M.TranslateBrowsePathsResponse(
                        M.ResponseHeader(now, req.header.request_handle),
                        results))

        if service_id == M.ID_SET_MONITORING_MODE_REQ:
            req = M.SetMonitoringModeRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            sub = state.subscriptions.get(req.subscription_id)
            if sub is None:
                return self._fault(req.header,
                                   M.BAD_SUBSCRIPTION_ID_INVALID)
            if not req.monitored_item_ids:
                return self._fault(req.header, M.BAD_NOTHING_TO_DO)
            results = []
            for i in req.monitored_item_ids:
                item = sub.items.get(i)
                if item is None:
                    results.append(M.BAD_MONITORED_ITEM_ID_INVALID)
                else:
                    item.mode = req.monitoring_mode
                    if req.monitoring_mode != 2:
                        # non-reporting items deliver nothing; drop the
                        # queue so a later re-enable starts fresh
                        item.queue.clear()
                        item.last = None
                    results.append(M.GOOD)
            return (M.ID_SET_MONITORING_MODE_RSP,
                    M.SetMonitoringModeResponse(
                        M.ResponseHeader(now, req.header.request_handle),
                        results))

        if service_id == M.ID_CREATE_SUBSCRIPTION_REQ:
            req = M.CreateSubscriptionRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            return self._create_subscription(req, now, state)

        if service_id == M.ID_MODIFY_SUBSCRIPTION_REQ:
            req = M.ModifySubscriptionRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            sub = state.subscriptions.get(req.subscription_id)
            if sub is None:
                return self._fault(req.header,
                                   M.BAD_SUBSCRIPTION_ID_INVALID)
            # Same revision policy as CreateSubscription; the new
            # interval applies from the NEXT sample (the pending deadline
            # is re-anchored so a shortened interval takes effect
            # immediately rather than after the old one elapses).
            interval_s = max(self.MIN_PUBLISHING_INTERVAL_S,
                             (req.requested_publishing_interval_ms
                              or 1000.0) / 1000.0)
            interval_s = self._revise_interval_for_load(
                interval_s, freed_rate=1.0 / sub.interval_s)
            self._sub_ticks_per_s += (1.0 / interval_s
                                      - 1.0 / sub.interval_s)
            keepalive = min(max(req.requested_max_keepalive_count, 1),
                            1000)
            lifetime = min(max(req.requested_lifetime_count,
                               3 * keepalive), 100_000)
            sub.next_sample = (sub.next_sample - sub.interval_s
                               + interval_s)
            sub.interval_s = interval_s
            sub.keepalive_count = keepalive
            sub.lifetime_count = lifetime
            sub.max_notifications = req.max_notifications_per_publish
            sub.priority = req.priority
            # The modify itself proves client liveness: reset the
            # counters (Part 4 lifetime semantics) — otherwise a stale
            # lifetime_elapsed carried into a much shorter interval can
            # expire the subscription right after the server acked the
            # modify.
            sub.lifetime_elapsed = 0
            sub.keepalive_elapsed = 0
            state.wake.set()   # re-derive the earliest due sample
            return (M.ID_MODIFY_SUBSCRIPTION_RSP,
                    M.ModifySubscriptionResponse(
                        M.ResponseHeader(now, req.header.request_handle),
                        revised_publishing_interval_ms=interval_s * 1000.0,
                        revised_lifetime_count=lifetime,
                        revised_max_keepalive_count=keepalive))

        if service_id == M.ID_CREATE_MONITORED_ITEMS_REQ:
            req = M.CreateMonitoredItemsRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            return self._create_monitored_items(req, now, state)

        if service_id == M.ID_DELETE_MONITORED_ITEMS_REQ:
            req = M.DeleteMonitoredItemsRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            sub = state.subscriptions.get(req.subscription_id)
            if sub is None:
                return self._fault(req.header,
                                   M.BAD_SUBSCRIPTION_ID_INVALID)
            if not req.monitored_item_ids:
                return self._fault(req.header, M.BAD_NOTHING_TO_DO)
            results = []
            for i in req.monitored_item_ids:
                if i in sub.items:
                    del sub.items[i]
                    results.append(M.GOOD)
                else:
                    results.append(M.BAD_MONITORED_ITEM_ID_INVALID)
            return (M.ID_DELETE_MONITORED_ITEMS_RSP,
                    M.DeleteMonitoredItemsResponse(
                        M.ResponseHeader(now, req.header.request_handle),
                        results))

        if service_id == M.ID_SET_PUBLISHING_MODE_REQ:
            req = M.SetPublishingModeRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            if not req.subscription_ids:
                return self._fault(req.header, M.BAD_NOTHING_TO_DO)
            results = []
            for sid in req.subscription_ids:
                sub = state.subscriptions.get(sid)
                if sub is None:
                    results.append(M.BAD_SUBSCRIPTION_ID_INVALID)
                else:
                    sub.enabled = req.publishing_enabled
                    results.append(M.GOOD)
            state.wake.set()   # re-enabled subs may have pending data
            return (M.ID_SET_PUBLISHING_MODE_RSP,
                    M.SetPublishingModeResponse(
                        M.ResponseHeader(now, req.header.request_handle),
                        results))

        if service_id == M.ID_PUBLISH_REQ:
            req = M.PublishRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            if not state.subscriptions:
                return self._fault(req.header, M.BAD_NO_SUBSCRIPTION)
            if len(state.publish_queue) >= state.MAX_PUBLISH_QUEUE:
                return self._fault(req.header,
                                   M.BAD_TOO_MANY_PUBLISH_REQUESTS)
            ack_results = []
            for a in req.acknowledgements:
                sub = state.subscriptions.get(a.subscription_id)
                if sub is None:
                    ack_results.append(M.BAD_SUBSCRIPTION_ID_INVALID)
                elif sub.retransmit.pop(a.sequence_number, None) is None:
                    ack_results.append(M.BAD_SEQUENCE_NUMBER_UNKNOWN)
                else:
                    ack_results.append(M.GOOD)
            # A Publish resets every subscription's lifetime countdown
            for sub in state.subscriptions.values():
                sub.lifetime_elapsed = 0
            state.publish_queue.append(
                (seq, req.header.request_handle, ack_results))
            # Wake the publisher only when this request can be answered
            # NOW (a subscription already has queued data) — the common
            # case (client re-arms right after a response, nothing
            # pending) sleeps through to the next sample tick.
            if any(s.enabled and s.has_pending()
                   for s in state.subscriptions.values()):
                state.wake.set()
            return None, None   # answered by the sampler task

        if service_id == M.ID_REPUBLISH_REQ:
            req = M.RepublishRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            sub = state.subscriptions.get(req.subscription_id)
            if sub is None:
                return self._fault(req.header,
                                   M.BAD_SUBSCRIPTION_ID_INVALID)
            msg = sub.retransmit.get(req.retransmit_sequence_number)
            if msg is None:
                return self._fault(req.header,
                                   M.BAD_MESSAGE_NOT_AVAILABLE)
            return M.ID_REPUBLISH_RSP, M.RepublishResponse(
                M.ResponseHeader(now, req.header.request_handle), msg)

        if service_id == M.ID_DELETE_SUBSCRIPTIONS_REQ:
            req = M.DeleteSubscriptionsRequest.decode(d)
            if not self._session_ok(req.header, state):
                return self._fault(req.header,
                                   M.BAD_SESSION_NOT_ACTIVATED)
            if not req.subscription_ids:
                return self._fault(req.header, M.BAD_NOTHING_TO_DO)
            results = []
            for sid in req.subscription_ids:
                if sid in state.subscriptions:
                    self._sub_ticks_per_s -= \
                        1.0 / state.subscriptions[sid].interval_s
                    del state.subscriptions[sid]
                    results.append(M.GOOD)
                else:
                    results.append(M.BAD_SUBSCRIPTION_ID_INVALID)
            state.wake.set()   # flush queued Publishes / re-derive due
            return (M.ID_DELETE_SUBSCRIPTIONS_RSP,
                    M.DeleteSubscriptionsResponse(
                        M.ResponseHeader(now, req.header.request_handle),
                        results))

        hdr = M.RequestHeader.decode(d)
        return self._fault(hdr, M.BAD_SERVICE_UNSUPPORTED)

    def _session_ok(self, header: M.RequestHeader,
                    state: "_ClientState") -> bool:
        return state.activated and header.auth_token == state.auth_token

    # ------------------------------------------------------------------
    # Subscriptions
    # ------------------------------------------------------------------

    MIN_PUBLISHING_INTERVAL_S = 0.05
    # Ceiling on how far the load-adaptive revision may stretch an
    # interval before the server refuses outright (a 60 s cadence is the
    # slowest publish that is still plausibly useful for plant telemetry).
    ADAPTIVE_MAX_INTERVAL_S = 60.0

    def _revise_interval_for_load(self, interval_s: float,
                                  freed_rate: float = 0.0):
        """Revise ``interval_s`` up so the server-wide aggregate sample
        rate stays within ``adaptive_tick_budget_per_s`` (Part 4 §5.13.2
        server-revision semantics). ``freed_rate`` is the rate the caller
        is about to release (ModifySubscription). Returns the revised
        interval; past budget exhaustion it returns the
        ADAPTIVE_MAX_INTERVAL_S floor cadence rather than refusing.

        All mutations of _sub_ticks_per_s happen on the server's single
        asyncio loop (request handlers, publisher tasks, connection
        teardown), so reads here are coherent without the lock."""
        headroom = (self.adaptive_tick_budget_per_s
                    - self._sub_ticks_per_s + freed_rate)
        if 1.0 / interval_s <= headroom:
            return interval_s
        # Budget exhausted: grant the floor cadence instead of refusing
        # — "sheds cadence, not sessions". Each floor-granted
        # subscription overshoots the budget by only 1/60 tick/s, and
        # the per-session MAX_SUBSCRIPTIONS x connection caps already
        # bound the total count, so no separate refusal is needed
        # (measured: the old refusal branch turned 687 of 1000
        # 250 ms-requesting sessions away while the first 312 kept
        # their full cadence — LOADTEST first-come-fully-served flaw).
        revised = (1.0 / headroom
                   if headroom > 1.0 / self.ADAPTIVE_MAX_INTERVAL_S
                   else self.ADAPTIVE_MAX_INTERVAL_S)
        logger.info("OPC UA adaptive revision: %.3f s -> %.3f s "
                    "(aggregate %.1f ticks/s, budget %.1f)",
                    interval_s, revised, self._sub_ticks_per_s,
                    self.adaptive_tick_budget_per_s)
        return revised

    def _create_subscription(self, req: "M.CreateSubscriptionRequest",
                             now: int, state: "_ClientState"):
        if len(state.subscriptions) >= state.MAX_SUBSCRIPTIONS:
            return self._fault(req.header, M.BAD_TOO_MANY_SUBSCRIPTIONS)
        interval_s = max(self.MIN_PUBLISHING_INTERVAL_S,
                         (req.requested_publishing_interval_ms or 1000.0)
                         / 1000.0)
        interval_s = self._revise_interval_for_load(interval_s)
        keepalive = min(max(req.requested_max_keepalive_count, 1), 1000)
        lifetime = min(max(req.requested_lifetime_count, 3 * keepalive),
                       100_000)
        with self._lock:
            sub_id = self._next_subscription
            self._next_subscription += 1
        sub = _Subscription(sub_id, interval_s, lifetime, keepalive,
                            req.max_notifications_per_publish,
                            req.publishing_enabled, req.priority)
        sub.next_sample = time.monotonic() + interval_s
        state.subscriptions[sub_id] = sub
        self._sub_ticks_per_s += 1.0 / interval_s
        state.wake.set()     # re-derive the earliest due sample
        if state.publisher_task is None:
            state.publisher_task = asyncio.get_running_loop().create_task(
                self._publisher(state))
        return M.ID_CREATE_SUBSCRIPTION_RSP, M.CreateSubscriptionResponse(
            M.ResponseHeader(now, req.header.request_handle),
            subscription_id=sub_id,
            revised_publishing_interval_ms=interval_s * 1000.0,
            revised_lifetime_count=lifetime,
            revised_max_keepalive_count=keepalive)

    def _create_monitored_items(self,
                                req: "M.CreateMonitoredItemsRequest",
                                now: int, state: "_ClientState"):
        sub = state.subscriptions.get(req.subscription_id)
        if sub is None:
            return self._fault(req.header, M.BAD_SUBSCRIPTION_ID_INVALID)
        if not req.items:
            return self._fault(req.header, M.BAD_NOTHING_TO_DO)
        results = []
        for item in req.items:
            rv = item.item_to_monitor
            known = (self._lookup(rv.node_id) is not None
                     or rv.node_id == M.OBJECTS_FOLDER
                     or (rv.node_id.namespace == NAMESPACE
                         and isinstance(rv.node_id.identifier, str)
                         and (rv.node_id.identifier in self._children
                              or rv.node_id.identifier
                              in self._properties)))
            if not known:
                results.append(M.MonitoredItemCreateResult(
                    status=M.BAD_NODE_ID_UNKNOWN))
                continue
            if len(sub.items) >= state.MAX_ITEMS_PER_SUBSCRIPTION:
                results.append(M.MonitoredItemCreateResult(
                    status=M.BAD_TOO_MANY_MONITORED_ITEMS))
                continue
            queue_size = min(max(item.requested_parameters.queue_size, 1),
                             100)
            # DataChangeFilter: absolute and percent deadbands are
            # applied at the sampler (percent converts to absolute via
            # the node's EURange span, Part 8 section 5.6.3.3). Unknown
            # filter types are refused rather than silently ignored.
            deadband = None
            filt = item.requested_parameters.filter
            if filt.body is not None:
                if not (filt.type_id.namespace == 0 and
                        filt.type_id.identifier == M.ID_DATA_CHANGE_FILTER):
                    results.append(M.MonitoredItemCreateResult(
                        status=M.BAD_MONITORED_ITEM_FILTER_UNSUPPORTED))
                    continue
                try:
                    dcf = M.DataChangeFilter.decode(Decoder(filt.body))
                except DecodeError:
                    results.append(M.MonitoredItemCreateResult(
                        status=M.BAD_MONITORED_ITEM_FILTER_INVALID))
                    continue
                if dcf.deadband_type == 2:
                    # Percent deadband (Part 8 section 5.6.3.3): percent
                    # OF THE EURANGE SPAN — only nodes carrying the
                    # EURange property qualify (Bad_FilterNotAllowed
                    # otherwise, per Part 8), and the percentage must
                    # be in [0, 100].
                    node = self._lookup(rv.node_id)
                    if node is None or node.eu_range is None:
                        results.append(M.MonitoredItemCreateResult(
                            status=M.BAD_FILTER_NOT_ALLOWED))
                        continue
                    if not 0.0 <= dcf.deadband_value <= 100.0:
                        results.append(M.MonitoredItemCreateResult(
                            status=M.BAD_DEADBAND_FILTER_INVALID))
                        continue
                    low, high = node.eu_range
                    deadband = dcf.deadband_value / 100.0 * (high - low)
                if dcf.deadband_type == 1:
                    if dcf.deadband_value < 0:
                        results.append(M.MonitoredItemCreateResult(
                            status=M.BAD_DEADBAND_FILTER_INVALID))
                        continue
                    deadband = dcf.deadband_value
                # deadband_type 0: trigger-only filter — StatusValue is
                # this server's native change semantics already
            mi = _MonitoredItem(
                sub.new_item_id(), rv,
                item.requested_parameters.client_handle,
                item.monitoring_mode, queue_size,
                item.requested_parameters.discard_oldest,
                deadband=deadband)
            sub.items[mi.id] = mi
            # Items sample at the publishing cadence — reported honestly
            # in the revised parameters (DataChangeFilter has no
            # filter-result type, so filter_result stays null).
            results.append(M.MonitoredItemCreateResult(
                status=M.GOOD, monitored_item_id=mi.id,
                revised_sampling_interval_ms=sub.interval_s * 1000.0,
                revised_queue_size=queue_size))
        return (M.ID_CREATE_MONITORED_ITEMS_RSP,
                M.CreateMonitoredItemsResponse(
                    M.ResponseHeader(now, req.header.request_handle),
                    results))

    def _sample_subscription(self, sub: "_Subscription",
                             now: int) -> None:
        """Read every reporting item; queue a notification on change.
        The first sample after creation always notifies (initial
        value), per Part 4 §5.12.1.2."""
        for item in sub.items.values():
            if item.mode != 2:      # disabled / sampling-only
                continue
            dv = self._read_attribute(item.rv, now)
            key = (None if dv.value is None
                   else (dv.value.type_id, repr(dv.value.value)),
                   dv.status)
            if key == item.last:
                continue
            # Absolute deadband (Part 4 §7.22.2): a numeric change inside
            # the band vs the last REPORTED value is not a data change —
            # item.last stays at the reported value so drift accumulates
            # toward the band edge instead of resetting each sample.
            # Status changes always report.
            if (item.deadband is not None and item.last is not None
                    and item.last_num is not None
                    and dv.value is not None
                    and isinstance(dv.value.value, (int, float))
                    and dv.status == item.last[1]
                    and abs(dv.value.value - item.last_num)
                    <= item.deadband):
                continue
            item.last = key
            item.last_num = (dv.value.value
                             if dv.value is not None and isinstance(
                                 dv.value.value, (int, float))
                             else None)
            item.queue.append(M.MonitoredItemNotification(
                item.client_handle, dv))
            if len(item.queue) > item.queue_size:
                if item.discard_oldest:
                    item.queue.pop(0)
                else:
                    item.queue.pop(-2)   # keep newest, drop previous
    # NOTE on overflow semantics: Part 4 asks for an Overflow bit in
    # the InfoBits of the replaced value's status; queue overflow is
    # rare at publish-cadence sampling (the queue drains every
    # interval) so the bit is omitted — documented scope cut.

    def _build_publish(self, sub: "_Subscription", state: "_ClientState",
                       now: int):
        """Drain pending notifications into one PublishResponse (a
        keepalive when publishing is disabled or nothing is queued —
        disabled subscriptions keep queueing, not delivering)."""
        seq_hdr, request_handle, ack_results = state.publish_queue.popleft()
        notifications: List[M.MonitoredItemNotification] = []
        budget = sub.max_notifications or (1 << 30)
        if sub.enabled:
            for item in sub.items.values():
                while item.queue and len(notifications) < budget:
                    notifications.append(item.queue.pop(0))
        more = sub.enabled and sub.has_pending()
        if notifications:
            msg = M.NotificationMessage(
                sequence_number=sub.next_seq, publish_time=now,
                notification_data=[M.DataChangeNotification(
                    notifications).to_extension_object()])
            sub.retransmit[sub.next_seq] = msg
            sub.next_seq += 1
            while len(sub.retransmit) > sub.MAX_RETRANSMIT:
                del sub.retransmit[min(sub.retransmit)]
        else:
            # keepalive: next expected sequence number, no payload
            msg = M.NotificationMessage(sequence_number=sub.next_seq,
                                        publish_time=now)
        sub.keepalive_elapsed = 0
        rsp = M.PublishResponse(
            M.ResponseHeader(now, request_handle),
            subscription_id=sub.id,
            available_sequence_numbers=sorted(sub.retransmit),
            more_notifications=more,
            notification_message=msg,
            results=ack_results)
        return self._frame_response(state, seq_hdr, M.ID_PUBLISH_RSP, rsp)

    async def _publisher(self, state: "_ClientState") -> None:
        """Per-connection sampler/publisher task: samples due
        subscriptions at their publishing interval and answers queued
        PublishRequests with data changes or keepalives. A write
        failure (slow reader, dead peer) closes the connection rather
        than leaving a zombie session whose subscriptions silently
        stopped publishing."""
        try:
            while True:
                # Event-driven tick: sleep until the earliest due sample —
                # no polling cap — and let request handlers interrupt the
                # wait via state.wake when new work arrives (a queued
                # PublishRequest, subscription create/delete).
                now_mono = time.monotonic()
                due = min((s.next_sample
                           for s in state.subscriptions.values()),
                          default=now_mono + 30.0)
                timeout = due - now_mono
                if timeout > 0:
                    try:
                        await asyncio.wait_for(state.wake.wait(),
                                               timeout=min(timeout, 30.0))
                    except asyncio.TimeoutError:
                        pass
                state.wake.clear()
                now_mono = time.monotonic()
                now = unix_to_filetime(time.time())
                replies = []
                # PublishRequests queued before the last subscription was
                # deleted would otherwise hang the client forever.
                if not state.subscriptions:
                    while state.publish_queue:
                        seq_hdr, handle, _acks = \
                            state.publish_queue.popleft()
                        replies.append(self._frame_response(
                            state, seq_hdr, M.ID_SERVICE_FAULT,
                            M.ServiceFault(M.ResponseHeader(
                                now, handle, M.BAD_NO_SUBSCRIPTION))))
                for sub in list(state.subscriptions.values()):
                    sampled = False
                    if now_mono >= sub.next_sample:
                        sub.next_sample = now_mono + sub.interval_s
                        self._sample_subscription(sub, now)
                        sub.keepalive_elapsed += 1
                        sampled = True
                        if not state.publish_queue:
                            sub.lifetime_elapsed += 1
                            if sub.lifetime_elapsed > sub.lifetime_count:
                                # expired: no Publish requests for the
                                # whole lifetime — drop the subscription
                                logger.info(
                                    "OPC UA subscription %d expired",
                                    sub.id)
                                self._sub_ticks_per_s -= \
                                    1.0 / sub.interval_s
                                del state.subscriptions[sub.id]
                            continue
                    # Deliver pending data whenever a PublishRequest is
                    # queued — including between sample ticks, when the
                    # wake event fired for a freshly queued Publish.
                    while (sub.enabled and sub.has_pending()
                           and state.publish_queue):
                        replies.append(self._build_publish(sub, state,
                                                           now))
                    if (sampled and state.publish_queue
                            and sub.keepalive_elapsed
                            >= sub.keepalive_count):
                        # nothing pending this tick but the keepalive
                        # budget elapsed: send the empty notification
                        replies.append(self._build_publish(sub, state,
                                                           now))
                if replies and state.writer is not None:
                    try:
                        async with state.wlock:
                            for r in replies:
                                state.writer.write(r)
                            await asyncio.wait_for(state.writer.drain(),
                                                   timeout=10.0)
                    except (ConnectionError, OSError,
                            asyncio.TimeoutError):
                        state.writer.close()
                        return
        except asyncio.CancelledError:
            raise
        except Exception:   # noqa: BLE001 — never kill the loop silently
            logger.exception("OPC UA publisher task error")
            if state.writer is not None:
                state.writer.close()

    # ------------------------------------------------------------------
    # Address space
    # ------------------------------------------------------------------

    def _lookup(self, node_id: NodeId) -> Optional[_Node]:
        if node_id.namespace != NAMESPACE or not isinstance(
                node_id.identifier, str):
            return None
        return self._nodes.get(node_id.identifier)

    def _read_value(self, node: _Node, now: int) -> DataValue:
        try:
            if node.kind == RegisterType.INPUT_REGISTER:
                v = self.slave.read_input_register(node.register,
                                                   unit=node.unit)
                var = Variant(VT_DOUBLE, float(v))
            elif node.kind == RegisterType.HOLDING_REGISTER:
                v = self.slave.read_holding_register(node.register,
                                                     unit=node.unit)
                var = Variant(VT_DOUBLE, float(v))
            elif node.kind == RegisterType.COIL:
                var = Variant(VT_BOOLEAN, bool(
                    self.slave.read_coil(node.register, unit=node.unit)))
            else:
                var = Variant(VT_BOOLEAN, bool(
                    self.slave.read_discrete_input(node.register,
                                                   unit=node.unit)))
        except Exception:   # noqa: BLE001 — map store errors to a status
            return DataValue(status=M.BAD_INTERNAL_ERROR,
                             source_timestamp=now)
        return DataValue(value=var, source_timestamp=now,
                         server_timestamp=now)

    def _read_attribute(self, rv: M.ReadValueId, now: int) -> DataValue:
        nid = rv.node_id
        # Folder nodes: Objects folder and unit folders
        if nid == M.OBJECTS_FOLDER or (
                nid.namespace == NAMESPACE
                and isinstance(nid.identifier, str)
                and nid.identifier in self._children):
            return self._read_folder_attribute(nid, rv.attribute_id, now)
        if (nid.namespace == NAMESPACE and isinstance(nid.identifier, str)
                and nid.identifier in self._properties):
            return self._read_property_attribute(nid, rv.attribute_id,
                                                 now)
        node = self._lookup(nid)
        if node is None:
            return DataValue(status=M.BAD_NODE_ID_UNKNOWN)
        a = rv.attribute_id
        if a == M.ATTR_VALUE:
            return self._read_value(node, now)
        if a == M.ATTR_NODE_ID:
            var = Variant(17, nid)
        elif a == M.ATTR_NODE_CLASS:
            var = Variant(6, M.NODECLASS_VARIABLE)
        elif a == M.ATTR_BROWSE_NAME:
            var = Variant(20, QualifiedName(NAMESPACE, node.register))
        elif a == M.ATTR_DISPLAY_NAME:
            var = Variant(21, LocalizedText(node.register, "en"))
        elif a == M.ATTR_DESCRIPTION:
            text = node.description
            if node.units:
                text += f" [{node.units}]"
            var = Variant(21, LocalizedText(text, "en"))
        elif a == M.ATTR_DATA_TYPE:
            var = Variant(17, M.DT_BOOLEAN if node.is_boolean
                          else M.DT_DOUBLE)
        elif a == M.ATTR_VALUE_RANK:
            var = Variant(6, -1)   # scalar
        elif a in (M.ATTR_ACCESS_LEVEL, M.ATTR_USER_ACCESS_LEVEL):
            var = Variant(3, 0x03 if node.writable else 0x01)
        else:
            return DataValue(status=M.BAD_ATTRIBUTE_ID_INVALID)
        return DataValue(value=var, source_timestamp=now)

    def _read_property_attribute(self, nid: NodeId, attr: int,
                                 now: int) -> DataValue:
        """EURange property node (Part 8 section 5.6.3.3): Value is a
        Range structure — ExtensionObject with the Range default-binary
        encoding (two doubles, low then high)."""
        low, high = self._properties[nid.identifier]
        if attr == M.ATTR_VALUE:
            body = Encoder().double(float(low)).double(float(high)).data()
            var = Variant(VT_EXTENSIONOBJECT, ExtensionObject(
                NodeId(0, M.ID_RANGE_BINARY), body))
            return DataValue(value=var, source_timestamp=now,
                             server_timestamp=now)
        if attr == M.ATTR_NODE_ID:
            var = Variant(17, nid)
        elif attr == M.ATTR_NODE_CLASS:
            var = Variant(6, M.NODECLASS_VARIABLE)
        elif attr == M.ATTR_BROWSE_NAME:
            var = Variant(20, QualifiedName(0, "EURange"))
        elif attr == M.ATTR_DISPLAY_NAME:
            var = Variant(21, LocalizedText("EURange", "en"))
        elif attr == M.ATTR_DATA_TYPE:
            var = Variant(17, M.DT_RANGE)
        elif attr == M.ATTR_VALUE_RANK:
            var = Variant(6, -1)
        elif attr in (M.ATTR_ACCESS_LEVEL, M.ATTR_USER_ACCESS_LEVEL):
            var = Variant(3, 0x01)         # read-only
        else:
            return DataValue(status=M.BAD_ATTRIBUTE_ID_INVALID)
        return DataValue(value=var, source_timestamp=now)

    def _read_folder_attribute(self, nid: NodeId, attr: int,
                               now: int) -> DataValue:
        name = ("Objects" if nid == M.OBJECTS_FOLDER
                else f"Unit{nid.identifier[1:]}")
        if attr == M.ATTR_NODE_ID:
            var = Variant(17, nid)
        elif attr == M.ATTR_NODE_CLASS:
            var = Variant(6, M.NODECLASS_OBJECT)
        elif attr == M.ATTR_BROWSE_NAME:
            ns = 0 if nid == M.OBJECTS_FOLDER else NAMESPACE
            var = Variant(20, QualifiedName(ns, name))
        elif attr == M.ATTR_DISPLAY_NAME:
            var = Variant(21, LocalizedText(name, "en"))
        else:
            return DataValue(status=M.BAD_ATTRIBUTE_ID_INVALID)
        return DataValue(value=var, source_timestamp=now)

    def _write_attribute(self, wv: M.WriteValue) -> int:
        if wv.attribute_id != M.ATTR_VALUE:
            return M.BAD_ATTRIBUTE_ID_INVALID
        node = self._lookup(wv.node_id)
        if node is None:
            return M.BAD_NODE_ID_UNKNOWN
        if not node.writable:
            return M.BAD_NOT_WRITABLE
        var = wv.value.value
        if var is None or var.is_array:
            return M.BAD_TYPE_MISMATCH   # scalar-only address space
        try:
            if node.kind == RegisterType.COIL:
                if var.type_id != VT_BOOLEAN:
                    return M.BAD_TYPE_MISMATCH
                self.slave.write_coil(node.register, bool(var.value),
                                      unit=node.unit)
            else:
                if var.type_id not in (VT_DOUBLE, 10, 6, 7):
                    return M.BAD_TYPE_MISMATCH
                self.slave.write_holding_register(
                    node.register, float(var.value), unit=node.unit)
        except ValueError:
            return M.BAD_OUT_OF_RANGE
        except Exception:   # noqa: BLE001
            return M.BAD_INTERNAL_ERROR
        return M.GOOD

    def _translate_path(self, path: "M.BrowsePath") -> "M.BrowsePathResult":
        """Walk hierarchical forward references by browse name —
        discovery stacks resolve 'Objects/Unit1/pH_outlet' to a node id
        this way instead of browsing level by level."""
        if not path.elements:
            return M.BrowsePathResult(status=M.BAD_NOTHING_TO_DO)
        current = path.starting_node
        for el in path.elements:
            if el.is_inverse or el.target_name.name is None:
                return M.BrowsePathResult(status=M.BAD_NO_MATCH)
            name = el.target_name.name
            nxt: Optional[NodeId] = None
            if current == M.ROOT_FOLDER:
                if el.target_name.namespace == 0 and name == "Objects":
                    nxt = M.OBJECTS_FOLDER
            elif current == M.OBJECTS_FOLDER:
                for folder in self._children:
                    if (el.target_name.namespace == NAMESPACE
                            and name == f"Unit{folder[1:]}"):
                        nxt = NodeId(NAMESPACE, folder)
                        break
            elif (current.namespace == NAMESPACE
                  and isinstance(current.identifier, str)
                  and current.identifier in self._children):
                sid = f"{current.identifier}.{name}"
                if (el.target_name.namespace == NAMESPACE
                        and sid in self._nodes):
                    nxt = NodeId(NAMESPACE, sid)
            if nxt is None:
                return M.BrowsePathResult(status=M.BAD_NO_MATCH)
            current = nxt
        return M.BrowsePathResult(
            targets=[M.BrowsePathTarget(target_id=current)])

    def _browse_node(self, b: M.BrowseDescription,
                     max_references: int = 0) -> M.BrowseResult:
        refs = []
        if b.node_id == M.ROOT_FOLDER:
            refs.append(M.ReferenceDescription(
                node_id=M.OBJECTS_FOLDER,
                browse_name=QualifiedName(0, "Objects"),
                display_name=LocalizedText("Objects", "en"),
                node_class=M.NODECLASS_OBJECT,
                type_definition=M.TYPE_FOLDER))
        elif b.node_id == M.OBJECTS_FOLDER:
            for folder in self._children:
                refs.append(M.ReferenceDescription(
                    node_id=NodeId(NAMESPACE, folder),
                    browse_name=QualifiedName(
                        NAMESPACE, f"Unit{folder[1:]}"),
                    display_name=LocalizedText(f"Unit{folder[1:]}", "en"),
                    node_class=M.NODECLASS_OBJECT,
                    type_definition=M.TYPE_FOLDER))
        elif (b.node_id.namespace == NAMESPACE
              and isinstance(b.node_id.identifier, str)
              and b.node_id.identifier in self._children):
            for sid in self._children[b.node_id.identifier]:
                node = self._nodes[sid]
                refs.append(M.ReferenceDescription(
                    node_id=NodeId(NAMESPACE, sid),
                    browse_name=QualifiedName(NAMESPACE, node.register),
                    display_name=LocalizedText(node.register, "en"),
                    node_class=M.NODECLASS_VARIABLE,
                    type_definition=M.TYPE_BASE_DATA_VARIABLE))
        elif self._lookup(b.node_id) is not None:
            # variables' only forward reference is the EURange property
            prop_sid = f"{b.node_id.identifier}.EURange"
            if prop_sid in self._properties:
                refs.append(M.ReferenceDescription(
                    node_id=NodeId(NAMESPACE, prop_sid),
                    browse_name=QualifiedName(0, "EURange"),
                    display_name=LocalizedText("EURange", "en"),
                    node_class=M.NODECLASS_VARIABLE,
                    type_definition=M.TYPE_PROPERTY))
        elif (b.node_id.namespace == NAMESPACE
              and isinstance(b.node_id.identifier, str)
              and b.node_id.identifier in self._properties):
            pass   # properties are leaves
        else:
            return M.BrowseResult(status=M.BAD_NODE_ID_UNKNOWN)
        if max_references:
            refs = refs[:max_references]
        return M.BrowseResult(references=refs)


class _MonitoredItem:
    """One sampled attribute inside a subscription."""

    def __init__(self, item_id: int, rv, client_handle: int, mode: int,
                 queue_size: int, discard_oldest: bool,
                 deadband: Optional[float] = None) -> None:
        self.id = item_id
        self.rv = rv                     # M.ReadValueId
        self.client_handle = client_handle
        self.mode = mode                 # 0 disabled / 1 sampling / 2 reporting
        self.queue_size = queue_size
        self.discard_oldest = discard_oldest
        self.deadband = deadband         # absolute DataChangeFilter band
        self.last: Optional[tuple] = None   # change-detection key
        self.last_num: Optional[float] = None  # last REPORTED numeric value
        self.queue: List[M.MonitoredItemNotification] = []


class _Subscription:
    """Server-side subscription: items, sequencing, retransmission."""

    MAX_RETRANSMIT = 8

    def __init__(self, sub_id: int, interval_s: float, lifetime: int,
                 keepalive: int, max_notifications: int, enabled: bool,
                 priority: int) -> None:
        self.id = sub_id
        self.interval_s = interval_s
        self.lifetime_count = lifetime
        self.keepalive_count = keepalive
        self.max_notifications = max_notifications   # 0 = unlimited
        self.enabled = enabled
        self.priority = priority
        self.items: Dict[int, _MonitoredItem] = {}
        self._next_item = 1
        self.next_seq = 1
        self.retransmit: Dict[int, M.NotificationMessage] = {}
        self.next_sample = 0.0        # monotonic deadline
        self.keepalive_elapsed = 0    # intervals since last send
        self.lifetime_elapsed = 0     # intervals without a Publish queued

    def new_item_id(self) -> int:
        i = self._next_item
        self._next_item += 1
        return i

    def has_pending(self) -> bool:
        return any(i.queue for i in self.items.values())


class _ClientState:
    """Per-connection transport/session state."""

    MAX_SUBSCRIPTIONS = 16
    MAX_PUBLISH_QUEUE = 10
    MAX_ITEMS_PER_SUBSCRIPTION = 512

    def __init__(self) -> None:
        self.said_hello = False
        self.closed = False
        self.channel_id = 0
        self.token_id = 0
        self.session_id: Optional[NodeId] = None
        self.auth_token: Optional[NodeId] = None
        self.activated = False
        # Subscription machinery (one sampler task per connection,
        # started lazily on the first CreateSubscription)
        self.subscriptions: Dict[int, _Subscription] = {}
        # queued PublishRequests: (SequenceHeader, request_handle,
        # ack_statuses)
        self.publish_queue: deque = deque()
        # Wakes the publisher task early when new work arrives (a queued
        # PublishRequest, a created/deleted subscription) — the loop
        # otherwise sleeps precisely until the earliest sample is due,
        # instead of polling on a short cap. At 1000 sessions the old
        # 0.25 s poll cap cost ~4000 loop wakeups/s of pure overhead.
        self.wake = asyncio.Event()
        self.writer: Optional[asyncio.StreamWriter] = None
        self.wlock: Optional[asyncio.Lock] = None
        self.publisher_task: Optional[asyncio.Task] = None
        self.out_seq = 0                       # server->client sequence
        self.max_out_frame = 16 * 1024 * 1024  # peer receive buffer
