"""
Modbus/TCP server — from-scratch asyncio implementation.

The reference delegates the wire protocol to pymodbus 3.x
(modbus/slave.py:320-339); that dependency is not available here, so this
module implements the Modbus/TCP application protocol directly (MBAP framing
+ function codes 1/2/3/4/5/6/8/15/16/22/23 and 43/14 with standard
exception responses). The
server lifecycle and the thread-safe, name-based register API match the
reference exactly:

- asyncio event loop in a daemon thread (reference slave.py:266-295)
- threading.Event-based startup/shutdown with timeouts (slave.py:255-278,
  341-372)
- sequential data blocks sized from the register map plus headroom
  (slave.py:113-137)
- RLock-guarded ``update_input_register`` / ``update_discrete_input`` /
  ``read_holding_register`` / ``write_holding_register`` / ``read_coil``
  with the +-1e9 range validation (slave.py:139-245)
"""

from __future__ import annotations

import asyncio
import logging
import struct
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from ics_wt_physicsengine_torch.modbus.protocols import (
    ModbusDecoder,
    ModbusEncoder,
)
from ics_wt_physicsengine_torch.modbus.register_map import (
    ModbusRegisterMap,
    RegisterType,
)
from ics_wt_physicsengine_torch.modbus.security import (
    ModbusTLSConfig,
    extract_role,
    make_server_ssl_context,
    pdu_requires_write,
)

logger = logging.getLogger(__name__)

# Modbus function codes
FC_READ_COILS = 0x01
FC_READ_DISCRETE_INPUTS = 0x02
FC_READ_HOLDING_REGISTERS = 0x03
FC_READ_INPUT_REGISTERS = 0x04
FC_WRITE_SINGLE_COIL = 0x05
FC_WRITE_SINGLE_REGISTER = 0x06
FC_WRITE_MULTIPLE_COILS = 0x0F
FC_WRITE_MULTIPLE_REGISTERS = 0x10
FC_MASK_WRITE_REGISTER = 0x16      # Mask Write Register (FC 22)
FC_READ_WRITE_MULTIPLE = 0x17      # Read/Write Multiple Registers (FC 23)
FC_DIAGNOSTICS = 0x08              # diagnostics sub-functions (FC 08)
FC_ENCAPSULATED_INTERFACE = 0x2B   # MEI transport (FC 43)

# FC 08 sub-functions (Modbus spec 6.8) — the reference's one explicitly
# listed protocol limitation is "No diagnostics counters (bad CRCs,
# timeouts)" (reference README.md:537); both data planes here keep the
# standard counters and serve them over the wire.
DIAG_RETURN_QUERY_DATA = 0x0000
DIAG_CLEAR_COUNTERS = 0x000A
DIAG_BUS_MESSAGE_COUNT = 0x000B
DIAG_BUS_COMM_ERROR_COUNT = 0x000C
DIAG_BUS_EXCEPTION_COUNT = 0x000D
DIAG_SLAVE_MESSAGE_COUNT = 0x000E
DIAG_SLAVE_NO_RESPONSE_COUNT = 0x000F
MEI_READ_DEVICE_ID = 0x0E          # Read Device Identification

EX_ILLEGAL_FUNCTION = 0x01
EX_ILLEGAL_DATA_ADDRESS = 0x02
EX_ILLEGAL_DATA_VALUE = 0x03

# Read Device Identification object ids (Modbus spec 6.21)
DEVICE_ID_OBJECTS = {
    0x00: "VendorName",
    0x01: "ProductCode",
    0x02: "MajorMinorRevision",
    0x04: "ProductName",
    0x05: "ModelName",
}
_BASIC_OBJECTS = (0x00, 0x01, 0x02)

MAX_REGISTER_VALUE = 1e9   # reference slave.py range validation (:205-214)


@dataclass
class ModbusServerConfig:
    """Server configuration (reference slave.py:33-51)."""

    host: str = "0.0.0.0"
    port: int = 5020
    unit_id: int = 1
    # Live-connection cap, enforced by the Python server (excess masters
    # are closed on connect). The C++ data plane has its own compile-time
    # cap of 64 (native/modbus_server.cpp kMaxClients).
    max_connections: int = 32
    timeout_seconds: float = 5.0
    # Idle disconnect: a connection holding a cap slot without sending a
    # request for this long is dropped (slow-loris defense — without it,
    # max_connections half-open sockets would lock legitimate masters out
    # forever). Generous vs any real SCADA poll interval.
    idle_timeout_seconds: float = 300.0
    # Modbus/TCP Security (MB-TCP-Security-v21): when set, the server
    # speaks TLS with mandatory client certificates and role-based
    # write authorization (modbus/security.py). Closes the reference's
    # "No authentication or encryption" limitation (README.md:536).
    tls: Optional["ModbusTLSConfig"] = None


class _DataBlock:
    """Thread-safe word/bit storage (replaces pymodbus datastore)."""

    def __init__(self, size: int):
        self.size = size
        self.values = [0] * size
        self.lock = threading.RLock()

    def get(self, address: int, count: int) -> List[int]:
        if address < 0 or address + count > self.size:
            raise IndexError(f"address range [{address}, {address + count}) "
                             f"outside block of {self.size}")
        with self.lock:
            return self.values[address:address + count]

    def set(self, address: int, values: List[int]) -> None:
        if address < 0 or address + len(values) > self.size:
            raise IndexError(f"address range [{address}, "
                             f"{address + len(values)}) outside block of "
                             f"{self.size}")
        with self.lock:
            self.values[address:address + len(values)] = values


class _UnitStore:
    """One Modbus unit's four data blocks (one simulated plant)."""

    def __init__(self, register_map: ModbusRegisterMap):
        # Data blocks sized from the map + headroom (slave.py:113-137)
        def block_size(regs):
            if not regs:
                return 16
            return max(r.address + r.size_words for r in regs) + 10

        self.ir = _DataBlock(block_size(register_map.input_registers))
        self.hr = _DataBlock(block_size(register_map.holding_registers))
        self.coil = _DataBlock(block_size(register_map.coils))
        self.di = _DataBlock(block_size(register_map.discrete_inputs))


class ModbusSlave:
    """Modbus/TCP slave with the reference's API (slave.py:54-397).

    Extension beyond the reference: ``units`` serves several Modbus unit
    ids from one endpoint, each with its own register space — the standard
    Modbus/TCP gateway multiplexing, for a fleet of plants served from one
    endpoint (unit id ``u`` for plant ``u-1``); the reference serves
    exactly one plant on one unit id."""

    def __init__(self, register_map: ModbusRegisterMap,
                 config: Optional[ModbusServerConfig] = None,
                 units: Optional[List[int]] = None):
        self.register_map = register_map
        self.config = config or ModbusServerConfig()

        # Device identification strings (reference slave.py:89-95)
        self.device_info = {
            "VendorName": "ICS-WT-PhysicsEngine-TPU",
            "ProductCode": "WTS-CUDA",
            "ProductName": "Water Treatment Simulator (PyTorch/CUDA)",
            "ModelName": "CSTR-MultiZone",
            "MajorMinorRevision": "1.0",
        }

        ids = tuple(units) if units else (self.config.unit_id,)
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate unit ids: {ids}")
        if not all(0 <= u <= 0xFE for u in ids):
            raise ValueError(f"unit ids must be in [0, 254]: {ids}")
        self.units = ids
        self._primary = (self.config.unit_id
                         if self.config.unit_id in ids else ids[0])
        self._stores: Dict[int, _UnitStore] = {
            u: _UnitStore(register_map) for u in ids}

        self._lock = threading.RLock()
        self._server_ready = threading.Event()
        self._shutdown_requested = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._actual_port: Optional[int] = None

        self.request_count = 0          # bus messages seen
        self.error_count = 0            # broken framing / handler errors
        self.exception_count = 0        # exception responses returned
        self.slave_message_count = 0    # frames addressed to a served unit
        self.no_response_count = 0      # other units' traffic (ignored)
        self.unauthorized_count = 0     # TLS role-gate rejections
        self._n_clients = 0   # live connections (event-loop thread only)
        # Idle/slow-reader enforcement: handlers stamp their activity
        # cell on completed frames; _async_run_server sweeps
        # (utils/netreap.py — shared with the OPC UA plane)
        from ics_wt_physicsengine_torch.utils.netreap import IdleReaper
        self._reaper = IdleReaper(
            self.config.idle_timeout_seconds,
            log=lambda m: logger.debug("Modbus: %s", m))

    # Backward-compatible single-unit block views (the primary unit's).
    @property
    def ir_block(self) -> _DataBlock:
        return self._stores[self._primary].ir

    @property
    def hr_block(self) -> _DataBlock:
        return self._stores[self._primary].hr

    @property
    def coil_block(self) -> _DataBlock:
        return self._stores[self._primary].coil

    @property
    def di_block(self) -> _DataBlock:
        return self._stores[self._primary].di

    def _store(self, unit: Optional[int]) -> _UnitStore:
        if unit is None:
            return self._stores[self._primary]
        try:
            return self._stores[unit]
        except KeyError:
            raise KeyError(f"not serving unit id {unit} "
                           f"(units: {self.units})") from None

    # ------------------------------------------------------------------
    # Wire protocol
    # ------------------------------------------------------------------

    def _process_pdu(self, pdu: bytes,
                     store: Optional[_UnitStore] = None) -> bytes:
        """Handle one request PDU against one unit's store, return the
        response PDU."""
        if store is None:
            store = self._stores[self._primary]
        if not pdu:
            # Empty PDU (MBAP length = 1): answer with a generic exception
            # rather than dropping the connection.
            return bytes([0x80, EX_ILLEGAL_DATA_VALUE])
        fc = pdu[0]
        try:
            if fc in (FC_READ_COILS, FC_READ_DISCRETE_INPUTS):
                address, count = struct.unpack(">HH", pdu[1:5])
                if not 1 <= count <= 2000:
                    return bytes([fc | 0x80, EX_ILLEGAL_DATA_VALUE])
                block = (store.coil if fc == FC_READ_COILS
                         else store.di)
                bits = block.get(address, count)
                n_bytes = (count + 7) // 8
                payload = bytearray(n_bytes)
                for i, bit in enumerate(bits):
                    if bit:
                        payload[i // 8] |= 1 << (i % 8)
                return bytes([fc, n_bytes]) + bytes(payload)

            if fc in (FC_READ_HOLDING_REGISTERS, FC_READ_INPUT_REGISTERS):
                address, count = struct.unpack(">HH", pdu[1:5])
                if not 1 <= count <= 125:
                    return bytes([fc | 0x80, EX_ILLEGAL_DATA_VALUE])
                block = (store.hr if fc == FC_READ_HOLDING_REGISTERS
                         else store.ir)
                words = block.get(address, count)
                return bytes([fc, count * 2]) + b"".join(
                    struct.pack(">H", w & 0xFFFF) for w in words)

            if fc == FC_WRITE_SINGLE_COIL:
                address, value = struct.unpack(">HH", pdu[1:5])
                if value not in (0x0000, 0xFF00):
                    return bytes([fc | 0x80, EX_ILLEGAL_DATA_VALUE])
                store.coil.set(address, [1 if value else 0])
                return pdu[:5]

            if fc == FC_WRITE_SINGLE_REGISTER:
                address, value = struct.unpack(">HH", pdu[1:5])
                store.hr.set(address, [value])
                return pdu[:5]

            if fc == FC_WRITE_MULTIPLE_COILS:
                address, count, n_bytes = struct.unpack(">HHB", pdu[1:6])
                # Spec validation (same checks as the C++ server): count in
                # [1, 0x07B0] and byte count consistent with the coil count.
                if not 1 <= count <= 0x07B0 or n_bytes != (count + 7) // 8:
                    return bytes([fc | 0x80, EX_ILLEGAL_DATA_VALUE])
                data = pdu[6:6 + n_bytes]
                if len(data) != n_bytes:
                    return bytes([fc | 0x80, EX_ILLEGAL_DATA_VALUE])
                bits = [(data[i // 8] >> (i % 8)) & 1 for i in range(count)]
                store.coil.set(address, bits)
                return pdu[:5]

            if fc == FC_WRITE_MULTIPLE_REGISTERS:
                address, count, n_bytes = struct.unpack(">HHB", pdu[1:6])
                if not 1 <= count <= 123 or n_bytes != count * 2:
                    return bytes([fc | 0x80, EX_ILLEGAL_DATA_VALUE])
                words = list(struct.unpack(f">{count}H", pdu[6:6 + n_bytes]))
                store.hr.set(address, words)
                return pdu[:5]

            if fc == FC_MASK_WRITE_REGISTER:
                # Modbus spec 6.16: reg = (current AND and_mask) OR
                # (or_mask AND NOT and_mask); response echoes the request.
                address, and_mask, or_mask = struct.unpack(">HHH",
                                                           pdu[1:7])
                current = store.hr.get(address, 1)[0]
                store.hr.set(address, [
                    (current & and_mask) | (or_mask & ~and_mask & 0xFFFF)])
                return pdu[:7]

            if fc == FC_READ_WRITE_MULTIPLE:
                # Modbus spec 6.17: the WRITE executes first, then the
                # read; response is FC3-shaped over the read range.
                (r_addr, r_count, w_addr, w_count,
                 n_bytes) = struct.unpack(">HHHHB", pdu[1:10])
                if (not 1 <= r_count <= 125 or not 1 <= w_count <= 121
                        or n_bytes != w_count * 2):
                    return bytes([fc | 0x80, EX_ILLEGAL_DATA_VALUE])
                words = list(struct.unpack(f">{w_count}H",
                                           pdu[10:10 + n_bytes]))
                store.hr.set(w_addr, words)
                out = store.hr.get(r_addr, r_count)
                return bytes([fc, r_count * 2]) + b"".join(
                    struct.pack(">H", w & 0xFFFF) for w in out)

            if fc == FC_DIAGNOSTICS:
                return self._process_diagnostics(pdu)

            if fc == FC_ENCAPSULATED_INTERFACE:
                return self._process_read_device_id(pdu)

            return bytes([fc | 0x80, EX_ILLEGAL_FUNCTION])
        except IndexError:
            return bytes([fc | 0x80, EX_ILLEGAL_DATA_ADDRESS])
        except (struct.error, ValueError):
            return bytes([fc | 0x80, EX_ILLEGAL_DATA_VALUE])

    def _process_diagnostics(self, pdu: bytes) -> bytes:
        """FC 08 Diagnostics: echo, clear, and the standard counter
        sub-functions 0x0B-0x0F (bus messages / comm errors / exceptions /
        slave messages / no-response). Fills the reference's own 'No
        diagnostics counters' gap (reference README.md:537) on the wire."""
        fc = pdu[0]
        sub, _data = struct.unpack(">HH", pdu[1:5])
        if sub == DIAG_RETURN_QUERY_DATA:
            return pdu[:5]
        if sub == DIAG_CLEAR_COUNTERS:
            self.request_count = 0
            self.error_count = 0
            self.exception_count = 0
            self.slave_message_count = 0
            self.no_response_count = 0
            return pdu[:5]
        counters = {
            DIAG_BUS_MESSAGE_COUNT: self.request_count,
            DIAG_BUS_COMM_ERROR_COUNT: self.error_count,
            DIAG_BUS_EXCEPTION_COUNT: self.exception_count,
            DIAG_SLAVE_MESSAGE_COUNT: self.slave_message_count,
            DIAG_SLAVE_NO_RESPONSE_COUNT: self.no_response_count,
        }
        if sub in counters:
            return bytes([fc]) + struct.pack(">HH", sub,
                                             counters[sub] & 0xFFFF)
        return bytes([fc | 0x80, EX_ILLEGAL_FUNCTION])

    def diagnostics(self) -> dict:
        """The FC 08 counters as a dict (same keys as the native plane's
        NativeModbusSlave.diagnostics)."""
        out = {"bus_message_count": self.request_count,
               "bus_comm_error_count": self.error_count,
               "bus_exception_count": self.exception_count,
               "slave_message_count": self.slave_message_count,
               "slave_no_response_count": self.no_response_count}
        if self.config.tls is not None:
            out["unauthorized_count"] = self.unauthorized_count
        return out

    def _process_read_device_id(self, pdu: bytes) -> bytes:
        """FC 43 / MEI type 14: Read Device Identification, serving
        ``device_info`` (reference slave.py:89-95 publishes the same strings
        via pymodbus's ModbusDeviceIdentification)."""
        fc = pdu[0]
        if len(pdu) < 4 or pdu[1] != MEI_READ_DEVICE_ID:
            return bytes([fc | 0x80, EX_ILLEGAL_FUNCTION])
        read_code, object_id = pdu[2], pdu[3]

        if read_code == 0x01:      # basic: objects 0x00-0x02
            ids = [i for i in _BASIC_OBJECTS if i >= object_id] \
                or list(_BASIC_OBJECTS)
        elif read_code in (0x02, 0x03):   # regular / extended: all we have
            ids = [i for i in sorted(DEVICE_ID_OBJECTS) if i >= object_id] \
                or sorted(DEVICE_ID_OBJECTS)
        elif read_code == 0x04:    # specific object
            if object_id not in DEVICE_ID_OBJECTS:
                return bytes([fc | 0x80, EX_ILLEGAL_DATA_ADDRESS])
            ids = [object_id]
        else:
            return bytes([fc | 0x80, EX_ILLEGAL_DATA_VALUE])

        # conformity 0x82: regular identification, both stream and
        # individual access; single response (no MoreFollows continuation —
        # the full object list is far below the 253-byte PDU limit).
        out = bytearray([fc, MEI_READ_DEVICE_ID, read_code, 0x82,
                         0x00, 0x00, len(ids)])
        for i in ids:
            value = self.device_info[DEVICE_ID_OBJECTS[i]].encode("ascii")
            out += bytes([i, len(value)]) + value
        return bytes(out)

    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        # Connection cap (config.max_connections): excess masters are
        # closed immediately rather than queued, so a connection flood
        # cannot accumulate server-side state. Single-threaded event loop,
        # so a plain counter is race-free.
        if self._n_clients >= self.config.max_connections:
            logger.warning("Rejecting Modbus client %s: %d connections "
                           "already active (max_connections=%d)", peer,
                           self._n_clients, self.config.max_connections)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            return
        self._n_clients += 1
        logger.debug("Modbus client connected: %s", peer)
        # Modbus/TCP Security role gate: mTLS already succeeded (the
        # listener's SSL context requires and verifies the client cert),
        # so authorization is purely the RoleOID → permission mapping.
        allow_write = True
        if self.config.tls is not None:
            ssl_obj = writer.get_extra_info("ssl_object")
            role = extract_role(
                ssl_obj.getpeercert(binary_form=True)
                if ssl_obj is not None else None)
            permission = self.config.tls.resolve_permission(role)
            if permission == "deny":
                self.unauthorized_count += 1
                logger.warning("Denying Modbus client %s: role %r maps "
                               "to 'deny'", peer, role)
                self._n_clients -= 1
                writer.close()
                try:
                    await writer.wait_closed()
                except Exception:  # noqa: BLE001
                    pass
                return
            allow_write = permission == "rw"
            logger.debug("Modbus TLS client %s authenticated: role=%r "
                         "permission=%s", peer, role, permission)
        # Idle/slow-reader enforcement is a REAPER SWEEP, not per-read
        # asyncio.wait_for (profiled at ~35% of the event loop's
        # non-epoll CPU at 3 awaits per request) — see utils/netreap.py.
        loop = asyncio.get_running_loop()
        activity = self._reaper.register(writer, loop.time())
        # Buffered framing: one read() per socket readiness, ALL complete
        # frames in the buffer parsed (offset-walked — no per-frame tail
        # copies) and answered with a single write+drain — pipelining
        # masters get batched responses, and the common case costs one
        # await per request instead of two readexactly (header + body).
        buf = b""
        malformed = False
        try:
            while not self._shutdown_requested.is_set():
                chunk = await reader.read(65536)
                if not chunk:
                    break
                # NOTE: no activity stamp here — the stamp happens only
                # on COMPLETED frames below, so a drip-feeding peer that
                # never finishes a frame (slow-loris) still looks idle
                # to the reaper and loses its slot within idle_timeout.
                buf += chunk
                responses = []
                off = 0
                while len(buf) - off >= 7:
                    (transaction_id, protocol_id, length,
                     unit_id) = struct.unpack_from(">HHHB", buf, off)
                    # MBAP length counts unit id + PDU: valid range
                    # [2, 254]. length == 1 is an answerable empty PDU;
                    # anything else outside the range breaks framing —
                    # drop the connection.
                    if not 1 <= length <= 254:
                        logger.warning("Malformed MBAP length %d from %s",
                                       length, peer)
                        self.error_count += 1
                        malformed = True
                        break
                    if len(buf) - off < 6 + length:
                        break              # incomplete frame: read more
                    pdu = buf[off + 7:off + 6 + length]
                    off += 6 + length
                    activity[0] = loop.time()   # real protocol progress
                    self.request_count += 1
                    # A slave only answers frames addressed to a unit it
                    # serves (or the broadcast unit 0xFF conventionally
                    # used over TCP, which maps to the primary unit).
                    if unit_id == 0xFF:
                        store = self._stores[self._primary]
                    elif unit_id in self._stores:
                        store = self._stores[unit_id]
                    else:
                        logger.debug("Ignoring request for unit %d "
                                     "(serving %s)", unit_id, self.units)
                        self.no_response_count += 1
                        continue
                    self.slave_message_count += 1
                    if not allow_write and pdu_requires_write(pdu):
                        # read-only role: refuse the write, keep serving
                        self.unauthorized_count += 1
                        response_pdu = bytes([pdu[0] | 0x80,
                                              EX_ILLEGAL_FUNCTION])
                    else:
                        response_pdu = self._process_pdu(pdu, store)
                    if response_pdu and response_pdu[0] & 0x80:
                        self.exception_count += 1
                    responses.append(struct.pack(
                        ">HHHB", transaction_id, protocol_id,
                        len(response_pdu) + 1, unit_id) + response_pdu)
                buf = buf[off:] if off else buf
                if responses:
                    writer.write(b"".join(responses))
                    # A client that sends requests but never reads
                    # responses parks this handler in drain() once the
                    # socket buffer fills — its activity cell then stops
                    # advancing and the reaper aborts the transport (the
                    # C++ plane drops slow readers via kMaxOutBuffer;
                    # this is the asyncio equivalent, at sweep
                    # granularity).
                    await writer.drain()
                    activity[0] = loop.time()
                if malformed:
                    break
                if len(buf) > 16 * 1024:
                    # a peer streaming bytes that never form a complete
                    # frame (max frame = 260 B) is framing-broken or
                    # hostile — don't buffer it without bound
                    logger.warning("Unframeable byte stream from %s", peer)
                    self.error_count += 1
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError,
                ConnectionAbortedError):
            pass
        except Exception as exc:  # noqa: BLE001 — log type only, like ref
            self.error_count += 1
            logger.warning("Modbus client error: %s", type(exc).__name__)
        finally:
            self._reaper.pop(writer)
            self._n_clients -= 1
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            logger.debug("Modbus client disconnected: %s", peer)

    async def _async_run_server(self):
        """Serve until shutdown (reference slave.py:320-339 lifecycle)."""
        ssl_ctx = (make_server_ssl_context(self.config.tls)
                   if self.config.tls is not None else None)
        self._server = await asyncio.start_server(
            self._handle_client, self.config.host, self.config.port,
            ssl=ssl_ctx,
            ssl_handshake_timeout=10.0 if ssl_ctx is not None else None)
        self._actual_port = self._server.sockets[0].getsockname()[1]
        self._server_ready.set()
        try:
            loop = asyncio.get_running_loop()
            while not self._shutdown_requested.is_set():
                await asyncio.sleep(0.1)
                # Idle/slow-reader reaper (see _handle_client and
                # utils/netreap.py): one O(n_connections) sweep per
                # idle/4 replaces 3 timer pairs per request.
                self._reaper.maybe_sweep(loop.time())
        finally:
            self._server.close()
            # wait_closed() (3.12+) also waits for in-flight client
            # handlers, which may sit in readexactly() for up to
            # idle_timeout_seconds — cancel them so stop()'s 3 s join
            # succeeds and the port is released promptly for rebinds.
            pending = [t for t in asyncio.all_tasks()
                       if t is not asyncio.current_task()]
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
            await self._server.wait_closed()

    def _run_server(self):
        """Daemon-thread entry: own event loop (reference slave.py:287-295)."""
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._async_run_server())
        except Exception as exc:  # noqa: BLE001
            logger.error("Modbus server error: %s", type(exc).__name__)
            self._server_ready.set()   # unblock start() so it can raise
        finally:
            self._loop.close()
            self._stopped.set()

    # ------------------------------------------------------------------
    # Lifecycle (reference slave.py:247-372)
    # ------------------------------------------------------------------

    def start(self, blocking: bool = False) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("Server already running")
        self._shutdown_requested.clear()
        self._server_ready.clear()
        self._stopped.clear()
        self._thread = threading.Thread(target=self._run_server,
                                        name="ModbusTCPServer", daemon=True)
        self._thread.start()
        if not self._server_ready.wait(timeout=self.config.timeout_seconds):
            raise RuntimeError(
                f"Modbus server failed to start within "
                f"{self.config.timeout_seconds}s")
        if self._actual_port is None:
            raise RuntimeError("Modbus server failed to bind")
        logger.info("Modbus TCP server listening on %s:%d",
                    self.config.host, self._actual_port)
        if blocking:
            try:
                self._thread.join()
            except KeyboardInterrupt:
                self.stop()

    def stop(self) -> None:
        self._shutdown_requested.set()
        if self._thread is not None:
            self._thread.join(timeout=3.0)
            if self._thread.is_alive():
                logger.warning("Modbus server thread did not stop cleanly")
        self._thread = None

    @property
    def port(self) -> Optional[int]:
        """Actual bound port (useful with port=0 for tests)."""
        return self._actual_port

    @property
    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------------
    # Name-based register API (reference slave.py:139-245)
    # ------------------------------------------------------------------

    def _lookup(self, name: str, register_type: RegisterType):
        reg = self.register_map.get_register_by_name(name)
        if reg is None or reg.register_type != register_type:
            raise KeyError(
                f"No {register_type.name} register named '{name}'")
        return reg

    @staticmethod
    def _validate_value(value: float) -> None:
        if not (-MAX_REGISTER_VALUE < value < MAX_REGISTER_VALUE):
            raise ValueError(f"Value {value} outside +-{MAX_REGISTER_VALUE}")

    def update_input_register(self, name: str, value: float,
                              unit: Optional[int] = None) -> None:
        reg = self._lookup(name, RegisterType.INPUT_REGISTER)
        st = self._store(unit)
        with self._lock:
            if reg.data_type == "float32":
                import math
                if not math.isnan(value):
                    self._validate_value(value)
                high, low = ModbusEncoder.float32_to_registers(value)
                st.ir.set(reg.address, [high, low])
            else:
                st.ir.set(
                    reg.address,
                    [ModbusEncoder.uint16_to_register(int(value))])

    def update_discrete_input(self, name: str, value: bool,
                              unit: Optional[int] = None) -> None:
        reg = self._lookup(name, RegisterType.DISCRETE_INPUT)
        st = self._store(unit)
        with self._lock:
            st.di.set(reg.address, [1 if value else 0])

    def read_input_register(self, name: str,
                            unit: Optional[int] = None) -> float:
        """Name-based read-back of a published input register (used by
        the OPC UA bridge so both planes serve one store)."""
        reg = self._lookup(name, RegisterType.INPUT_REGISTER)
        st = self._store(unit)
        with self._lock:
            words = st.ir.get(reg.address, reg.size_words)
        if reg.data_type == "float32":
            return ModbusDecoder.registers_to_float32(*words)
        return float(words[0])

    def read_discrete_input(self, name: str,
                            unit: Optional[int] = None) -> bool:
        reg = self._lookup(name, RegisterType.DISCRETE_INPUT)
        st = self._store(unit)
        with self._lock:
            return bool(st.di.get(reg.address, 1)[0])

    def read_holding_register(self, name: str,
                              unit: Optional[int] = None) -> float:
        reg = self._lookup(name, RegisterType.HOLDING_REGISTER)
        st = self._store(unit)
        with self._lock:
            words = st.hr.get(reg.address, reg.size_words)
        if reg.data_type == "float32":
            return ModbusDecoder.registers_to_float32(*words)
        return float(words[0])

    def write_holding_register(self, name: str, value: float,
                               unit: Optional[int] = None) -> None:
        reg = self._lookup(name, RegisterType.HOLDING_REGISTER)
        self._validate_value(value)
        st = self._store(unit)
        with self._lock:
            if reg.data_type == "float32":
                high, low = ModbusEncoder.float32_to_registers(value)
                st.hr.set(reg.address, [high, low])
            else:
                st.hr.set(
                    reg.address,
                    [ModbusEncoder.uint16_to_register(int(value))])

    def read_coil(self, name: str, unit: Optional[int] = None) -> bool:
        reg = self._lookup(name, RegisterType.COIL)
        st = self._store(unit)
        with self._lock:
            return bool(st.coil.get(reg.address, 1)[0])

    def write_coil(self, name: str, value: bool,
                   unit: Optional[int] = None) -> None:
        reg = self._lookup(name, RegisterType.COIL)
        st = self._store(unit)
        with self._lock:
            st.coil.set(reg.address, [1 if value else 0])

    # -- bulk getters (reference slave.py:374-392) --
    def get_all_input_registers(self, unit: Optional[int] = None
                                ) -> Dict[str, float]:
        out = {}
        st = self._store(unit)
        for reg in self.register_map.input_registers:
            words = st.ir.get(reg.address, reg.size_words)
            if reg.data_type == "float32":
                out[reg.name] = ModbusDecoder.registers_to_float32(*words)
            else:
                out[reg.name] = float(words[0])
        return out

    def get_all_holding_registers(self, unit: Optional[int] = None
                                  ) -> Dict[str, float]:
        return {reg.name: self.read_holding_register(reg.name, unit=unit)
                for reg in self.register_map.holding_registers}
