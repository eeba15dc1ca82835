"""
Modbus RTU framing — serial-line and RTU-over-TCP transports.

The reference explicitly lists "No Modbus RTU/serial support" as a
protocol limitation (reference README.md:535); this module closes it.
RTU is the serial framing of the same application PDUs the TCP plane
serves (slave.py): ``[unit id][PDU][CRC-16 lo][CRC-16 hi]`` with no
length field — frame boundaries come from the PDU structure (each
function code's request/response length is deterministic, spec section
6) and a CRC-16 check (polynomial 0xA001, init 0xFFFF, low byte first).

Two transports:

- **Serial** (``start_serial``): a file descriptor or device path — a
  real ``/dev/tty*``, an RS-485 adapter, or a pty pair in tests. One
  blocking reader thread per line (serial Modbus is single-master
  half-duplex by construction, so a thread per line is the faithful
  concurrency model — no event loop needed).
- **RTU-over-TCP** (``start_tcp``): the same framing on a TCP socket,
  the common bridge mode of serial device servers (Moxa/Lantronix
  style), handy for load tests without a serial device.

Semantics implemented beyond the happy path:

- **Broadcast (unit id 0)**: writes are applied to EVERY served unit
  and never answered (spec 4.3); reads to unit 0 are ignored.
- **CRC failure / noise resync**: a frame that fails its CRC (or opens
  with an unknown function code) increments the bus-comm-error counter
  and the parser resyncs by sliding one byte — the standard recovery on
  a noisy line.
- Unit ids not served are ignored (counted as no-response, like the TCP
  plane), so several slaves can share one RS-485 line.

PDU processing and the thread-safe name-based register API are
delegated to an (unstarted) ``ModbusSlave`` core, so both framings
serve one register store and one FC implementation.
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import threading
from typing import List, Optional, Tuple

from ics_wt_physicsengine_torch.modbus.register_map import ModbusRegisterMap
from ics_wt_physicsengine_torch.modbus.slave import (
    ModbusServerConfig,
    ModbusSlave,
)

logger = logging.getLogger(__name__)

BROADCAST_UNIT = 0


def _set_raw_if_tty(fd: int) -> None:
    """Raw mode on tty fds: the default line discipline echoes input and
    rewrites CR/NL bytes, which corrupts binary RTU frames on ptys and
    real serial devices alike."""
    try:
        import tty
        if os.isatty(fd):
            tty.setraw(fd)
    except Exception:  # noqa: BLE001 — non-tty fds (pipes, sockets)
        pass

# CRC-16/MODBUS: poly 0xA001 (reflected 0x8005), init 0xFFFF, no final
# xor; check value for "123456789" is 0x4B37. Table-driven (one 256-entry
# table beats bit-by-bit 8x on the hot path).
_CRC_TABLE: List[int] = []
for _byte in range(256):
    _crc = _byte
    for _ in range(8):
        _crc = (_crc >> 1) ^ 0xA001 if _crc & 1 else _crc >> 1
    _CRC_TABLE.append(_crc)


def crc16(data: bytes) -> int:
    crc = 0xFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc


def frame_rtu(unit_id: int, pdu: bytes) -> bytes:
    """unit id + PDU + CRC-16 (low byte first on the wire)."""
    body = bytes([unit_id]) + pdu
    return body + struct.pack("<H", crc16(body))


def check_crc(frame: bytes) -> bool:
    return (len(frame) >= 4
            and struct.unpack("<H", frame[-2:])[0] == crc16(frame[:-2]))


# Per-FC deterministic frame lengths (spec section 6). Return values:
# total frame length (incl. unit + CRC), None = need more bytes,
# -1 = unparseable (unknown FC) — caller resyncs.

_FIXED_REQUEST = {0x01: 8, 0x02: 8, 0x03: 8, 0x04: 8, 0x05: 8, 0x06: 8,
                  0x08: 8, 0x16: 10}


def expected_request_length(buf: bytes) -> Optional[int]:
    if len(buf) < 2:
        return None
    fc = buf[1]
    if fc in _FIXED_REQUEST:
        return _FIXED_REQUEST[fc]
    if fc in (0x0F, 0x10):          # byte count at offset 6
        return None if len(buf) < 7 else 9 + buf[6]
    if fc == 0x17:                  # byte count at offset 10
        return None if len(buf) < 11 else 13 + buf[10]
    if fc == 0x2B:                  # MEI read device id: fixed 7
        return 7
    return -1


_FIXED_RESPONSE = {0x05: 8, 0x06: 8, 0x08: 8, 0x0F: 8, 0x10: 8, 0x16: 10}


def expected_response_length(buf: bytes) -> Optional[int]:
    if len(buf) < 2:
        return None
    fc = buf[1]
    if fc & 0x80:                   # exception: unit+fc+code+crc
        return 5
    if fc in _FIXED_RESPONSE:
        return _FIXED_RESPONSE[fc]
    if fc in (0x01, 0x02, 0x03, 0x04, 0x17):   # byte count at offset 2
        return None if len(buf) < 3 else 5 + buf[2]
    if fc == 0x2B:                  # walk the device-id object list
        if len(buf) < 8:
            return None
        n_objects, off = buf[7], 8
        for _ in range(n_objects):
            if len(buf) < off + 2:
                return None
            off += 2 + buf[off + 1]
        return off + 2
    return -1


class RtuFramer:
    """Incremental RTU frame extractor with slide-one-byte resync."""

    def __init__(self, length_fn=expected_request_length):
        self._buf = b""
        self._length_fn = length_fn
        self.crc_errors = 0

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        """Consume bytes; return complete, CRC-valid (unit_id, pdu)
        frames. Invalid CRC or an unknown FC drops one byte and rescans
        (noise resync)."""
        self._buf += data
        frames = []
        while True:
            need = self._length_fn(self._buf)
            if need is None:
                break                       # incomplete: read more
            if need < 0:
                self.crc_errors += 1
                self._buf = self._buf[1:]   # unknown FC: resync
                continue
            if len(self._buf) < need:
                break
            frame, self._buf = self._buf[:need], self._buf[need:]
            if not check_crc(frame):
                self.crc_errors += 1
                # put the tail back and slide one byte: the frame
                # boundary guess was wrong (line noise)
                self._buf = frame[1:] + self._buf
                continue
            frames.append((frame[0], frame[1:-2]))
        return frames


class ModbusRtuSlave:
    """Modbus RTU slave over a serial line or RTU-over-TCP.

    Delegates storage + PDU semantics to an unstarted ``ModbusSlave``
    core, so the name-based register API (``update_input_register`` …)
    and multi-unit fleet spaces work identically on both framings."""

    def __init__(self, register_map: ModbusRegisterMap,
                 config: Optional[ModbusServerConfig] = None,
                 units: Optional[List[int]] = None,
                 serial_device=None):
        if config is not None and config.tls is not None:
            raise ValueError("RTU framing has no TLS profile "
                             "(MB-TCP-Security-v21 covers TCP only); "
                             "use the mbaps TCP plane for security")
        self.core = ModbusSlave(register_map, config, units=units)
        # when set, start() serves this serial device; otherwise start()
        # serves RTU-over-TCP on the config's host:port (drop-in for the
        # orchestrator's slave.start(blocking=False) lifecycle)
        self._serial_device = serial_device
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fd: Optional[int] = None
        self._owns_fd = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._ready = threading.Event()
        self._actual_port: Optional[int] = None

    def __getattr__(self, name):
        # register API / diagnostics pass straight through to the core
        if name == "core":
            raise AttributeError(name)
        return getattr(self.core, name)

    def start(self, blocking: bool = False) -> None:
        """Lifecycle-compatible with ModbusSlave.start: dispatch to the
        configured transport (serial_device= from the constructor, else
        RTU-over-TCP on the config's host:port)."""
        if self._serial_device is not None:
            self.start_serial(self._serial_device, blocking=blocking)
        else:
            self.start_tcp(self.core.config.host, self.core.config.port)
            if blocking:
                self._thread.join()

    # -- frame processing shared by both transports --

    def _serve_frame(self, unit_id: int, pdu: bytes) -> Optional[bytes]:
        """Return the response frame, or None (broadcast / other unit)."""
        core = self.core
        core.request_count += 1
        if unit_id == BROADCAST_UNIT:
            # broadcast: apply writes to every served unit, never answer
            from ics_wt_physicsengine_torch.modbus.security import (
                pdu_requires_write,
            )
            if pdu_requires_write(pdu):
                core.slave_message_count += 1
                for uid in core.units:
                    core._process_pdu(pdu, core._stores[uid])
            return None
        if unit_id not in core._stores:
            core.no_response_count += 1
            return None
        core.slave_message_count += 1
        response = core._process_pdu(pdu, core._stores[unit_id])
        if response and response[0] & 0x80:
            core.exception_count += 1
        return frame_rtu(unit_id, response)

    # -- serial transport --

    def start_serial(self, device, blocking: bool = False) -> None:
        """Serve on a serial line: ``device`` is a path (opened O_RDWR,
        e.g. /dev/ttyUSB0 or a pty slave path) or an already-open fd."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("Server already running")
        if isinstance(device, int):
            self._fd = device
            self._owns_fd = False
        else:
            self._fd = os.open(device, os.O_RDWR | os.O_NOCTTY)
            self._owns_fd = True
        _set_raw_if_tty(self._fd)
        self._shutdown.clear()
        self._thread = threading.Thread(target=self._serial_loop,
                                        name="ModbusRTUSerial",
                                        daemon=True)
        self._thread.start()
        logger.info("Modbus RTU serving on serial fd %d", self._fd)
        if blocking:
            self._thread.join()

    def _serial_loop(self):
        import select
        framer = RtuFramer(expected_request_length)
        fd = self._fd
        while not self._shutdown.is_set():
            # select-with-timeout rather than a blocking read: close()
            # from stop() does NOT interrupt a thread parked in read(),
            # so a pure blocking loop could never shut down cleanly.
            try:
                ready, _, _ = select.select([fd], [], [], 0.1)
            except (OSError, ValueError):
                break                        # fd closed by stop()
            if not ready:
                continue
            try:
                chunk = os.read(fd, 4096)
            except OSError:
                break                        # EIO: peer end closed
            if not chunk:
                break
            frames = framer.feed(chunk)
            # flush CRC/noise tallies BEFORE serving: a master that syncs
            # on the response (or queries FC 08 in the same chunk) must
            # see errors from earlier bytes of that chunk already counted
            self.core.error_count += framer.crc_errors
            framer.crc_errors = 0
            for unit_id, pdu in frames:
                response = self._serve_frame(unit_id, pdu)
                if response is not None:
                    try:
                        os.write(fd, response)
                    except OSError:
                        return

    # -- RTU-over-TCP transport --

    def start_tcp(self, host: str = "127.0.0.1", port: int = 0) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("Server already running")
        self._shutdown.clear()
        self._ready.clear()
        self._thread = threading.Thread(target=self._tcp_thread,
                                        args=(host, port),
                                        name="ModbusRTUoverTCP",
                                        daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=self.core.config.timeout_seconds):
            raise RuntimeError("RTU-over-TCP server failed to start")
        if self._actual_port is None:
            raise RuntimeError("RTU-over-TCP server failed to bind")
        logger.info("Modbus RTU-over-TCP listening on %s:%d", host,
                    self._actual_port)

    async def _handle_tcp_client(self, reader, writer):
        framer = RtuFramer(expected_request_length)
        try:
            while not self._shutdown.is_set():
                chunk = await reader.read(4096)
                if not chunk:
                    break
                frames = framer.feed(chunk)
                self.core.error_count += framer.crc_errors
                framer.crc_errors = 0
                out = []
                for unit_id, pdu in frames:
                    response = self._serve_frame(unit_id, pdu)
                    if response is not None:
                        out.append(response)
                if out:
                    writer.write(b"".join(out))
                    await writer.drain()
        except (ConnectionResetError, ConnectionAbortedError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _async_tcp_server(self, host, port):
        self._server = await asyncio.start_server(
            self._handle_tcp_client, host, port)
        self._actual_port = self._server.sockets[0].getsockname()[1]
        self._ready.set()
        try:
            while not self._shutdown.is_set():
                await asyncio.sleep(0.1)
        finally:
            self._server.close()
            pending = [t for t in asyncio.all_tasks()
                       if t is not asyncio.current_task()]
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
            await self._server.wait_closed()

    def _tcp_thread(self, host, port):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._async_tcp_server(host,
                                                                 port))
        except Exception as exc:  # noqa: BLE001
            logger.error("RTU-over-TCP server error: %s",
                         type(exc).__name__)
            self._ready.set()
        finally:
            self._loop.close()

    @property
    def port(self) -> Optional[int]:
        return self._actual_port

    @property
    def is_running(self) -> bool:
        # NOT delegated: the core ModbusSlave is never started (it only
        # provides storage + PDU semantics), so its is_running is False.
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        self._shutdown.set()
        if self._fd is not None and self._owns_fd:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        if self._thread is not None:
            self._thread.join(timeout=3.0)
            if self._thread.is_alive():
                logger.warning("RTU server thread did not stop cleanly")
        self._thread = None


class ModbusRtuClient:
    """Blocking RTU master over a serial fd/path or RTU-over-TCP.

    Offers the same helper surface as ModbusTcpClient by reusing its
    method bodies — only the transport/framing differ."""

    def __init__(self, device=None, host: Optional[str] = None,
                 port: Optional[int] = None, unit_id: int = 1,
                 timeout: float = 5.0):
        if (device is None) == (host is None):
            raise ValueError("pass exactly one of device= (serial) or "
                             "host=/port= (RTU-over-TCP)")
        self.device = device
        self.host = host
        self.port = port
        self.unit_id = unit_id
        self.timeout = timeout
        self._fd: Optional[int] = None
        self._owns_fd = False
        self._sock = None

    def connect(self):
        if self.device is not None:
            if isinstance(self.device, int):
                self._fd = self.device
            else:
                self._fd = os.open(self.device, os.O_RDWR | os.O_NOCTTY)
                self._owns_fd = True
            _set_raw_if_tty(self._fd)
        else:
            import socket
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout)
        return self

    def close(self):
        if self._fd is not None and self._owns_fd:
            try:
                os.close(self._fd)
            except OSError:
                pass
        self._fd = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def __enter__(self):
        return self.connect()

    def __exit__(self, *exc):
        self.close()

    def _read_some(self) -> bytes:
        if self._sock is not None:
            return self._sock.recv(4096)
        import select
        ready, _, _ = select.select([self._fd], [], [], self.timeout)
        if not ready:
            raise TimeoutError("RTU response timeout")
        return os.read(self._fd, 4096)

    def _transact(self, pdu: bytes) -> bytes:
        frame = frame_rtu(self.unit_id, pdu)
        if self._sock is not None:
            self._sock.sendall(frame)
        elif self._fd is not None:
            os.write(self._fd, frame)
        else:
            raise RuntimeError("Client not connected")
        buf = b""
        import time
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            need = expected_response_length(buf)
            if need is not None and need < 0:
                raise IOError(f"unparseable RTU response "
                              f"(fc=0x{buf[1]:02x})")
            if need is not None and len(buf) >= need:
                break
            chunk = self._read_some()
            if not chunk:
                raise ConnectionError("Connection closed by server")
            buf += chunk
        need = expected_response_length(buf)
        if need is None or need < 0 or len(buf) < need:
            raise TimeoutError(f"incomplete RTU response ({len(buf)} B)")
        frame = buf[:need]
        if not check_crc(frame):
            raise IOError("RTU response CRC mismatch")
        if frame[0] != self.unit_id:
            raise IOError(f"RTU response from unit {frame[0]}, "
                          f"expected {self.unit_id}")
        response = frame[1:-2]
        if response[0] & 0x80:
            raise IOError(f"Modbus exception {response[1]} for "
                          f"function {response[0] & 0x7F}")
        return response

    def send_broadcast(self, pdu: bytes) -> None:
        """Unit-0 broadcast: fire-and-forget (no response by spec)."""
        frame = frame_rtu(BROADCAST_UNIT, pdu)
        if self._sock is not None:
            self._sock.sendall(frame)
        elif self._fd is not None:
            os.write(self._fd, frame)
        else:
            raise RuntimeError("Client not connected")


# Graft the TCP client's helper methods (read_input_registers,
# write_register, read_float32, diagnostics, …) onto the RTU client:
# they are pure PDU builders/parsers over self._transact, so they are
# framing-agnostic by construction.
def _graft_helpers():
    from ics_wt_physicsengine_torch.modbus.client import ModbusTcpClient
    skip = {"__init__", "connect", "close", "_transact", "_recv_exact",
            "__enter__", "__exit__"}
    for name, member in vars(ModbusTcpClient).items():
        if callable(member) and name not in skip \
                and not hasattr(ModbusRtuClient, name):
            setattr(ModbusRtuClient, name, member)


_graft_helpers()
