"""
Minimal synchronous Modbus/TCP client.

The reference relies on external pymodbus clients for closed-loop HIL testing
(reference README.md:249-273); since pymodbus is not available here, this
client provides the same capability in-repo: it exercises the slave over a
real TCP socket for integration tests and external-controller loops.
"""

from __future__ import annotations

import socket
import ssl as _ssl
import struct
from typing import List, Optional

from ics_wt_physicsengine_torch.modbus.protocols import (
    ModbusDecoder,
    ModbusEncoder,
)


class ModbusTcpClient:
    """Blocking Modbus/TCP master for tests and HIL controller loops."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5020,
                 unit_id: int = 1, timeout: float = 5.0,
                 ssl_context: Optional[_ssl.SSLContext] = None,
                 server_hostname: Optional[str] = None):
        self.host = host
        self.port = port
        self.unit_id = unit_id
        self.timeout = timeout
        # Modbus/TCP Security: pass security.make_client_ssl_context(...)
        # to speak mbaps (TLS + client certificate) to a TLS-enabled slave.
        self.ssl_context = ssl_context
        self.server_hostname = server_hostname or host
        self._sock: socket.socket | None = None
        self._transaction = 0

    def connect(self):
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout)
        if self.ssl_context is not None:
            self._sock = self.ssl_context.wrap_socket(
                self._sock, server_hostname=self.server_hostname)
        return self

    def close(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def __enter__(self):
        return self.connect()

    def __exit__(self, *exc):
        self.close()

    def _transact(self, pdu: bytes) -> bytes:
        if self._sock is None:
            raise RuntimeError("Client not connected")
        self._transaction = (self._transaction + 1) & 0xFFFF
        request = struct.pack(">HHHB", self._transaction, 0, len(pdu) + 1,
                              self.unit_id) + pdu
        self._sock.sendall(request)
        header = self._recv_exact(7)
        _, _, length, _ = struct.unpack(">HHHB", header)
        response = self._recv_exact(length - 1)
        if response[0] & 0x80:
            raise IOError(f"Modbus exception {response[1]} for "
                          f"function {response[0] & 0x7F}")
        return response

    def _recv_exact(self, n: int) -> bytes:
        chunks = b""
        while len(chunks) < n:
            chunk = self._sock.recv(n - len(chunks))
            if not chunk:
                raise ConnectionError("Connection closed by server")
            chunks += chunk
        return chunks

    # -- register access --
    def read_input_registers(self, address: int, count: int) -> List[int]:
        resp = self._transact(struct.pack(">BHH", 0x04, address, count))
        return list(struct.unpack(f">{count}H", resp[2:]))

    def read_holding_registers(self, address: int, count: int) -> List[int]:
        resp = self._transact(struct.pack(">BHH", 0x03, address, count))
        return list(struct.unpack(f">{count}H", resp[2:]))

    def read_coils(self, address: int, count: int) -> List[bool]:
        resp = self._transact(struct.pack(">BHH", 0x01, address, count))
        data = resp[2:]
        return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(count)]

    def read_discrete_inputs(self, address: int, count: int) -> List[bool]:
        resp = self._transact(struct.pack(">BHH", 0x02, address, count))
        data = resp[2:]
        return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(count)]

    def write_register(self, address: int, value: int):
        self._transact(struct.pack(">BHH", 0x06, address, value & 0xFFFF))

    def write_registers(self, address: int, values: List[int]):
        count = len(values)
        pdu = struct.pack(">BHHB", 0x10, address, count, count * 2)
        pdu += struct.pack(f">{count}H", *[v & 0xFFFF for v in values])
        self._transact(pdu)

    def write_coil(self, address: int, value: bool):
        self._transact(struct.pack(">BHH", 0x05, address,
                                   0xFF00 if value else 0x0000))

    def write_coils(self, address: int, values: List[bool]):
        count = len(values)
        n_bytes = (count + 7) // 8
        data = bytearray(n_bytes)
        for i, v in enumerate(values):
            if v:
                data[i // 8] |= 1 << (i % 8)
        pdu = struct.pack(">BHHB", 0x0F, address, count, n_bytes) + bytes(data)
        self._transact(pdu)

    def mask_write_register(self, address: int, and_mask: int,
                            or_mask: int) -> None:
        """FC 22 Mask Write Register (spec 6.16):
        reg = (current AND and_mask) OR (or_mask AND NOT and_mask)."""
        self._transact(struct.pack(">BHHH", 0x16, address,
                                   and_mask & 0xFFFF, or_mask & 0xFFFF))

    def read_write_registers(self, read_address: int, read_count: int,
                             write_address: int,
                             values: list) -> list:
        """FC 23 Read/Write Multiple Registers (spec 6.17): the write
        executes first, then the read; returns the read words."""
        n = len(values)
        pdu = struct.pack(">BHHHHB", 0x17, read_address, read_count,
                          write_address, n, n * 2) + b"".join(
            struct.pack(">H", v & 0xFFFF) for v in values)
        resp = self._transact(pdu)
        count = resp[1] // 2
        return list(struct.unpack(f">{count}H", resp[2:2 + resp[1]]))

    def diagnostics(self, sub_function: int, data: int = 0) -> int:
        """FC 08 Diagnostics: returns the response data field (the counter
        value for sub-functions 0x0B-0x0F, the echoed data for 0x0000,
        0 after 0x000A Clear Counters)."""
        resp = self._transact(struct.pack(">BHH", 0x08,
                                          sub_function & 0xFFFF,
                                          data & 0xFFFF))
        _, value = struct.unpack(">HH", resp[1:5])
        return value

    def diagnostic_counters(self) -> dict:
        """All five standard FC 08 counters in one call (same keys as the
        servers' diagnostics() methods)."""
        return {
            "bus_message_count": self.diagnostics(0x0B),
            "bus_comm_error_count": self.diagnostics(0x0C),
            "bus_exception_count": self.diagnostics(0x0D),
            "slave_message_count": self.diagnostics(0x0E),
            "slave_no_response_count": self.diagnostics(0x0F),
        }

    def read_device_identification(self, read_code: int = 0x01,
                                   object_id: int = 0x00) -> dict:
        """FC 43 / MEI 14 Read Device Identification. Returns
        ``{object_id: string}`` (vendor/product identity, reference
        slave.py:89-95)."""
        resp = self._transact(struct.pack(">BBBB", 0x2B, 0x0E,
                                          read_code, object_id))
        n_objects = resp[6]
        out, off = {}, 7
        for _ in range(n_objects):
            oid, length = resp[off], resp[off + 1]
            out[oid] = resp[off + 2:off + 2 + length].decode("ascii")
            off += 2 + length
        return out

    # -- typed convenience --
    def read_float32(self, address: int, input_register: bool = True) -> float:
        regs = (self.read_input_registers(address, 2) if input_register
                else self.read_holding_registers(address, 2))
        return ModbusDecoder.registers_to_float32(*regs)

    def write_float32(self, address: int, value: float):
        high, low = ModbusEncoder.float32_to_registers(value)
        self.write_registers(address, [high, low])
