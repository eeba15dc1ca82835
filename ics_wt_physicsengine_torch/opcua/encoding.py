"""
OPC UA Binary encoding (OPC 10000-6 "Mappings", UA Binary) — from scratch.

The reference roadmap lists "OPC UA server (in addition to Modbus)"
(reference README.md:456) but ships none; no OPC UA stack is
available in this environment either, so this package implements the
subset of the UA Binary data encoding needed for a SecurityPolicy#None
server and client: the built-in scalar types, NodeId/ExpandedNodeId,
QualifiedName/LocalizedText, Variant, DataValue, ExtensionObject, and
arrays thereof.

Layouts follow OPC 10000-6 §5.1-5.2 (all little-endian):

- String / ByteString: Int32 byte length (-1 = null) + UTF-8 bytes.
- NodeId: encoding byte, then TwoByte (ns 0, id < 256), FourByte
  (ns < 256, id < 65536), Numeric, String, Guid or ByteString body.
- DateTime: Int64, 100 ns ticks since 1601-01-01 (Windows FILETIME).
- Variant: encoding byte = built-in type id | 0x80 array bit
  (| 0x40 array-dimensions bit, unused here), then the value.
- DataValue: encoding mask byte (bit0 value .. bit5 serverPicoseconds),
  then the present fields in order.
- ExtensionObject: type NodeId + encoding byte (0x00 none,
  0x01 ByteString body) + Int32 length + body.
- DiagnosticInfo: encoding mask byte; we always emit 0x00 (absent).

Every encoder has a matching decoder and the pair is round-trip tested;
a handful of golden byte strings in tests/test_opcua.py pin the layouts
themselves (not just self-consistency).
"""

from __future__ import annotations

import struct
import uuid as _uuid
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# Built-in type ids (OPC 10000-6 Table 1)
# ---------------------------------------------------------------------------

VT_BOOLEAN = 1
VT_SBYTE = 2
VT_BYTE = 3
VT_INT16 = 4
VT_UINT16 = 5
VT_INT32 = 6
VT_UINT32 = 7
VT_INT64 = 8
VT_UINT64 = 9
VT_FLOAT = 10
VT_DOUBLE = 11
VT_STRING = 12
VT_DATETIME = 13
VT_GUID = 14
VT_BYTESTRING = 15
VT_NODEID = 17
VT_STATUSCODE = 19
VT_QUALIFIEDNAME = 20
VT_LOCALIZEDTEXT = 21
VT_EXTENSIONOBJECT = 22

# Epoch delta: 1601-01-01 -> 1970-01-01 in 100 ns ticks
_FILETIME_EPOCH_DELTA = 116444736000000000


# ---------------------------------------------------------------------------
# Value classes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NodeId:
    """ns + identifier; identifier type follows the Python type."""

    namespace: int = 0
    identifier: Union[int, str, bytes, _uuid.UUID] = 0

    def __str__(self) -> str:
        kind = {int: "i", str: "s", bytes: "b"}.get(
            type(self.identifier), "g")
        return f"ns={self.namespace};{kind}={self.identifier}"


NULL_NODE_ID = NodeId(0, 0)


@dataclass(frozen=True)
class QualifiedName:
    namespace: int = 0
    name: Optional[str] = None


@dataclass(frozen=True)
class LocalizedText:
    text: Optional[str] = None
    locale: Optional[str] = None


@dataclass(frozen=True)
class Variant:
    """A typed scalar or 1-D array. ``value=None, type_id=0`` is the
    null variant (single 0x00 byte on the wire)."""

    type_id: int = 0
    value: object = None
    is_array: bool = False


@dataclass
class DataValue:
    value: Optional[Variant] = None
    status: Optional[int] = None            # StatusCode; None = Good omitted
    source_timestamp: Optional[int] = None  # FILETIME ticks
    server_timestamp: Optional[int] = None


@dataclass
class ExtensionObject:
    type_id: NodeId = field(default_factory=lambda: NULL_NODE_ID)
    body: Optional[bytes] = None            # None = no body (encoding 0x00)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

class Encoder:
    """Append-only little-endian byte builder."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def data(self) -> bytes:
        return b"".join(self._parts)

    def raw(self, b: bytes) -> "Encoder":
        self._parts.append(b)
        return self

    def boolean(self, v: bool) -> "Encoder":
        return self.raw(b"\x01" if v else b"\x00")

    def byte(self, v: int) -> "Encoder":
        return self.raw(struct.pack("<B", v & 0xFF))

    def uint16(self, v: int) -> "Encoder":
        return self.raw(struct.pack("<H", v & 0xFFFF))

    def int32(self, v: int) -> "Encoder":
        return self.raw(struct.pack("<i", v))

    def uint32(self, v: int) -> "Encoder":
        return self.raw(struct.pack("<I", v & 0xFFFFFFFF))

    def int64(self, v: int) -> "Encoder":
        return self.raw(struct.pack("<q", v))

    def uint64(self, v: int) -> "Encoder":
        return self.raw(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))

    def float32(self, v: float) -> "Encoder":
        return self.raw(struct.pack("<f", v))

    def double(self, v: float) -> "Encoder":
        return self.raw(struct.pack("<d", v))

    def string(self, v: Optional[str]) -> "Encoder":
        if v is None:
            return self.int32(-1)
        b = v.encode("utf-8")
        return self.int32(len(b)).raw(b)

    def bytestring(self, v: Optional[bytes]) -> "Encoder":
        if v is None:
            return self.int32(-1)
        return self.int32(len(v)).raw(v)

    def guid(self, v: _uuid.UUID) -> "Encoder":
        return self.raw(v.bytes_le)

    def datetime(self, ticks: int) -> "Encoder":
        return self.int64(ticks)

    def status_code(self, v: int) -> "Encoder":
        return self.uint32(v)

    def node_id(self, n: NodeId) -> "Encoder":
        ident = n.identifier
        if isinstance(ident, bool):
            raise TypeError("bool is not a NodeId identifier")
        if isinstance(ident, int):
            if n.namespace == 0 and 0 <= ident <= 0xFF:
                return self.byte(0x00).byte(ident)
            if 0 <= n.namespace <= 0xFF and 0 <= ident <= 0xFFFF:
                return self.byte(0x01).byte(n.namespace).uint16(ident)
            return self.byte(0x02).uint16(n.namespace).uint32(ident)
        if isinstance(ident, str):
            return self.byte(0x03).uint16(n.namespace).string(ident)
        if isinstance(ident, _uuid.UUID):
            return self.byte(0x04).uint16(n.namespace).guid(ident)
        if isinstance(ident, bytes):
            return self.byte(0x05).uint16(n.namespace).bytestring(ident)
        raise TypeError(f"unsupported NodeId identifier {ident!r}")

    def expanded_node_id(self, n: NodeId) -> "Encoder":
        # No namespaceUri / serverIndex flags: plain NodeId layout.
        return self.node_id(n)

    def qualified_name(self, q: QualifiedName) -> "Encoder":
        return self.uint16(q.namespace).string(q.name)

    def localized_text(self, t: LocalizedText) -> "Encoder":
        mask = (0x01 if t.locale is not None else 0) | (
            0x02 if t.text is not None else 0)
        self.byte(mask)
        if t.locale is not None:
            self.string(t.locale)
        if t.text is not None:
            self.string(t.text)
        return self

    def diagnostic_info(self) -> "Encoder":
        return self.byte(0x00)   # always "absent"

    def extension_object(self, e: ExtensionObject) -> "Encoder":
        self.node_id(e.type_id)
        if e.body is None:
            return self.byte(0x00)
        return self.byte(0x01).bytestring(e.body)

    _SCALAR = None   # filled in after class definition

    def _variant_scalar(self, type_id: int, v: object) -> None:
        try:
            self._SCALAR[type_id](self, v)
        except KeyError:
            raise ValueError(f"unsupported Variant type id {type_id}") \
                from None

    def variant(self, v: Variant) -> "Encoder":
        if v.type_id == 0:
            return self.byte(0x00)
        if v.is_array:
            self.byte(v.type_id | 0x80)
            items = list(v.value) if v.value is not None else None
            if items is None:
                return self.int32(-1)
            self.int32(len(items))
            for item in items:
                self._variant_scalar(v.type_id, item)
            return self
        self.byte(v.type_id)
        self._variant_scalar(v.type_id, v.value)
        return self

    def data_value(self, d: DataValue) -> "Encoder":
        mask = 0
        if d.value is not None:
            mask |= 0x01
        if d.status is not None:
            mask |= 0x02
        if d.source_timestamp is not None:
            mask |= 0x04
        if d.server_timestamp is not None:
            mask |= 0x08
        self.byte(mask)
        if d.value is not None:
            self.variant(d.value)
        if d.status is not None:
            self.status_code(d.status)
        if d.source_timestamp is not None:
            self.datetime(d.source_timestamp)
        if d.server_timestamp is not None:
            self.datetime(d.server_timestamp)
        return self

    def array(self, items: Optional[list], encode_one) -> "Encoder":
        """Int32 count (-1 = null) + each element via ``encode_one``."""
        if items is None:
            return self.int32(-1)
        self.int32(len(items))
        for item in items:
            encode_one(self, item)
        return self


Encoder._SCALAR = {
    VT_BOOLEAN: Encoder.boolean,
    VT_SBYTE: lambda e, v: e.raw(struct.pack("<b", v)),
    VT_BYTE: Encoder.byte,
    VT_INT16: lambda e, v: e.raw(struct.pack("<h", v)),
    VT_UINT16: Encoder.uint16,
    VT_INT32: Encoder.int32,
    VT_UINT32: Encoder.uint32,
    VT_INT64: Encoder.int64,
    VT_UINT64: Encoder.uint64,
    VT_FLOAT: Encoder.float32,
    VT_DOUBLE: Encoder.double,
    VT_STRING: Encoder.string,
    VT_DATETIME: Encoder.datetime,
    VT_GUID: Encoder.guid,
    VT_BYTESTRING: Encoder.bytestring,
    VT_NODEID: Encoder.node_id,
    VT_STATUSCODE: Encoder.status_code,
    VT_QUALIFIEDNAME: Encoder.qualified_name,
    VT_LOCALIZEDTEXT: Encoder.localized_text,
    VT_EXTENSIONOBJECT: Encoder.extension_object,
}


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class DecodeError(ValueError):
    """Malformed UA Binary input."""


class Decoder:
    """Little-endian byte reader with bounds checking."""

    def __init__(self, data: bytes, offset: int = 0) -> None:
        self._d = data
        self._o = offset

    @property
    def offset(self) -> int:
        return self._o

    def remaining(self) -> int:
        return len(self._d) - self._o

    def raw(self, n: int) -> bytes:
        if n < 0 or self._o + n > len(self._d):
            raise DecodeError(f"need {n} bytes, have {self.remaining()}")
        b = self._d[self._o:self._o + n]
        self._o += n
        return b

    def boolean(self) -> bool:
        return self.raw(1) != b"\x00"

    def byte(self) -> int:
        return self.raw(1)[0]

    def uint16(self) -> int:
        return struct.unpack("<H", self.raw(2))[0]

    def int32(self) -> int:
        return struct.unpack("<i", self.raw(4))[0]

    def uint32(self) -> int:
        return struct.unpack("<I", self.raw(4))[0]

    def int64(self) -> int:
        return struct.unpack("<q", self.raw(8))[0]

    def uint64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def float32(self) -> float:
        return struct.unpack("<f", self.raw(4))[0]

    def double(self) -> float:
        return struct.unpack("<d", self.raw(8))[0]

    def string(self) -> Optional[str]:
        n = self.int32()
        if n < 0:
            return None
        try:
            return self.raw(n).decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError(f"bad UTF-8 in String: {e}") from None

    def bytestring(self) -> Optional[bytes]:
        n = self.int32()
        if n < 0:
            return None
        return self.raw(n)

    def guid(self) -> _uuid.UUID:
        return _uuid.UUID(bytes_le=self.raw(16))

    def datetime(self) -> int:
        return self.int64()

    def status_code(self) -> int:
        return self.uint32()

    def node_id(self) -> NodeId:
        enc = self.byte()
        kind = enc & 0x3F
        if kind == 0x00:
            return NodeId(0, self.byte())
        if kind == 0x01:
            return NodeId(self.byte(), self.uint16())
        if kind == 0x02:
            return NodeId(self.uint16(), self.uint32())
        if kind == 0x03:
            ns = self.uint16()
            return NodeId(ns, self.string() or "")
        if kind == 0x04:
            return NodeId(self.uint16(), self.guid())
        if kind == 0x05:
            ns = self.uint16()
            return NodeId(ns, self.bytestring() or b"")
        raise DecodeError(f"unsupported NodeId encoding 0x{enc:02x}")

    def expanded_node_id(self) -> NodeId:
        # Peek the flag bits: 0x80 = namespaceUri follows, 0x40 = serverIndex
        enc = self._d[self._o] if self._o < len(self._d) else 0
        n = self.node_id()
        if enc & 0x80:
            self.string()
        if enc & 0x40:
            self.uint32()
        return n

    def qualified_name(self) -> QualifiedName:
        ns = self.uint16()
        return QualifiedName(ns, self.string())

    def localized_text(self) -> LocalizedText:
        mask = self.byte()
        locale = self.string() if mask & 0x01 else None
        text = self.string() if mask & 0x02 else None
        return LocalizedText(text, locale)

    def diagnostic_info(self) -> None:
        mask = self.byte()
        # Optional int/string fields per mask bit (OPC 10000-6 §5.2.2.12)
        if mask & 0x01:
            self.int32()            # symbolicId
        if mask & 0x02:
            self.int32()            # namespaceUri
        if mask & 0x04:
            self.int32()            # localizedText index
        if mask & 0x08:
            self.int32()            # locale
        if mask & 0x10:
            self.string()           # additionalInfo
        if mask & 0x20:
            self.status_code()      # innerStatusCode
        if mask & 0x40:
            self.diagnostic_info()  # innerDiagnosticInfo
        return None

    def extension_object(self) -> ExtensionObject:
        type_id = self.node_id()
        enc = self.byte()
        if enc == 0x00:
            return ExtensionObject(type_id, None)
        if enc == 0x01:
            return ExtensionObject(type_id, self.bytestring() or b"")
        if enc == 0x02:
            raise DecodeError("XML ExtensionObject body not supported")
        raise DecodeError(f"bad ExtensionObject encoding 0x{enc:02x}")

    _SCALAR = None   # filled in below

    def _variant_scalar(self, type_id: int) -> object:
        try:
            return self._SCALAR[type_id](self)
        except KeyError:
            raise DecodeError(f"unsupported Variant type id {type_id}") \
                from None

    def variant(self) -> Variant:
        enc = self.byte()
        if enc == 0x00:
            return Variant(0, None)
        type_id = enc & 0x3F
        if enc & 0x80:
            n = self.int32()
            if n < 0:
                return Variant(type_id, None, is_array=True)
            items = [self._variant_scalar(type_id) for _ in range(n)]
            if enc & 0x40:                      # ArrayDimensions
                dims = self.int32()
                for _ in range(max(dims, 0)):
                    self.int32()
            return Variant(type_id, items, is_array=True)
        return Variant(type_id, self._variant_scalar(type_id))

    def data_value(self) -> DataValue:
        # Mask bits (OPC 10000-6 §5.2.2.17): 0x01 value, 0x02 status,
        # 0x04 sourceTimestamp, 0x08 serverTimestamp,
        # 0x10 sourcePicoseconds, 0x20 serverPicoseconds.
        mask = self.byte()
        d = DataValue()
        if mask & 0x01:
            d.value = self.variant()
        if mask & 0x02:
            d.status = self.status_code()
        if mask & 0x04:
            d.source_timestamp = self.datetime()
        if mask & 0x10:
            self.uint16()      # sourcePicoseconds follows its timestamp
        if mask & 0x08:
            d.server_timestamp = self.datetime()
        if mask & 0x20:
            self.uint16()      # serverPicoseconds
        return d

    def array(self, decode_one) -> Optional[list]:
        n = self.int32()
        if n < 0:
            return None
        if n > 1_000_000:
            raise DecodeError(f"array length {n} over sanity cap")
        return [decode_one(self) for _ in range(n)]


Decoder._SCALAR = {
    VT_BOOLEAN: Decoder.boolean,
    VT_SBYTE: lambda d: struct.unpack("<b", d.raw(1))[0],
    VT_BYTE: Decoder.byte,
    VT_INT16: lambda d: struct.unpack("<h", d.raw(2))[0],
    VT_UINT16: Decoder.uint16,
    VT_INT32: Decoder.int32,
    VT_UINT32: Decoder.uint32,
    VT_INT64: Decoder.int64,
    VT_UINT64: Decoder.uint64,
    VT_FLOAT: Decoder.float32,
    VT_DOUBLE: Decoder.double,
    VT_STRING: Decoder.string,
    VT_DATETIME: Decoder.datetime,
    VT_GUID: Decoder.guid,
    VT_BYTESTRING: Decoder.bytestring,
    VT_NODEID: Decoder.node_id,
    VT_STATUSCODE: Decoder.status_code,
    VT_QUALIFIEDNAME: Decoder.qualified_name,
    VT_LOCALIZEDTEXT: Decoder.localized_text,
    VT_EXTENSIONOBJECT: Decoder.extension_object,
}


def unix_to_filetime(unix_seconds: float) -> int:
    """POSIX seconds -> OPC UA DateTime (100 ns ticks since 1601)."""
    return int(unix_seconds * 10_000_000) + _FILETIME_EPOCH_DELTA


def filetime_to_unix(ticks: int) -> float:
    return (ticks - _FILETIME_EPOCH_DELTA) / 10_000_000
