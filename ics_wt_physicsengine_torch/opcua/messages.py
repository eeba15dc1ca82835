"""
OPC UA service structs + secure-conversation framing (SecurityPolicy#None).

Implements the wire layouts from OPC 10000-4 (services) and 10000-6
(transport) for the service subset a read/write/browse server needs:

- Transport: HEL/ACK/ERR connection protocol, OPN (asymmetric header,
  policy None) and MSG/CLO (symmetric header) secure-conversation chunks.
  Single-chunk ('F') messages only; chunked ('C'/'A') transfers are
  rejected with Bad_TcpMessageTypeInvalid — fine for this server's small
  payloads, and the negotiated max sizes advertise that honestly.
- Services: OpenSecureChannel, CloseSecureChannel, GetEndpoints,
  CreateSession, ActivateSession, CloseSession, Read, Write, Browse,
  plus ServiceFault.

Numeric ids are the standard NodeIds from the OPC UA namespace-0 nodeset
(csv "Opc.Ua.NodeIds"): a service struct's DefaultBinary encoding node is
its type id + 2.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ics_wt_physicsengine_torch.opcua.encoding import (
    DataValue,
    DecodeError,
    Decoder,
    Encoder,
    ExtensionObject,
    LocalizedText,
    NodeId,
    NULL_NODE_ID,
    QualifiedName,
    Variant,
)

# --------------------------------------------------------------------------
# Standard numeric ids (namespace 0)
# --------------------------------------------------------------------------

ID_SERVICE_FAULT = 397              # ServiceFault_Encoding_DefaultBinary
ID_OPEN_CHANNEL_REQ = 446
ID_OPEN_CHANNEL_RSP = 449
ID_CLOSE_CHANNEL_REQ = 452
ID_CLOSE_CHANNEL_RSP = 455
ID_GET_ENDPOINTS_REQ = 428
ID_GET_ENDPOINTS_RSP = 431
ID_CREATE_SESSION_REQ = 461
ID_CREATE_SESSION_RSP = 464
ID_ACTIVATE_SESSION_REQ = 467
ID_ACTIVATE_SESSION_RSP = 470
ID_CLOSE_SESSION_REQ = 473
ID_CLOSE_SESSION_RSP = 476
ID_READ_REQ = 631
ID_READ_RSP = 634
ID_WRITE_REQ = 673
ID_WRITE_RSP = 676
ID_BROWSE_REQ = 527
ID_BROWSE_RSP = 530
ID_ANONYMOUS_IDENTITY_TOKEN = 321   # AnonymousIdentityToken binary encoding
ID_TRANSLATE_BROWSE_PATHS_REQ = 552
ID_TRANSLATE_BROWSE_PATHS_RSP = 555
ID_REGISTER_NODES_REQ = 560
ID_REGISTER_NODES_RSP = 563
ID_UNREGISTER_NODES_REQ = 566
ID_UNREGISTER_NODES_RSP = 569
ID_CREATE_MONITORED_ITEMS_REQ = 751
ID_CREATE_MONITORED_ITEMS_RSP = 754
ID_SET_MONITORING_MODE_REQ = 767
ID_SET_MONITORING_MODE_RSP = 770
ID_DELETE_MONITORED_ITEMS_REQ = 781
ID_DELETE_MONITORED_ITEMS_RSP = 784
ID_CREATE_SUBSCRIPTION_REQ = 787
ID_CREATE_SUBSCRIPTION_RSP = 790
ID_MODIFY_SUBSCRIPTION_REQ = 793
ID_MODIFY_SUBSCRIPTION_RSP = 796
ID_SET_PUBLISHING_MODE_REQ = 799
ID_SET_PUBLISHING_MODE_RSP = 802
ID_DATA_CHANGE_NOTIFICATION = 811   # DataChangeNotification encoding node
ID_DATA_CHANGE_FILTER = 724         # DataChangeFilter encoding node
ID_PUBLISH_REQ = 826
ID_PUBLISH_RSP = 829
ID_REPUBLISH_REQ = 832
ID_REPUBLISH_RSP = 835
ID_DELETE_SUBSCRIPTIONS_REQ = 847
ID_DELETE_SUBSCRIPTIONS_RSP = 850

SECURITY_POLICY_NONE = "http://opcfoundation.org/UA/SecurityPolicy#None"
TRANSPORT_PROFILE_BINARY = (
    "http://opcfoundation.org/UA-Profile/Transport/uatcp-uasc-uabinary")

# StatusCodes (OPC 10000-4 Table 177 / Part 6 Annex)
GOOD = 0x00000000
BAD_UNEXPECTED_ERROR = 0x80010000
BAD_INTERNAL_ERROR = 0x80020000
BAD_TIMEOUT = 0x800A0000
BAD_SERVICE_UNSUPPORTED = 0x800B0000
BAD_COMMUNICATION_ERROR = 0x80050000
BAD_ENCODING_ERROR = 0x80060000
BAD_DECODING_ERROR = 0x80070000
BAD_SECURE_CHANNEL_ID_INVALID = 0x80220000
BAD_SESSION_ID_INVALID = 0x80250000
BAD_SESSION_NOT_ACTIVATED = 0x80270000
BAD_NODE_ID_UNKNOWN = 0x80340000
BAD_ATTRIBUTE_ID_INVALID = 0x80350000
BAD_NOT_READABLE = 0x803A0000
BAD_NOT_WRITABLE = 0x803B0000
BAD_OUT_OF_RANGE = 0x803C0000
BAD_TYPE_MISMATCH = 0x80740000
BAD_SECURITY_POLICY_REJECTED = 0x80550000
BAD_TCP_MESSAGE_TYPE_INVALID = 0x807E0000
BAD_TCP_ENDPOINT_URL_INVALID = 0x80830000
BAD_REQUEST_TOO_LARGE = 0x80B80000
BAD_RESPONSE_TOO_LARGE = 0x80B90000
BAD_NOTHING_TO_DO = 0x800F0000
BAD_NO_MATCH = 0x806F0000
BAD_SUBSCRIPTION_ID_INVALID = 0x80280000
BAD_MONITORED_ITEM_ID_INVALID = 0x80420000
BAD_MONITORED_ITEM_FILTER_INVALID = 0x80430000
BAD_MONITORED_ITEM_FILTER_UNSUPPORTED = 0x80440000
BAD_DEADBAND_FILTER_INVALID = 0x808E0000
BAD_FILTER_NOT_ALLOWED = 0x80450000   # percent deadband w/o EURange
BAD_TOO_MANY_SUBSCRIPTIONS = 0x80770000
BAD_TOO_MANY_PUBLISH_REQUESTS = 0x80780000
BAD_NO_SUBSCRIPTION = 0x80790000
BAD_SEQUENCE_NUMBER_UNKNOWN = 0x807A0000
BAD_MESSAGE_NOT_AVAILABLE = 0x807B0000
BAD_TOO_MANY_MONITORED_ITEMS = 0x80DB0000

# Attribute ids (OPC 10000-3 §5.9)
ATTR_NODE_ID = 1
ATTR_NODE_CLASS = 2
ATTR_BROWSE_NAME = 3
ATTR_DISPLAY_NAME = 4
ATTR_DESCRIPTION = 5
ATTR_VALUE = 13
ATTR_DATA_TYPE = 14
ATTR_VALUE_RANK = 15
ATTR_ACCESS_LEVEL = 17
ATTR_USER_ACCESS_LEVEL = 18

# NodeClass bits
NODECLASS_OBJECT = 1
NODECLASS_VARIABLE = 2

# Well-known namespace-0 nodes
OBJECTS_FOLDER = NodeId(0, 85)
ROOT_FOLDER = NodeId(0, 84)
TYPE_FOLDER = NodeId(0, 61)          # FolderType
TYPE_BASE_DATA_VARIABLE = NodeId(0, 63)
REF_ORGANIZES = NodeId(0, 35)
REF_HAS_TYPE_DEFINITION = NodeId(0, 40)
REF_HIERARCHICAL = NodeId(0, 33)
DT_BOOLEAN = NodeId(0, 1)
DT_DOUBLE = NodeId(0, 11)
TYPE_PROPERTY = NodeId(0, 68)        # PropertyType
REF_HAS_PROPERTY = NodeId(0, 46)
DT_RANGE = NodeId(0, 884)            # Range structure DataType
ID_RANGE_BINARY = 886                # Range default-binary encoding node


# --------------------------------------------------------------------------
# Request / response headers
# --------------------------------------------------------------------------

@dataclass
class RequestHeader:
    auth_token: NodeId = field(default_factory=lambda: NULL_NODE_ID)
    timestamp: int = 0
    request_handle: int = 0
    return_diagnostics: int = 0
    audit_entry_id: Optional[str] = None
    timeout_hint: int = 0

    def encode(self, e: Encoder) -> None:
        e.node_id(self.auth_token)
        e.datetime(self.timestamp)
        e.uint32(self.request_handle)
        e.uint32(self.return_diagnostics)
        e.string(self.audit_entry_id)
        e.uint32(self.timeout_hint)
        e.extension_object(ExtensionObject())   # additionalHeader: none

    @classmethod
    def decode(cls, d: Decoder) -> "RequestHeader":
        h = cls(auth_token=d.node_id(), timestamp=d.datetime(),
                request_handle=d.uint32(), return_diagnostics=d.uint32(),
                audit_entry_id=d.string(), timeout_hint=d.uint32())
        d.extension_object()
        return h


@dataclass
class ResponseHeader:
    timestamp: int = 0
    request_handle: int = 0
    service_result: int = GOOD

    def encode(self, e: Encoder) -> None:
        e.datetime(self.timestamp)
        e.uint32(self.request_handle)
        e.status_code(self.service_result)
        e.diagnostic_info()
        e.array([], lambda enc, s: enc.string(s))   # stringTable
        e.extension_object(ExtensionObject())

    @classmethod
    def decode(cls, d: Decoder) -> "ResponseHeader":
        h = cls(timestamp=d.datetime(), request_handle=d.uint32(),
                service_result=d.status_code())
        d.diagnostic_info()
        d.array(lambda dec: dec.string())
        d.extension_object()
        return h


# --------------------------------------------------------------------------
# Connection protocol messages (HEL / ACK / ERR)
# --------------------------------------------------------------------------

@dataclass
class Hello:
    """With max_chunk_count=1, a whole message must fit one chunk, so
    the buffer sizes ARE the message-size cap (Part 6 §7.1.2) — they
    default to max_message_size rather than a 64 KiB transport buffer
    a single-chunk stack would immediately violate."""

    protocol_version: int = 0
    receive_buffer_size: int = 16 * 1024 * 1024
    send_buffer_size: int = 16 * 1024 * 1024
    max_message_size: int = 16 * 1024 * 1024
    max_chunk_count: int = 1
    endpoint_url: str = ""

    def encode(self) -> bytes:
        e = Encoder()
        e.uint32(self.protocol_version)
        e.uint32(self.receive_buffer_size)
        e.uint32(self.send_buffer_size)
        e.uint32(self.max_message_size)
        e.uint32(self.max_chunk_count)
        e.string(self.endpoint_url)
        return frame("HEL", e.data())

    @classmethod
    def decode(cls, body: bytes) -> "Hello":
        d = Decoder(body)
        return cls(d.uint32(), d.uint32(), d.uint32(), d.uint32(),
                   d.uint32(), d.string() or "")


@dataclass
class Acknowledge:
    protocol_version: int = 0
    receive_buffer_size: int = 16 * 1024 * 1024
    send_buffer_size: int = 16 * 1024 * 1024
    max_message_size: int = 16 * 1024 * 1024
    max_chunk_count: int = 1

    def encode(self) -> bytes:
        e = Encoder()
        e.uint32(self.protocol_version)
        e.uint32(self.receive_buffer_size)
        e.uint32(self.send_buffer_size)
        e.uint32(self.max_message_size)
        e.uint32(self.max_chunk_count)
        return frame("ACK", e.data())

    @classmethod
    def decode(cls, body: bytes) -> "Acknowledge":
        d = Decoder(body)
        return cls(d.uint32(), d.uint32(), d.uint32(), d.uint32(),
                   d.uint32())


def encode_error(status: int, reason: str) -> bytes:
    e = Encoder()
    e.status_code(status)
    e.string(reason)
    return frame("ERR", e.data())


def frame(msg_type: str, body: bytes, chunk: str = "F") -> bytes:
    """8-byte message header + body (OPC 10000-6 §7.1.2)."""
    assert len(msg_type) == 3
    header = msg_type.encode("ascii") + chunk.encode("ascii")
    e = Encoder()
    e.raw(header)
    e.uint32(8 + len(body))
    e.raw(body)
    return e.data()


# --------------------------------------------------------------------------
# Secure conversation headers
# --------------------------------------------------------------------------

@dataclass
class AsymmetricHeader:
    """OPN security header: policy URI + null cert fields for None."""

    secure_channel_id: int = 0
    policy_uri: str = SECURITY_POLICY_NONE

    def encode(self, e: Encoder) -> None:
        e.uint32(self.secure_channel_id)
        e.string(self.policy_uri)
        e.bytestring(None)   # senderCertificate
        e.bytestring(None)   # receiverCertificateThumbprint

    @classmethod
    def decode(cls, d: Decoder) -> "AsymmetricHeader":
        h = cls(secure_channel_id=d.uint32(), policy_uri=d.string() or "")
        d.bytestring()
        d.bytestring()
        return h


@dataclass
class SequenceHeader:
    sequence_number: int = 1
    request_id: int = 1

    def encode(self, e: Encoder) -> None:
        e.uint32(self.sequence_number)
        e.uint32(self.request_id)

    @classmethod
    def decode(cls, d: Decoder) -> "SequenceHeader":
        return cls(d.uint32(), d.uint32())


# --------------------------------------------------------------------------
# Channel / session services
# --------------------------------------------------------------------------

@dataclass
class OpenSecureChannelRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    client_protocol_version: int = 0
    request_type: int = 0        # 0 = issue, 1 = renew
    security_mode: int = 1       # 1 = None
    client_nonce: Optional[bytes] = None
    requested_lifetime_ms: int = 3600_000

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.uint32(self.client_protocol_version)
        e.int32(self.request_type)
        e.int32(self.security_mode)
        e.bytestring(self.client_nonce)
        e.uint32(self.requested_lifetime_ms)

    @classmethod
    def decode(cls, d: Decoder) -> "OpenSecureChannelRequest":
        return cls(RequestHeader.decode(d), d.uint32(), d.int32(),
                   d.int32(), d.bytestring(), d.uint32())


@dataclass
class ChannelSecurityToken:
    channel_id: int = 0
    token_id: int = 0
    created_at: int = 0
    revised_lifetime_ms: int = 3600_000

    def encode(self, e: Encoder) -> None:
        e.uint32(self.channel_id)
        e.uint32(self.token_id)
        e.datetime(self.created_at)
        e.uint32(self.revised_lifetime_ms)

    @classmethod
    def decode(cls, d: Decoder) -> "ChannelSecurityToken":
        return cls(d.uint32(), d.uint32(), d.datetime(), d.uint32())


@dataclass
class OpenSecureChannelResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    server_protocol_version: int = 0
    token: ChannelSecurityToken = field(
        default_factory=ChannelSecurityToken)
    server_nonce: Optional[bytes] = None

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.uint32(self.server_protocol_version)
        self.token.encode(e)
        e.bytestring(self.server_nonce)

    @classmethod
    def decode(cls, d: Decoder) -> "OpenSecureChannelResponse":
        return cls(ResponseHeader.decode(d), d.uint32(),
                   ChannelSecurityToken.decode(d), d.bytestring())


@dataclass
class ApplicationDescription:
    application_uri: str = ""
    product_uri: str = ""
    application_name: LocalizedText = field(
        default_factory=LocalizedText)
    application_type: int = 0    # 0 = server
    discovery_urls: List[str] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        e.string(self.application_uri)
        e.string(self.product_uri)
        e.localized_text(self.application_name)
        e.int32(self.application_type)
        e.string(None)   # gatewayServerUri
        e.string(None)   # discoveryProfileUri
        e.array(self.discovery_urls, lambda enc, s: enc.string(s))

    @classmethod
    def decode(cls, d: Decoder) -> "ApplicationDescription":
        a = cls(d.string() or "", d.string() or "", d.localized_text(),
                d.int32())
        d.string()
        d.string()
        a.discovery_urls = d.array(lambda dec: dec.string()) or []
        return a


@dataclass
class UserTokenPolicy:
    policy_id: str = "anonymous"
    token_type: int = 0          # 0 = anonymous

    def encode(self, e: Encoder) -> None:
        e.string(self.policy_id)
        e.int32(self.token_type)
        e.string(None)   # issuedTokenType
        e.string(None)   # issuerEndpointUrl
        e.string(None)   # securityPolicyUri (inherit endpoint's)

    @classmethod
    def decode(cls, d: Decoder) -> "UserTokenPolicy":
        p = cls(d.string() or "", d.int32())
        d.string()
        d.string()
        d.string()
        return p


@dataclass
class EndpointDescription:
    endpoint_url: str = ""
    server: ApplicationDescription = field(
        default_factory=ApplicationDescription)
    security_mode: int = 1       # MessageSecurityMode None
    security_policy_uri: str = SECURITY_POLICY_NONE
    user_identity_tokens: List[UserTokenPolicy] = field(
        default_factory=lambda: [UserTokenPolicy()])
    security_level: int = 0

    def encode(self, e: Encoder) -> None:
        e.string(self.endpoint_url)
        self.server.encode(e)
        e.bytestring(None)   # serverCertificate
        e.int32(self.security_mode)
        e.string(self.security_policy_uri)
        e.array(self.user_identity_tokens,
                lambda enc, t: t.encode(enc))
        e.string(TRANSPORT_PROFILE_BINARY)
        e.byte(self.security_level)

    @classmethod
    def decode(cls, d: Decoder) -> "EndpointDescription":
        ep = cls(d.string() or "", ApplicationDescription.decode(d))
        d.bytestring()
        ep.security_mode = d.int32()
        ep.security_policy_uri = d.string() or ""
        ep.user_identity_tokens = d.array(UserTokenPolicy.decode) or []
        d.string()
        ep.security_level = d.byte()
        return ep


@dataclass
class GetEndpointsRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    endpoint_url: str = ""

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.string(self.endpoint_url)
        e.array([], lambda enc, s: enc.string(s))   # localeIds
        e.array([], lambda enc, s: enc.string(s))   # profileUris

    @classmethod
    def decode(cls, d: Decoder) -> "GetEndpointsRequest":
        r = cls(RequestHeader.decode(d), d.string() or "")
        d.array(lambda dec: dec.string())
        d.array(lambda dec: dec.string())
        return r


@dataclass
class GetEndpointsResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    endpoints: List[EndpointDescription] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.endpoints, lambda enc, ep: ep.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "GetEndpointsResponse":
        return cls(ResponseHeader.decode(d),
                   d.array(EndpointDescription.decode) or [])


@dataclass
class CreateSessionRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    client_description: ApplicationDescription = field(
        default_factory=ApplicationDescription)
    endpoint_url: str = ""
    session_name: str = ""
    client_nonce: Optional[bytes] = None
    requested_timeout_ms: float = 3600_000.0
    max_response_size: int = 16 * 1024 * 1024

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        self.client_description.encode(e)
        e.string(None)   # serverUri
        e.string(self.endpoint_url)
        e.string(self.session_name)
        e.bytestring(self.client_nonce)
        e.bytestring(None)   # clientCertificate
        e.double(self.requested_timeout_ms)
        e.uint32(self.max_response_size)

    @classmethod
    def decode(cls, d: Decoder) -> "CreateSessionRequest":
        h = RequestHeader.decode(d)
        desc = ApplicationDescription.decode(d)
        d.string()
        r = cls(h, desc, d.string() or "", d.string() or "",
                d.bytestring())
        d.bytestring()
        r.requested_timeout_ms = d.double()
        r.max_response_size = d.uint32()
        return r


@dataclass
class CreateSessionResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    session_id: NodeId = field(default_factory=lambda: NULL_NODE_ID)
    auth_token: NodeId = field(default_factory=lambda: NULL_NODE_ID)
    revised_timeout_ms: float = 3600_000.0
    endpoints: List[EndpointDescription] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.node_id(self.session_id)
        e.node_id(self.auth_token)
        e.double(self.revised_timeout_ms)
        e.bytestring(None)   # serverNonce
        e.bytestring(None)   # serverCertificate
        e.array(self.endpoints, lambda enc, ep: ep.encode(enc))
        e.array([], lambda enc, c: None)   # serverSoftwareCertificates
        e.string(None)       # serverSignature.algorithm
        e.bytestring(None)   # serverSignature.signature
        e.uint32(16 * 1024 * 1024)   # maxRequestMessageSize

    @classmethod
    def decode(cls, d: Decoder) -> "CreateSessionResponse":
        r = cls(ResponseHeader.decode(d), d.node_id(), d.node_id(),
                d.double())
        d.bytestring()
        d.bytestring()
        r.endpoints = d.array(EndpointDescription.decode) or []
        d.array(lambda dec: (dec.bytestring(), dec.bytestring()))
        d.string()
        d.bytestring()
        d.uint32()
        return r


@dataclass
class ActivateSessionRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    identity_token: ExtensionObject = field(
        default_factory=lambda: _anonymous_token())

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.string(None)       # clientSignature.algorithm
        e.bytestring(None)   # clientSignature.signature
        e.array([], lambda enc, c: None)   # clientSoftwareCertificates
        e.array([], lambda enc, s: enc.string(s))   # localeIds
        e.extension_object(self.identity_token)
        e.string(None)       # userTokenSignature.algorithm
        e.bytestring(None)   # userTokenSignature.signature

    @classmethod
    def decode(cls, d: Decoder) -> "ActivateSessionRequest":
        h = RequestHeader.decode(d)
        d.string()
        d.bytestring()
        d.array(lambda dec: (dec.bytestring(), dec.bytestring()))
        d.array(lambda dec: dec.string())
        tok = d.extension_object()
        d.string()
        d.bytestring()
        return cls(h, tok)


def _anonymous_token() -> ExtensionObject:
    body = Encoder().string("anonymous").data()
    return ExtensionObject(NodeId(0, ID_ANONYMOUS_IDENTITY_TOKEN), body)


@dataclass
class ActivateSessionResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.bytestring(None)   # serverNonce
        e.array([], lambda enc, s: enc.status_code(s))
        e.array([], lambda enc, s: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "ActivateSessionResponse":
        r = cls(ResponseHeader.decode(d))
        d.bytestring()
        d.array(lambda dec: dec.status_code())
        d.array(lambda dec: dec.diagnostic_info())
        return r


@dataclass
class CloseSessionRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    delete_subscriptions: bool = True

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.boolean(self.delete_subscriptions)

    @classmethod
    def decode(cls, d: Decoder) -> "CloseSessionRequest":
        return cls(RequestHeader.decode(d), d.boolean())


@dataclass
class CloseSessionResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)

    @classmethod
    def decode(cls, d: Decoder) -> "CloseSessionResponse":
        return cls(ResponseHeader.decode(d))


# --------------------------------------------------------------------------
# Attribute services
# --------------------------------------------------------------------------

@dataclass
class ReadValueId:
    node_id: NodeId = field(default_factory=lambda: NULL_NODE_ID)
    attribute_id: int = ATTR_VALUE

    def encode(self, e: Encoder) -> None:
        e.node_id(self.node_id)
        e.uint32(self.attribute_id)
        e.string(None)                       # indexRange
        e.qualified_name(QualifiedName())    # dataEncoding

    @classmethod
    def decode(cls, d: Decoder) -> "ReadValueId":
        r = cls(d.node_id(), d.uint32())
        d.string()
        d.qualified_name()
        return r


@dataclass
class ReadRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    max_age: float = 0.0
    timestamps_to_return: int = 0    # 0 = Source
    nodes: List[ReadValueId] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.double(self.max_age)
        e.int32(self.timestamps_to_return)
        e.array(self.nodes, lambda enc, n: n.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "ReadRequest":
        return cls(RequestHeader.decode(d), d.double(), d.int32(),
                   d.array(ReadValueId.decode) or [])


@dataclass
class ReadResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    results: List[DataValue] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.results, lambda enc, v: enc.data_value(v))
        e.array([], lambda enc, x: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "ReadResponse":
        r = cls(ResponseHeader.decode(d),
                d.array(lambda dec: dec.data_value()) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return r


@dataclass
class WriteValue:
    node_id: NodeId = field(default_factory=lambda: NULL_NODE_ID)
    attribute_id: int = ATTR_VALUE
    value: DataValue = field(default_factory=DataValue)

    def encode(self, e: Encoder) -> None:
        e.node_id(self.node_id)
        e.uint32(self.attribute_id)
        e.string(None)   # indexRange
        e.data_value(self.value)

    @classmethod
    def decode(cls, d: Decoder) -> "WriteValue":
        w = cls(d.node_id(), d.uint32())
        d.string()
        w.value = d.data_value()
        return w


@dataclass
class WriteRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    nodes: List[WriteValue] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.nodes, lambda enc, n: n.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "WriteRequest":
        return cls(RequestHeader.decode(d),
                   d.array(WriteValue.decode) or [])


@dataclass
class WriteResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    results: List[int] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.results, lambda enc, s: enc.status_code(s))
        e.array([], lambda enc, x: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "WriteResponse":
        r = cls(ResponseHeader.decode(d),
                d.array(lambda dec: dec.status_code()) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return r


# --------------------------------------------------------------------------
# View service (Browse)
# --------------------------------------------------------------------------

@dataclass
class BrowseDescription:
    node_id: NodeId = field(default_factory=lambda: OBJECTS_FOLDER)
    direction: int = 0               # 0 = forward
    reference_type: NodeId = field(
        default_factory=lambda: REF_HIERARCHICAL)
    include_subtypes: bool = True
    node_class_mask: int = 0         # 0 = all
    result_mask: int = 0x3F          # everything

    def encode(self, e: Encoder) -> None:
        e.node_id(self.node_id)
        e.int32(self.direction)
        e.node_id(self.reference_type)
        e.boolean(self.include_subtypes)
        e.uint32(self.node_class_mask)
        e.uint32(self.result_mask)

    @classmethod
    def decode(cls, d: Decoder) -> "BrowseDescription":
        return cls(d.node_id(), d.int32(), d.node_id(), d.boolean(),
                   d.uint32(), d.uint32())


@dataclass
class ReferenceDescription:
    reference_type: NodeId = field(
        default_factory=lambda: REF_ORGANIZES)
    is_forward: bool = True
    node_id: NodeId = field(default_factory=lambda: NULL_NODE_ID)
    browse_name: QualifiedName = field(default_factory=QualifiedName)
    display_name: LocalizedText = field(default_factory=LocalizedText)
    node_class: int = NODECLASS_VARIABLE
    type_definition: NodeId = field(
        default_factory=lambda: TYPE_BASE_DATA_VARIABLE)

    def encode(self, e: Encoder) -> None:
        e.node_id(self.reference_type)
        e.boolean(self.is_forward)
        e.expanded_node_id(self.node_id)
        e.qualified_name(self.browse_name)
        e.localized_text(self.display_name)
        e.uint32(self.node_class)
        e.expanded_node_id(self.type_definition)

    @classmethod
    def decode(cls, d: Decoder) -> "ReferenceDescription":
        return cls(d.node_id(), d.boolean(), d.expanded_node_id(),
                   d.qualified_name(), d.localized_text(), d.uint32(),
                   d.expanded_node_id())


@dataclass
class BrowseResult:
    status: int = GOOD
    references: List[ReferenceDescription] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        e.status_code(self.status)
        e.bytestring(None)   # continuationPoint
        e.array(self.references, lambda enc, r: r.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "BrowseResult":
        r = cls(d.status_code())
        d.bytestring()
        r.references = d.array(ReferenceDescription.decode) or []
        return r


@dataclass
class BrowseRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    max_references: int = 0
    nodes: List[BrowseDescription] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.node_id(NULL_NODE_ID)   # view.viewId
        e.datetime(0)             # view.timestamp
        e.uint32(0)               # view.viewVersion
        e.uint32(self.max_references)
        e.array(self.nodes, lambda enc, n: n.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "BrowseRequest":
        h = RequestHeader.decode(d)
        d.node_id()
        d.datetime()
        d.uint32()
        return cls(h, d.uint32(), d.array(BrowseDescription.decode) or [])


@dataclass
class BrowseResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    results: List[BrowseResult] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.results, lambda enc, r: r.encode(enc))
        e.array([], lambda enc, x: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "BrowseResponse":
        r = cls(ResponseHeader.decode(d),
                d.array(BrowseResult.decode) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return r


@dataclass
class ServiceFault:
    header: ResponseHeader = field(default_factory=ResponseHeader)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)

    @classmethod
    def decode(cls, d: Decoder) -> "ServiceFault":
        return cls(ResponseHeader.decode(d))


# --------------------------------------------------------------------------
# View service: TranslateBrowsePathsToNodeIds (OPC 10000-4 §5.8.4)
# --------------------------------------------------------------------------

@dataclass
class RelativePathElement:
    reference_type: NodeId = field(
        default_factory=lambda: REF_HIERARCHICAL)
    is_inverse: bool = False
    include_subtypes: bool = True
    target_name: QualifiedName = field(default_factory=QualifiedName)

    def encode(self, e: Encoder) -> None:
        e.node_id(self.reference_type)
        e.boolean(self.is_inverse)
        e.boolean(self.include_subtypes)
        e.qualified_name(self.target_name)

    @classmethod
    def decode(cls, d: Decoder) -> "RelativePathElement":
        return cls(d.node_id(), d.boolean(), d.boolean(),
                   d.qualified_name())


@dataclass
class BrowsePath:
    starting_node: NodeId = field(default_factory=lambda: ROOT_FOLDER)
    elements: List[RelativePathElement] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        e.node_id(self.starting_node)
        e.array(self.elements, lambda enc, el: el.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "BrowsePath":
        return cls(d.node_id(),
                   d.array(RelativePathElement.decode) or [])


@dataclass
class BrowsePathTarget:
    target_id: NodeId = field(default_factory=lambda: NULL_NODE_ID)
    remaining_path_index: int = 0xFFFFFFFF   # max = whole path matched

    def encode(self, e: Encoder) -> None:
        e.expanded_node_id(self.target_id)
        e.uint32(self.remaining_path_index)

    @classmethod
    def decode(cls, d: Decoder) -> "BrowsePathTarget":
        return cls(d.expanded_node_id(), d.uint32())


@dataclass
class BrowsePathResult:
    status: int = GOOD
    targets: List[BrowsePathTarget] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        e.status_code(self.status)
        e.array(self.targets, lambda enc, t: t.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "BrowsePathResult":
        return cls(d.status_code(),
                   d.array(BrowsePathTarget.decode) or [])


@dataclass
class RegisterNodesRequest:
    """Part 4 §5.8.5 — optimization hint: the client asks for ids it can
    use for repeated access. A server MAY return the ids unchanged."""
    header: RequestHeader = field(default_factory=RequestHeader)
    nodes_to_register: List[NodeId] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.nodes_to_register, lambda enc, n: enc.node_id(n))

    @classmethod
    def decode(cls, d: Decoder) -> "RegisterNodesRequest":
        return cls(RequestHeader.decode(d),
                   d.array(lambda dd: dd.node_id()) or [])


@dataclass
class RegisterNodesResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    registered_node_ids: List[NodeId] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.registered_node_ids, lambda enc, n: enc.node_id(n))

    @classmethod
    def decode(cls, d: Decoder) -> "RegisterNodesResponse":
        return cls(ResponseHeader.decode(d),
                   d.array(lambda dd: dd.node_id()) or [])


@dataclass
class UnregisterNodesRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    nodes_to_unregister: List[NodeId] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.nodes_to_unregister, lambda enc, n: enc.node_id(n))

    @classmethod
    def decode(cls, d: Decoder) -> "UnregisterNodesRequest":
        return cls(RequestHeader.decode(d),
                   d.array(lambda dd: dd.node_id()) or [])


@dataclass
class UnregisterNodesResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)

    @classmethod
    def decode(cls, d: Decoder) -> "UnregisterNodesResponse":
        return cls(ResponseHeader.decode(d))


@dataclass
class TranslateBrowsePathsRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    paths: List[BrowsePath] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.paths, lambda enc, p: p.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "TranslateBrowsePathsRequest":
        return cls(RequestHeader.decode(d),
                   d.array(BrowsePath.decode) or [])


@dataclass
class TranslateBrowsePathsResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    results: List[BrowsePathResult] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.results, lambda enc, r: r.encode(enc))
        e.array([], lambda enc, x: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "TranslateBrowsePathsResponse":
        r = cls(ResponseHeader.decode(d),
                d.array(BrowsePathResult.decode) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return r


# --------------------------------------------------------------------------
# Subscription services (OPC 10000-4 §5.13 / §5.12)
# --------------------------------------------------------------------------

@dataclass
class CreateSubscriptionRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    requested_publishing_interval_ms: float = 1000.0
    requested_lifetime_count: int = 60
    requested_max_keepalive_count: int = 10
    max_notifications_per_publish: int = 0   # 0 = unlimited
    publishing_enabled: bool = True
    priority: int = 0

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.double(self.requested_publishing_interval_ms)
        e.uint32(self.requested_lifetime_count)
        e.uint32(self.requested_max_keepalive_count)
        e.uint32(self.max_notifications_per_publish)
        e.boolean(self.publishing_enabled)
        e.byte(self.priority)

    @classmethod
    def decode(cls, d: Decoder) -> "CreateSubscriptionRequest":
        return cls(RequestHeader.decode(d), d.double(), d.uint32(),
                   d.uint32(), d.uint32(), d.boolean(), d.byte())


@dataclass
class CreateSubscriptionResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    subscription_id: int = 0
    revised_publishing_interval_ms: float = 1000.0
    revised_lifetime_count: int = 60
    revised_max_keepalive_count: int = 10

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.uint32(self.subscription_id)
        e.double(self.revised_publishing_interval_ms)
        e.uint32(self.revised_lifetime_count)
        e.uint32(self.revised_max_keepalive_count)

    @classmethod
    def decode(cls, d: Decoder) -> "CreateSubscriptionResponse":
        return cls(ResponseHeader.decode(d), d.uint32(), d.double(),
                   d.uint32(), d.uint32())


@dataclass
class ModifySubscriptionRequest:
    """Part 4 §5.13.3 — revise an existing subscription's publishing
    interval / lifetime / keepalive / notification cap / priority."""
    header: RequestHeader = field(default_factory=RequestHeader)
    subscription_id: int = 0
    requested_publishing_interval_ms: float = 1000.0
    requested_lifetime_count: int = 60
    requested_max_keepalive_count: int = 10
    max_notifications_per_publish: int = 0   # 0 = unlimited
    priority: int = 0

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.uint32(self.subscription_id)
        e.double(self.requested_publishing_interval_ms)
        e.uint32(self.requested_lifetime_count)
        e.uint32(self.requested_max_keepalive_count)
        e.uint32(self.max_notifications_per_publish)
        e.byte(self.priority)

    @classmethod
    def decode(cls, d: Decoder) -> "ModifySubscriptionRequest":
        return cls(RequestHeader.decode(d), d.uint32(), d.double(),
                   d.uint32(), d.uint32(), d.uint32(), d.byte())


@dataclass
class ModifySubscriptionResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    revised_publishing_interval_ms: float = 1000.0
    revised_lifetime_count: int = 60
    revised_max_keepalive_count: int = 10

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.double(self.revised_publishing_interval_ms)
        e.uint32(self.revised_lifetime_count)
        e.uint32(self.revised_max_keepalive_count)

    @classmethod
    def decode(cls, d: Decoder) -> "ModifySubscriptionResponse":
        return cls(ResponseHeader.decode(d), d.double(), d.uint32(),
                   d.uint32())


@dataclass
class DataChangeFilter:
    """Part 4 §7.22.2 — when to report a monitored item's change.
    Trigger: 0 Status / 1 StatusValue / 2 StatusValueTimestamp.
    DeadbandType: 0 None / 1 Absolute / 2 Percent."""
    trigger: int = 1
    deadband_type: int = 0
    deadband_value: float = 0.0

    def encode(self, e: Encoder) -> None:
        e.int32(self.trigger)
        e.uint32(self.deadband_type)
        e.double(self.deadband_value)

    @classmethod
    def decode(cls, d: Decoder) -> "DataChangeFilter":
        return cls(d.int32(), d.uint32(), d.double())

    def to_extension_object(self) -> ExtensionObject:
        e = Encoder()
        self.encode(e)
        return ExtensionObject(NodeId(0, ID_DATA_CHANGE_FILTER), e.data())


@dataclass
class MonitoringParameters:
    client_handle: int = 0
    sampling_interval_ms: float = -1.0   # -1 = use publishing interval
    filter: ExtensionObject = field(default_factory=ExtensionObject)
    queue_size: int = 1
    discard_oldest: bool = True

    def encode(self, e: Encoder) -> None:
        e.uint32(self.client_handle)
        e.double(self.sampling_interval_ms)
        e.extension_object(self.filter)
        e.uint32(self.queue_size)
        e.boolean(self.discard_oldest)

    @classmethod
    def decode(cls, d: Decoder) -> "MonitoringParameters":
        return cls(d.uint32(), d.double(), d.extension_object(),
                   d.uint32(), d.boolean())


@dataclass
class MonitoredItemCreateRequest:
    item_to_monitor: ReadValueId = field(default_factory=ReadValueId)
    monitoring_mode: int = 2    # 0 disabled / 1 sampling / 2 reporting
    requested_parameters: MonitoringParameters = field(
        default_factory=MonitoringParameters)

    def encode(self, e: Encoder) -> None:
        self.item_to_monitor.encode(e)
        e.int32(self.monitoring_mode)
        self.requested_parameters.encode(e)

    @classmethod
    def decode(cls, d: Decoder) -> "MonitoredItemCreateRequest":
        return cls(ReadValueId.decode(d), d.int32(),
                   MonitoringParameters.decode(d))


@dataclass
class MonitoredItemCreateResult:
    status: int = GOOD
    monitored_item_id: int = 0
    revised_sampling_interval_ms: float = 0.0
    revised_queue_size: int = 1
    filter_result: ExtensionObject = field(
        default_factory=ExtensionObject)

    def encode(self, e: Encoder) -> None:
        e.status_code(self.status)
        e.uint32(self.monitored_item_id)
        e.double(self.revised_sampling_interval_ms)
        e.uint32(self.revised_queue_size)
        e.extension_object(self.filter_result)

    @classmethod
    def decode(cls, d: Decoder) -> "MonitoredItemCreateResult":
        return cls(d.status_code(), d.uint32(), d.double(), d.uint32(),
                   d.extension_object())


@dataclass
class CreateMonitoredItemsRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    subscription_id: int = 0
    timestamps_to_return: int = 0
    items: List[MonitoredItemCreateRequest] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.uint32(self.subscription_id)
        e.int32(self.timestamps_to_return)
        e.array(self.items, lambda enc, i: i.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "CreateMonitoredItemsRequest":
        return cls(RequestHeader.decode(d), d.uint32(), d.int32(),
                   d.array(MonitoredItemCreateRequest.decode) or [])


@dataclass
class CreateMonitoredItemsResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    results: List[MonitoredItemCreateResult] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.results, lambda enc, r: r.encode(enc))
        e.array([], lambda enc, x: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "CreateMonitoredItemsResponse":
        r = cls(ResponseHeader.decode(d),
                d.array(MonitoredItemCreateResult.decode) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return r


@dataclass
class DeleteMonitoredItemsRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    subscription_id: int = 0
    monitored_item_ids: List[int] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.uint32(self.subscription_id)
        e.array(self.monitored_item_ids, lambda enc, i: enc.uint32(i))

    @classmethod
    def decode(cls, d: Decoder) -> "DeleteMonitoredItemsRequest":
        return cls(RequestHeader.decode(d), d.uint32(),
                   d.array(lambda dec: dec.uint32()) or [])


@dataclass
class DeleteMonitoredItemsResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    results: List[int] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.results, lambda enc, s: enc.status_code(s))
        e.array([], lambda enc, x: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "DeleteMonitoredItemsResponse":
        r = cls(ResponseHeader.decode(d),
                d.array(lambda dec: dec.status_code()) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return r


@dataclass
class SetPublishingModeRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    publishing_enabled: bool = True
    subscription_ids: List[int] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.boolean(self.publishing_enabled)
        e.array(self.subscription_ids, lambda enc, i: enc.uint32(i))

    @classmethod
    def decode(cls, d: Decoder) -> "SetPublishingModeRequest":
        return cls(RequestHeader.decode(d), d.boolean(),
                   d.array(lambda dec: dec.uint32()) or [])


@dataclass
class SetPublishingModeResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    results: List[int] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.results, lambda enc, s: enc.status_code(s))
        e.array([], lambda enc, x: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "SetPublishingModeResponse":
        r = cls(ResponseHeader.decode(d),
                d.array(lambda dec: dec.status_code()) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return r


@dataclass
class SetMonitoringModeRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    subscription_id: int = 0
    monitoring_mode: int = 2
    monitored_item_ids: List[int] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.uint32(self.subscription_id)
        e.int32(self.monitoring_mode)
        e.array(self.monitored_item_ids, lambda enc, i: enc.uint32(i))

    @classmethod
    def decode(cls, d: Decoder) -> "SetMonitoringModeRequest":
        return cls(RequestHeader.decode(d), d.uint32(), d.int32(),
                   d.array(lambda dec: dec.uint32()) or [])


@dataclass
class SetMonitoringModeResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    results: List[int] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.results, lambda enc, s: enc.status_code(s))
        e.array([], lambda enc, x: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "SetMonitoringModeResponse":
        r = cls(ResponseHeader.decode(d),
                d.array(lambda dec: dec.status_code()) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return r


@dataclass
class SubscriptionAcknowledgement:
    subscription_id: int = 0
    sequence_number: int = 0

    def encode(self, e: Encoder) -> None:
        e.uint32(self.subscription_id)
        e.uint32(self.sequence_number)

    @classmethod
    def decode(cls, d: Decoder) -> "SubscriptionAcknowledgement":
        return cls(d.uint32(), d.uint32())


@dataclass
class PublishRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    acknowledgements: List[SubscriptionAcknowledgement] = field(
        default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.acknowledgements, lambda enc, a: a.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "PublishRequest":
        return cls(RequestHeader.decode(d),
                   d.array(SubscriptionAcknowledgement.decode) or [])


@dataclass
class MonitoredItemNotification:
    client_handle: int = 0
    value: DataValue = field(default_factory=DataValue)

    def encode(self, e: Encoder) -> None:
        e.uint32(self.client_handle)
        e.data_value(self.value)

    @classmethod
    def decode(cls, d: Decoder) -> "MonitoredItemNotification":
        return cls(d.uint32(), d.data_value())


@dataclass
class DataChangeNotification:
    """Carried inside NotificationMessage as an ExtensionObject
    (type id 811, DataChangeNotification_Encoding_DefaultBinary)."""

    monitored_items: List[MonitoredItemNotification] = field(
        default_factory=list)

    def to_extension_object(self) -> ExtensionObject:
        e = Encoder()
        e.array(self.monitored_items, lambda enc, m: m.encode(enc))
        e.array([], lambda enc, x: enc.diagnostic_info())
        return ExtensionObject(NodeId(0, ID_DATA_CHANGE_NOTIFICATION),
                               e.data())

    @classmethod
    def from_extension_object(
            cls, obj: ExtensionObject) -> "DataChangeNotification":
        if obj.type_id != NodeId(0, ID_DATA_CHANGE_NOTIFICATION):
            raise DecodeError(
                f"not a DataChangeNotification: {obj.type_id}")
        d = Decoder(obj.body or b"")
        out = cls(d.array(MonitoredItemNotification.decode) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return out


@dataclass
class NotificationMessage:
    sequence_number: int = 1
    publish_time: int = 0
    notification_data: List[ExtensionObject] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        e.uint32(self.sequence_number)
        e.datetime(self.publish_time)
        e.array(self.notification_data,
                lambda enc, o: enc.extension_object(o))

    @classmethod
    def decode(cls, d: Decoder) -> "NotificationMessage":
        return cls(d.uint32(), d.datetime(),
                   d.array(lambda dec: dec.extension_object()) or [])


@dataclass
class PublishResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    subscription_id: int = 0
    available_sequence_numbers: List[int] = field(default_factory=list)
    more_notifications: bool = False
    notification_message: NotificationMessage = field(
        default_factory=NotificationMessage)
    results: List[int] = field(default_factory=list)   # ack statuses

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.uint32(self.subscription_id)
        e.array(self.available_sequence_numbers,
                lambda enc, s: enc.uint32(s))
        e.boolean(self.more_notifications)
        self.notification_message.encode(e)
        e.array(self.results, lambda enc, s: enc.status_code(s))
        e.array([], lambda enc, x: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "PublishResponse":
        r = cls(ResponseHeader.decode(d), d.uint32(),
                d.array(lambda dec: dec.uint32()) or [], d.boolean(),
                NotificationMessage.decode(d),
                d.array(lambda dec: dec.status_code()) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return r


@dataclass
class RepublishRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    subscription_id: int = 0
    retransmit_sequence_number: int = 0

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.uint32(self.subscription_id)
        e.uint32(self.retransmit_sequence_number)

    @classmethod
    def decode(cls, d: Decoder) -> "RepublishRequest":
        return cls(RequestHeader.decode(d), d.uint32(), d.uint32())


@dataclass
class RepublishResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    notification_message: NotificationMessage = field(
        default_factory=NotificationMessage)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        self.notification_message.encode(e)

    @classmethod
    def decode(cls, d: Decoder) -> "RepublishResponse":
        return cls(ResponseHeader.decode(d),
                   NotificationMessage.decode(d))


@dataclass
class DeleteSubscriptionsRequest:
    header: RequestHeader = field(default_factory=RequestHeader)
    subscription_ids: List[int] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.subscription_ids, lambda enc, i: enc.uint32(i))

    @classmethod
    def decode(cls, d: Decoder) -> "DeleteSubscriptionsRequest":
        return cls(RequestHeader.decode(d),
                   d.array(lambda dec: dec.uint32()) or [])


@dataclass
class DeleteSubscriptionsResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    results: List[int] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        e.array(self.results, lambda enc, s: enc.status_code(s))
        e.array([], lambda enc, x: enc.diagnostic_info())

    @classmethod
    def decode(cls, d: Decoder) -> "DeleteSubscriptionsResponse":
        r = cls(ResponseHeader.decode(d),
                d.array(lambda dec: dec.status_code()) or [])
        d.array(lambda dec: dec.diagnostic_info())
        return r


# --------------------------------------------------------------------------
# Message body helpers
# --------------------------------------------------------------------------

def encode_service(type_id: int, struct_obj) -> bytes:
    """TypeId NodeId + struct body — the payload after the sequence
    header in OPN/MSG chunks."""
    e = Encoder()
    e.node_id(NodeId(0, type_id))
    struct_obj.encode(e)
    return e.data()


def decode_service_id(d: Decoder) -> int:
    n = d.node_id()
    if n.namespace != 0 or not isinstance(n.identifier, int):
        raise DecodeError(f"non-standard service type id {n}")
    return n.identifier


def read_exact_message(data: bytes) -> Optional[tuple]:
    """Split one framed message off ``data``: returns
    ``(msg_type, chunk_type, body, rest)`` or None if incomplete."""
    if len(data) < 8:
        return None
    msg_type = data[0:3].decode("ascii", "replace")
    chunk_type = chr(data[3])
    size = int.from_bytes(data[4:8], "little")
    # 16 MiB = the max_message_size the server advertises in ACK; a
    # larger declared size is rejected before any buffering happens.
    if size < 8 or size > 16 * 1024 * 1024:
        raise DecodeError(f"bad message size {size}")
    if len(data) < size:
        return None
    return msg_type, chunk_type, data[8:size], data[size:]
