"""
Minimal synchronous OPC UA client (binary transport, policy None).

Counterpart to :mod:`.server` — a blocking-socket client that speaks the
same from-scratch UA Binary implementation: HEL/ACK, OpenSecureChannel
(None), CreateSession + anonymous ActivateSession, then Read / Write /
Browse. Used by the live tests, the load generator, and usable as a
library surface the way ``modbus.client.ModbusTcpClient`` is::

    with OPCUAClient("127.0.0.1", 4840) as c:
        c.read_double("u1.outlet_chlorine")
        c.write_double("u1.chlorine_flow_rate", 0.8)
        c.browse("u1")               # -> register names

Node ids are the ``ns=1;s=u<unit>.<register>`` strings the server
publishes (see server.py docstring).
"""

from __future__ import annotations

import socket
import struct
import time
from typing import List, Optional, Tuple, Union

from ics_wt_physicsengine_torch.opcua import messages as M
from ics_wt_physicsengine_torch.opcua.encoding import (
    DataValue,
    DecodeError,
    Decoder,
    Encoder,
    NodeId,
    Variant,
    VT_BOOLEAN,
    VT_DOUBLE,
    unix_to_filetime,
)


class OPCUAError(RuntimeError):
    """Service or transport-level failure (carries the StatusCode)."""

    def __init__(self, status: int, context: str = ""):
        super().__init__(f"OPC UA error 0x{status:08X}"
                         + (f" ({context})" if context else ""))
        self.status = status


class OPCUAClient:
    """Blocking OPC UA client for one server endpoint."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._seq = 0
        self._req_id = 0
        self._handle = 0
        self._channel_id = 0
        self._token_id = 0
        self._auth_token: NodeId = NodeId(0, 0)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def connect(self) -> "OPCUAClient":
        # Reset per-connection state so a client instance can be
        # reconnected after close() without stale buffer bytes or
        # channel/session ids leaking into the new connection.
        self._buf = b""
        self._seq = 0
        self._req_id = 0
        self._handle = 0
        self._channel_id = 0
        self._token_id = 0
        self._auth_token = NodeId(0, 0)
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout)
        url = f"opc.tcp://{self.host}:{self.port}/plant"
        self._sock.sendall(M.Hello(endpoint_url=url).encode())
        msg_type, _, body = self._recv()
        if msg_type == "ERR":
            raise self._decode_err(body)
        if msg_type != "ACK":
            raise OPCUAError(M.BAD_TCP_MESSAGE_TYPE_INVALID,
                             f"expected ACK, got {msg_type}")
        M.Acknowledge.decode(body)
        self._open_channel()
        self._create_session(url)
        return self

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            req = M.CloseSessionRequest(self._request_header())
            self._service(M.ID_CLOSE_SESSION_REQ, req,
                          M.ID_CLOSE_SESSION_RSP,
                          M.CloseSessionResponse.decode)
        except (OSError, OPCUAError, DecodeError):
            pass
        try:
            self._sock.sendall(M.frame("CLO", b""))
        except OSError:
            pass
        self._sock.close()
        self._sock = None

    def __enter__(self) -> "OPCUAClient":
        if self._sock is None:
            self.connect()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # Handshake
    # ------------------------------------------------------------------

    def _open_channel(self) -> None:
        self._seq += 1
        self._req_id += 1
        req = M.OpenSecureChannelRequest(self._request_header())
        e = Encoder()
        M.AsymmetricHeader(0).encode(e)
        M.SequenceHeader(self._seq, self._req_id).encode(e)
        e.raw(M.encode_service(M.ID_OPEN_CHANNEL_REQ, req))
        self._sock.sendall(M.frame("OPN", e.data()))
        msg_type, _, body = self._recv()
        if msg_type == "ERR":
            raise self._decode_err(body)
        if msg_type != "OPN":
            raise OPCUAError(M.BAD_TCP_MESSAGE_TYPE_INVALID,
                             f"expected OPN, got {msg_type}")
        d = Decoder(body)
        M.AsymmetricHeader.decode(d)
        M.SequenceHeader.decode(d)
        if M.decode_service_id(d) != M.ID_OPEN_CHANNEL_RSP:
            raise OPCUAError(M.BAD_DECODING_ERROR, "bad OPN response")
        rsp = M.OpenSecureChannelResponse.decode(d)
        self._check(rsp.header.service_result, "OpenSecureChannel")
        self._channel_id = rsp.token.channel_id
        self._token_id = rsp.token.token_id

    def _create_session(self, url: str) -> None:
        req = M.CreateSessionRequest(
            self._request_header(),
            client_description=M.ApplicationDescription(
                application_uri="urn:ics-wt-physicsengine-tpu:client",
                product_uri="urn:ics-wt-physicsengine-tpu"),
            endpoint_url=url, session_name="wt-client")
        rsp = self._service(M.ID_CREATE_SESSION_REQ, req,
                            M.ID_CREATE_SESSION_RSP,
                            M.CreateSessionResponse.decode)
        self._check(rsp.header.service_result, "CreateSession")
        self._auth_token = rsp.auth_token
        act = M.ActivateSessionRequest(self._request_header())
        arsp = self._service(M.ID_ACTIVATE_SESSION_REQ, act,
                             M.ID_ACTIVATE_SESSION_RSP,
                             M.ActivateSessionResponse.decode)
        self._check(arsp.header.service_result, "ActivateSession")

    # ------------------------------------------------------------------
    # Wire helpers
    # ------------------------------------------------------------------

    def _request_header(self) -> M.RequestHeader:
        self._handle += 1
        return M.RequestHeader(auth_token=self._auth_token,
                               timestamp=unix_to_filetime(time.time()),
                               request_handle=self._handle,
                               timeout_hint=int(self.timeout * 1000))

    def _recv(self, timeout: Optional[float] = None
              ) -> Tuple[str, str, bytes]:
        deadline = time.monotonic() + (timeout or self.timeout)
        while True:
            split = M.read_exact_message(self._buf)
            if split is not None:
                msg_type, chunk_type, body, self._buf = split
                return msg_type, chunk_type, body
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise OPCUAError(M.BAD_TIMEOUT, "receive timeout")
            self._sock.settimeout(min(remaining, self.timeout))
            try:
                chunk = self._sock.recv(65536)
            except (TimeoutError, socket.timeout):
                continue    # re-check the deadline
            if not chunk:
                raise OPCUAError(M.BAD_COMMUNICATION_ERROR,
                                 "connection closed by server")
            self._buf += chunk

    @staticmethod
    def _decode_err(body: bytes) -> OPCUAError:
        d = Decoder(body)
        status = d.status_code()
        return OPCUAError(status, d.string() or "server ERR")

    @staticmethod
    def _check(status: int, context: str) -> None:
        if status & 0x80000000:
            raise OPCUAError(status, context)

    def _service(self, req_id: int, req, rsp_id: int, decode_rsp,
                 timeout: Optional[float] = None):
        self._seq += 1
        self._req_id += 1
        e = Encoder()
        e.uint32(self._channel_id)
        e.uint32(self._token_id)
        M.SequenceHeader(self._seq, self._req_id).encode(e)
        e.raw(M.encode_service(req_id, req))
        self._sock.sendall(M.frame("MSG", e.data()))
        while True:
            msg_type, _, body = self._recv(timeout)
            if msg_type == "ERR":
                raise self._decode_err(body)
            if msg_type != "MSG":
                raise OPCUAError(M.BAD_TCP_MESSAGE_TYPE_INVALID,
                                 f"expected MSG, got {msg_type}")
            d = Decoder(body)
            d.uint32()   # channel id
            d.uint32()   # token id
            seq = M.SequenceHeader.decode(d)
            if seq.request_id != self._req_id:
                # Late answer to an earlier request (e.g. a Publish
                # whose wait we timed out on): discard and keep reading
                # — correlation keeps the stream in sync.
                continue
            got = M.decode_service_id(d)
            if got == M.ID_SERVICE_FAULT:
                fault = M.ServiceFault.decode(d)
                raise OPCUAError(fault.header.service_result,
                                 "ServiceFault")
            if got != rsp_id:
                raise OPCUAError(M.BAD_DECODING_ERROR,
                                 f"expected service {rsp_id}, got {got}")
            return decode_rsp(d)

    @staticmethod
    def _node(node: Union[str, NodeId]) -> NodeId:
        return node if isinstance(node, NodeId) else NodeId(1, node)

    # ------------------------------------------------------------------
    # Attribute / view services
    # ------------------------------------------------------------------

    def read(self, nodes: List[Union[str, NodeId]],
             attribute_id: int = M.ATTR_VALUE) -> List[DataValue]:
        req = M.ReadRequest(
            self._request_header(),
            nodes=[M.ReadValueId(self._node(n), attribute_id)
                   for n in nodes])
        rsp = self._service(M.ID_READ_REQ, req, M.ID_READ_RSP,
                            M.ReadResponse.decode)
        self._check(rsp.header.service_result, "Read")
        return rsp.results

    def read_double(self, node: Union[str, NodeId]) -> float:
        dv = self.read([node])[0]
        if dv.status is not None and dv.status & 0x80000000:
            raise OPCUAError(dv.status, f"Read {node}")
        return float(dv.value.value)

    def read_eu_range(self, node: Union[str, NodeId]
                      ) -> Tuple[float, float]:
        """(low, high) from a variable's EURange property (Part 8):
        pass the VARIABLE's node — '.EURange' is appended."""
        sid = node if isinstance(node, str) else node.identifier
        dv = self.read([f"{sid}.EURange"])[0]
        if dv.status is not None and dv.status & 0x80000000:
            raise OPCUAError(dv.status, f"Read {sid}.EURange")
        from ics_wt_physicsengine_torch.opcua.encoding import Decoder
        d = Decoder(dv.value.value.body)      # Range: low, high doubles
        return d.double(), d.double()

    def read_bool(self, node: Union[str, NodeId]) -> bool:
        dv = self.read([node])[0]
        if dv.status is not None and dv.status & 0x80000000:
            raise OPCUAError(dv.status, f"Read {node}")
        return bool(dv.value.value)

    def write(self, nodes: List[Tuple[Union[str, NodeId], Variant]]
              ) -> List[int]:
        req = M.WriteRequest(
            self._request_header(),
            nodes=[M.WriteValue(self._node(n), M.ATTR_VALUE,
                                DataValue(value=v))
                   for n, v in nodes])
        rsp = self._service(M.ID_WRITE_REQ, req, M.ID_WRITE_RSP,
                            M.WriteResponse.decode)
        self._check(rsp.header.service_result, "Write")
        return rsp.results

    def write_double(self, node: Union[str, NodeId], value: float) -> None:
        status = self.write([(node, Variant(VT_DOUBLE, float(value)))])[0]
        self._check(status, f"Write {node}")

    def write_bool(self, node: Union[str, NodeId], value: bool) -> None:
        status = self.write([(node, Variant(VT_BOOLEAN, bool(value)))])[0]
        self._check(status, f"Write {node}")

    def browse(self, node: Union[str, NodeId] = M.OBJECTS_FOLDER
               ) -> List[str]:
        """Forward hierarchical references of ``node`` -> browse names."""
        nid = (node if isinstance(node, NodeId)
               else self._node(node))
        req = M.BrowseRequest(self._request_header(),
                              nodes=[M.BrowseDescription(node_id=nid)])
        rsp = self._service(M.ID_BROWSE_REQ, req, M.ID_BROWSE_RSP,
                            M.BrowseResponse.decode)
        self._check(rsp.header.service_result, "Browse")
        result = rsp.results[0]
        self._check(result.status, "Browse result")
        return [r.browse_name.name or "" for r in result.references]

    def get_endpoints(self) -> List[M.EndpointDescription]:
        req = M.GetEndpointsRequest(
            self._request_header(),
            endpoint_url=f"opc.tcp://{self.host}:{self.port}/plant")
        rsp = self._service(M.ID_GET_ENDPOINTS_REQ, req,
                            M.ID_GET_ENDPOINTS_RSP,
                            M.GetEndpointsResponse.decode)
        self._check(rsp.header.service_result, "GetEndpoints")
        return rsp.endpoints

    def translate_path(self, *names: str,
                       namespace: int = 1) -> NodeId:
        """Resolve a browse path from the Objects folder, e.g.
        ``translate_path("Unit1", "pH_outlet")`` -> the node id."""
        from ics_wt_physicsengine_torch.opcua.encoding import QualifiedName
        req = M.TranslateBrowsePathsRequest(
            self._request_header(),
            paths=[M.BrowsePath(
                starting_node=M.OBJECTS_FOLDER,
                elements=[M.RelativePathElement(
                    target_name=QualifiedName(namespace, n))
                    for n in names])])
        rsp = self._service(M.ID_TRANSLATE_BROWSE_PATHS_REQ, req,
                            M.ID_TRANSLATE_BROWSE_PATHS_RSP,
                            M.TranslateBrowsePathsResponse.decode)
        self._check(rsp.header.service_result, "TranslateBrowsePaths")
        result = rsp.results[0]
        self._check(result.status, "TranslateBrowsePaths result")
        return result.targets[0].target_id

    # ------------------------------------------------------------------
    # Subscription services
    # ------------------------------------------------------------------

    def register_nodes(self, nodes: List[Union[str, NodeId]]
                       ) -> List[NodeId]:
        """RegisterNodes (Part 4 §5.8.5): optimization hint before cyclic
        access; returns the ids to use (this server echoes them)."""
        req = M.RegisterNodesRequest(
            self._request_header(),
            nodes_to_register=[self._node(n) for n in nodes])
        rsp = self._service(M.ID_REGISTER_NODES_REQ, req,
                            M.ID_REGISTER_NODES_RSP,
                            M.RegisterNodesResponse.decode)
        self._check(rsp.header.service_result, "RegisterNodes")
        return rsp.registered_node_ids

    def unregister_nodes(self, nodes: List[Union[str, NodeId]]) -> None:
        req = M.UnregisterNodesRequest(
            self._request_header(),
            nodes_to_unregister=[self._node(n) for n in nodes])
        rsp = self._service(M.ID_UNREGISTER_NODES_REQ, req,
                            M.ID_UNREGISTER_NODES_RSP,
                            M.UnregisterNodesResponse.decode)
        self._check(rsp.header.service_result, "UnregisterNodes")

    def create_subscription(self, publishing_interval: float = 0.5,
                            lifetime_count: int = 60,
                            max_keepalive_count: int = 5,
                            max_notifications: int = 0,
                            publishing_enabled: bool = True
                            ) -> Tuple[int, float]:
        """Create a subscription; returns (subscription_id,
        revised_publishing_interval_s)."""
        req = M.CreateSubscriptionRequest(
            self._request_header(),
            requested_publishing_interval_ms=publishing_interval * 1000.0,
            requested_lifetime_count=lifetime_count,
            requested_max_keepalive_count=max_keepalive_count,
            max_notifications_per_publish=max_notifications,
            publishing_enabled=publishing_enabled)
        rsp = self._service(M.ID_CREATE_SUBSCRIPTION_REQ, req,
                            M.ID_CREATE_SUBSCRIPTION_RSP,
                            M.CreateSubscriptionResponse.decode)
        self._check(rsp.header.service_result, "CreateSubscription")
        return (rsp.subscription_id,
                rsp.revised_publishing_interval_ms / 1000.0)

    def modify_subscription(self, subscription_id: int,
                            publishing_interval: float = 0.5,
                            lifetime_count: int = 60,
                            max_keepalive_count: int = 5,
                            max_notifications: int = 0,
                            priority: int = 0) -> float:
        """Revise an existing subscription (Part 4 §5.13.3); returns the
        revised publishing interval in seconds."""
        req = M.ModifySubscriptionRequest(
            self._request_header(),
            subscription_id=subscription_id,
            requested_publishing_interval_ms=publishing_interval * 1000.0,
            requested_lifetime_count=lifetime_count,
            requested_max_keepalive_count=max_keepalive_count,
            max_notifications_per_publish=max_notifications,
            priority=priority)
        rsp = self._service(M.ID_MODIFY_SUBSCRIPTION_REQ, req,
                            M.ID_MODIFY_SUBSCRIPTION_RSP,
                            M.ModifySubscriptionResponse.decode)
        self._check(rsp.header.service_result, "ModifySubscription")
        return rsp.revised_publishing_interval_ms / 1000.0

    def create_monitored_items(self, subscription_id: int,
                               nodes: List[Union[str, NodeId]],
                               client_handles: Optional[List[int]] = None,
                               queue_size: int = 1,
                               mode: int = 2,
                               deadband: Optional[float] = None,
                               deadband_percent: bool = False
                               ) -> List[M.MonitoredItemCreateResult]:
        """Monitor the Value attribute of ``nodes``. ``client_handles``
        default to the node's index in the list. ``deadband`` attaches a
        DataChangeFilter: numeric changes within the band are not
        reported (Part 4 §7.22.2). ``deadband_percent=True`` sends a
        percent deadband (percent of the node's EURange span, Part 8
        §5.6.3.3) instead of an absolute one."""
        handles = client_handles or list(range(len(nodes)))
        filt = (M.DataChangeFilter(
                    trigger=1,
                    deadband_type=2 if deadband_percent else 1,
                    deadband_value=deadband
                ).to_extension_object()
                if deadband is not None else None)
        req = M.CreateMonitoredItemsRequest(
            self._request_header(), subscription_id=subscription_id,
            items=[M.MonitoredItemCreateRequest(
                item_to_monitor=M.ReadValueId(self._node(n)),
                monitoring_mode=mode,
                requested_parameters=M.MonitoringParameters(
                    client_handle=h, queue_size=queue_size,
                    **({"filter": filt} if filt is not None else {})))
                for n, h in zip(nodes, handles)])
        rsp = self._service(M.ID_CREATE_MONITORED_ITEMS_REQ, req,
                            M.ID_CREATE_MONITORED_ITEMS_RSP,
                            M.CreateMonitoredItemsResponse.decode)
        self._check(rsp.header.service_result, "CreateMonitoredItems")
        return rsp.results

    def publish(self,
                acks: Optional[List[Tuple[int, int]]] = None,
                timeout: Optional[float] = None) -> M.PublishResponse:
        """Send one PublishRequest and block until the server answers
        (data change or keepalive). ``acks`` is a list of
        (subscription_id, sequence_number) pairs from prior responses.
        Keepalives arrive after max_keepalive_count publishing
        intervals — size ``timeout`` accordingly."""
        req = M.PublishRequest(
            self._request_header(),
            acknowledgements=[M.SubscriptionAcknowledgement(s, q)
                              for s, q in (acks or [])])
        rsp = self._service(M.ID_PUBLISH_REQ, req, M.ID_PUBLISH_RSP,
                            M.PublishResponse.decode, timeout=timeout)
        self._check(rsp.header.service_result, "Publish")
        return rsp

    @staticmethod
    def data_changes(rsp: M.PublishResponse
                     ) -> List[Tuple[int, DataValue]]:
        """Flatten a PublishResponse into (client_handle, DataValue)
        pairs (empty for keepalives)."""
        out = []
        for obj in rsp.notification_message.notification_data:
            dcn = M.DataChangeNotification.from_extension_object(obj)
            out.extend((m.client_handle, m.value)
                       for m in dcn.monitored_items)
        return out

    def republish(self, subscription_id: int,
                  sequence_number: int) -> M.NotificationMessage:
        req = M.RepublishRequest(
            self._request_header(), subscription_id=subscription_id,
            retransmit_sequence_number=sequence_number)
        rsp = self._service(M.ID_REPUBLISH_REQ, req, M.ID_REPUBLISH_RSP,
                            M.RepublishResponse.decode)
        self._check(rsp.header.service_result, "Republish")
        return rsp.notification_message

    def set_publishing_mode(self, enabled: bool,
                            subscription_ids: List[int]) -> List[int]:
        req = M.SetPublishingModeRequest(
            self._request_header(), publishing_enabled=enabled,
            subscription_ids=subscription_ids)
        rsp = self._service(M.ID_SET_PUBLISHING_MODE_REQ, req,
                            M.ID_SET_PUBLISHING_MODE_RSP,
                            M.SetPublishingModeResponse.decode)
        self._check(rsp.header.service_result, "SetPublishingMode")
        return rsp.results

    def set_monitoring_mode(self, subscription_id: int, mode: int,
                            item_ids: List[int]) -> List[int]:
        """0 = disabled, 1 = sampling (no reporting), 2 = reporting."""
        req = M.SetMonitoringModeRequest(
            self._request_header(), subscription_id=subscription_id,
            monitoring_mode=mode, monitored_item_ids=item_ids)
        rsp = self._service(M.ID_SET_MONITORING_MODE_REQ, req,
                            M.ID_SET_MONITORING_MODE_RSP,
                            M.SetMonitoringModeResponse.decode)
        self._check(rsp.header.service_result, "SetMonitoringMode")
        return rsp.results

    def delete_monitored_items(self, subscription_id: int,
                               item_ids: List[int]) -> List[int]:
        req = M.DeleteMonitoredItemsRequest(
            self._request_header(), subscription_id=subscription_id,
            monitored_item_ids=item_ids)
        rsp = self._service(M.ID_DELETE_MONITORED_ITEMS_REQ, req,
                            M.ID_DELETE_MONITORED_ITEMS_RSP,
                            M.DeleteMonitoredItemsResponse.decode)
        self._check(rsp.header.service_result, "DeleteMonitoredItems")
        return rsp.results

    def delete_subscriptions(self,
                             subscription_ids: List[int]) -> List[int]:
        req = M.DeleteSubscriptionsRequest(
            self._request_header(), subscription_ids=subscription_ids)
        rsp = self._service(M.ID_DELETE_SUBSCRIPTIONS_REQ, req,
                            M.ID_DELETE_SUBSCRIPTIONS_RSP,
                            M.DeleteSubscriptionsResponse.decode)
        self._check(rsp.header.service_result, "DeleteSubscriptions")
        return rsp.results
