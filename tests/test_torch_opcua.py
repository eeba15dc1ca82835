"""The port's OPC UA plane (``ics_wt_physicsengine_torch/opcua``) against
the JAX package's, on the CPU: the binary encoding of built-in types and of
service messages built from values drawn with a NumPy seed is byte-equal in
the two packages, and each package decodes the other's bytes; over a real
socket the JAX ``OPCUAClient`` reads and writes the port's
``OPCUAServer`` (bridged onto the port's Modbus register store), and the
port's client reads the JAX server. Servers bind port 0; socket waits are
bounded by the clients' timeouts."""

import uuid

import numpy as np
import pytest

from ics_wt_physicsengine_tpu import modbus as JMB
from ics_wt_physicsengine_tpu import opcua as JUA
from ics_wt_physicsengine_tpu.opcua import encoding as JE
from ics_wt_physicsengine_tpu.opcua import messages as JMSG

from ics_wt_physicsengine_torch import modbus as TMB
from ics_wt_physicsengine_torch import opcua as TUA
from ics_wt_physicsengine_torch.opcua import encoding as TE
from ics_wt_physicsengine_torch.opcua import messages as TMSG

PKGS = {"torch": (TE, TMSG), "jax": (JE, JMSG)}


def _scalars(rng):
    """Built-in values drawn from ``rng``: (encoder method, value)."""
    out = []
    for v in rng.normal(0, 1e6, 8).tolist() + [0.0, -0.0, float("inf")]:
        out.append(("double", v))
    for v in rng.integers(0, 256, 4).tolist():
        out.append(("byte", v))
    for v in rng.integers(0, 2, 4).tolist():
        out.append(("boolean", bool(v)))
    for n in rng.integers(0, 12, 4).tolist():
        out.append(("string", "".join(chr(c) for c in rng.integers(
            32, 0x2FF, n).tolist())))
    out += [("string", None), ("bytestring", bytes(rng.integers(
        0, 256, 9, dtype=np.uint8))), ("bytestring", None)]
    for v in rng.integers(0, 2 ** 62, 3).tolist():
        out.append(("datetime", v))
    for v in rng.integers(0, 2 ** 32, 3).tolist():
        out.append(("status_code", v))
    out.append(("guid", uuid.UUID(int=int(rng.integers(0, 2 ** 63)))))
    return out


def _node_ids(E, rng):
    return [E.NodeId(0, int(rng.integers(0, 256))),
            E.NodeId(int(rng.integers(1, 256)), int(rng.integers(0, 65536))),
            E.NodeId(300, int(rng.integers(65536, 2 ** 32))),
            E.NodeId(1, "u1.pH_outlet"),
            E.NodeId(2, bytes(rng.integers(0, 256, 5, dtype=np.uint8))),
            E.NodeId(4, uuid.UUID(int=int(rng.integers(0, 2 ** 63))))]


def _variants(E, rng):
    doubles = rng.normal(size=4).tolist()
    return [E.Variant(E.VT_DOUBLE, doubles[0]),
            E.Variant(E.VT_BOOLEAN, True), E.Variant(E.VT_INT32, -42),
            E.Variant(E.VT_STRING, "héllo"),
            E.Variant(E.VT_DOUBLE, doubles, is_array=True),
            E.Variant(E.VT_STRING, ["a", None, "c"], is_array=True),
            E.Variant()]


def test_builtin_encoding_is_byte_equal():
    rng = np.random.default_rng(20)
    for method, value in _scalars(rng):
        a = getattr(TE.Encoder(), method)(value).data()
        b = getattr(JE.Encoder(), method)(value).data()
        assert a == b, method
        assert getattr(TE.Decoder(b), method)() \
            == getattr(JE.Decoder(a), method)()
    for seed in (1, 2):
        rng_t, rng_j = (np.random.default_rng(seed) for _ in range(2))
        for nt, nj in zip(_node_ids(TE, rng_t), _node_ids(JE, rng_j)):
            a, b = TE.Encoder().node_id(nt).data(), \
                JE.Encoder().node_id(nj).data()
            assert a == b
            assert TE.Decoder(b).node_id() == nt
        for vt, vj in zip(_variants(TE, rng_t), _variants(JE, rng_j)):
            a = TE.Encoder().data_value(TE.DataValue(
                value=vt, status=0, source_timestamp=5)).data()
            b = JE.Encoder().data_value(JE.DataValue(
                value=vj, status=0, source_timestamp=5)).data()
            assert a == b
            assert TE.Encoder().data_value(TE.Decoder(b).data_value()) \
                .data() == a


def _messages(E, M, rng):
    """Service messages built alike in either package from ``rng``."""
    hdr = M.RequestHeader(request_handle=int(rng.integers(1, 2 ** 31)))
    x = float(rng.normal())
    nid = E.NodeId(1, "u1.pH_outlet")
    dcn = M.DataChangeNotification([M.MonitoredItemNotification(
        7, E.DataValue(value=E.Variant(E.VT_DOUBLE, x), status=0))])
    return [
        M.ReadRequest(hdr, nodes=[M.ReadValueId(nid, 13)]),
        M.WriteRequest(hdr, nodes=[M.WriteValue(
            E.NodeId(1, "u1.acid_flow_rate"), 13,
            E.DataValue(value=E.Variant(E.VT_DOUBLE, x)))]),
        M.BrowseRequest(hdr, max_references=int(rng.integers(1, 99)),
                        nodes=[M.BrowseDescription()]),
        M.CreateSessionRequest(hdr, endpoint_url="opc.tcp://h:4840/plant",
                               session_name="s"),
        M.ActivateSessionRequest(hdr),
        M.GetEndpointsRequest(hdr, endpoint_url="opc.tcp://h:4840/plant"),
        M.OpenSecureChannelRequest(
            hdr, requested_lifetime_ms=int(rng.integers(1000, 10 ** 6))),
        M.CloseSessionRequest(hdr),
        M.CreateSubscriptionRequest(
            requested_publishing_interval_ms=float(rng.uniform(10, 1000)),
            requested_lifetime_count=30, requested_max_keepalive_count=7,
            max_notifications_per_publish=5, publishing_enabled=False,
            priority=3),
        M.CreateMonitoredItemsRequest(
            subscription_id=9, items=[M.MonitoredItemCreateRequest(
                item_to_monitor=M.ReadValueId(nid), monitoring_mode=2,
                requested_parameters=M.MonitoringParameters(
                    client_handle=42, queue_size=4,
                    discard_oldest=False))]),
        M.ReadResponse(
            M.ResponseHeader(request_handle=4, service_result=M.GOOD),
            results=[E.DataValue(value=E.Variant(E.VT_DOUBLE, x)),
                     E.DataValue(status=M.BAD_NODE_ID_UNKNOWN)]),
        M.PublishResponse(
            subscription_id=3, available_sequence_numbers=[1, 2],
            more_notifications=True,
            notification_message=M.NotificationMessage(
                sequence_number=2, publish_time=5,
                notification_data=[dcn.to_extension_object()]),
            results=[M.GOOD, M.BAD_SEQUENCE_NUMBER_UNKNOWN]),
    ]


@pytest.mark.parametrize("seed", [3, 4])
def test_service_messages_are_byte_equal(seed):
    built = {name: _messages(E, M, np.random.default_rng(seed))
             for name, (E, M) in PKGS.items()}
    for mt, mj in zip(built["torch"], built["jax"]):
        et, ej = TE.Encoder(), JE.Encoder()
        mt.encode(et)
        mj.encode(ej)
        assert et.data() == ej.data(), type(mt).__name__
        # each package decodes the other's bytes and re-encodes them
        back = type(mt).decode(TE.Decoder(ej.data()))
        again = TE.Encoder()
        back.encode(again)
        assert again.data() == ej.data()
    assert TMSG.frame("HEL", b"\x01\x02") == JMSG.frame("HEL", b"\x01\x02")
    assert TMSG.Hello(endpoint_url="opc.tcp://h:1/plant").encode() \
        == JMSG.Hello(endpoint_url="opc.tcp://h:1/plant").encode()
    assert TE.unix_to_filetime(1.5e9) == JE.unix_to_filetime(1.5e9)


def _store(MB):
    slave = MB.ModbusSlave(MB.ModbusRegisterMap(),
                           MB.ModbusServerConfig(host="127.0.0.1", port=0))
    slave.update_input_register("pH_outlet", 7.2)
    slave.update_input_register("simulation_time", 1800.0)
    slave.write_holding_register("chlorine_flow_rate", 0.0)
    slave.write_coil("acid_pump_enable", True)
    return slave


@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch")])
def test_opcua_across_the_packages(server, client):
    mb, ua = {"torch": (TMB, TUA), "jax": (JMB, JUA)}[server]
    slave = _store(mb)
    srv = ua.OPCUAServer(slave, host="127.0.0.1", port=0)
    srv.start()
    try:
        cls = {"torch": TUA, "jax": JUA}[client].OPCUAClient
        with cls("127.0.0.1", srv.actual_port, timeout=10) as c:
            assert c.read_double("u1.pH_outlet") == pytest.approx(7.2, 1e-6)
            assert c.read_double("u1.simulation_time") == 1800.0
            assert c.read_bool("u1.acid_pump_enable") is True
            c.write_double("u1.chlorine_flow_rate", 0.5)
            assert slave.read_holding_register("chlorine_flow_rate") \
                == pytest.approx(0.5, 1e-6)
            names = set(c.browse("u1"))
            assert {"pH_outlet", "chlorine_flow_rate"} <= names
    finally:
        srv.stop()
