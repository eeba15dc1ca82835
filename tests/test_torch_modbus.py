"""The port's Modbus plane (``ics_wt_physicsengine_torch/modbus``) against
the JAX package's, on the CPU: register maps entry by entry, the float32
word encoding and RTU framing byte for byte on inputs drawn from a NumPy
seed, and each package's client against the other package's server over a
real socket (plain Modbus/TCP, RTU framing over TCP, Modbus/TCP Security
with client certificates, and the native C++ plane). Servers bind port 0;
every socket wait is bounded by the clients' 5 s timeout."""

import dataclasses
import struct

import numpy as np
import pytest

from ics_wt_physicsengine_tpu import modbus as JM
from ics_wt_physicsengine_tpu.modbus import rtu as JRTU

from ics_wt_physicsengine_torch import modbus as TM
from ics_wt_physicsengine_torch.modbus import native_slave as TNS
from ics_wt_physicsengine_torch.modbus import rtu as TRTU

FLAGS = ("extended_nitrogen", "extended_gas", "extended_particles",
         "extended_disinfection", "extended_biofilm", "extended_phase")
KINDS = ("input_registers", "holding_registers", "coils", "discrete_inputs")


def _entry(reg):
    """A register definition as plain values (the enum by name and
    value)."""
    out = dataclasses.asdict(reg)
    out["register_type"] = (reg.register_type.name, reg.register_type.value)
    return out


@pytest.mark.parametrize("flags", [(), *((f,) for f in FLAGS), FLAGS],
                         ids=["base", *FLAGS, "all"])
def test_register_maps_equal_entry_by_entry(flags):
    kw = dict.fromkeys(flags, True)
    port, ref = TM.ModbusRegisterMap(**kw), JM.ModbusRegisterMap(**kw)
    for kind in KINDS:
        a, b = getattr(port, kind), getattr(ref, kind)
        assert [_entry(r) for r in a] == [_entry(r) for r in b], kind
        assert [r.size_words for r in a] == [r.size_words for r in b]
    assert len(port.all_registers()) == len(ref.all_registers())


def test_word_encoding_is_byte_equal():
    rng = np.random.default_rng(10)
    floats = np.concatenate([
        rng.normal(0, 1e3, 200), rng.uniform(-1, 1, 100),
        [0.0, -0.0, 1e-40, 3.4e38, -3.4e38, np.inf, -np.inf, np.nan]])
    for x in floats:
        a = TM.ModbusEncoder.float32_to_registers(float(x))
        assert a == JM.ModbusEncoder.float32_to_registers(float(x))
        ya = TM.ModbusDecoder.registers_to_float32(*a)
        yb = JM.ModbusDecoder.registers_to_float32(*a)
        assert struct.pack(">f", ya) == struct.pack(">f", yb)
    for v in rng.integers(-32768, 32768, 200).tolist():
        w = TM.ModbusEncoder.int16_to_register(v)
        assert w == JM.ModbusEncoder.int16_to_register(v)
        assert TM.ModbusDecoder.register_to_int16(w) \
            == JM.ModbusDecoder.register_to_int16(w) == v
    for v in rng.integers(0, 65536, 100).tolist():
        assert TM.ModbusEncoder.uint16_to_register(v) \
            == JM.ModbusEncoder.uint16_to_register(v)
    arr = rng.normal(size=17).astype(np.float32)
    regs = TM.ModbusEncoder.array_to_registers(arr)
    assert regs == JM.ModbusEncoder.array_to_registers(arr)
    np.testing.assert_array_equal(
        TM.ModbusDecoder.registers_to_array(regs),
        JM.ModbusDecoder.registers_to_array(regs))
    TM.validate_encoding()


def test_rtu_framing_is_byte_equal():
    rng = np.random.default_rng(11)
    framer_t, framer_j = TRTU.RtuFramer(), JRTU.RtuFramer()
    stream = b""
    for n in rng.integers(1, 60, 60).tolist():
        pdu = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        unit = int(rng.integers(0, 248))
        assert TRTU.crc16(pdu) == JRTU.crc16(pdu)
        frame = TRTU.frame_rtu(unit, pdu)
        assert frame == JRTU.frame_rtu(unit, pdu)
        assert TRTU.check_crc(frame) and JRTU.check_crc(frame)
        bad = frame[:-1] + bytes([frame[-1] ^ 0x01])
        assert not TRTU.check_crc(bad) and not JRTU.check_crc(bad)
        assert TRTU.expected_request_length(frame) \
            == JRTU.expected_request_length(frame)
        assert TRTU.expected_response_length(frame) \
            == JRTU.expected_response_length(frame)
    # well-formed requests fed in ragged pieces split the same way
    for fc, body in ((3, struct.pack(">HH", 0, 4)),
                     (6, struct.pack(">HH", 2, 77)),
                     (16, struct.pack(">HHB", 0, 2, 4) + b"\x40\xe0\x00\x00"),
                     (1, struct.pack(">HH", 0, 3))):
        stream += TRTU.frame_rtu(1, bytes([fc]) + body)
    cuts = sorted(set(rng.integers(1, len(stream), 7).tolist()))
    got_t, got_j = [], []
    for a, b in zip([0, *cuts], [*cuts, len(stream)]):
        got_t += framer_t.feed(stream[a:b])
        got_j += framer_j.feed(stream[a:b])
    assert got_t == got_j and len(got_t) == 4


def _slave(pkg, **kw):
    s = pkg.ModbusSlave(pkg.ModbusRegisterMap(),
                        pkg.ModbusServerConfig(host="127.0.0.1", port=0,
                                               **kw))
    s.start(blocking=False)
    return s


def _round_trip(client, slave):
    """Inputs written by the server read back through the client; holding
    registers and coils written by the client land in the server."""
    slave.update_input_register("pH_outlet", 7.125)
    slave.update_input_register("simulation_time", 3600.0)
    slave.update_discrete_input("sensor_fault_chlorine", True)
    assert client.read_float32(4) == pytest.approx(7.125, abs=1e-6)
    assert client.read_float32(100) == 3600.0
    assert client.read_discrete_inputs(0, 3)[2] is True
    client.write_float32(0, 1.25)                 # acid_flow_rate
    client.write_coil(1, False)                   # chlorine_pump_enable
    assert slave.read_holding_register("acid_flow_rate") \
        == pytest.approx(1.25, abs=1e-6)
    assert slave.read_coil("chlorine_pump_enable") is False
    client.write_registers(10, list(TM.ModbusEncoder.float32_to_registers(
        0.05)))                                   # acid_concentration
    assert slave.read_holding_register("acid_concentration") \
        == pytest.approx(0.05, abs=1e-7)


@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch")])
def test_clients_and_servers_across_the_packages(server, client):
    pkgs = {"torch": TM, "jax": JM}
    slave = _slave(pkgs[server])
    try:
        with pkgs[client].ModbusTcpClient("127.0.0.1", slave.port,
                                          timeout=5) as c:
            _round_trip(c, slave)
            info = c.read_device_identification()
            assert info[0x00] == "ICS-WT-PhysicsEngine-TPU"   # VendorName
    finally:
        slave.stop()


def test_rtu_over_tcp_across_the_packages():
    slave = TM.ModbusRtuSlave(TM.ModbusRegisterMap())
    slave.start_tcp("127.0.0.1", 0)
    try:
        with JM.ModbusRtuClient(host="127.0.0.1", port=slave.port,
                                unit_id=1) as c:
            _round_trip(c, slave)
            with pytest.raises(IOError, match="exception 2"):
                c.read_holding_registers(9000, 2)
    finally:
        slave.stop()


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """A throwaway PKI made by the port's helper: an operator (rw role) and
    a viewer (ro role)."""
    return TM.security.generate_test_pki(
        str(tmp_path_factory.mktemp("pki")),
        roles={"operator": "Operator", "viewer": "Viewer"})


def test_tls_plane_serves_the_jax_client(pki):
    tls = TM.ModbusTLSConfig(
        certfile=pki["server"]["cert"], keyfile=pki["server"]["key"],
        cafile=pki["ca"]["cert"],
        role_permissions={"Operator": "rw", "Viewer": "ro"},
        default_permission="ro")
    slave = _slave(TM, tls=tls)

    def client(name):
        ctx = JM.make_client_ssl_context(pki[name]["cert"], pki[name]["key"],
                                         pki["ca"]["cert"])
        return JM.ModbusTcpClient("127.0.0.1", slave.port, ssl_context=ctx,
                                  timeout=5)

    try:
        with client("operator") as c:
            _round_trip(c, slave)
        with client("viewer") as c:
            assert c.read_float32(4) == pytest.approx(7.125, abs=1e-6)
            with pytest.raises(IOError):
                c.write_float32(0, 0.5)
        assert slave.read_holding_register("acid_flow_rate") \
            == pytest.approx(1.25, abs=1e-6)
    finally:
        slave.stop()


def test_native_plane_serves_the_jax_client():
    """The port builds native/modbus_server.cpp itself (into
    build/torch_native/, never native/) and serves a JAX client."""
    assert TM.native_available()
    assert TNS._LIB_PATH.parent.name == "torch_native"
    slave = TM.NativeModbusSlave(
        TM.ModbusRegisterMap(),
        TM.ModbusServerConfig(host="127.0.0.1", port=0))
    slave.start()
    try:
        with JM.ModbusTcpClient("127.0.0.1", slave.port, timeout=5) as c:
            _round_trip(c, slave)
        assert slave.request_count > 0
    finally:
        slave.stop()


def test_native_plane_raises_when_it_cannot_be_built(monkeypatch, tmp_path):
    monkeypatch.setattr(TNS, "_lib", None)
    monkeypatch.setattr(TNS, "_LIB_PATH", tmp_path / "libwtmodbus.so")
    monkeypatch.setattr(TNS, "_SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="unavailable"):
        TM.NativeModbusSlave(TM.ModbusRegisterMap())
    assert not list(tmp_path.iterdir())          # no partial library left


def test_modbus_demo_main(capsys):
    from ics_wt_physicsengine_torch.modbus.__main__ import main
    main()
    out = capsys.readouterr().out
    assert "MODBUS" in out
