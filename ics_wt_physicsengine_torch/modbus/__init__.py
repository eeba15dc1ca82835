"""
Modbus package: register map, wire encoding, TCP slave + test client.

The external HIL plane of the framework (SURVEY.md section 5.8): sensors
publish to input registers, external SCADA/PID controllers write actuator
commands to holding registers. The server is a from-scratch asyncio
implementation (the reference's pymodbus dependency is replaced — see
slave.py docstring); the register map and name-based API match the reference.
"""

from ics_wt_physicsengine_torch.modbus.register_map import (  # noqa: F401
    ModbusRegisterMap,
    RegisterDefinition,
    RegisterType,
)
from ics_wt_physicsengine_torch.modbus.protocols import (  # noqa: F401
    ModbusDecoder,
    ModbusEncoder,
    validate_encoding,
)
from ics_wt_physicsengine_torch.modbus.slave import (  # noqa: F401
    ModbusServerConfig,
    ModbusSlave,
)
from ics_wt_physicsengine_torch.modbus.client import ModbusTcpClient  # noqa: F401
from ics_wt_physicsengine_torch.modbus.security import (  # noqa: F401
    ModbusTLSConfig,
    make_client_ssl_context,
    make_server_ssl_context,
)
from ics_wt_physicsengine_torch.modbus.rtu import (  # noqa: F401
    ModbusRtuClient,
    ModbusRtuSlave,
)
from ics_wt_physicsengine_torch.modbus.native_slave import (  # noqa: F401
    NativeModbusSlave,
)
from ics_wt_physicsengine_torch.modbus.native_slave import (  # noqa: F401
    is_available as native_available,
)


def print_package_info():
    """Package overview (reference modbus/__init__.py:92-127)."""
    from ics_wt_physicsengine_torch.modbus.native_slave import is_available
    print("=" * 70)
    print("MODBUS PACKAGE — ICS-WT-PhysicsEngine-TPU")
    print("=" * 70)
    print("Components:")
    print("  ModbusRegisterMap  declarative register layout (addresses/names")
    print("                     identical to the reference)")
    print("  ModbusEncoder/Decoder  IEEE-754 float32 <-> big-endian words")
    print("  ModbusSlave        asyncio Modbus/TCP server (FC 1-6, 15, 16)")
    print("  NativeModbusSlave  C++ data-plane server "
          f"({'available' if is_available() else 'toolchain missing'})")
    print("  ModbusTcpClient    in-repo master for HIL loops and tests")
    print()
    ModbusRegisterMap().print_register_map()
