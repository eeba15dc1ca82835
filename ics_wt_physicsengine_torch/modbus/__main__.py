"""
Modbus smoke demo: ``python -m ics_wt_physicsengine_torch.modbus``.

Mirrors the reference's module demo (reference modbus/slave.py:400-438):
prints package info and the register map, starts the from-scratch TCP slave
on an ephemeral port, exercises it with the in-repo client (reads, writes,
FC 43 identity, exception paths), and reports counters. Pass ``--native``
to demo the C++ data-plane server instead.
"""

from __future__ import annotations

import sys


def main(native: bool = False) -> None:
    from ics_wt_physicsengine_torch.modbus import (
        ModbusRegisterMap,
        ModbusServerConfig,
        ModbusSlave,
        ModbusTcpClient,
        print_package_info,
    )

    print_package_info()
    register_map = ModbusRegisterMap()
    print()
    register_map.print_register_map()

    config = ModbusServerConfig(host="127.0.0.1", port=0)
    if native:
        from ics_wt_physicsengine_torch.modbus.native_slave import (
            NativeModbusSlave, is_available)
        if not is_available():
            print("native library unavailable; falling back to Python slave")
            slave = ModbusSlave(register_map, config)
        else:
            slave = NativeModbusSlave(register_map, config)
    else:
        slave = ModbusSlave(register_map, config)

    slave.start(blocking=False)
    kind = type(slave).__name__
    print(f"\n{kind} listening on 127.0.0.1:{slave.port}")

    # Simulate one plant tick publishing measurements
    slave.update_input_register("pH_inlet", 7.21)
    slave.update_input_register("pH_outlet", 7.05)
    slave.update_input_register("chlorine_outlet", 1.48)
    slave.update_input_register("system_status", 1)
    slave.update_discrete_input("sensor_fault_pH_inlet", False)

    with ModbusTcpClient("127.0.0.1", slave.port) as client:
        ident = client.read_device_identification(read_code=0x02)
        print("\nFC 43 device identification:")
        for oid, value in sorted(ident.items()):
            print(f"  object 0x{oid:02X}: {value}")

        def addr(name):
            return register_map.get_register_by_name(name).address

        print("\nSCADA master view:")
        print(f"  pH_inlet          = "
              f"{client.read_float32(addr('pH_inlet')):.3f}")
        print(f"  pH_outlet         = "
              f"{client.read_float32(addr('pH_outlet')):.3f}")
        print(f"  chlorine_outlet   = "
              f"{client.read_float32(addr('chlorine_outlet')):.3f}")
        print(f"  system_status     = "
              f"{client.read_input_registers(102, 1)[0]}")
        print(f"  pH_inlet_fault    = {client.read_discrete_inputs(0, 1)[0]}")

        print("\nOperator writes a dosing setpoint:")
        client.write_float32(0, 0.35)            # acid_flow_rate
        client.write_coil(0, True)               # acid_pump_enable
        print(f"  acid_flow_rate    = "
              f"{slave.read_holding_register('acid_flow_rate'):.3f}")
        print(f"  acid_pump_enable  = {slave.read_coil('acid_pump_enable')}")

        print("\nException paths:")
        try:
            client.read_input_registers(60000, 4)
        except IOError as e:
            print(f"  out-of-range read  -> {e}")
        try:
            client._transact(b"\x2a\x00\x00")
        except IOError as e:
            print(f"  unknown function   -> {e}")

    print(f"\nServed {slave.request_count} requests, "
          f"{slave.error_count} protocol errors")
    slave.stop()
    print("Demo complete.")


if __name__ == "__main__":
    main(native="--native" in sys.argv)
