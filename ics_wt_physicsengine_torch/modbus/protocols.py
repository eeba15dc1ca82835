"""
Modbus wire encoding: IEEE-754 float32 <-> big-endian register pairs.

Parity with the reference (modbus/protocols.py:34-330): float32 packs to two
big-endian uint16 words (high word first), int16 two's-complement, uint16
pass-through with range checks, bool to 0/1, plus array batch converters and
a round-trip validation suite.
"""

from __future__ import annotations

import struct
from typing import List, Tuple, Union

import numpy as np


class ModbusEncoder:
    """Python values -> Modbus register format
    (reference protocols.py:26-144)."""

    @staticmethod
    def float32_to_registers(value: float) -> Tuple[int, int]:
        packed = struct.pack(">f", value)
        high, low = struct.unpack(">HH", packed)
        return high, low

    @staticmethod
    def int16_to_register(value: int) -> int:
        if not -32768 <= value <= 32767:
            raise ValueError(
                f"int16 value {value} out of range [-32768, 32767]")
        packed = struct.pack(">h", value)
        (result,) = struct.unpack(">H", packed)
        return result

    @staticmethod
    def uint16_to_register(value: int) -> int:
        if not 0 <= value <= 65535:
            raise ValueError(f"uint16 value {value} out of range [0, 65535]")
        return value

    @staticmethod
    def bool_to_coil(value: bool) -> int:
        return 1 if value else 0

    @staticmethod
    def array_to_registers(values: Union[List[float], np.ndarray],
                           data_type: str = "float32") -> List[int]:
        registers: List[int] = []
        for value in values:
            if data_type == "float32":
                registers.extend(
                    ModbusEncoder.float32_to_registers(float(value)))
            elif data_type == "int16":
                registers.append(ModbusEncoder.int16_to_register(int(value)))
            elif data_type == "uint16":
                registers.append(ModbusEncoder.uint16_to_register(int(value)))
            else:
                raise ValueError(f"Unknown data type: {data_type}")
        return registers


class ModbusDecoder:
    """Modbus register format -> Python values
    (reference protocols.py:147-263)."""

    @staticmethod
    def registers_to_float32(high: int, low: int) -> float:
        packed = struct.pack(">HH", high & 0xFFFF, low & 0xFFFF)
        (value,) = struct.unpack(">f", packed)
        return value

    @staticmethod
    def register_to_int16(value: int) -> int:
        packed = struct.pack(">H", value & 0xFFFF)
        (result,) = struct.unpack(">h", packed)
        return result

    @staticmethod
    def register_to_uint16(value: int) -> int:
        if not 0 <= value <= 65535:
            raise ValueError(f"Register value {value} out of range")
        return value

    @staticmethod
    def coil_to_bool(value: int) -> bool:
        return bool(value)

    @staticmethod
    def registers_to_array(registers: List[int],
                           data_type: str = "float32") -> List[float]:
        values: List[float] = []
        if data_type == "float32":
            if len(registers) % 2 != 0:
                raise ValueError(
                    "float32 decoding requires an even register count")
            for i in range(0, len(registers), 2):
                values.append(ModbusDecoder.registers_to_float32(
                    registers[i], registers[i + 1]))
        elif data_type == "int16":
            values.extend(ModbusDecoder.register_to_int16(r)
                          for r in registers)
        elif data_type == "uint16":
            values.extend(ModbusDecoder.register_to_uint16(r)
                          for r in registers)
        else:
            raise ValueError(f"Unknown data type: {data_type}")
        return values


def validate_encoding() -> None:
    """Round-trip validation (reference protocols.py:266-330)."""
    test_floats = [0.0, 1.0, -1.0, 7.25, -273.15, 1e-6, 3.4e38, float("inf")]
    for v in test_floats:
        high, low = ModbusEncoder.float32_to_registers(v)
        decoded = ModbusDecoder.registers_to_float32(high, low)
        expected = struct.unpack(">f", struct.pack(">f", v))[0]
        if not (decoded == expected
                or (np.isnan(decoded) and np.isnan(expected))):
            raise AssertionError(f"float32 round-trip failed for {v}")

    nan_regs = ModbusEncoder.float32_to_registers(float("nan"))
    if not np.isnan(ModbusDecoder.registers_to_float32(*nan_regs)):
        raise AssertionError("NaN round-trip failed")

    for v in (-32768, -1, 0, 1, 32767):
        if ModbusDecoder.register_to_int16(
                ModbusEncoder.int16_to_register(v)) != v:
            raise AssertionError(f"int16 round-trip failed for {v}")

    for v in (0, 1, 65535):
        if ModbusDecoder.register_to_uint16(
                ModbusEncoder.uint16_to_register(v)) != v:
            raise AssertionError(f"uint16 round-trip failed for {v}")

    arr = [1.5, -2.25, 100.0]
    regs = ModbusEncoder.array_to_registers(arr, "float32")
    back = ModbusDecoder.registers_to_array(regs, "float32")
    if not np.allclose(arr, back):
        raise AssertionError("array round-trip failed")

    print("All encoding validations passed")
