"""
Native (C++) Modbus/TCP slave binding.

``NativeModbusSlave`` presents the same name-based API as the Python
``ModbusSlave`` but delegates socket serving and word storage to the C++
data plane in ``native/modbus_server.cpp`` (a single poll()-driven thread,
microsecond request handling, immune to the Python GIL). Use it when many
SCADA masters poll the plant at high rate or when the serving loop must not
contend with Python-side work.

The shared library is built on demand with ``g++`` straight from
``native/modbus_server.cpp`` (the source the JAX package builds too) into
``build/torch_native/libwtmodbus.so`` beside the package, under a name of
its own first and renamed into place, so that processes building at once
never load a half-written file; it is rebuilt when the source is newer.
``is_available()`` reports whether the toolchain produced it. Python owns
the register *semantics* (map, encodings, validation) — the C++ side
stores raw words only.
"""

from __future__ import annotations

import ctypes
import logging
import math
import os
import pathlib
import subprocess
import threading
from typing import Dict, Optional

from ics_wt_physicsengine_torch.modbus.protocols import (
    ModbusDecoder,
    ModbusEncoder,
)
from ics_wt_physicsengine_torch.modbus.register_map import (
    ModbusRegisterMap,
    RegisterType,
)
from ics_wt_physicsengine_torch.modbus.slave import (
    MAX_REGISTER_VALUE,
    ModbusServerConfig,
)

logger = logging.getLogger(__name__)

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "modbus_server.cpp"
_LIB_PATH = _ROOT / "build" / "torch_native" / "libwtmodbus.so"
# native/Makefile's flags
_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")

_BLOCK_COILS = 0
_BLOCK_DISCRETE = 1
_BLOCK_INPUT = 2
_BLOCK_HOLDING = 3

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> None:
    """Compile ``_SOURCE`` into ``_LIB_PATH`` unless a library newer than
    the source is there: into a file of this process's own, then renamed
    into place (atomic), so that a concurrent build or load never sees a
    partial library."""
    if _LIB_PATH.exists() \
            and _LIB_PATH.stat().st_mtime >= _SOURCE.stat().st_mtime:
        return
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"libwtmodbus.{os.getpid()}.so")
    try:
        subprocess.run(["g++", *_CXXFLAGS, "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load_library():
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            _build_library()
        except (subprocess.SubprocessError, OSError) as e:
            if not _LIB_PATH.exists():
                logger.warning("Native modbus build failed: %s",
                               type(e).__name__)
                return None
            logger.warning("Native modbus rebuild failed (%s); trying the "
                           "existing library", type(e).__name__)
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError as e:
            logger.warning("Native modbus load failed: %s", e)
            return None
        if not hasattr(lib, "mb_add_unit"):   # stale pre-fleet binary
            logger.warning("Native modbus library is stale (mb_add_unit "
                           "missing) and rebuild failed; not using it")
            return None

        lib.mb_create.argtypes = [ctypes.POINTER(ctypes.c_uint32)]
        lib.mb_create.restype = ctypes.c_void_p
        lib.mb_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint16]
        lib.mb_start.restype = ctypes.c_int
        lib.mb_stop.argtypes = [ctypes.c_void_p]
        lib.mb_destroy.argtypes = [ctypes.c_void_p]
        lib.mb_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_uint32, ctypes.c_uint32,
                               ctypes.POINTER(ctypes.c_uint16)]
        lib.mb_get.restype = ctypes.c_int
        lib.mb_set.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_uint32, ctypes.c_uint32,
                               ctypes.POINTER(ctypes.c_uint16)]
        lib.mb_set.restype = ctypes.c_int
        lib.mb_request_count.argtypes = [ctypes.c_void_p]
        lib.mb_request_count.restype = ctypes.c_uint64
        lib.mb_error_count.argtypes = [ctypes.c_void_p]
        lib.mb_error_count.restype = ctypes.c_uint64
        lib.mb_set_unit_id.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.mb_add_unit.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.mb_add_unit.restype = ctypes.c_int
        lib.mb_get_unit.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_uint32,
                                    ctypes.c_uint32,
                                    ctypes.POINTER(ctypes.c_uint16)]
        lib.mb_get_unit.restype = ctypes.c_int
        lib.mb_set_unit.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_uint32,
                                    ctypes.c_uint32,
                                    ctypes.POINTER(ctypes.c_uint16)]
        lib.mb_set_unit.restype = ctypes.c_int
        lib.mb_set_identity.argtypes = [ctypes.c_void_p, ctypes.c_uint8,
                                        ctypes.c_char_p]
        if hasattr(lib, "mb_diag_counters"):
            lib.mb_diag_counters.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load_library() is not None


class NativeModbusSlave:
    """Drop-in alternative to ``ModbusSlave`` backed by the C++ data plane."""

    def __init__(self, register_map: ModbusRegisterMap,
                 config: Optional[ModbusServerConfig] = None,
                 units: Optional[list] = None):
        lib = _load_library()
        if lib is None:
            raise RuntimeError(
                "Native modbus library unavailable (the g++ build of "
                "native/modbus_server.cpp failed)")
        self._lib = lib
        self.register_map = register_map
        self.config = config or ModbusServerConfig()

        ids = tuple(units) if units else (self.config.unit_id,)
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate unit ids: {ids}")
        if not all(0 <= u <= 0xFE for u in ids):
            raise ValueError(f"unit ids must be in [0, 254]: {ids}")
        self.units = ids
        self._primary = (self.config.unit_id
                         if self.config.unit_id in ids else ids[0])

        def block_size(regs):
            if not regs:
                return 16
            return max(r.address + r.size_words for r in regs) + 10

        sizes = (ctypes.c_uint32 * 4)(
            block_size(register_map.coils),
            block_size(register_map.discrete_inputs),
            block_size(register_map.input_registers),
            block_size(register_map.holding_registers))
        self._handle = lib.mb_create(sizes)
        # Serve only the configured unit ids (FC 43 identity is compiled
        # into the C++ side with the same strings as ModbusSlave.device_info).
        # The primary unit's bank is the one mb_create made; every other id
        # gets its own bank (fleet mode — gateway multiplexing).
        lib.mb_set_unit_id(self._handle, int(self._primary))
        # Runtime connection cap (the C++ plane's historic compile-time 64
        # is now a default): size it to config like the Python plane so
        # 1000-client load targets work. Older prebuilt .so files lack the
        # symbol — degrade to the built-in default.
        if hasattr(lib, "mb_set_max_clients"):
            lib.mb_set_max_clients.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int]
            lib.mb_set_max_clients(self._handle,
                                   int(self.config.max_connections))
        elif self.config.max_connections > 64:
            import logging
            logging.getLogger(__name__).warning(
                "native Modbus library predates mb_set_max_clients "
                "(stale libwtmodbus.so?): the compile-time cap of 64 "
                "connections applies, not the configured %d — masters "
                "beyond 64 will be refused; rebuild with `make -C native`",
                self.config.max_connections)
        for u in ids:
            if u != self._primary:
                if lib.mb_add_unit(self._handle, int(u)) != 0:
                    raise RuntimeError(f"mb_add_unit({u}) failed")
        self._running = False
        self._actual_port: Optional[int] = None

    # -- lifecycle --
    def start(self, blocking: bool = False) -> None:
        if self._running:
            raise RuntimeError("Server already running")
        port = self._lib.mb_start(self._handle,
                                  self.config.host.encode(),
                                  self.config.port)
        if port < 0:
            raise RuntimeError(
                f"Native Modbus server failed to bind "
                f"{self.config.host}:{self.config.port}")
        self._actual_port = port
        self._running = True
        logger.info("Native Modbus TCP server listening on %s:%d",
                    self.config.host, port)
        if blocking:
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                self.stop()

    def stop(self) -> None:
        if self._running:
            self._lib.mb_stop(self._handle)
            self._running = False

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.mb_destroy(self._handle)
                self._handle = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    @property
    def port(self) -> Optional[int]:
        return self._actual_port

    @property
    def is_running(self) -> bool:
        return self._running

    @property
    def request_count(self) -> int:
        return int(self._lib.mb_request_count(self._handle))

    @property
    def error_count(self) -> int:
        return int(self._lib.mb_error_count(self._handle))

    def diagnostics(self) -> dict:
        """The FC 08 diagnostic counters (also served on the wire via
        Diagnostics sub-functions 0x0B-0x0F; clear with sub 0x0A) — the
        reference's explicitly listed protocol limitation
        (reference README.md:537)."""
        import ctypes as _ct
        if not hasattr(self._lib, "mb_diag_counters"):
            # stale prebuilt libwtmodbus.so (same degradation story as
            # mb_set_max_clients above) — fail with a curated message
            # instead of a bare ctypes AttributeError
            raise RuntimeError(
                "native Modbus library predates mb_diag_counters — "
                "rebuild native/modbus_server.cpp (make -C native) or use "
                "the Python plane's diagnostics()")
        out = (_ct.c_uint64 * 5)()
        self._lib.mb_diag_counters(self._handle, out)
        return {"bus_message_count": int(out[0]),
                "bus_comm_error_count": int(out[1]),
                "bus_exception_count": int(out[2]),
                "slave_message_count": int(out[3]),
                "slave_no_response_count": int(out[4])}

    # -- raw word access --
    def _resolve_unit(self, unit) -> int:
        if unit is None:
            return -1                       # C side: -1 = primary bank
        if unit not in self.units:
            raise KeyError(f"not serving unit id {unit} "
                           f"(units: {self.units})")
        return int(unit)

    def _get_words(self, block: int, address: int, count: int, unit=None):
        out = (ctypes.c_uint16 * count)()
        if self._lib.mb_get_unit(self._handle, self._resolve_unit(unit),
                                 block, address, count, out) != 0:
            raise IndexError(f"block {block} address {address}+{count} "
                             f"out of range")
        return list(out)

    def _set_words(self, block: int, address: int, values, unit=None):
        arr = (ctypes.c_uint16 * len(values))(*[v & 0xFFFF for v in values])
        if self._lib.mb_set_unit(self._handle, self._resolve_unit(unit),
                                 block, address, len(values), arr) != 0:
            raise IndexError(f"block {block} address {address}+{len(values)} "
                             f"out of range")

    # -- name-based API (mirrors ModbusSlave, slave.py:139-245) --
    def _lookup(self, name: str, register_type: RegisterType):
        reg = self.register_map.get_register_by_name(name)
        if reg is None or reg.register_type != register_type:
            raise KeyError(f"No {register_type.name} register named '{name}'")
        return reg

    @staticmethod
    def _validate_value(value: float) -> None:
        if not (-MAX_REGISTER_VALUE < value < MAX_REGISTER_VALUE):
            raise ValueError(f"Value {value} outside +-{MAX_REGISTER_VALUE}")

    def update_input_register(self, name: str, value: float,
                              unit=None) -> None:
        reg = self._lookup(name, RegisterType.INPUT_REGISTER)
        if reg.data_type == "float32":
            if not math.isnan(value):
                self._validate_value(value)
            self._set_words(_BLOCK_INPUT, reg.address,
                            ModbusEncoder.float32_to_registers(value),
                            unit=unit)
        else:
            self._set_words(_BLOCK_INPUT, reg.address,
                            [ModbusEncoder.uint16_to_register(int(value))],
                            unit=unit)

    def update_discrete_input(self, name: str, value: bool,
                              unit=None) -> None:
        reg = self._lookup(name, RegisterType.DISCRETE_INPUT)
        self._set_words(_BLOCK_DISCRETE, reg.address, [1 if value else 0],
                        unit=unit)

    def read_input_register(self, name: str, unit=None) -> float:
        """Name-based read-back of a published input register (used by
        the OPC UA bridge so both planes serve one store)."""
        reg = self._lookup(name, RegisterType.INPUT_REGISTER)
        words = self._get_words(_BLOCK_INPUT, reg.address, reg.size_words,
                                unit=unit)
        if reg.data_type == "float32":
            return ModbusDecoder.registers_to_float32(*words)
        return float(words[0])

    def read_discrete_input(self, name: str, unit=None) -> bool:
        reg = self._lookup(name, RegisterType.DISCRETE_INPUT)
        return bool(self._get_words(_BLOCK_DISCRETE, reg.address, 1,
                                    unit=unit)[0])

    def read_holding_register(self, name: str, unit=None) -> float:
        reg = self._lookup(name, RegisterType.HOLDING_REGISTER)
        words = self._get_words(_BLOCK_HOLDING, reg.address, reg.size_words,
                                unit=unit)
        if reg.data_type == "float32":
            return ModbusDecoder.registers_to_float32(*words)
        return float(words[0])

    def write_holding_register(self, name: str, value: float,
                               unit=None) -> None:
        reg = self._lookup(name, RegisterType.HOLDING_REGISTER)
        self._validate_value(value)
        if reg.data_type == "float32":
            self._set_words(_BLOCK_HOLDING, reg.address,
                            ModbusEncoder.float32_to_registers(value),
                            unit=unit)
        else:
            self._set_words(_BLOCK_HOLDING, reg.address,
                            [ModbusEncoder.uint16_to_register(int(value))],
                            unit=unit)

    def read_coil(self, name: str, unit=None) -> bool:
        reg = self._lookup(name, RegisterType.COIL)
        return bool(self._get_words(_BLOCK_COILS, reg.address, 1,
                                    unit=unit)[0])

    def write_coil(self, name: str, value: bool, unit=None) -> None:
        reg = self._lookup(name, RegisterType.COIL)
        self._set_words(_BLOCK_COILS, reg.address, [1 if value else 0],
                        unit=unit)

    def get_all_input_registers(self, unit=None) -> Dict[str, float]:
        out = {}
        for reg in self.register_map.input_registers:
            words = self._get_words(_BLOCK_INPUT, reg.address,
                                    reg.size_words, unit=unit)
            if reg.data_type == "float32":
                out[reg.name] = ModbusDecoder.registers_to_float32(*words)
            else:
                out[reg.name] = float(words[0])
        return out

    def get_all_holding_registers(self, unit=None) -> Dict[str, float]:
        return {reg.name: self.read_holding_register(reg.name, unit=unit)
                for reg in self.register_map.holding_registers}
