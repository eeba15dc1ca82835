"""
Declarative Modbus register map.

Address-for-address and name-for-name parity with the reference
(modbus/register_map.py:91-556): 9 input registers (pH x3, Cl x2, flow,
temp x2, sim time, status), 6 holding registers (3 actuator flows, 2 dosing
concentrations, sim timestep), 3 coils (pump enables, sim running), 3
discrete inputs (sensor fault bits). float32 occupies two big-endian words.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import List, Optional, Tuple


class RegisterType(IntEnum):
    """Modbus register types (reference register_map.py:32-38)."""

    COIL = 0
    DISCRETE_INPUT = 1
    INPUT_REGISTER = 3
    HOLDING_REGISTER = 4


@dataclass
class RegisterDefinition:
    """One register (or float32 register pair)
    (reference register_map.py:41-88)."""

    address: int
    name: str
    register_type: RegisterType
    data_type: str
    units: str
    description: str
    read_only: bool = True
    # Engineering-unit range (low, high) for analog values: drives the
    # OPC UA EURange property and percent-deadband conversion (Part 8
    # section 5.6.3.3); None for counters/codes with no natural span.
    eu_range: "Optional[Tuple[float, float]]" = None

    def validate(self):
        if self.address < 0 or self.address > 65535:
            raise ValueError(
                f"Register address {self.address} out of range [0, 65535]")
        if self.eu_range is not None:
            low, high = self.eu_range
            if not (low < high):
                raise ValueError(
                    f"Register {self.name}: eu_range low ({low}) must be "
                    f"< high ({high})")
        if self.data_type not in ("float32", "int16", "uint16", "bool"):
            raise ValueError(f"Unknown data type: {self.data_type}")
        if self.register_type == RegisterType.HOLDING_REGISTER \
                and self.read_only:
            raise ValueError(
                f"Holding register {self.name} marked as read-only")
        if self.register_type == RegisterType.INPUT_REGISTER \
                and not self.read_only:
            raise ValueError(f"Input register {self.name} marked as writable")

    @property
    def size_words(self) -> int:
        return 2 if self.data_type == "float32" else 1


def _ir(address, name, units, description, eu_range=None):
    return RegisterDefinition(address, name, RegisterType.INPUT_REGISTER,
                              "float32", units, description, read_only=True,
                              eu_range=eu_range)


def _hr(address, name, units, description, eu_range=None):
    return RegisterDefinition(address, name, RegisterType.HOLDING_REGISTER,
                              "float32", units, description,
                              read_only=False, eu_range=eu_range)


class ModbusRegisterMap:
    """Register layout only — no sensor/actuator/control logic
    (reference register_map.py:91-102)."""

    def __init__(self, extended_nitrogen: bool = False,
                 extended_gas: bool = False,
                 extended_particles: bool = False,
                 extended_disinfection: bool = False,
                 extended_biofilm: bool = False,
                 extended_phase: bool = False):
        """``extended_nitrogen=True`` appends the nitrogen-chemistry
        extension's registers (core/nitrogen.py) at addresses the
        reference map leaves free — the base map stays address-identical
        to the reference either way. ``extended_gas=True`` likewise appends
        the gas-exchange extension's registers (core/gas.py): dissolved-O2
        and carbonate telemetry plus the diffused-aeration actuator.
        ``extended_particles=True`` appends the particle-dynamics
        extension's registers (core/particles.py): turbidity/TSS/sludge
        telemetry plus the coagulant, filtration, and blowdown
        actuators. ``extended_disinfection=True`` appends the
        disinfection extension's registers (core/disinfection.py):
        per-pathogen log-removal credit, CT, water age, THM, and UVT
        telemetry plus the UV-lamp and source-water-TOC inputs.
        ``extended_biofilm=True`` appends the biofilm/regrowth
        extension's registers (core/biofilm.py): HPC plate-count, BDOC
        and peak wall-film telemetry plus the source-water HPC/BDOC
        inputs. ``extended_phase=True`` appends the phase-change
        extension's registers (core/phase.py): surface/worst ice-fraction
        telemetry plus the weather inputs (ambient temperature, relative
        humidity, wind speed) the freeze/evaporation physics responds
        to."""
        # Input registers (reference register_map.py:119-244)
        # eu_range values mirror the instruments' measurement ranges
        # (sensor wrappers) and the orchestrator's zero-trust clamps
        # (__main__.validate_flow_rate max 20); simulation_time is an
        # unbounded counter, so it carries none.
        self.input_registers: List[RegisterDefinition] = [
            _ir(0, "pH_inlet", "pH", "pH at inlet (zone 0)",
                eu_range=(0.0, 14.0)),
            _ir(2, "pH_middle", "pH", "pH at middle (zone n/2)",
                eu_range=(0.0, 14.0)),
            _ir(4, "pH_outlet", "pH", "pH at outlet (zone -1)",
                eu_range=(0.0, 14.0)),
            _ir(6, "chlorine_inlet", "mg/L", "Free chlorine at inlet",
                eu_range=(0.0, 10.0)),
            _ir(8, "chlorine_outlet", "mg/L", "Free chlorine at outlet",
                eu_range=(0.0, 10.0)),
            _ir(10, "flow_rate", "L/min", "Main flow rate",
                eu_range=(0.0, 20.0)),
            _ir(12, "temperature_inlet", "degC",
                "Water temperature at inlet", eu_range=(0.0, 50.0)),
            _ir(14, "temperature_outlet", "degC",
                "Water temperature at outlet", eu_range=(0.0, 50.0)),
            _ir(100, "simulation_time", "s", "Simulation elapsed time"),
            RegisterDefinition(102, "system_status",
                               RegisterType.INPUT_REGISTER, "uint16", "",
                               "System status code (0=OK, >0=fault)",
                               read_only=True),
        ]
        if extended_nitrogen:
            self.input_registers += [
                _ir(20, "ammonia_outlet", "mg N/L",
                    "Total ammonia nitrogen at outlet",
                    eu_range=(0.0, 10.0)),
                _ir(22, "nitrite_outlet", "mg N/L", "Nitrite at outlet",
                    eu_range=(0.0, 10.0)),
                _ir(24, "nitrate_outlet", "mg N/L", "Nitrate at outlet",
                    eu_range=(0.0, 50.0)),
                _ir(26, "chloramine_outlet", "mg/L as Cl2",
                    "Combined chlorine (monochloramine) at outlet",
                    eu_range=(0.0, 5.0)),
            ]
        if extended_gas:
            self.input_registers += [
                _ir(28, "oxygen_outlet", "mg/L",
                    "Dissolved oxygen at outlet",
                    eu_range=(0.0, 20.0)),
                _ir(30, "carbonate_outlet", "mmol/L",
                    "Total carbonate (C_T) at outlet",
                    eu_range=(0.0, 20.0)),
            ]
        if extended_particles:
            self.input_registers += [
                _ir(32, "turbidity_outlet", "NTU",
                    "Turbidity at outlet (nephelometric)",
                    eu_range=(0.0, 1000.0)),
                _ir(34, "tss_outlet", "mg/L",
                    "Total suspended solids at outlet",
                    eu_range=(0.0, 500.0)),
                _ir(36, "sludge_level", "mg/L",
                    "Settled sludge inventory (bottom-zone equivalent)",
                    eu_range=(0.0, 10000.0)),
            ]
        if extended_disinfection:
            self.input_registers += [
                _ir(38, "virus_log_removal", "log10",
                    "Virus log inactivation credit at outlet",
                    eu_range=(0.0, 30.0)),
                _ir(40, "giardia_log_removal", "log10",
                    "Giardia log inactivation credit at outlet",
                    eu_range=(0.0, 30.0)),
                _ir(42, "crypto_log_removal", "log10",
                    "Cryptosporidium log inactivation credit at outlet",
                    eu_range=(0.0, 30.0)),
                _ir(44, "ct_outlet", "mg min/L",
                    "Accumulated disinfectant CT credit at outlet",
                    eu_range=(0.0, 10000.0)),
                _ir(46, "water_age_outlet", "min",
                    "Water age at outlet", eu_range=(0.0, 100000.0)),
                _ir(48, "thm_outlet", "ug/L",
                    "Total trihalomethanes at outlet",
                    eu_range=(0.0, 1000.0)),
                _ir(50, "uvt_outlet", "%",
                    "UV transmittance (254 nm, 1 cm) at outlet",
                    eu_range=(0.0, 100.0)),
            ]
        if extended_biofilm:
            self.input_registers += [
                _ir(52, "hpc_outlet", "CFU/mL",
                    "Heterotrophic plate count at outlet",
                    eu_range=(0.0, 1.0e7)),
                _ir(54, "bdoc_outlet", "mg/L",
                    "Biodegradable dissolved organic carbon at outlet",
                    eu_range=(0.0, 10.0)),
                _ir(56, "biofilm_peak", "mg C/m2",
                    "Peak wall-attached biofilm density across zones",
                    eu_range=(0.0, 2000.0)),
            ]
        if extended_phase:
            self.input_registers += [
                _ir(58, "ice_fraction_top", "frac",
                    "Ice fraction at the surface zone (0 = open water, "
                    "1 = solid lid)", eu_range=(0.0, 1.0)),
                _ir(60, "ice_fraction_max", "frac",
                    "Worst ice fraction across zones",
                    eu_range=(0.0, 1.0)),
            ]

        # Holding registers (reference register_map.py:246-323)
        self.holding_registers: List[RegisterDefinition] = [
            _hr(0, "acid_flow_rate", "L/min",
                "Acid dosing pump flow rate setpoint",
                eu_range=(0.0, 20.0)),
            _hr(2, "chlorine_flow_rate", "L/min",
                "Chlorine dosing pump flow rate setpoint",
                eu_range=(0.0, 20.0)),
            _hr(4, "inlet_flow_rate", "L/min",
                "Main inlet flow rate setpoint", eu_range=(0.0, 20.0)),
            _hr(10, "acid_concentration", "mol/L",
                "Acid stock solution concentration",
                eu_range=(0.0, 1.0)),
            _hr(12, "chlorine_concentration", "mg/L",
                "Chlorine stock solution concentration",
                eu_range=(0.0, 100.0)),
            _hr(100, "simulation_timestep", "s", "Simulation time step",
                eu_range=(0.0, 60.0)),
        ]
        if extended_nitrogen:
            self.holding_registers += [
                _hr(14, "inlet_ammonia", "mg N/L",
                    "Source-water total ammonia nitrogen",
                    eu_range=(0.0, 10.0)),
            ]
        if extended_gas:
            self.holding_registers += [
                _hr(16, "aeration_kla", "1/s",
                    "Diffused-aeration volumetric kLa setpoint "
                    "(0 = blowers off)",
                    eu_range=(0.0, 0.1)),
            ]
        if extended_particles:
            self.holding_registers += [
                _hr(18, "coagulant_dose", "mg/L",
                    "Coagulant dose setpoint",
                    eu_range=(0.0, 100.0)),
                _hr(20, "filter_flow_rate", "L/min",
                    "Recirculating filter flow setpoint",
                    eu_range=(0.0, 60.0)),
                _hr(22, "sludge_blowdown", "1/s",
                    "Sludge blowdown (wasting) rate",
                    eu_range=(0.0, 0.01)),
            ]
        if extended_disinfection:
            self.holding_registers += [
                _hr(24, "uv_intensity", "mW/cm2",
                    "UV bank lamp wall fluence rate setpoint "
                    "(0 = lamps off)",
                    eu_range=(0.0, 50.0)),
                _hr(26, "inlet_toc", "mg/L",
                    "Source-water total organic carbon",
                    eu_range=(0.0, 20.0)),
            ]
        if extended_biofilm:
            self.holding_registers += [
                _hr(28, "inlet_bdoc", "mg/L",
                    "Source-water biodegradable dissolved organic carbon",
                    eu_range=(0.0, 10.0)),
                _hr(30, "inlet_hpc", "CFU/mL",
                    "Source-water heterotrophic plate count",
                    eu_range=(0.0, 1.0e7)),
            ]
        if extended_phase:
            self.holding_registers += [
                _hr(32, "ambient_humidity", "frac",
                    "Ambient relative humidity (0-1) for the evaporation "
                    "model", eu_range=(0.0, 1.0)),
                _hr(34, "wind_speed", "m/s",
                    "Wind speed over the free surface",
                    eu_range=(0.0, 30.0)),
                _hr(36, "ambient_temperature", "C",
                    "Ambient air temperature for heat loss / evaporation",
                    eu_range=(-60.0, 60.0)),
            ]

        # Coils (reference register_map.py:325-362)
        self.coils: List[RegisterDefinition] = [
            RegisterDefinition(0, "acid_pump_enable", RegisterType.COIL,
                               "bool", "", "Enable acid dosing pump",
                               read_only=False),
            RegisterDefinition(1, "chlorine_pump_enable", RegisterType.COIL,
                               "bool", "", "Enable chlorine dosing pump",
                               read_only=False),
            RegisterDefinition(2, "simulation_running", RegisterType.COIL,
                               "bool", "", "Simulation running",
                               read_only=False),
        ]

        # Discrete inputs (reference register_map.py:364-401)
        self.discrete_inputs: List[RegisterDefinition] = [
            RegisterDefinition(0, "sensor_fault_pH_inlet",
                               RegisterType.DISCRETE_INPUT, "bool", "",
                               "pH inlet sensor fault status"),
            RegisterDefinition(1, "sensor_fault_pH_outlet",
                               RegisterType.DISCRETE_INPUT, "bool", "",
                               "pH outlet sensor fault status"),
            RegisterDefinition(2, "sensor_fault_chlorine",
                               RegisterType.DISCRETE_INPUT, "bool", "",
                               "Chlorine sensor fault status"),
        ]

        self._validate_all()

    # -- validation (reference register_map.py:403-446) --
    def _validate_all(self):
        for reg in self.all_registers():
            reg.validate()
        self._check_conflicts(self.input_registers, "Input registers")
        self._check_conflicts(self.holding_registers, "Holding registers")
        self._check_conflicts(self.coils, "Coils")
        self._check_conflicts(self.discrete_inputs, "Discrete inputs")

    @staticmethod
    def _check_conflicts(registers, type_name):
        spans = sorted((r.address, r.address + r.size_words - 1, r.name)
                       for r in registers)
        for (s0, e0, n0), (s1, e1, n1) in zip(spans, spans[1:]):
            if e0 >= s1:
                raise ValueError(
                    f"{type_name} address conflict: {n0} [{s0}-{e0}] "
                    f"overlaps with {n1} [{s1}-{e1}]")

    def all_registers(self):
        return (self.input_registers + self.holding_registers + self.coils
                + self.discrete_inputs)

    # -- lookup (reference register_map.py:448-499) --
    def get_register_by_name(self, name: str) -> Optional[RegisterDefinition]:
        for reg in self.all_registers():
            if reg.name == name:
                return reg
        return None

    def get_register_by_address(self, address: int,
                                register_type: RegisterType
                                ) -> Optional[RegisterDefinition]:
        table = {
            RegisterType.INPUT_REGISTER: self.input_registers,
            RegisterType.HOLDING_REGISTER: self.holding_registers,
            RegisterType.COIL: self.coils,
            RegisterType.DISCRETE_INPUT: self.discrete_inputs,
        }.get(register_type)
        if table is None:
            return None
        for reg in table:
            if reg.address <= address < reg.address + reg.size_words:
                return reg
        return None

    # -- documentation (reference register_map.py:501-556) --
    def print_register_map(self):
        print("=" * 80)
        print("MODBUS REGISTER MAP")
        print("=" * 80)
        sections = [
            ("INPUT REGISTERS (Read-Only Sensor Values)",
             self.input_registers, 30001),
            ("HOLDING REGISTERS (Read/Write Actuator Setpoints)",
             self.holding_registers, 40001),
            ("COILS (Read/Write Discrete Outputs)", self.coils, 1),
            ("DISCRETE INPUTS (Read-Only Status Bits)",
             self.discrete_inputs, 10001),
        ]
        for title, regs, base in sections:
            print(f"\n{title}")
            print("-" * 80)
            for reg in regs:
                addr = base + reg.address
                addr_str = (f"{addr}-{addr + 1}"
                            if reg.data_type == "float32" else str(addr))
                print(f"{addr_str:<12} {reg.name:<25} {reg.data_type:<10} "
                      f"{reg.units:<8} {reg.description}")
        print("\n" + "=" * 80)
