"""
The reference simulator's sensor classes over the functional core (port of
``ics_wt_physicsengine_tpu/sensors/wrappers.py``), and the ammonia, oxygen
and turbidity instruments of the extension axes in the same shell.

These classes present the ``BaseSensor`` surface (``read`` / ``calibrate``
/ ``get_statistics`` / ``reset`` and the per-type extras) while all
measurement math runs through the pure transforms in ph.py / chlorine.py /
flow.py / temperature.py / ammonia.py / oxygen.py / turbidity.py on the
sensor's device. The wrapper owns host-side concerns only: the bounded
reading and calibration history, monotonic-time enforcement, duck-typed
state access, and enum conversion.

The duck-typed state contract is kept: ``read`` accepts any object with the
arrays the sensor needs (``.pH``, ``.chlorine``, ``.temperature``,
``.flow_rate``, ``.ammonia``, ``.oxygen``, ``.tss``), tensors or NumPy
values.

Each sensor takes ``device`` (``None``: the CUDA card) and ``seed``: its
draws come from a ``torch.Generator`` on that device (``seed=None`` takes
one from ``secrets``). ``read`` also takes the draws themselves
(``rand=``), which is how the tests feed both packages the same numbers.
One read costs the device one short chain of elementwise launches and the
host one copy of the reading's eight fields.
"""

from __future__ import annotations

import secrets
import threading
import time as time_module
from collections import deque
from dataclasses import replace
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, resolve_device,
                                               tensor_from_numpy)
from ics_wt_physicsengine_torch.core import particles as PC
from ics_wt_physicsengine_torch.sensors import ammonia as AM
from ics_wt_physicsengine_torch.sensors import base as B
from ics_wt_physicsengine_torch.sensors import chlorine as CL
from ics_wt_physicsengine_torch.sensors import electrical as E
from ics_wt_physicsengine_torch.sensors import flow as FL
from ics_wt_physicsengine_torch.sensors import oxygen as OX
from ics_wt_physicsengine_torch.sensors import ph as PH
from ics_wt_physicsengine_torch.sensors import temperature as TP
from ics_wt_physicsengine_torch.sensors import turbidity as TB
from ics_wt_physicsengine_torch.sensors.types import (
    FAULT_FROM_CODE,
    STATUS_FROM_CODE,
    CalibrationRecord,
    InstallationQuality,
    SampleLine,
    SensorFault,
    SensorReading,
    SensorStatus,
)


def _zone(arr, idx):
    """Zone ``idx`` of a profile: a tensor stays on its device."""
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    n = arr.shape[-1]
    if idx >= n or idx < -n:
        raise IndexError(f"zone_index {idx} out of bounds for {n} zones")
    return arr[..., idx]


def _new_generator(seed: Optional[int], device) -> torch.Generator:
    if seed is None:
        seed = secrets.randbits(63)
    return torch.Generator(device=device).manual_seed(seed)


class _SensorShell:
    """Common wrapper machinery (history, calibration, statistics)."""

    def __init__(self, name: str, params, carry, read_fn,
                 max_history_length: int = 1000,
                 calibration_validity_hours: float = 24.0,
                 seed: Optional[int] = None):
        if not isinstance(name, str) or len(name) == 0:
            raise ValueError("Sensor name must be non-empty string")
        self.name = name
        self.params = params
        self.carry = carry
        self._read_fn = read_fn
        self.device = carry.base.current_value.device
        self._dtype = carry.base.current_value.dtype
        self._generator = _new_generator(seed, self.device)
        self.max_history_length = max_history_length
        self.calibration_validity_hours = calibration_validity_hours
        self.reading_history: Deque[SensorReading] = deque(
            maxlen=max_history_length)
        self.calibration_history: Deque[CalibrationRecord] = deque(maxlen=100)
        self._state_lock = threading.RLock()
        # opt-in electrical-environment stage (sensors/electrical.py):
        # EMI / cable capacitance / ground loop on the transmitted value
        self._electrical_params = None
        self._electrical_carry = None
        self._electrical_generator = None

    def attach_electrical(self, params, seed: int = 0) -> None:
        """Attach an electrical-environment model (EMI pickup, cable RC,
        ground loop: sensors/electrical.py) to this sensor's transmitted
        signal. The stage corrupts the reported value; the status and fault
        fields still reflect the instrument itself."""
        with self._state_lock:
            self._electrical_params = params
            self._electrical_carry = None     # seeded on the first read
            self._electrical_generator = _new_generator(seed, self.device)

    def _scalar(self, x) -> torch.Tensor:
        return tensor_from_numpy(x, self._dtype, self.device)

    # -- attribute parity helpers --
    @property
    def min_value(self):
        return float(self.params.base.min_value)

    @property
    def max_value(self):
        return float(self.params.base.max_value)

    @property
    def precision(self):
        return float(self.params.base.precision)

    @property
    def current_value(self):
        return float(self.carry.base.current_value)

    @property
    def status(self) -> SensorStatus:
        return STATUS_FROM_CODE[int(self.carry.base.status)]

    @property
    def fault(self) -> SensorFault:
        return FAULT_FROM_CODE[int(self.carry.base.fault)]

    @property
    def cumulative_drift(self):
        if self.reading_history:
            return self.reading_history[-1].drift
        return 0.0

    def _extract_inputs(self, reactor_state):
        raise NotImplementedError

    def read(self, reactor_state, current_time: Optional[float] = None,
             rand=None, electrical_rand=None) -> SensorReading:
        """One reading of ``reactor_state`` at ``current_time`` (default:
        the monotonic clock). ``rand`` / ``electrical_rand``: optional
        pre-drawn ``(normals, uniforms)`` for the instrument and for an
        attached electrical stage; by default both draw from the sensor's
        generators."""
        with self._state_lock:
            if current_time is None:
                current_time = time_module.monotonic()
            if (self.reading_history
                    and current_time < self.reading_history[-1].timestamp):
                raise ValueError(
                    f"Non-monotonic time: {current_time} < "
                    f"{self.reading_history[-1].timestamp}")

            inputs = self._extract_inputs(reactor_state)
            self.carry, out = self._read_fn(
                self.params, self.carry, *inputs, float(current_time),
                rand=rand, generator=self._generator)
            value = out.value
            if self._electrical_params is not None:
                if self._electrical_carry is None:
                    # seed at the first read's clock so the first dt is 0
                    # (no burst or walk jump from a huge gap)
                    self._electrical_carry = E.make_electrical_carry(
                        self._electrical_params, t0=float(current_time))
                self._electrical_carry, value = E.electrical_transform(
                    self._electrical_params, self._electrical_carry,
                    value, float(current_time), rand=electrical_rand,
                    generator=self._electrical_generator)
            # one copy to the host for the whole reading
            fields = torch.stack([
                out.timestamp, value.to(self._dtype), out.raw_value,
                out.noise, out.drift, out.uncertainty,
                out.status.to(self._dtype), out.fault.to(self._dtype),
            ]).tolist()
            reading = SensorReading(
                timestamp=fields[0], value=fields[1], raw_value=fields[2],
                noise=fields[3], drift=fields[4],
                status=STATUS_FROM_CODE[int(fields[6])],
                uncertainty=fields[5],
                fault=FAULT_FROM_CODE[int(fields[7])],
            )
            self.reading_history.append(reading)
            return reading

    def calibrate(self, reference_value: float,
                  current_time: Optional[float] = None,
                  operator_id: str = "auto",
                  validity_hours: Optional[float] = None) -> CalibrationRecord:
        with self._state_lock:
            if current_time is None:
                current_time = time_module.monotonic()
            measured = float(self.carry.base.current_value)
            validity = validity_hours or self.calibration_validity_hours
            new_base, offset = B.calibrate(
                self.carry.base, reference_value, current_time,
                validity_hours=validity)
            self.carry = replace(self.carry, base=new_base)
            record = CalibrationRecord(
                timestamp=current_time, reference_value=reference_value,
                measured_value=measured, offset=float(offset),
                operator_id=operator_id, validity_hours=validity)
            self.calibration_history.append(record)
            return record

    def get_recent_readings(self,
                            window_seconds: float) -> List[SensorReading]:
        with self._state_lock:
            if not self.reading_history:
                return []
            cutoff = self.reading_history[-1].timestamp - window_seconds
            return [r for r in reversed(self.reading_history)
                    if r.timestamp >= cutoff]

    def calculate_drift_rate(self, window_seconds: float = 3600.0) -> float:
        recent = self.get_recent_readings(window_seconds)
        if len(recent) < 2:
            return 0.0
        dt = recent[0].timestamp - recent[-1].timestamp
        if dt > 0:
            return (recent[0].drift - recent[-1].drift) / dt * 3600.0
        return 0.0

    def get_statistics(self, window_seconds: float = 60.0) -> Dict[str, float]:
        recent = self.get_recent_readings(window_seconds)
        if not recent:
            return {"mean": 0.0, "std": 0.0, "min": 0.0, "max": 0.0,
                    "count": 0, "drift_rate": 0.0, "fault_rate": 0.0}
        values = np.array([r.value for r in recent
                           if np.isfinite(r.value)])
        if len(values) == 0:
            return {"mean": np.nan, "std": np.nan, "min": np.nan,
                    "max": np.nan, "count": len(recent), "drift_rate": 0.0,
                    "fault_rate": 1.0}
        fault_count = sum(1 for r in recent if not np.isfinite(r.value))
        return {
            "mean": float(np.mean(values)), "std": float(np.std(values)),
            "min": float(np.min(values)), "max": float(np.max(values)),
            "count": len(recent),
            "drift_rate": self.calculate_drift_rate(window_seconds),
            "fault_rate": fault_count / len(recent),
        }

    def inject_fault(self, kind: str = "power_low") -> None:
        """Scripted fault injection: force a latching supply-power fault.
        Reads return NaN with POWER_FAULT until ``clear_faults()`` (or
        maintenance) repairs it."""
        with self._state_lock:
            self.carry = replace(
                self.carry,
                base=B.inject_power_fault(self.carry.base, kind))

    def clear_faults(self) -> None:
        """Repair an injected (or organic) power fault: nominal supply
        voltage, fault and status cleared."""
        with self._state_lock:
            self.carry = replace(
                self.carry, base=B.clear_power_fault(self.carry.base))

    def reset(self, seed: Optional[int] = None) -> None:
        """Fresh carry, empty histories, and the generator reseeded
        (``seed=None``: from ``secrets``)."""
        with self._state_lock:
            self.reading_history.clear()
            self.calibration_history.clear()
            self.carry = self._fresh_carry()
            self._generator = _new_generator(seed, self.device)

    def _fresh_carry(self):
        raise NotImplementedError

    def __repr__(self) -> str:
        return (f"{self.__class__.__name__}(name='{self.name}', "
                f"value={self.current_value:.3f}, "
                f"status={self.status.value})")


# The reference simulator's abstract base class name: users subclass
# BaseSensor to build custom instruments, supplying parameters, a carry and
# a read transform ``fn(params, carry, *inputs, t, rand=, generator=)``.
BaseSensor = _SensorShell


class pHSensor(_SensorShell):
    """Glass-electrode pH sensor."""

    def __init__(self, name: str, zone_index: int = 0, precision: float = 0.01,
                 response_time: float = 15.0, drift_rate: float = 0.01 / 24.0,
                 temperature_coefficient: float = 0.003,
                 max_history_length: int = 1000,
                 sample_line: Optional[SampleLine] = None,
                 installation: Optional[InstallationQuality] = None,
                 calibration_validity_hours: float = 24.0,
                 seed: Optional[int] = None, dtype=DEFAULT_DTYPE,
                 device=None):
        dev = resolve_device(device)
        self.zone_index = zone_index
        self.temperature_coefficient = temperature_coefficient
        self.sample_line = sample_line
        self.installation = installation or InstallationQuality()
        params = PH.make_ph_params(
            zone_index=zone_index, precision=precision,
            response_time=response_time, drift_rate=drift_rate,
            temperature_coefficient=temperature_coefficient,
            sample_line=sample_line, installation=installation,
            dtype=dtype, device=dev)
        carry = PH.make_ph_carry(params, dtype=dtype, device=dev)
        super().__init__(name, params, carry, PH.ph_read, max_history_length,
                         calibration_validity_hours, seed)

    def _fresh_carry(self):
        return PH.make_ph_carry(self.params, dtype=self._dtype,
                                device=self.device)

    def _extract_inputs(self, reactor_state):
        ph = _zone(reactor_state.pH, self.zone_index)
        if hasattr(reactor_state, "temperature"):
            temp = _zone(reactor_state.temperature, self.zone_index)
        else:
            temp = 25.0
        return ph, temp

    # -- pH-specific extras --
    @property
    def membrane_fouling(self):
        return float(self.carry.membrane_fouling)

    @property
    def slope_percentage(self):
        return float(self.carry.slope_percentage)

    def calibrate_two_point(self, buffer_pH_1, buffer_pH_2, measured_pH_1,
                            measured_pH_2, current_time=None,
                            operator_id="auto"):
        if current_time is None:
            current_time = time_module.monotonic()
        if buffer_pH_2 != buffer_pH_1:
            measured_slope = (measured_pH_2 - measured_pH_1) \
                / (buffer_pH_2 - buffer_pH_1)
            slope_pct = measured_slope * 100.0
        else:
            slope_pct = float(self.carry.slope_percentage)
        self.carry = replace(
            self.carry,
            slope_percentage=self._scalar(slope_pct),
            cal_point_1=self._scalar(buffer_pH_1),
            cal_point_2=self._scalar(buffer_pH_2),
            reference_contamination=self._scalar(0.0))
        mid = (buffer_pH_1 + buffer_pH_2) / 2.0
        return self.calibrate(mid, current_time, operator_id)

    def clean_electrode(self, cleaning_method: str, current_time=None):
        if current_time is None:
            current_time = time_module.monotonic()
        self.carry = PH.clean_electrode(self.carry, cleaning_method,
                                        current_time)

    def check_slope_health(self) -> Dict[str, float]:
        slope = float(self.carry.slope_percentage)
        if 95.0 <= slope <= 105.0:
            health = "excellent"
        elif 90.0 <= slope <= 110.0:
            health = "good"
        elif 85.0 <= slope <= 115.0:
            health = "fair"
        else:
            health = "poor"
        days_since_cal = 0.0
        if self.calibration_history:
            days_since_cal = (
                time_module.monotonic()
                - self.calibration_history[-1].timestamp) / 86400.0
        return {
            "slope_percentage": slope,
            "health": health,
            "impedance_ohms": 1e8,
            "days_since_calibration": days_since_cal,
            "membrane_fouling": float(self.carry.membrane_fouling),
            "glass_etching": float(self.carry.glass_etching),
            "days_since_cleaning": float(self.carry.days_since_cleaning),
        }

    def set_water_hardness(self, hardness_mg_L: float):
        if hardness_mg_L < 0:
            raise ValueError(
                f"Hardness must be non-negative, got {hardness_mg_L}")
        self.carry = replace(self.carry,
                             water_hardness=self._scalar(hardness_mg_L))


def _chlorine_read(params, carry, cl, ph, o3, h2o2, clo2, comb, t, rand=None,
                   generator=None):
    return CL.chlorine_read(params, carry, cl, ph, t, ozone=o3,
                            hydrogen_peroxide=h2o2, chlorine_dioxide=clo2,
                            combined_zone=comb, rand=rand,
                            generator=generator)


class ChlorineSensor(_SensorShell):
    """Chlorine sensor (amperometric or DPD colorimetric)."""

    def __init__(self, name: str, zone_index: int = 0,
                 sensor_type: str = CL.AMPEROMETRIC,
                 measurement_type: str = "free",
                 precision: Optional[float] = None,
                 response_time: Optional[float] = None,
                 drift_rate: float = 0.02 / 24.0,
                 max_history_length: int = 1000,
                 sample_line: Optional[SampleLine] = None,
                 installation: Optional[InstallationQuality] = None,
                 calibration_validity_hours: float = 24.0,
                 seed: Optional[int] = None, dtype=DEFAULT_DTYPE,
                 device=None):
        dev = resolve_device(device)
        if hasattr(sensor_type, "value"):       # accept reference-style enums
            sensor_type = sensor_type.value
        self.zone_index = zone_index
        self.sensor_type = sensor_type
        self.measurement_type = measurement_type
        params = CL.make_chlorine_params(
            zone_index=zone_index, sensor_type=sensor_type,
            measurement_type=measurement_type,
            precision=precision, response_time=response_time,
            drift_rate=drift_rate, sample_line=sample_line,
            installation=installation, dtype=dtype, device=dev)
        carry = CL.make_chlorine_carry(params, dtype=dtype, device=dev)
        super().__init__(name, params, carry, _chlorine_read,
                         max_history_length, calibration_validity_hours,
                         seed)

    def _fresh_carry(self):
        return CL.make_chlorine_carry(self.params, dtype=self._dtype,
                                      device=self.device)

    def _extract_inputs(self, reactor_state):
        cl = _zone(reactor_state.chlorine, self.zone_index)
        ph = (_zone(reactor_state.pH, self.zone_index)
              if hasattr(reactor_state, "pH") else 7.5)

        def optional(attr):
            v = getattr(reactor_state, attr, None)
            if hasattr(v, "__getitem__"):
                return _zone(v, self.zone_index)
            return 0.0

        return (cl, ph, optional("ozone"), optional("hydrogen_peroxide"),
                optional("chlorine_dioxide"), optional("chloramine"))

    @property
    def membrane_fouling(self):
        return float(self.carry.membrane_fouling)

    @property
    def reagent_potency(self):
        return float(self.carry.reagent_potency)

    def replace_membrane(self, current_time=None):
        if self.sensor_type != CL.AMPEROMETRIC:
            raise ValueError("Only amperometric sensors have membranes")
        if current_time is None:
            current_time = time_module.monotonic()
        self.carry = CL.replace_membrane(self.carry, current_time)
        self.calibrate(0.0, current_time, operator_id="membrane_replacement")

    def replace_reagent(self, current_time=None, storage_temp: float = 20.0):
        if self.sensor_type != CL.DPD:
            raise ValueError("Only DPD sensors have reagent")
        if current_time is None:
            current_time = time_module.monotonic()
        self.carry = CL.replace_reagent(self.carry, current_time,
                                        storage_temp)
        self.calibrate(0.0, current_time, operator_id="reagent_replacement")


class FlowSensor(_SensorShell):
    """Flow sensor (magnetic or turbine)."""

    def __init__(self, name: str, sensor_type: str = FL.MAGNETIC,
                 full_scale: float = 100.0, precision: Optional[float] = None,
                 response_time: float = 0.5, drift_rate: float = 0.0,
                 max_history_length: int = 1000,
                 sample_line: Optional[SampleLine] = None,
                 installation: Optional[InstallationQuality] = None,
                 seed: Optional[int] = None, dtype=DEFAULT_DTYPE,
                 device=None):
        dev = resolve_device(device)
        if hasattr(sensor_type, "value"):
            sensor_type = sensor_type.value
        self.sensor_type = sensor_type
        self.full_scale = full_scale
        params = FL.make_flow_params(
            sensor_type=sensor_type, full_scale=full_scale,
            precision=precision, response_time=response_time,
            drift_rate=drift_rate, sample_line=sample_line,
            installation=installation, dtype=dtype, device=dev)
        carry = FL.make_flow_carry(params, dtype=dtype, device=dev)
        super().__init__(name, params, carry, FL.flow_read,
                         max_history_length,
                         calibration_validity_hours=8760.0, seed=seed)

    def _fresh_carry(self):
        return FL.make_flow_carry(self.params, dtype=self._dtype,
                                  device=self.device)

    def _extract_inputs(self, reactor_state):
        if not hasattr(reactor_state, "flow_rate"):
            raise AttributeError("reactor_state missing flow_rate attribute")
        return (reactor_state.flow_rate,)

    def read_flow(self, flow_rate: float, current_time=None,
                  rand=None) -> SensorReading:
        """Convenience read from a known value."""

        class MockState:
            pass

        state = MockState()
        state.flow_rate = flow_rate
        return self.read(state, current_time, rand=rand)


class TemperatureSensor(_SensorShell):
    """Temperature sensor (RTD or thermocouple)."""

    def __init__(self, name: str, zone_index: int = 0,
                 sensor_type: str = TP.RTD_PT100,
                 precision: Optional[float] = None,
                 response_time: float = 15.0, drift_rate: float = 0.0,
                 max_history_length: int = 1000,
                 sample_line: Optional[SampleLine] = None,
                 installation: Optional[InstallationQuality] = None,
                 seed: Optional[int] = None, dtype=DEFAULT_DTYPE,
                 device=None):
        dev = resolve_device(device)
        if hasattr(sensor_type, "value"):
            sensor_type = sensor_type.value
        self.zone_index = zone_index
        self.sensor_type = sensor_type
        params = TP.make_temperature_params(
            zone_index=zone_index, sensor_type=sensor_type,
            precision=precision, response_time=response_time,
            drift_rate=drift_rate, sample_line=sample_line,
            installation=installation, dtype=dtype, device=dev)
        carry = TP.make_temperature_carry(params, dtype=dtype, device=dev)
        super().__init__(name, params, carry, TP.temperature_read,
                         max_history_length,
                         calibration_validity_hours=8760.0, seed=seed)

    def _fresh_carry(self):
        return TP.make_temperature_carry(self.params, dtype=self._dtype,
                                         device=self.device)

    def _extract_inputs(self, reactor_state):
        return (_zone(reactor_state.temperature, self.zone_index),)


class AmmoniaSensor(_SensorShell):
    """Total-ammonia-nitrogen sensor (ISE / gas-sensing membrane), the
    instrument of the nitrogen chemistry."""

    def __init__(self, name: str, zone_index: int = 0,
                 sensor_type: str = AM.ISE,
                 precision: Optional[float] = None,
                 response_time: Optional[float] = None,
                 drift_rate: float = 0.02 / 24.0,
                 selectivity_potassium: float = 0.1,
                 potassium_mgL: float = 2.0,
                 max_history_length: int = 1000,
                 sample_line: Optional[SampleLine] = None,
                 installation: Optional[InstallationQuality] = None,
                 calibration_validity_hours: float = 24.0,
                 seed: Optional[int] = None, dtype=DEFAULT_DTYPE,
                 device=None):
        dev = resolve_device(device)
        if hasattr(sensor_type, "value"):
            sensor_type = sensor_type.value
        self.zone_index = zone_index
        self.sensor_type = sensor_type
        params = AM.make_ammonia_params(
            zone_index=zone_index, sensor_type=sensor_type,
            precision=precision, response_time=response_time,
            drift_rate=drift_rate,
            selectivity_potassium=selectivity_potassium,
            potassium_mgL=potassium_mgL, sample_line=sample_line,
            installation=installation, dtype=dtype, device=dev)
        carry = AM.make_ammonia_carry(params, dtype=dtype, device=dev)
        super().__init__(name, params, carry, AM.ammonia_read,
                         max_history_length, calibration_validity_hours,
                         seed)

    def _fresh_carry(self):
        return AM.make_ammonia_carry(self.params, dtype=self._dtype,
                                     device=self.device)

    def _extract_inputs(self, reactor_state):
        tan = _zone(reactor_state.ammonia, self.zone_index)
        ph = (_zone(reactor_state.pH, self.zone_index)
              if hasattr(reactor_state, "pH") else 7.0)
        temp = (_zone(reactor_state.temperature, self.zone_index)
                if hasattr(reactor_state, "temperature") else 20.0)
        return tan, ph, temp

    @property
    def membrane_age_days(self):
        return float(self.carry.membrane_age_days)

    @property
    def slope_percentage(self):
        return float(self.carry.slope_percentage)


class OxygenSensor(_SensorShell):
    """Dissolved-oxygen sensor (optical luminescent / Clark amperometric),
    the instrument of the gas exchange."""

    def __init__(self, name: str, zone_index: int = 0,
                 sensor_type: str = OX.OPTICAL,
                 precision: Optional[float] = None,
                 response_time: Optional[float] = None,
                 drift_rate: float = 0.01 / 24.0,
                 cal_temperature: float = 20.0,
                 max_history_length: int = 1000,
                 sample_line: Optional[SampleLine] = None,
                 installation: Optional[InstallationQuality] = None,
                 calibration_validity_hours: float = 24.0 * 30,
                 seed: Optional[int] = None, dtype=DEFAULT_DTYPE,
                 device=None):
        dev = resolve_device(device)
        if hasattr(sensor_type, "value"):
            sensor_type = sensor_type.value
        self.zone_index = zone_index
        self.sensor_type = sensor_type
        params = OX.make_oxygen_params(
            zone_index=zone_index, sensor_type=sensor_type,
            precision=precision, response_time=response_time,
            drift_rate=drift_rate, cal_temperature=cal_temperature,
            sample_line=sample_line, installation=installation,
            dtype=dtype, device=dev)
        carry = OX.make_oxygen_carry(params, dtype=dtype, device=dev)
        super().__init__(name, params, carry, OX.oxygen_read,
                         max_history_length, calibration_validity_hours,
                         seed)

    def _fresh_carry(self):
        return OX.make_oxygen_carry(self.params, dtype=self._dtype,
                                    device=self.device)

    def _extract_inputs(self, reactor_state):
        o2 = _zone(reactor_state.oxygen, self.zone_index)
        temp = (_zone(reactor_state.temperature, self.zone_index)
                if hasattr(reactor_state, "temperature") else 20.0)
        flow = (reactor_state.flow_rate
                if hasattr(reactor_state, "flow_rate") else 1.0)
        return o2, temp, flow

    def replace_cap(self) -> None:
        """Replace the sensing cap (optical) / membrane and electrolyte
        (Clark): resets all consumable aging."""
        with self._state_lock:
            self.carry = OX.replace_cap(self.carry)

    @property
    def cap_age_days(self):
        return float(self.carry.cap_age_days)

    @property
    def slope_percentage(self):
        return float(self.carry.slope_percentage)

    @property
    def membrane_fouling(self):
        return float(self.carry.membrane_fouling)

    @property
    def electrolyte(self):
        return float(self.carry.electrolyte)


class TurbiditySensor(_SensorShell):
    """Nephelometric turbidity sensor (ISO 7027 90-degree scatter), the
    instrument of the particle dynamics. It is size-blind: its true value
    is the class-weighted NTU of the state's ``tss`` classes under
    ``ntu_weights`` (default: the particle model's weights)."""

    def __init__(self, name: str, zone_index: int = 0,
                 precision: Optional[float] = None,
                 response_time: Optional[float] = None,
                 drift_rate: float = 0.005 / 24.0,
                 ntu_weights=None,
                 max_history_length: int = 1000,
                 sample_line: Optional[SampleLine] = None,
                 installation: Optional[InstallationQuality] = None,
                 calibration_validity_hours: float = 24.0 * 90,
                 seed: Optional[int] = None, dtype=DEFAULT_DTYPE,
                 device=None):
        dev = resolve_device(device)
        self.zone_index = zone_index
        if ntu_weights is None:
            ntu_weights = PC.DEFAULT_NTU_PER_MGL
        self._ntu_weights = np.asarray(ntu_weights, float)
        params = TB.make_turbidity_params(
            zone_index=zone_index, precision=precision,
            response_time=response_time, drift_rate=drift_rate,
            sample_line=sample_line, installation=installation,
            dtype=dtype, device=dev)
        carry = TB.make_turbidity_carry(params, dtype=dtype, device=dev)
        super().__init__(name, params, carry, TB.turbidity_read,
                         max_history_length, calibration_validity_hours,
                         seed)

    def _fresh_carry(self):
        return TB.make_turbidity_carry(self.params, dtype=self._dtype,
                                       device=self.device)

    def _extract_inputs(self, reactor_state):
        col = _zone(reactor_state.tss, self.zone_index)      # [..., C]
        if isinstance(col, torch.Tensor):
            weights = torch.as_tensor(self._ntu_weights, dtype=col.dtype,
                                      device=col.device)
            return (torch.sum(weights * col, dim=-1),)
        return (float(np.sum(self._ntu_weights * col, axis=-1)),)

    def wipe_window(self) -> None:
        """Run the mechanical wiper (clears the window-fouling bias)."""
        with self._state_lock:
            self.carry = TB.wipe_window(self.carry)

    @property
    def window_fouling_ntu(self):
        return float(self.carry.window_fouling_ntu)
