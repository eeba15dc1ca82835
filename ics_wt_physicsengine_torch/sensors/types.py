"""
Sensor data types: enums, reading/record dataclasses, configuration bundles.

API parity with the reference (citations per item):
- SensorStatus / SensorFault enums      reference sensors/base_sensor.py:49-75
- SensorReading                         reference sensors/base_sensor.py:78-103
- CalibrationRecord                     reference sensors/base_sensor.py:106-121
- InstallationQuality                   reference sensors/base_sensor.py:124-145
- SampleLine                            reference sensors/base_sensor.py:148-216

In the functional core, enum-valued fields travel as int32 codes (the
``.code`` attribute); the wrapper layer converts back to enums for readings.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np


class SensorStatus(Enum):
    NORMAL = "normal"
    CALIBRATING = "calibrating"
    WARMING_UP = "warming_up"
    FAILED = "failed"
    SATURATED = "saturated"
    DRIFT_WARNING = "drift_warning"
    CALIBRATION_EXPIRED = "calibration_expired"
    OPEN_CIRCUIT = "open_circuit"
    SHORT_CIRCUIT = "short_circuit"
    OUT_OF_RANGE = "out_of_range"
    POWER_FAULT = "power_fault"
    RATE_OF_CHANGE_FAULT = "rate_of_change_fault"


class SensorFault(Enum):
    NONE = "none"
    OPEN_CIRCUIT = "open_circuit"
    SHORT_CIRCUIT = "short_circuit"
    OUT_OF_RANGE = "out_of_range"
    RATE_FAULT = "rate_fault"
    POWER_LOW = "power_low"
    POWER_HIGH = "power_high"


# Stable integer codes for the in-graph representation.
STATUS_CODE = {s: i for i, s in enumerate(SensorStatus)}
STATUS_FROM_CODE = {i: s for s, i in STATUS_CODE.items()}
FAULT_CODE = {f: i for i, f in enumerate(SensorFault)}
FAULT_FROM_CODE = {i: f for f, i in FAULT_CODE.items()}


@dataclass
class SensorReading:
    """Single sensor reading with metadata (reference base_sensor.py:78-103)."""

    timestamp: float
    value: float
    raw_value: float
    noise: float
    drift: float
    status: SensorStatus = SensorStatus.NORMAL
    uncertainty: float = 0.0
    fault: SensorFault = SensorFault.NONE

    def __post_init__(self):
        if not isinstance(self.timestamp, (int, float)):
            raise TypeError(
                f"Timestamp must be numeric, got {type(self.timestamp)}")
        if self.timestamp < 0:
            raise ValueError(
                f"Timestamp must be positive, got {self.timestamp}")
        if not (np.isfinite(self.value) or np.isnan(self.value)):
            raise ValueError(
                f"Sensor reading must be finite or NaN, got {self.value}")


@dataclass
class CalibrationRecord:
    """Record of a calibration event (reference base_sensor.py:106-121)."""

    timestamp: float
    reference_value: float
    measured_value: float
    offset: float
    operator_id: str = "auto"
    notes: str = ""
    validity_hours: float = 24.0

    def is_expired(self, current_time: float) -> bool:
        return (current_time - self.timestamp) / 3600.0 > self.validity_hours


@dataclass
class InstallationQuality:
    """Installation quality factors (reference base_sensor.py:124-145)."""

    flow_velocity: float = 0.5          # [m/s]
    air_bubble_frequency: float = 0.0   # [bubbles/min]
    grounding_quality: float = 1.0      # 0-1
    pipe_vibration_g: float = 0.0       # [g RMS]
    ambient_temperature: float = 25.0   # [C]

    def validate(self):
        if not 0.0 <= self.flow_velocity <= 5.0:
            raise ValueError(
                f"Flow velocity {self.flow_velocity} m/s out of range")
        if not 0.0 <= self.grounding_quality <= 1.0:
            raise ValueError("Grounding quality must be 0-1")
        if self.pipe_vibration_g < 0:
            raise ValueError("Vibration must be non-negative")


@dataclass
class SampleLine:
    """Sample-line configuration (reference base_sensor.py:148-216).

    Functional-core note: the reference implements the transport delay as a
    deque with a nearest-timestamp linear search; here the configuration only
    carries the derived delay, and the delay buffer itself is a fixed-size
    ring in the sensor carry (static capacity, in-graph argmin lookup).
    """

    volume_mL: float = 100.0
    flow_rate_mL_min: float = 500.0
    ambient_temp: float = 20.0

    def __post_init__(self):
        self.volume_L = self.volume_mL / 1000.0
        self.flow_rate_L_s = self.flow_rate_mL_min / 1000.0 / 60.0
        self.transport_delay_s = (
            self.volume_L / self.flow_rate_L_s
            if self.flow_rate_L_s > 0 else 0.0)

    @property
    def buffer_capacity(self) -> int:
        """Ring capacity (mirrors the reference's deque maxlen policy,
        base_sensor.py:174)."""
        return max(100, int(self.transport_delay_s) + 10)

    # -- host-side (value, temp) transport, API parity with reference
    #    base_sensor.py:177-216. The in-graph sensor pipeline carries values
    #    only: the reference's read() discards the transported temperature
    #    (base_sensor.py:611-615), so buffering temps in the scan carry would
    #    spend HBM bandwidth on a dead output. Host users of the reference's
    #    SampleLine.transport_sample get the same semantics here.

    def add_sample(self, value: float, temp: float,
                   timestamp: float) -> None:
        """Append a (timestamp, value, temp) sample to the host-side delay
        buffer (reference base_sensor.py:185-188)."""
        if not hasattr(self, "_delay_buffer"):
            from collections import deque
            self._delay_buffer = deque(maxlen=self.buffer_capacity)
        self._delay_buffer.append((timestamp, value, temp))

    def transport_sample(self, value: float, temp: float,
                         timestamp: float):
        """Delayed, temperature-relaxed sample: the nearest buffered sample
        to ``timestamp - transport_delay_s``, its temperature exponentially
        approaching ``ambient_temp`` at 10 %/s of line residence (reference
        base_sensor.py:177-216). Returns ``(delayed_value, actual_temp)``."""
        import math

        self.add_sample(value, temp, timestamp)
        target_time = timestamp - self.transport_delay_s
        delayed_time, delayed_value, delayed_temp = min(
            self._delay_buffer, key=lambda s: abs(s[0] - target_time))
        time_in_line = timestamp - delayed_time
        temp_fraction = math.exp(-0.1 * time_in_line)
        actual_temp = (self.ambient_temp
                       + (delayed_temp - self.ambient_temp) * temp_fraction)
        return delayed_value, actual_temp
