"""
Sensor validation suites (port of
``ics_wt_physicsengine_tpu/sensors/validation.py``; the ammonia, oxygen and
turbidity suites live beside their instruments).

Each follows the reference simulator's strategy: a duck-typed mock reactor
state, a burst of reads, and envelope/behaviour checks. Reads are
timestamped past the warm-up window so values are live. Every suite takes
``device`` (``None``: the CUDA card); the seeds are fixed, the envelopes
wide enough for any stream.
"""

from __future__ import annotations

import numpy as np

from ics_wt_physicsengine_torch.device import resolve_device
from ics_wt_physicsengine_torch.sensors import chlorine as _chlorine
from ics_wt_physicsengine_torch.sensors import flow as _flow
from ics_wt_physicsengine_torch.sensors import temperature as _temperature
from ics_wt_physicsengine_torch.sensors.types import (InstallationQuality,
                                                      SampleLine)
from ics_wt_physicsengine_torch.sensors.wrappers import (
    ChlorineSensor,
    FlowSensor,
    TemperatureSensor,
    pHSensor,
)


class _MockReactorState:
    def __init__(self):
        self.pH = np.array([7.0, 7.1, 7.2, 7.3, 7.4])
        self.chlorine = np.array([2.0, 1.9, 1.8, 1.7, 1.6])
        self.temperature = np.array([20.0, 20.0, 20.0, 20.0, 20.0])
        self.flow_rate = 5.0


def validate_pH_sensor(device=None):
    """pH sensor: reading envelope, two-point calibration, slope health,
    electrode cleaning."""
    sample_line = SampleLine(volume_mL=100, flow_rate_mL_min=500,
                             ambient_temp=20.0)
    installation = InstallationQuality(flow_velocity=0.5,
                                       air_bubble_frequency=0.0,
                                       grounding_quality=1.0)
    sensor = pHSensor(name="pH_test", zone_index=0, sample_line=sample_line,
                      installation=installation, seed=101, device=device)
    sensor.calibrate(7.0, 0.0)

    state = _MockReactorState()
    readings = [sensor.read(state, 1800.0 + i + 1).value for i in range(10)]
    finite = [v for v in readings if np.isfinite(v)]
    if finite:
        mean_ph = float(np.mean(finite))
        std_ph = float(np.std(finite))
        if not (6.0 < mean_ph < 8.0):
            raise AssertionError(f"Mean pH should be near 7.0, got {mean_ph}")
        if std_ph >= 0.2:
            raise AssertionError(f"pH std should be small, got {std_ph}")
    if not sensor.reading_history:
        raise AssertionError("Should have reading history")

    sensor.calibrate_two_point(4.0, 7.0, 4.05, 7.02, 1900.0)
    if not (90 < sensor.slope_percentage < 110):
        raise AssertionError(
            f"Slope should be reasonable, got {sensor.slope_percentage}")

    health = sensor.check_slope_health()
    if health["health"] not in ("excellent", "good", "fair", "poor"):
        raise AssertionError(f"Unknown health status: {health['health']}")

    sensor.clean_electrode("water_rinse", 2000.0)
    if sensor.membrane_fouling >= 0.5:
        raise AssertionError("Cleaning should reduce fouling")
    print("pH sensor validation passed")


def validate_chlorine_sensor(device=None):
    """Chlorine sensor: reading envelope, ozone cross-sensitivity of the
    amperometric cell, a DPD reading."""
    state = _MockReactorState()
    state.ozone = np.array([0.5] * 5)   # interference injection

    amp = ChlorineSensor(name="cl_amp", zone_index=0,
                         sensor_type=_chlorine.AMPEROMETRIC, seed=102,
                         device=device)
    amp.calibrate(2.0, 0.0)
    readings = [amp.read(state, 300.0 + i + 1).value for i in range(20)]
    finite = [v for v in readings if np.isfinite(v)]
    if not finite:
        raise AssertionError("No finite amperometric readings")
    if not all(0.0 <= v <= 10.0 for v in finite):
        raise AssertionError("Readings out of range")

    # the amperometric cell over-reads against clean water because of ozone
    amp2 = ChlorineSensor(name="cl_amp2", zone_index=0,
                          sensor_type=_chlorine.AMPEROMETRIC, seed=102,
                          device=device)
    amp2.calibrate(2.0, 0.0)
    clean = [amp2.read(_MockReactorState(), 300.0 + i + 1).value
             for i in range(20)]
    if not (np.nanmean(finite) > np.nanmean(clean) + 0.3):
        raise AssertionError("Ozone interference not visible")

    dpd = ChlorineSensor(name="cl_dpd", zone_index=0,
                         sensor_type=_chlorine.DPD, seed=103, device=device)
    dpd.calibrate(2.0, 0.0)
    r = dpd.read(_MockReactorState(), 61.0)
    if not (np.isfinite(r.value) and 0.0 <= r.value <= 10.0):
        raise AssertionError("DPD reading invalid")
    print("Chlorine sensor validation passed")


def validate_flow_sensor(device=None):
    """Flow sensor: a mid-scale reading in range, zero flow reads zero."""
    sensor = FlowSensor(name="flow_test", sensor_type=_flow.MAGNETIC,
                        seed=104, device=device)
    reading = sensor.read_flow(50.0, 11.0)
    if not (0.0 <= reading.value <= 100.0):
        raise AssertionError(f"Reading out of range: {reading.value}")
    sensor2 = FlowSensor(name="flow_zero", sensor_type=_flow.MAGNETIC,
                         seed=105, device=device)
    reading_zero = sensor2.read_flow(0.0, 11.0)
    if reading_zero.value != 0.0:
        raise AssertionError("Should read zero at zero flow")
    print("Flow sensor validation passed")


def validate_temperature_sensor(device=None):
    """Temperature sensor: an RTD reading inside its envelope (the
    lead-resistance error biases it by about +2.6 C)."""
    sensor = TemperatureSensor(name="temp_test", zone_index=0,
                               sensor_type=_temperature.RTD_PT100,
                               seed=106, device=device)
    state = _MockReactorState()
    reading = sensor.read(state, 31.0)
    if not (15.0 < reading.value < 26.0):
        raise AssertionError(
            f"Reading out of expected range: {reading.value}")
    print("Temperature sensor validation passed")


def run_all_sensor_validations(device=None):
    """All seven instrument suites on ``device`` (``None``: the CUDA
    card)."""
    from ics_wt_physicsengine_torch.sensors.ammonia import (
        validate_ammonia_sensor)
    from ics_wt_physicsengine_torch.sensors.oxygen import (
        validate_oxygen_sensor)
    from ics_wt_physicsengine_torch.sensors.turbidity import (
        validate_turbidity_sensor)

    device = resolve_device(device)
    validate_pH_sensor(device)
    validate_chlorine_sensor(device)
    validate_flow_sensor(device)
    validate_temperature_sensor(device)
    for name, suite in (("ammonia", validate_ammonia_sensor),
                        ("oxygen", validate_oxygen_sensor),
                        ("turbidity", validate_turbidity_sensor)):
        if not suite(device=device):
            raise RuntimeError(f"{name} sensor validation failed")
    print(f"ALL SENSOR VALIDATIONS PASSED on {device}")
