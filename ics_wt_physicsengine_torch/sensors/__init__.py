"""The instrument suite: pure transforms on batched tensors (the base
pipeline ``base``; the pH, chlorine, flow and temperature overlays; the
ammonia, oxygen and turbidity overlays of the extension axes; the
``electrical`` transmission stage), the reference simulator's sensor classes
over them (``wrappers``), the physical sample line (``sampleline``: derived
heat transfer and in-line decay, host-side), and the suite factory of the
canonical plant."""

from typing import Optional

from ics_wt_physicsengine_torch.sensors.types import (  # noqa: F401
    CalibrationRecord,
    InstallationQuality,
    SampleLine,
    SensorFault,
    SensorReading,
    SensorStatus,
)
from ics_wt_physicsengine_torch.sensors.base import (  # noqa: F401
    SensorCarry,
    SensorOutput,
    SensorParams,
    base_read,
    calibrate,
    make_sensor_carry,
    make_sensor_params,
)
from ics_wt_physicsengine_torch.sensors.electrical import (  # noqa: F401
    ElectricalCarry,
    ElectricalParams,
    electrical_transform,
    make_electrical_carry,
    make_electrical_params,
)
from ics_wt_physicsengine_torch.sensors.wrappers import (  # noqa: F401
    AmmoniaSensor,
    BaseSensor,
    ChlorineSensor,
    FlowSensor,
    OxygenSensor,
    TemperatureSensor,
    TurbiditySensor,
    pHSensor,
)
from ics_wt_physicsengine_torch.sensors.sampleline import (  # noqa: F401
    LineThermalConfig,
    PhysicalSampleLine,
    validate_sample_line,
)
from ics_wt_physicsengine_torch.sensors.ammonia import (  # noqa: F401
    validate_ammonia_sensor,
)
from ics_wt_physicsengine_torch.sensors.oxygen import (  # noqa: F401
    validate_oxygen_sensor,
)
from ics_wt_physicsengine_torch.sensors.turbidity import (  # noqa: F401
    validate_turbidity_sensor,
)
from ics_wt_physicsengine_torch.sensors.validation import (  # noqa: F401
    run_all_sensor_validations,
    validate_chlorine_sensor,
    validate_flow_sensor,
    validate_pH_sensor,
    validate_temperature_sensor,
)
from ics_wt_physicsengine_torch.sensors import chlorine as _chlorine
from ics_wt_physicsengine_torch.sensors import flow as _flow
from ics_wt_physicsengine_torch.sensors import oxygen as _oxygen
from ics_wt_physicsengine_torch.sensors import temperature as _temperature


# Enum-style aliases matching the reference simulator's names
class ChlorineSensorType:
    AMPEROMETRIC = _chlorine.AMPEROMETRIC
    DPD_COLORIMETRIC = _chlorine.DPD


class ChlorineMeasurementType:
    FREE_CHLORINE = "free"
    TOTAL_CHLORINE = "total"


class FlowSensorType:
    TURBINE = _flow.TURBINE
    MAGNETIC = _flow.MAGNETIC


class TemperatureSensorType:
    RTD_PT100 = _temperature.RTD_PT100
    RTD_PT1000 = _temperature.RTD_PT1000
    THERMOCOUPLE_K = _temperature.THERMOCOUPLE_K
    THERMOCOUPLE_J = _temperature.THERMOCOUPLE_J


class OxygenSensorType:
    OPTICAL = _oxygen.OPTICAL
    CLARK = _oxygen.CLARK


def _suite_installation() -> InstallationQuality:
    """The good-installation profile every suite sensor shares."""
    return InstallationQuality(
        flow_velocity=0.5, air_bubble_frequency=0.0, grounding_quality=0.9,
        pipe_vibration_g=0.1, ambient_temperature=30.0)


def _suite_seed(seed, i):
    """Per-sensor sub-seed derivation shared by the whole suite."""
    return None if seed is None else seed * 1000 + i


def _base_suite(reactor_config, seed: Optional[int] = None, dtype=None,
                device=None):
    """The canonical 7-sensor plant. pH_inlet and temp_inlet (and the two
    outlet sensors) share a sample-line configuration but own separate
    delay rings, as in the JAX package."""
    good_installation = _suite_installation()
    inlet_sample_line = SampleLine(volume_mL=250, flow_rate_mL_min=500,
                                   ambient_temp=25.0)
    outlet_sample_line = SampleLine(volume_mL=250, flow_rate_mL_min=500,
                                    ambient_temp=25.0)
    common = dict(installation=good_installation, device=device)
    if dtype is not None:
        common["dtype"] = dtype

    def sub_seed(i):
        return _suite_seed(seed, i)

    return {
        "pH_inlet": pHSensor(
            name="pH_inlet", zone_index=0, sample_line=inlet_sample_line,
            seed=sub_seed(0), **common),
        "pH_outlet": pHSensor(
            name="pH_outlet", zone_index=-1, sample_line=outlet_sample_line,
            seed=sub_seed(1), **common),
        "chlorine_inlet": ChlorineSensor(
            name="chlorine_inlet", zone_index=0,
            sensor_type=ChlorineSensorType.AMPEROMETRIC,
            seed=sub_seed(2), **common),
        "chlorine_outlet": ChlorineSensor(
            name="chlorine_outlet", zone_index=-1,
            sensor_type=ChlorineSensorType.DPD_COLORIMETRIC,
            seed=sub_seed(3), **common),
        "flow_main": FlowSensor(
            name="flow_main", sensor_type=FlowSensorType.MAGNETIC,
            full_scale=reactor_config.flow_rate * 2.0,
            seed=sub_seed(4), **common),
        "temp_inlet": TemperatureSensor(
            name="temp_inlet", zone_index=0,
            sensor_type=TemperatureSensorType.RTD_PT100,
            sample_line=inlet_sample_line, seed=sub_seed(5), **common),
        "temp_outlet": TemperatureSensor(
            name="temp_outlet", zone_index=-1,
            sensor_type=TemperatureSensorType.RTD_PT100,
            sample_line=outlet_sample_line, seed=sub_seed(6), **common),
    }


def create_realistic_sensor_suite(reactor_config, seed: Optional[int] = None,
                                  dtype=None, device=None):
    """The canonical sensor objects for ``reactor_config`` on ``device``
    (``None``: the CUDA card): the seven base instruments, plus an outlet
    ammonia ISE with the nitrogen axis, an optical DO probe with the gas
    axis and a nephelometer with the particle axis."""
    suite = _base_suite(reactor_config, seed, dtype=dtype, device=device)
    common = dict(zone_index=-1, installation=_suite_installation(),
                  device=device)
    if dtype is not None:
        common["dtype"] = dtype
    if getattr(reactor_config, "enable_nitrogen", False):
        suite["ammonia_outlet"] = AmmoniaSensor(
            name="ammonia_outlet", seed=_suite_seed(seed, 7), **common)
    if getattr(reactor_config, "enable_gas", False):
        suite["oxygen_outlet"] = OxygenSensor(
            name="oxygen_outlet", sensor_type=OxygenSensorType.OPTICAL,
            seed=_suite_seed(seed, 8), **common)
    if getattr(reactor_config, "enable_particles", False):
        suite["turbidity_outlet"] = TurbiditySensor(
            name="turbidity_outlet", seed=_suite_seed(seed, 9), **common)
    return suite
