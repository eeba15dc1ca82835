"""The instrument suite as pure transforms on batched tensors: the base
pipeline (``base``) and the pH, chlorine, flow and temperature overlays."""

from ics_wt_physicsengine_torch.sensors.types import (  # noqa: F401
    CalibrationRecord,
    InstallationQuality,
    SampleLine,
    SensorFault,
    SensorReading,
    SensorStatus,
)
