"""
OPC UA plane (binary transport, SecurityPolicy#None) — from scratch.

Closes the reference roadmap's last row, "OPC UA server (in addition to
Modbus)" (reference README.md:456). See server.py for the scope and
the address-space layout; client.py for the matching client.
"""

from ics_wt_physicsengine_torch.opcua.client import OPCUAClient, OPCUAError
from ics_wt_physicsengine_torch.opcua.encoding import (
    DataValue,
    Decoder,
    Encoder,
    LocalizedText,
    NodeId,
    QualifiedName,
    Variant,
)
from ics_wt_physicsengine_torch.opcua.server import OPCUAServer

__all__ = [
    "DataValue",
    "Decoder",
    "Encoder",
    "LocalizedText",
    "NodeId",
    "OPCUAClient",
    "OPCUAError",
    "OPCUAServer",
    "QualifiedName",
    "Variant",
]
