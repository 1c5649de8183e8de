"""Sim telemetry of the port: the UDP/msgpack server and client (msgpack
in plain Python, :mod:`.wire`), the rolling force scope and the headless
:class:`~.viewer.SimViewer` (imported from :mod:`.viewer`)."""
from .client import TelemetryClient  # noqa: F401
from .scope import ForceScope, watch  # noqa: F401
from .server import TelemetryServer, simulation_packet  # noqa: F401
