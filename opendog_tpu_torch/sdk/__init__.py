"""Host-side SDK of the robot: the motor controllers' UDP/JSON protocol
(:class:`QuadPilotBody`) and the camera's HTTP endpoints
(:class:`QuadPilotCamera`)."""
from .body import QuadPilotBody  # noqa: F401
from .camera import QuadPilotCamera  # noqa: F401
