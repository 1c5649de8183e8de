from . import costs, mpc, mppi  # noqa: F401
from .mppi import MPPIConfig, MPPIState, make_solver  # noqa: F401
from .mpc import make_mpc  # noqa: F401
