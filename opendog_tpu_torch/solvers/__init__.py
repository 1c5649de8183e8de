from . import costs, graph, mpc, mppi  # noqa: F401
from .graph import GraphedTick  # noqa: F401
from .mppi import MPPIConfig, MPPIState, graph_solve, make_solver  # noqa: F401
from .mpc import RealtimeController, graph_tick, make_mpc  # noqa: F401
