from . import costs, graph, ilqr, mpc, mppi  # noqa: F401
from .graph import GraphedTick  # noqa: F401
from .ilqr import ILQRConfig, make_ilqr  # noqa: F401
from .mppi import MPPIConfig, MPPIState, graph_solve, make_solver  # noqa: F401
from .mpc import (RealtimeController, graph_tick, make_ilqr_tracker,  # noqa: F401
                  make_mpc)
