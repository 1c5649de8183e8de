"""Task environments over a leading env axis (the JAX package's vmapped
envs): walk / turn on OpenDOG, jump / landing on Go1, and the sim2real
symmetric-gait and terrain walks."""
from .base import Env, Transition, vector_env  # noqa: F401
from .walk import TurnEnv, WalkEnv  # noqa: F401
from .jump import JumpEnv, LandingEnv  # noqa: F401
from .sim2real_walk import SymWalkEnv, TerrainWalkEnv  # noqa: F401
