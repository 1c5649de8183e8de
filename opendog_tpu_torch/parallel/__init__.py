"""Multi-device layer on ``torch.distributed``: meshes of ranks, the
collectives the sharded solvers and the data-parallel learner reduce with,
and data-parallel PPO.  Port of ``opendog_tpu/parallel``."""
from .mesh import (  # noqa: F401
    Mesh,
    env_mesh,
    initialize_distributed,
    make_mesh,
    replicate,
    shard_batch,
    sample_mesh,
)
from .rollout import make_sharded_ppo, scaling_efficiency  # noqa: F401
