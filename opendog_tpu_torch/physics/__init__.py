import torch

from .model import (JNT_FREE, JNT_HINGE, JNT_NONE, Contact,  # noqa: F401
                    Model, State, StepInfo, Terrain, terrain_from_numpy)
from .mjcf import load_model  # noqa: F401
from . import dynamics, spatial, terrain  # noqa: F401


def make_state(model: Model, key_name: str = "home") -> State:
    """Initial :class:`State` from a keyframe (or zeros if absent), on the
    model's device."""
    if model.key_names and key_name in model.key_names:
        qpos = model.key_qpos[model.key_id(key_name)].clone()
    else:
        qpos = torch.zeros(model.nq, dtype=torch.float32, device=model.device)
    return State(
        qpos=qpos,
        qvel=torch.zeros(model.nv, dtype=qpos.dtype, device=qpos.device),
        time=torch.zeros((), dtype=qpos.dtype, device=qpos.device),
    )
