# Frozen copy of opendog_tpu_torch/physics/__init__.py at commit 9b29168.
import torch

from .model import (JNT_FREE, JNT_HINGE, JNT_NONE, Contact,  # noqa: F401
                    Model, State, StepInfo, Terrain)
from .mjcf import load_model  # noqa: F401
from . import dynamics, spatial, terrain  # noqa: F401


def make_state(model: Model, key_name: str = "home") -> State:
    """Initial :class:`State` from a keyframe, on the model's device."""
    qpos = model.key_qpos[model.key_id(key_name)].clone()
    return State(
        qpos=qpos,
        qvel=torch.zeros(model.nv, dtype=qpos.dtype, device=qpos.device),
        time=torch.zeros((), dtype=qpos.dtype, device=qpos.device),
    )
