"""Model / State definitions of the PyTorch port.

Counterpart of ``opendog_tpu/physics/model.py``: the same field names, with
static metadata kept as Python ints and tuples and every array a tensor on
one device.  A ``Model`` is built once by :mod:`.mjcf` (or carried across
from numpy arrays with :func:`model_from_arrays`) and read by the kernel
tables, the costs and the solvers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Joint type codes (static metadata).
JNT_NONE = 0
JNT_HINGE = 1
JNT_FREE = 2

STATIC_FIELDS = (
    "nq", "nv", "nu", "nbody", "ngeom", "nsite",
    "body_names", "joint_names", "actuator_names", "site_names", "key_names",
    "body_parent", "jnt_type", "body_qpos_adr", "body_dof_adr", "dof_body",
    "site_body", "foot_body", "foot_geom", "geom_body_static",
    "timestep", "has_plane", "hfield_nrow", "hfield_ncol",
)

INT_ARRAY_FIELDS = ("actuator_dof", "actuator_qposadr", "geom_body")

ARRAY_FIELDS = (
    "body_pos", "body_quat", "body_mass", "body_com", "body_inertia",
    "jnt_axis", "jnt_pos",
    "dof_armature", "dof_damping", "dof_frictionloss", "dof_limited",
    "dof_range", "ancestor_mask",
    "actuator_dof", "actuator_qposadr", "actuator_kp", "actuator_kv",
    "actuator_ctrlrange", "actuator_forcerange",
    "geom_body", "geom_pos", "geom_radius", "geom_friction",
    "geom_stiffness", "geom_damping",
    "wbox_pos", "wbox_size", "site_pos", "key_qpos", "key_ctrl", "gravity",
    "contact_stiffness", "contact_damping", "friction_smoothing",
    "limit_stiffness", "limit_damping", "hfield_size",
)

OPTIONAL_ARRAY_FIELDS = ("geom_imp_dmin", "geom_imp_width")


@dataclass(frozen=True)
class Model:
    """Static robot + scene description; arrays are tensors on one device."""

    # ---- static metadata ----
    nq: int
    nv: int
    nu: int
    nbody: int  # movable bodies, excl. world
    ngeom: int  # collision spheres
    nsite: int
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]  # per body ('' if none)
    actuator_names: Tuple[str, ...]
    site_names: Tuple[str, ...]
    key_names: Tuple[str, ...]
    body_parent: Tuple[int, ...]  # -1 = world
    jnt_type: Tuple[int, ...]  # per body
    body_qpos_adr: Tuple[int, ...]
    body_dof_adr: Tuple[int, ...]
    dof_body: Tuple[int, ...]
    site_body: Tuple[int, ...]
    foot_body: Tuple[int, ...]
    foot_geom: Tuple[int, ...]
    geom_body_static: Tuple[int, ...]
    timestep: float
    has_plane: bool
    hfield_nrow: int
    hfield_ncol: int

    # ---- bodies ----
    body_pos: torch.Tensor  # (nb, 3) frame offset in parent frame
    body_quat: torch.Tensor  # (nb, 4)
    body_mass: torch.Tensor  # (nb,)
    body_com: torch.Tensor  # (nb, 3) COM in body frame
    body_inertia: torch.Tensor  # (nb, 3, 3) about COM, body frame
    # ---- joints (one per body) ----
    jnt_axis: torch.Tensor  # (nb, 3) hinge axis, body frame
    jnt_pos: torch.Tensor  # (nb, 3) hinge anchor, body frame
    # ---- dofs ----
    dof_armature: torch.Tensor  # (nv,)
    dof_damping: torch.Tensor  # (nv,)
    dof_frictionloss: torch.Tensor  # (nv,)
    dof_limited: torch.Tensor  # (nv,) 0/1
    dof_range: torch.Tensor  # (nv, 2)
    ancestor_mask: torch.Tensor  # (nb, nv)
    # ---- position-servo actuators ----
    actuator_dof: torch.Tensor  # (nu,) int32
    actuator_qposadr: torch.Tensor  # (nu,) int32
    actuator_kp: torch.Tensor  # (nu,)
    actuator_kv: torch.Tensor  # (nu,)
    actuator_ctrlrange: torch.Tensor  # (nu, 2)
    actuator_forcerange: torch.Tensor  # (nu, 2)
    # ---- collision spheres ----
    geom_body: torch.Tensor  # (ng,) int32
    geom_pos: torch.Tensor  # (ng, 3)
    geom_radius: torch.Tensor  # (ng,)
    geom_friction: torch.Tensor  # (ng, 3)
    geom_stiffness: torch.Tensor  # (ng,)
    geom_damping: torch.Tensor  # (ng,)
    # ---- static world boxes, sites, keyframes, options ----
    wbox_pos: torch.Tensor  # (nw, 3)
    wbox_size: torch.Tensor  # (nw, 3)
    site_pos: torch.Tensor  # (ns, 3)
    key_qpos: torch.Tensor  # (nkey, nq)
    key_ctrl: torch.Tensor  # (nkey, nu)
    gravity: torch.Tensor  # (3,)
    contact_stiffness: torch.Tensor  # ()
    contact_damping: torch.Tensor  # ()
    friction_smoothing: torch.Tensor  # ()
    limit_stiffness: torch.Tensor  # ()
    limit_damping: torch.Tensor  # ()
    hfield_size: torch.Tensor  # (4,)
    geom_imp_dmin: Optional[torch.Tensor] = None  # (ng,)
    geom_imp_width: Optional[torch.Tensor] = None  # (ng,)

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.body_pos.device

    def replace(self, **changes) -> "Model":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Model":
        """The same model with every tensor on ``device``."""
        device = torch.device(device)
        if self.device == device:
            return self
        moved = {
            name: getattr(self, name).to(device)
            for name in ARRAY_FIELDS + OPTIONAL_ARRAY_FIELDS
            if getattr(self, name) is not None
        }
        return dataclasses.replace(self, **moved)

    def numpy(self, name: str) -> np.ndarray:
        """Field ``name`` as a host numpy array (for building tables)."""
        return getattr(self, name).detach().cpu().numpy()

    def key_id(self, name: str) -> int:
        return self.key_names.index(name)


@dataclass
class State:
    """Dynamic simulation state; batch-first where batched."""

    qpos: torch.Tensor  # (nq,) or (K, nq)
    qvel: torch.Tensor  # (nv,) or (K, nv)
    time: torch.Tensor  # () or (K,)


def model_from_arrays(static: Dict, arrays: Dict[str, np.ndarray],
                      device) -> Model:
    """Build a :class:`Model` from static metadata and numpy arrays.

    ``static`` maps every name of :data:`STATIC_FIELDS` to its value;
    ``arrays`` maps every name of :data:`ARRAY_FIELDS` (and optionally
    :data:`OPTIONAL_ARRAY_FIELDS`) to a numpy array.  Floats become float32
    tensors and the index fields int32 tensors, on ``device``."""
    device = torch.device(device)
    kw = {}
    for name in STATIC_FIELDS:
        v = static[name]
        kw[name] = tuple(v) if isinstance(v, (list, tuple)) else v
    for name in ARRAY_FIELDS + OPTIONAL_ARRAY_FIELDS:
        a = arrays.get(name)
        if a is None:
            if name in OPTIONAL_ARRAY_FIELDS:
                kw[name] = None
                continue
            raise KeyError(f"model_from_arrays: missing array {name!r}")
        dtype = np.int32 if name in INT_ARRAY_FIELDS else np.float32
        kw[name] = torch.from_numpy(np.array(a, dtype=dtype)).to(device)
    return Model(**kw)
