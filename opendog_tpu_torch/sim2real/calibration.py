"""Sim <-> real joint-angle calibration maps.

Port of ``opendog_tpu/sim2real/calibration.py`` (the reference's sim-to-real
mapping, ``sim2real/train.py:94-130``): the real robot's home pose in
degrees per actuator, per-joint scale factors, and the conversion

    real_deg = real_home_deg + scale * degrees(sim_rad - sim_home_rad)

and its inverse (``sim2real/run.py:60-79``).  The actuator order is the
reference's ``ACTUATOR_NAMES_ORDERED`` (FR, FL, BR, BL interleaved), which
differs from the MJCF actuator declaration order; both orders are
supported explicitly.  The conversions take tensors (on any device) or
numpy arrays and return the same kind.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

# sim2real/train.py:25-30 -- the canonical sim2real actuator ordering.
ACTUATOR_NAMES_ORDERED = (
    "FR_tigh_actuator", "FR_knee_actuator",
    "FL_tigh_actuator", "FL_knee_actuator",
    "BR_tigh_actuator", "BR_knee_actuator",
    "BL_tigh_actuator", "BL_knee_actuator",
)

# Real-robot home pose in degrees (sim2real/train.py:95-101).
REAL_HOME_DEG: Dict[str, float] = {
    "FR_tigh_actuator": -45.0, "FR_knee_actuator": 45.0,
    "FL_tigh_actuator": 45.0,  "FL_knee_actuator": 45.0,
    "BR_tigh_actuator": 45.0,  "BR_knee_actuator": -45.0,
    "BL_tigh_actuator": 45.0,  "BL_knee_actuator": -45.0,
}

# Per-joint scale factors (sim2real/train.py:102 -- all 1.0 in the reference).
JOINT_SCALE: Dict[str, float] = {n: 1.0 for n in ACTUATOR_NAMES_ORDERED}


class Calibration:
    """Vectorised calibration for a loaded model.  The vectors are numpy
    float32 arrays (``sim_home_rad``, ``real_home_deg``, ``scale``,
    ``ctrl_lo``, ``ctrl_hi``) in ``order``, the reference sim2real order
    by default; a tensor argument meets a copy of them on its device."""

    def __init__(self, model, order: Sequence[str] = ACTUATOR_NAMES_ORDERED):
        self.order = tuple(order)
        idx = [model.actuator_names.index(n) for n in self.order]
        self.model_actuator_index = np.array(idx, dtype=np.int32)
        qposadr = model.numpy("actuator_qposadr")[idx]
        home_qpos = model.numpy("key_qpos")[model.key_id("home")]
        self.sim_home_rad = home_qpos[qposadr].astype(np.float32)
        self.real_home_deg = np.array(
            [REAL_HOME_DEG[n] for n in self.order], dtype=np.float32)
        self.scale = np.array([JOINT_SCALE[n] for n in self.order],
                              dtype=np.float32)
        cr = model.numpy("actuator_ctrlrange")[idx]
        self.ctrl_lo = cr[:, 0].astype(np.float32)
        self.ctrl_hi = cr[:, 1].astype(np.float32)
        self._on = {}

    def on(self, device) -> dict:
        """The calibration vectors as float32 tensors on ``device``, made
        once per device."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {
                k: torch.as_tensor(getattr(self, k), device=device)
                for k in ("sim_home_rad", "real_home_deg", "scale",
                          "ctrl_lo", "ctrl_hi")}
            self._on[device]["inv"] = torch.as_tensor(
                np.argsort(self.model_actuator_index), device=device)
            self._on[device]["index"] = torch.as_tensor(
                self.model_actuator_index.astype(np.int64), device=device)
        return self._on[device]

    def _vec(self, x):
        return self.on(x.device) if isinstance(x, torch.Tensor) else \
            {k: getattr(self, k) for k in ("sim_home_rad", "real_home_deg",
                                           "scale", "ctrl_lo", "ctrl_hi")}

    # -- conversions --
    def sim_rad_to_real_deg(self, sim_rad):
        """sim2real/train.py:120-130."""
        v = self._vec(sim_rad)
        delta = sim_rad - v["sim_home_rad"]
        deg = torch.rad2deg(delta) if isinstance(delta, torch.Tensor) \
            else np.degrees(delta)
        return v["real_home_deg"] + v["scale"] * deg

    def real_deg_to_sim_rad(self, real_deg, clip: bool = True):
        """Inverse map with ctrlrange clamping (sim2real/run.py:60-79)."""
        v = self._vec(real_deg)
        delta_deg = (real_deg - v["real_home_deg"]) / v["scale"]
        if isinstance(delta_deg, torch.Tensor):
            sim = v["sim_home_rad"] + torch.deg2rad(delta_deg)
            return torch.clamp(sim, v["ctrl_lo"], v["ctrl_hi"]) if clip \
                else sim
        sim = v["sim_home_rad"] + np.radians(delta_deg)
        return np.clip(sim, v["ctrl_lo"], v["ctrl_hi"]) if clip else sim

    def reorder_from_model(self, ctrl_model_order):
        """Model-declaration-order ctrl vector -> calibration order."""
        if isinstance(ctrl_model_order, torch.Tensor):
            return ctrl_model_order[..., self.on(
                ctrl_model_order.device)["index"]]
        return ctrl_model_order[..., self.model_actuator_index]

    def reorder_to_model(self, ctrl_cal_order):
        if isinstance(ctrl_cal_order, torch.Tensor):
            return ctrl_cal_order[..., self.on(ctrl_cal_order.device)["inv"]]
        return ctrl_cal_order[..., np.argsort(self.model_actuator_index)]
