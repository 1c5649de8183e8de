"""Built-in robot descriptions (programmatic, no external asset files).

The XML generators are copies of those of the JAX package; the loaders
place the parsed model on a device (CUDA unless the caller names another).
"""
from __future__ import annotations

import functools

import numpy as np

from ..device import resolve_device
from .go1 import go1_xml
from .mini import mini_xml
from .opendog import opendog_xml


@functools.lru_cache(maxsize=None)
def _load(xml: str, device: str, overrides: tuple):
    from ..physics.mjcf import load_model

    return load_model(xml, device=device, **dict(overrides))


def load_opendog(scene: str = "flat", device=None, **overrides):
    """OpenDOG 8-DoF model (reference: our_robot.xml).  scene: flat|terrain|none."""
    return _load(opendog_xml(scene), str(resolve_device(device)),
                 tuple(sorted(overrides.items())))


def load_go1(scene: str = "flat", device=None, **overrides):
    """Go1 12-DoF model (reference: go1.xml).  scene: flat|jump|landing|none."""
    return _load(go1_xml(scene), str(resolve_device(device)),
                 tuple(sorted(overrides.items())))


def load_mini(device=None, **overrides):
    """Minimal 2-leg test robot (fast fused-kernel fixture)."""
    return _load(mini_xml(), str(resolve_device(device)),
                 tuple(sorted(overrides.items())))


def go1_oracle_contact(model):
    """Oracle-matched contact variant of a loaded Go1 model (copy of the
    JAX package's ``assets.go1_oracle_contact``).

    The production plant keeps the crisp penalty foot; this variant
    enables, on the FOOT pads only (the spheres of the explicit-solref
    stiffness 2370 N/m), the two published contact semantics of the
    reference model the default simplifies away:

      * progressive impedance (go1.xml:62 solimp="0.015 1 0.023"): soft at
        touchdown, full stiffness at 23 mm of penetration;
      * condim=6 torsional + rolling friction (friction "0.8 0.02 0.01"),
        which the step turns on together with the impedance;

    with a base foot stiffness 26x the soft pad's (the impedance ramp now
    carries the softness), the damping scaled by sqrt(26), and 10x the
    tangential regularisation.  It is the one model that sets
    ``geom_imp_dmin``."""
    import torch

    gs, gd = model.geom_stiffness, model.geom_damping
    feet = torch.isclose(gs, torch.full_like(gs, 2370.0))
    one = torch.ones_like(gs)
    return model.replace(
        geom_stiffness=torch.where(feet, gs * 26.0, gs),
        geom_damping=torch.where(feet, gd * float(np.sqrt(26.0)), gd),
        geom_imp_dmin=torch.where(feet, 0.015 * one, one),
        geom_imp_width=torch.where(feet, 0.023 * one, one),
        friction_smoothing=model.friction_smoothing * 10.0,
    )
