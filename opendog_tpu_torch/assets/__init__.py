"""Built-in robot descriptions (programmatic, no external asset files).

The XML generators are copies of those of the JAX package; the loaders
place the parsed model on a device (CUDA unless the caller names another).
"""
from __future__ import annotations

import functools

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
