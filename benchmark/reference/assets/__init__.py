"""The robots' MJCF generators (frozen copies) and their loaders."""
from __future__ import annotations

from ..physics.mjcf import load_model
from .go1 import go1_xml
from .opendog import opendog_xml

XML = {"go1": go1_xml, "opendog": opendog_xml}


def load_robot(robot: str, scene: str, device="cpu"):
    """The parsed model of ``robot`` ("go1" or "opendog") in ``scene``."""
    return load_model(XML[robot](scene), device=device)
