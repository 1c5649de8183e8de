"""Static topology helpers of the Featherstone dynamics (numpy).

Port of ``_body_ancestor_matrix`` and ``_arrow_structure`` from
``opendog_tpu/physics/dynamics.py:48,124-150``; the kernel tables and the
plain substep read the block-arrow structure from here.  The op-graph
physics of that module is not ported yet (ROADMAP M8).
"""
from __future__ import annotations

import numpy as np

from .model import JNT_FREE, Model


def _body_ancestor_matrix(model: Model) -> np.ndarray:
    """A[b, i] = 1 if body i is an ancestor of (or equals) body b."""
    nb = model.nbody
    A = np.zeros((nb, nb), dtype=np.float32)
    for b in range(nb):
        j = b
        while j >= 0:
            A[b, j] = 1.0
            j = model.body_parent[j]
    return A


def _arrow_structure(model: Model):
    """Detect the quadruped block-arrow sparsity: a floating base (6 dofs)
    plus G independent serial chains of equal length hanging off it.
    Returns (base_dofs, chains (G, n) numpy) or None."""
    if model.nbody == 0 or model.jnt_type[0] != JNT_FREE:
        return None
    base = list(range(6))
    groups = {}
    for j in range(6, model.nv):
        b = model.dof_body[j]
        # walk up to the child-of-base body
        while model.body_parent[b] != 0:
            b = model.body_parent[b]
            if b < 0:
                return None
        groups.setdefault(b, []).append(j)
    chains = list(groups.values())
    if not chains:
        return None
    n = len(chains[0])
    if any(len(c) != n for c in chains):
        return None
    return np.array(base), np.array(chains)
