"""Topology, kinematics and terrain helpers of the Featherstone dynamics.

Port of ``opendog_tpu/physics/dynamics.py``: ``_body_ancestor_matrix`` and
``_arrow_structure`` (lines 48, 124-150), which the kernel tables and the
plain substep read; the level-parallel ``fk`` (lines 288-360); and the
terrain lookups ``_terrain_height_normal`` and ``geom_local_planes`` (lines
549-608), which give the substep kernel its contact planes.  The rest of
the op-graph physics is not ported yet (ROADMAP M8).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import spatial
from .model import JNT_FREE, JNT_HINGE, Model, Terrain


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


# ---------------------------------------------------------------------------
# Kinematics
# ---------------------------------------------------------------------------


def _tree_levels(body_parent):
    """Static list of numpy body-index arrays grouped by tree depth: one
    batched op-set per level instead of one per body."""
    depth = {}
    for i, p in enumerate(body_parent):
        depth[i] = 0 if p < 0 else depth[p] + 1
    nlev = max(depth.values()) + 1
    return [
        np.array([i for i in range(len(body_parent)) if depth[i] == L],
                 dtype=np.int32)
        for L in range(nlev)
    ]


def _level_perm(body_parent):
    """(levels, inverse permutation) mapping level-major concat -> body order."""
    levels = _tree_levels(body_parent)
    order = np.concatenate(levels)
    inv = np.argsort(order)
    return levels, inv


def _fk_plan(model: Model, device, dtype):
    """The index tensors of ``fk`` for ``model`` on ``device``, made once
    per topology, device and dtype: ``(levels, inv)`` with one entry per
    tree depth, ``("free", qpos addresses)`` or ``("joint", index of each
    parent in the previous level or None at the world root, body indices,
    qpos addresses or None, hinge mask or None)``.  ``fk`` then copies no
    host data to the device, which a CUDA graph capture would refuse."""
    return _fk_plan_of(model.body_parent, model.jnt_type,
                       model.body_qpos_adr, torch.device(device), dtype)


@functools.lru_cache(maxsize=None)
def _fk_plan_of(body_parent, jnt_type, body_qpos_adr, device, dtype):
    levels, inv = _level_perm(body_parent)
    idx_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    plan = []
    for L, idx in enumerate(levels):
        free_mask = np.array([jnt_type[i] == JNT_FREE for i in idx])
        if free_mask.all():
            plan.append(("free", [body_qpos_adr[i] for i in idx]))
            continue
        if free_mask.any():
            raise ValueError("mixed free/hinge level unsupported")
        parents = np.array([body_parent[i] for i in idx])
        pos_in_prev = None
        if parents[0] >= 0:
            prev = levels[L - 1]
            pos_in_prev = idx_t(
                [int(np.where(prev == p_)[0][0]) for p_ in parents])
        hinge = np.array([jnt_type[i] == JNT_HINGE for i in idx])
        adr = mask = None
        if hinge.any():
            adr = idx_t([body_qpos_adr[i] for i in idx])
            mask = torch.as_tensor(hinge, dtype=dtype, device=device)
        plan.append(("joint", pos_in_prev, idx_t(idx), adr, mask))
    return plan, idx_t(inv)


def fk(model: Model, qpos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics: world body positions (..., nb, 3) and
    quaternions (..., nb, 4) of ``qpos (..., nq)``.

    Level-parallel as in the JAX package: each tree depth is one batched
    op-set (parents gathered from the previous level), assembled at the end
    with one concatenation and a static permutation."""
    plan, inv_t = _fk_plan(model, qpos.device, qpos.dtype)
    pos_levels, quat_levels = [], []
    for L, level in enumerate(plan):
        if level[0] == "free":
            adr = level[1]
            p = torch.stack([qpos[..., a:a + 3] for a in adr], dim=-2)
            q = spatial.quat_normalize(
                torch.stack([qpos[..., a + 3:a + 7] for a in adr], dim=-2))
        else:
            _, pos_in_prev, sel, adr, hinge = level
            if pos_in_prev is None:  # hinge bodies welded at the world root
                shape = qpos.shape[:-1] + (sel.shape[0],)
                pp = torch.zeros(shape + (3,), dtype=qpos.dtype,
                                 device=qpos.device)
                pq = spatial.quat_identity(qpos.dtype, qpos.device).expand(
                    shape + (4,))
            else:
                pp = pos_levels[L - 1][..., pos_in_prev, :]
                pq = quat_levels[L - 1][..., pos_in_prev, :]
            p = pp + spatial.quat_rotate(pq, model.body_pos[sel])
            q = spatial.quat_mul(pq, model.body_quat[sel])
            if adr is not None:
                theta = qpos[..., adr] * hinge
                qj = spatial.quat_from_axis_angle(model.jnt_axis[sel], theta)
                jpos = model.jnt_pos[sel]
                anchor = p + spatial.quat_rotate(q, jpos)
                q = spatial.quat_mul(q, qj)
                p = anchor - spatial.quat_rotate(q, jpos)
        pos_levels.append(p)
        quat_levels.append(q)
    xpos = torch.cat(pos_levels, dim=-2)[..., inv_t, :]
    xquat = torch.cat(quat_levels, dim=-2)[..., inv_t, :]
    return xpos, xquat


# ---------------------------------------------------------------------------
# Terrain
# ---------------------------------------------------------------------------


def _terrain_height_normal(model: Model, terrain: Optional[Terrain],
                           xy: torch.Tensor):
    """Ground height and unit normal under world xy points (batched over the
    leading axes of ``xy``): bilinear in the heightfield, with the lookup
    clipped to ``n - 1.001`` cells as in the JAX package."""
    if terrain is None:
        h = torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
        n = torch.tensor([0.0, 0.0, 1.0], dtype=xy.dtype,
                         device=xy.device).expand(xy.shape[:-1] + (3,))
        return h, n
    height = terrain.height
    nrow, ncol = height.shape
    sx, sy = model.hfield_size[0], model.hfield_size[1]
    # grid spans [-sx, sx] x [-sy, sy]; row ~ y, col ~ x (MuJoCo layout)
    fx = (xy[..., 0] + sx) / (2 * sx) * (ncol - 1)
    fy = (xy[..., 1] + sy) / (2 * sy) * (nrow - 1)
    fx = torch.clamp(fx, 0.0, ncol - 1.001)
    fy = torch.clamp(fy, 0.0, nrow - 1.001)
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    tx = fx - x0
    ty = fy - y0
    h00 = height[y0, x0]
    h01 = height[y0, x0 + 1]
    h10 = height[y0 + 1, x0]
    h11 = height[y0 + 1, x0 + 1]
    h = (
        h00 * (1 - tx) * (1 - ty)
        + h01 * tx * (1 - ty)
        + h10 * (1 - tx) * ty
        + h11 * tx * ty
    )
    dx = ((h01 - h00) * (1 - ty) + (h11 - h10) * ty) / (2 * sx / (ncol - 1))
    dy = ((h10 - h00) * (1 - tx) + (h11 - h01) * tx) / (2 * sy / (nrow - 1))
    n = torch.stack([-dx, -dy, torch.ones_like(dx)], dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    return h, n


def geom_local_planes(model: Model, terrain: Optional[Terrain],
                      qpos: torch.Tensor) -> torch.Tensor:
    """(..., ngeom, 4) terrain tangent plane ``(nx, ny, nz, d)`` under each
    collision geom's current center (plane {x : n.x = d}, n unit): the
    plane rows of the substep kernel's per-geom mode."""
    xpos, xquat = fk(model, qpos)
    R = spatial.quat_to_mat(xquat)
    gb = model.geom_body.long()
    centers = xpos[..., gb, :] + torch.einsum(
        "...gij,gj->...gi", R[..., gb, :, :], model.geom_pos)
    h, n = _terrain_height_normal(model, terrain, centers[..., :2])
    p0 = torch.stack([centers[..., 0], centers[..., 1], h], dim=-1)
    d = torch.sum(n * p0, dim=-1)
    return torch.cat([n, d[..., None]], dim=-1)
