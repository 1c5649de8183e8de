# Frozen copy of opendog_tpu_torch/physics/dynamics.py at commit 9b29168 (the benchmark's reference:
# later changes to the program do not reach it).  Imports rewritten only.
"""Featherstone dynamics in base-centered world coordinates (PyTorch).

Port of ``opendog_tpu/physics/dynamics.py``: the op-graph physics step
(CRBA mass matrix, RNEA bias, position-servo actuators, soft joint limits,
smooth penalty contact on a plane, a bilinear heightfield and static boxes,
an implicit-damping velocity update through the quadruped's block-arrow
solve, semi-implicit integration), the level-parallel ``fk``, and the
terrain lookups that give the substep kernel its contact planes.

The JAX functions are written for one state and vmapped.  Here every
function takes explicit leading batch axes, ``(..., nq)`` / ``(..., nv)``:
B = 1 for a plant, B = K for MPPI rollouts, or none at all.  Every static
index the JAX code takes from numpy at trace time (body and dof gathers,
``.at[...].set`` scatters, the ancestor masks, the level permutations) is a
tensor of a plan made once per topology, device and dtype
(:func:`_fk_plan`, :func:`_plan`), so that a step copies no host data, reads
nothing back and draws no random number: a CUDA graph can capture it.
Float32 throughout with TF32 off (``device.use_full_fp32``), the
counterpart of the JAX step's ``precision="highest"``.
"""
from __future__ import annotations

import functools
import types
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._device import use_full_fp32
from . import spatial
from .model import (JNT_FREE, JNT_HINGE, Contact, Model, State, StepInfo,
                    Terrain)

# ---------------------------------------------------------------------------
# Static topology helpers (numpy, from the model's static metadata)
# ---------------------------------------------------------------------------


def _body_ancestor_matrix(model: Model) -> np.ndarray:
    """A[b, i] = 1 if body i is an ancestor of (or equals) body b."""
    return _ancestors_of(model.body_parent)


def _ancestors_of(body_parent) -> np.ndarray:
    nb = len(body_parent)
    A = np.zeros((nb, nb), dtype=np.float32)
    for b in range(nb):
        j = b
        while j >= 0:
            A[b, j] = 1.0
            j = body_parent[j]
    return A


def _dof_ancestors(model: Model) -> List[List[int]]:
    """Static per-dof ancestor dof lists (strictly above, excluding self),
    ordered ascending.  Two dofs couple in the mass matrix iff one is an
    ancestor of the other: the branch-induced sparsity that makes the
    tree-sparse LTDL solve O(depth) instead of O(nv^3)."""
    A = _body_ancestor_matrix(model)
    anc = []
    for j in range(model.nv):
        bj = model.dof_body[j]
        lst = [
            i for i in range(model.nv)
            if i != j and A[bj, model.dof_body[i]] and (
                model.dof_body[i] != bj or i < j
            )
        ]
        anc.append([i for i in lst if i < j])
    return anc


def _dof_ancestor_matrix(model: Model) -> np.ndarray:
    """D[i, j] = 1 if dof i belongs to an ancestor-or-self joint of dof j's
    body (i.e. M[i, j] is structurally nonzero with i above j)."""
    return _dof_ancestors_mask(model.body_parent, model.dof_body)


def _dof_ancestors_mask(body_parent, dof_body) -> np.ndarray:
    A = _ancestors_of(body_parent)
    nv = len(dof_body)
    D = np.zeros((nv, nv), dtype=np.float32)
    for j in range(nv):
        bj = dof_body[j]
        for i in range(nv):
            bi = dof_body[i]
            if A[bj, bi]:
                # Same-body pairs (e.g. the free joint's 6x6 block) are
                # "ancestor" in both directions; keep only the upper
                # triangle so the symmetrizing Wm + Wm.T in mass_matrix
                # doesn't double-count them (verified vs mujoco.mj_fullM).
                if bi == bj and i > j:
                    continue
                D[i, j] = 1.0
    return D


def _arrow_structure(model: Model):
    """Detect the quadruped block-arrow sparsity: a floating base (6 dofs)
    plus G independent serial chains of equal length hanging off it.
    Returns (base_dofs, chains (G, n) numpy) or None."""
    return _arrow_of(model.nbody, model.jnt_type, model.body_parent,
                     model.dof_body, model.nv)


def _arrow_of(nbody, jnt_type, body_parent, dof_body, nv):
    if nbody == 0 or jnt_type[0] != JNT_FREE:
        return None
    base = list(range(6))
    groups = {}
    for j in range(6, nv):
        b = dof_body[j]
        # walk up to the child-of-base body
        while body_parent[b] != 0:
            b = body_parent[b]
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


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def _parents_in_prev(levels, L, body_parent, device):
    """Index of each level-L body's parent in level L - 1, or None at the
    world root."""
    parents = [body_parent[i] for i in levels[L]]
    if parents[0] < 0:
        return None
    prev = levels[L - 1]
    return _idx([int(np.where(prev == p_)[0][0]) for p_ in parents], device)


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
    plan = []
    for L, idx in enumerate(levels):
        free_mask = np.array([jnt_type[i] == JNT_FREE for i in idx])
        if free_mask.all():
            plan.append(("free", [body_qpos_adr[i] for i in idx]))
            continue
        if free_mask.any():
            raise ValueError("mixed free/hinge level unsupported")
        pos_in_prev = _parents_in_prev(levels, L, body_parent, device)
        hinge = np.array([jnt_type[i] == JNT_HINGE for i in idx])
        adr = mask = None
        if hinge.any():
            adr = _idx([body_qpos_adr[i] for i in idx], device)
            mask = torch.as_tensor(hinge, dtype=dtype, device=device)
        plan.append(("joint", pos_in_prev, _idx(idx, device), adr, mask))
    return plan, _idx(inv, device)


def _plan(model: Model, device, dtype):
    """The index and mask tensors of the step for ``model`` on ``device``,
    made once per topology, device and dtype (see :func:`_plan_of`)."""
    return _plan_of(model.body_parent, model.jnt_type, model.body_qpos_adr,
                    model.body_dof_adr, model.dof_body, model.site_body,
                    model.foot_body, model.geom_body_static,
                    torch.device(device), dtype)


@functools.lru_cache(maxsize=None)
def _plan_of(body_parent, jnt_type, body_qpos_adr, body_dof_adr, dof_body,
             site_body, foot_body, geom_body, device, dtype):
    """Everything the step takes from the static topology, as tensors on
    ``device``: the ancestor masks, the dof -> body gather, the tree levels
    of the RNEA, the row order of the motion subspace, the hinge dof
    positions, the arrow blocks of the solve, the integrator's qpos order,
    and the site, geom and foot gathers."""
    nb, nv = len(body_parent), len(dof_body)
    fl = lambda a: torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                                   device=device)
    p = types.SimpleNamespace()
    p.body_anc = fl(_ancestors_of(body_parent))                # (nb, nb)
    p.dof_anc = fl(_dof_ancestors_mask(body_parent, dof_body))  # (nv, nv)
    own = np.zeros((nb, nv), np.float32)
    for j in range(nv):
        own[dof_body[j], j] = 1.0
    p.own_mask = fl(own)                                       # (nb, nv)
    p.dof_body = _idx(dof_body, device)
    levels, inv = _level_perm(body_parent)
    p.levels = [(_idx(idx, device),
                 _parents_in_prev(levels, L, body_parent, device))
                for L, idx in enumerate(levels)]
    p.level_inv = _idx(inv, device)

    # motion subspace rows: 6 per free body (3 translational, 3 rotational),
    # then one per hinge body, put back into dof order
    p.free_bodies = [i for i in range(nb) if jnt_type[i] == JNT_FREE]
    hinge = [i for i in range(nb) if jnt_type[i] == JNT_HINGE]
    p.hinge_bodies = _idx(hinge, device) if hinge else None
    row_dofs = [body_dof_adr[i] + r for i in p.free_bodies for r in range(6)]
    row_dofs += [body_dof_adr[i] for i in hinge]
    p.s_perm = (None if row_dofs == list(range(nv))
                else _idx(np.argsort(row_dofs), device))
    p.free_trans = torch.cat(
        [torch.zeros(3, 3, dtype=dtype, device=device),
         torch.eye(3, dtype=dtype, device=device)], dim=1)      # (3, 6)

    # hinge angle of each dof (free dofs read 0)
    src, is_hinge = np.zeros(nv, np.int64), np.zeros(nv, bool)
    for i in hinge:
        src[body_dof_adr[i]] = body_qpos_adr[i]
        is_hinge[body_dof_adr[i]] = True
    p.dofpos_src = _idx(src, device) if hinge else None
    p.dofpos_hinge = torch.as_tensor(is_hinge, device=device)

    # block-arrow solve: base and chain blocks, and the permutation that
    # puts [x_base, x_chains (flattened)] back into dof order
    arrow = _arrow_of(nb, jnt_type, body_parent, dof_body, nv)
    p.arrow = None
    if arrow is not None:
        base, chains = arrow
        order = np.concatenate([base, chains.reshape(-1)])
        p.arrow = (_idx(base, device), _idx(chains, device),
                   _idx(np.argsort(order), device), chains.shape)

    # integrator: free joints (qpos adr, dof adr), then the hinges, put back
    # into the body order the JAX package concatenates in
    p.free_joints = [(body_qpos_adr[i], body_dof_adr[i])
                     for i in p.free_bodies]
    p.hinge_qpos = (_idx([body_qpos_adr[i] for i in hinge], device)
                    if hinge else None)
    p.hinge_dofs = (_idx([body_dof_adr[i] for i in hinge], device)
                    if hinge else None)
    mine, pos = {}, 0
    for i in p.free_bodies:
        mine[i] = list(range(pos, pos + 7))
        pos += 7
    for i in hinge:
        mine[i] = [pos]
        pos += 1
    body_order = [k for i in range(nb) if i in mine for k in mine[i]]
    p.int_perm = (None if body_order == list(range(pos))
                  else _idx(body_order, device))

    p.site_body = _idx(site_body, device)
    p.geom_body = _idx(geom_body, device)
    gb = np.asarray(geom_body, np.int64)
    feet = np.stack([gb == foot for foot in foot_body]) if foot_body else \
        np.zeros((0, len(geom_body)), bool)
    p.foot_sel = fl(feet)                                       # (nfeet, ng)
    p.foot_mask = torch.as_tensor(feet, device=device)
    p.axes3 = torch.arange(3, device=device)
    p.eye3 = torch.eye(3, dtype=dtype, device=device)
    return p


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


def motion_subspace(model: Model, xpos: torch.Tensor, xquat: torch.Tensor,
                    origin: torch.Tensor) -> torch.Tensor:
    """Per-dof spatial motion axes S (..., nv, 6) at the reference
    ``origin`` (..., 3).

    Free joint follows the MuJoCo convention: 3 translational dofs in world
    axes, then 3 rotational dofs as body-frame angular-velocity components
    (axes rotate with the body)."""
    plan = _plan(model, xpos.device, xpos.dtype)
    rows = []
    for i in plan.free_bodies:
        Rt = spatial.quat_to_mat(xquat[..., i, :]).transpose(-1, -2)
        p = (xpos[..., i, :] - origin)[..., None, :].expand(Rt.shape)
        rows.append(plan.free_trans.expand(Rt.shape[:-2] + (3, 6)))
        rows.append(torch.cat([Rt, spatial._cross(p, Rt)], dim=-1))
    hb = plan.hinge_bodies
    if hb is not None:
        q = xquat[..., hb, :]
        a = spatial.quat_rotate(q, model.jnt_axis[hb])
        anchor = (xpos[..., hb, :] + spatial.quat_rotate(q, model.jnt_pos[hb])
                  - origin[..., None, :])
        rows.append(torch.cat([a, spatial._cross(anchor, a)], dim=-1))
    S = torch.cat(rows, dim=-2)
    return S if plan.s_perm is None else S[..., plan.s_perm, :]


def body_velocities(model: Model, S: torch.Tensor,
                    qvel: torch.Tensor) -> torch.Tensor:
    """Spatial velocity of every body at the reference origin: (..., nb, 6)."""
    return (model.ancestor_mask * qvel[..., None, :]) @ S


def site_positions(model: Model, xpos: torch.Tensor,
                   xquat: torch.Tensor) -> torch.Tensor:
    """World positions of all sites (..., nsite, 3)."""
    if model.nsite == 0:
        return xpos.new_zeros(xpos.shape[:-2] + (0, 3))
    sb = _plan(model, xpos.device, xpos.dtype).site_body
    return xpos[..., sb, :] + spatial.quat_rotate(xquat[..., sb, :],
                                                  model.site_pos)


# ---------------------------------------------------------------------------
# Inertia / bias
# ---------------------------------------------------------------------------


def _spatial_inertias(model: Model, xpos: torch.Tensor, xquat: torch.Tensor,
                      origin: torch.Tensor) -> torch.Tensor:
    """Per-body 6x6 spatial inertia about the reference origin: (..., nb, 6, 6)."""
    R = spatial.quat_to_mat(xquat)  # (..., nb, 3, 3)
    com = (xpos + torch.einsum("...bij,bj->...bi", R, model.body_com)
           - origin[..., None, :])
    I_world = torch.einsum("...bij,bjk,...blk->...bil", R, model.body_inertia,
                           R)
    return spatial.spatial_inertia_at_origin(model.body_mass, com, I_world)


def mass_matrix(model: Model, S: torch.Tensor, I_O: torch.Tensor) -> torch.Tensor:
    """CRBA in common-origin coordinates: M (..., nv, nv), armature included."""
    plan = _plan(model, S.device, S.dtype)
    # composite subtree inertia for each body: IC_i = sum_b A[b,i] * I_O[b]
    IC = torch.einsum("bi,...bjk->...ijk", plan.body_anc, I_O)
    # F_j = IC[body(j)] @ S_j
    F = torch.einsum("...jab,...jb->...ja", IC[..., plan.dof_body, :, :], S)
    W = S @ F.transpose(-1, -2)  # W[i,j] = S_i . F_j
    Wm = W * plan.dof_anc
    M = (Wm + Wm.transpose(-1, -2)
         - torch.diag_embed(torch.diagonal(Wm, dim1=-2, dim2=-1)))
    return M + torch.diag(model.dof_armature)


def bias_forces(model: Model, S: torch.Tensor, V: torch.Tensor,
                I_O: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """RNEA with zero acceleration: C(q, v) including gravity: (..., nv)."""
    plan = _plan(model, S.device, S.dtype)
    # per-body "joint velocity" contribution: vJ_i = sum(dofs of i) S qdot
    vJ = (plan.own_mask * qvel[..., None, :]) @ S  # (..., nb, 6)

    # accelerations: a_i = a_parent + v_i x vJ_i ; a_base_frame = [0; -g]
    # (level-parallel: one batched op-set per tree depth)
    g_acc = torch.cat([model.gravity.new_zeros(3), -model.gravity])
    a_levels = []
    for L, (idx, pos_in_prev) in enumerate(plan.levels):
        if pos_in_prev is None:  # root level
            a_p = g_acc.expand(V.shape[:-2] + (idx.shape[0], 6))
        else:
            a_p = a_levels[L - 1][..., pos_in_prev, :]
        a_levels.append(a_p + spatial.motion_cross(V[..., idx, :],
                                                   vJ[..., idx, :]))
    a = torch.cat(a_levels, dim=-2)[..., plan.level_inv, :]

    f = torch.einsum("...bij,...bj->...bi", I_O, a) + spatial.force_cross(
        V, torch.einsum("...bij,...bj->...bi", I_O, V))
    # subtree sums: f_sub_i = sum_b A[b,i] f_b ; C_j = S_j . f_sub[body(j)]
    f_sub = torch.einsum("bi,...bk->...ik", plan.body_anc, f)
    return torch.einsum("...jk,...jk->...j", S, f_sub[..., plan.dof_body, :])


# ---------------------------------------------------------------------------
# Forces: actuators, passive, contact
# ---------------------------------------------------------------------------


def actuator_forces(model: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                    ctrl: torch.Tensor) -> torch.Tensor:
    """Position-servo torques scattered into dof space (..., nv).

    tau = clip(kp (ctrl - q) - kv qdot, forcerange): the MuJoCo position
    actuator the reference robots use (our_robot.xml:11, go1.xml:10)."""
    dof = model.actuator_dof.long()
    q = qpos[..., model.actuator_qposadr.long()]
    qd = qvel[..., dof]
    tau = model.actuator_kp * (ctrl - q) - model.actuator_kv * qd
    tau = torch.clamp(tau, model.actuator_forcerange[:, 0],
                      model.actuator_forcerange[:, 1])
    return torch.zeros_like(qvel).index_add_(-1, dof, tau)


def passive_terms(model: Model, qpos: torch.Tensor, qvel: torch.Tensor):
    """Soft joint-limit spring torques (explicit) + per-dof damping
    coefficients (implicit): returns (tau_spring (..., nv), d_diag (..., nv)).

    Damping folds joint damping, a Coulomb friction-loss linearisation
    (saturating at ``dof_frictionloss``), and extra limit damping when a
    limit is engaged.  The friction-loss quotient is one division (one
    rounding), as in the JAX package and the kernels."""
    qj = _dof_positions(model, qpos)
    lo, hi = model.dof_range[:, 0], model.dof_range[:, 1]
    below = torch.clamp(lo - qj, min=0.0)
    above = torch.clamp(qj - hi, min=0.0)
    k = model.limit_stiffness
    tau = model.dof_limited * k * (below - above)
    engaged = model.dof_limited * ((below > 0) | (above > 0))
    d_diag = (
        model.dof_damping
        + torch.div(model.dof_frictionloss,
                    torch.clamp(torch.abs(qvel), min=0.05))
        + model.limit_damping * engaged
    )
    return tau, d_diag


def _dof_positions(model: Model, qpos: torch.Tensor) -> torch.Tensor:
    """Hinge angles aligned with dof indexing (free dofs get 0)."""
    plan = _plan(model, qpos.device, qpos.dtype)
    if plan.dofpos_src is None:
        return qpos.new_zeros(qpos.shape[:-1] + (model.nv,))
    return torch.where(plan.dofpos_hinge, qpos[..., plan.dofpos_src], 0.0)


def _terrain_height_normal(model: Model, terrain: Optional[Terrain],
                           xy: torch.Tensor):
    """Ground height and unit normal under world xy points (batched over the
    leading axes of ``xy``): bilinear in the heightfield, with the lookup
    clipped to ``n - 1.001`` cells as in the JAX package.  A terrain of
    one grid (nrow, ncol) lies under every point; a terrain of one grid
    per env (B, nrow, ncol) lies under the points of env b =
    ``xy[b, ...]`` (the JAX package's vmapped env, each with its own
    terrain)."""
    if terrain is None:
        h = xy.new_zeros(xy.shape[:-1])
        n = torch.stack([h, h, torch.ones_like(h)], dim=-1)
        return h, n
    height = terrain.height
    nrow, ncol = height.shape[-2:]
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
    if height.dim() == 2:
        h00 = height[y0, x0]
        h01 = height[y0, x0 + 1]
        h10 = height[y0 + 1, x0]
        h11 = height[y0 + 1, x0 + 1]
    else:
        per_env = height.reshape(height.shape[0], -1)
        cell = (y0 * ncol + x0).reshape(height.shape[0], -1)

        def at(offset):
            return torch.gather(per_env, 1, cell + offset).reshape(y0.shape)

        h00, h01, h10, h11 = at(0), at(1), at(ncol), at(ncol + 1)
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


def _contact_geometry(model: Model, xpos: torch.Tensor, xquat: torch.Tensor,
                      terrain: Optional[Terrain]):
    """Sphere-vs-(ground|static boxes) queries for every collision geom.

    Returns (penetration (..., ng), normal (..., ng, 3), contact point
    (..., ng, 3), R (..., nb, 3, 3)).  Inside a box the nearest face wins,
    the first of equal ones (``jnp.argmin``'s and ``torch.argmin``'s tie
    rule), with the sign of 0 being 0 in both packages."""
    plan = _plan(model, xpos.device, xpos.dtype)
    R = spatial.quat_to_mat(xquat)  # (..., nb, 3, 3)
    gb = plan.geom_body
    centers = xpos[..., gb, :] + torch.einsum(
        "...gij,gj->...gi", R[..., gb, :, :], model.geom_pos)
    radius = model.geom_radius

    h, n = _terrain_height_normal(model, terrain, centers[..., :2])
    phi_g = (centers[..., 2] - h) * n[..., 2] - radius

    if model.wbox_pos.shape[0] > 0:
        size = model.wbox_size
        rel = centers[..., :, None, :] - model.wbox_pos  # (..., ng, nw, 3)
        clamped = torch.clamp(rel, -size, size)
        delta = rel - clamped
        dist = torch.linalg.norm(delta, dim=-1)
        inside = dist < 1e-9
        # inside the box: nearest face gives penetration and normal
        face_d = size - torch.abs(rel)  # (..., ng, nw, 3) >= 0 inside
        ax = torch.argmin(face_d, dim=-1, keepdim=True)  # (..., ng, nw, 1)
        n_inside = (torch.sign(torch.gather(rel, -1, ax))
                    * (ax == plan.axes3).to(centers.dtype))
        d_inside = torch.gather(face_d, -1, ax)[..., 0]
        n_box = torch.where(inside[..., None], n_inside,
                            delta / torch.clamp(dist, min=1e-9)[..., None])
        phi_box = torch.where(inside, -d_inside, dist) - radius[:, None]
        bi = torch.argmin(phi_box, dim=-1, keepdim=True)  # (..., ng, 1)
        phi_b = torch.gather(phi_box, -1, bi)[..., 0]
        n_b = torch.gather(
            n_box, -2, bi[..., None].expand(bi.shape + (3,)))[..., 0, :]
        use_box = phi_b < phi_g
        phi = torch.where(use_box, phi_b, phi_g)
        n = torch.where(use_box[..., None], n_b, n)
    else:
        phi = phi_g

    contact_pt = centers - n * radius[:, None]
    return phi, n, contact_pt, R


def _jcj(J: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """sum_g J_g C_g J_g^T: (..., ng, nv, 3), (..., ng, 3, 3) -> (..., nv, nv)."""
    return torch.einsum("...gvj,...gwj->...vw", J @ C, J)


def contact_terms(model: Model, xpos: torch.Tensor, xquat: torch.Tensor,
                  S: torch.Tensor, V: torch.Tensor, origin: torch.Tensor,
                  terrain: Optional[Terrain]):
    """Contact spring forces + implicit damping operator.

    The stiff parts of the soft contact (normal damper, Coulomb-friction
    regularisation) are returned as a positive-semidefinite generalized
    damping matrix ``D`` folded into an implicit velocity update
    ``(M + dt D) v' = M v + dt f``, while the (bounded) penetration spring
    stays explicit: the penalty-contact analogue of MuJoCo's
    'implicitfast' integrator.

    Returns (qfrc_spring (..., nv), D (..., nv, nv), Contact diagnostics).
    """
    plan = _plan(model, xpos.device, xpos.dtype)
    phi, n, contact_pt, R = _contact_geometry(model, xpos, xquat, terrain)
    gb = plan.geom_body
    pt_rel = contact_pt - origin[..., None, :]
    Vg = V[..., gb, :]
    v_pt = Vg[..., 3:] + spatial._cross(Vg[..., :3], pt_rel)

    # penetration capped at 5 cm: keeps spring forces finite in f32 even
    # when a fallen robot's geoms end up deep inside the ground/boxes
    pen = torch.clamp(-phi, 0.0, 0.05)
    active = (phi < 0.0).to(phi.dtype)
    v_n = torch.sum(v_pt * n, dim=-1)
    k, d = model.geom_stiffness, model.geom_damping
    if model.geom_imp_dmin is not None:
        # progressive impedance (MuJoCo solimp, power 1): soft at
        # touchdown, full stiffness at pen >= width; scales the normal
        # spring, the damper and (through fn) the Coulomb limit
        imp = (model.geom_imp_dmin
               + (1.0 - model.geom_imp_dmin)
               * torch.clamp(pen / model.geom_imp_width, 0.0, 1.0))
        k = k * imp
        d = d * imp
    fn_spring = torch.clamp(k * pen, max=1e4)  # explicit, bounded

    # point Jacobians (..., ng, nv, 3)
    mask = model.ancestor_mask[gb][:, :, None]
    J = mask * (S[..., None, :, 3:]
                + spatial._cross(S[..., None, :, :3], pt_rel[..., :, None, :]))

    qfrc_spring = torch.einsum("...gvi,...gi->...v", J,
                               fn_spring[..., None] * n)

    # implicit damping: normal damper (only while approaching or loaded) and
    # tangential friction linearised about the current slip speed with
    # saturation at mu*fn ( coefficient  mu fn / max(|vt|, eps) ).
    v_t = v_pt - v_n[..., None] * n
    vt_norm = torch.sqrt(torch.sum(v_t * v_t, dim=-1) + 1e-12)
    mu = model.geom_friction[:, 0]
    eps = model.friction_smoothing
    kappa_t = mu * fn_spring / torch.maximum(vt_norm, eps)
    d_n = d * active
    # C_g = d_n n n^T + kappa_t (I - n n^T)   (3x3 PSD per geom)
    nnT = n[..., :, None] * n[..., None, :]
    C = (d_n[..., None, None] * nnT
         + (kappa_t * active)[..., None, None] * (plan.eye3 - nnT))
    D = _jcj(J, C)
    if model.geom_imp_dmin is not None:
        # oracle-contact variant (same gate as the progressive impedance):
        # torsional + rolling friction, the condim=6 part of the reference
        # foot (go1.xml:62 friction "0.8 0.02 0.01"), linearised about the
        # current angular slip like the sliding term and folded into D
        # through the angular Jacobian
        w_g = Vg[..., :3]
        w_n = torch.sum(w_g * n, dim=-1)
        w_t = w_g - w_n[..., None] * n
        wt_norm = torch.sqrt(torch.sum(w_t * w_t, dim=-1) + 1e-12)
        eps_r = 0.5  # rad/s linearisation scale
        mu_tors = model.geom_friction[:, 1]
        mu_roll = model.geom_friction[:, 2]
        kap_tors = mu_tors * fn_spring / torch.clamp(torch.abs(w_n),
                                                     min=eps_r)
        kap_roll = mu_roll * fn_spring / torch.clamp(wt_norm, min=eps_r)
        C_ang = ((kap_tors * active)[..., None, None] * nnT
                 + (kap_roll * active)[..., None, None] * (plan.eye3 - nnT))
        J_ang = mask * S[..., None, :, :3]
        D = D + _jcj(J_ang, C_ang)

    # diagnostics with the saturated Coulomb model at the current velocity
    fn_diag = torch.clamp(fn_spring - d * v_n, min=0.0) * active
    f_t = -(mu * fn_diag / torch.maximum(vt_norm, eps))[..., None] * v_t
    force = fn_diag[..., None] * n + f_t
    Rg = R[..., gb, :, :]
    contact = Contact(
        force_world=force,
        force_body=torch.einsum("...gji,...gj->...gi", Rg, force),
        penetration=pen,
        in_contact=(phi < 0.0) & (fn_diag > 0),
    )
    return qfrc_spring, D, contact


# ---------------------------------------------------------------------------
# Linear solves of the implicit velocity update
# ---------------------------------------------------------------------------


def tree_solve(model: Model, A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b exploiting branch-induced sparsity (MuJoCo's
    mj_factorM/mj_solveM equivalent, unrolled over the static tree).

    A (..., nv, nv) must carry the tree sparsity pattern: A[i, j] == 0
    unless dof i and j lie on one root path.  LTDL factorization
    A = L' D L with unit-lower-triangular L sharing A's sparsity,
    processed leaf-to-root (Featherstone ch. 8)."""
    anc = _dof_ancestors(model)
    nv = model.nv
    H = {}
    for j in range(nv):
        for i in anc[j] + [j]:
            H[(j, i)] = A[..., j, i]
    # factorize: for k = nv-1..0: for i in anc(k): ...
    for k in reversed(range(nv)):
        dk = H[(k, k)]
        for i in reversed(anc[k]):
            a = H[(k, i)] / dk
            for j in anc[k]:
                if j <= i:
                    H[(i, j)] = H.get((i, j), 0.0) - a * H[(k, j)]
            H[(k, i)] = a
    # x = L^-1 (D^-1 (L^-T b))
    x = [b[..., j] for j in range(nv)]
    for k in reversed(range(nv)):
        for i in anc[k]:
            x[i] = x[i] - H[(k, i)] * x[k]
    for k in range(nv):
        x[k] = x[k] / H[(k, k)]
    for k in range(nv):
        for i in anc[k]:
            x[k] = x[k] - H[(k, i)] * x[i]
    return torch.stack(x, dim=-1)


def _dense_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cholesky solve of a dense SPD system; ``cholesky_ex`` leaves the
    factorization's status on the device (plain ``cholesky`` reads it on
    the host, which a CUDA graph cannot capture)."""
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def _clamp_det(det: torch.Tensor) -> torch.Tensor:
    """det pushed away from 0 to +-1e-12, as the JAX package does."""
    tiny = torch.where(det < 0, -1e-12, 1e-12).to(det.dtype)
    return torch.where(torch.abs(det) < 1e-12, tiny, det)


def _leg_inverse(m: torch.Tensor, n: int) -> torch.Tensor:
    """Closed-form inverse of the (..., n, n) leg blocks, n <= 3."""
    if n == 1:
        return torch.div(1.0, m)
    if n == 2:
        a_, b_ = m[..., 0, 0], m[..., 0, 1]
        c_, d_ = m[..., 1, 0], m[..., 1, 1]
        det = _clamp_det(a_ * d_ - b_ * c_)
        return torch.stack([
            torch.stack([d_, -b_], dim=-1),
            torch.stack([-c_, a_], dim=-1),
        ], dim=-2) / det[..., None, None]
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = _clamp_det(m[..., 0, 0] * c00 + m[..., 0, 1] * c01
                     + m[..., 0, 2] * c02)
    return torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2) / det[..., None, None]


def arrow_solve(model: Model, A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve of the implicit-dynamics system exploiting the
    quadruped's block-arrow sparsity: legs only couple through the floating
    base, so the dense (nv, nv) Cholesky reduces to G small closed-form leg
    inverses + one 6x6 Schur solve.  Without the structure (no free joint)
    or with legs of more than 3 dofs: a dense Cholesky solve.

    A: (..., nv, nv) with the tree sparsity; b: (..., nv)."""
    arrow = _plan(model, A.device, A.dtype).arrow
    if arrow is None or arrow[3][1] > 3:
        return _dense_solve(A, b)
    base, chains, inv, (G, n) = arrow

    Abb = A[..., base[:, None], base[None, :]]               # (...,6,6)
    Abl = A[..., base[:, None, None], chains[None, :, :]]    # (...,6,G,n)
    All = A[..., chains[:, :, None], chains[:, None, :]]     # (...,G,n,n)
    bl = b[..., chains]                                      # (...,G,n)
    bb = b[..., base]                                        # (...,6)
    All_inv = _leg_inverse(All, n)

    # Schur complement on the base: S = Abb - sum_g Abl inv(All) Alb
    AblInv = torch.einsum("...igm,...gmn->...ign", Abl, All_inv)
    S = Abb - torch.einsum("...ign,...jgn->...ij", AblInv, Abl)
    yb = bb - torch.einsum("...ign,...gn->...i", AblInv, bl)

    # 6x6 SPD solve via unrolled Cholesky
    xb = _chol_solve_unrolled(S, yb)

    # back-substitute legs: x_l = inv(All) (b_l - Alb x_b)
    rhs = bl - torch.einsum("...ign,...i->...gn", Abl, xb)
    xl = torch.einsum("...gmn,...gn->...gm", All_inv, rhs)
    x = torch.cat([xb, xl.reshape(xl.shape[:-2] + (G * n,))], dim=-1)
    return x[..., inv]


def _chol_solve_unrolled(S: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky solve for small fixed m = S.shape[-1] (static)."""
    m = S.shape[-1]
    L = [[None] * m for _ in range(m)]
    for j in range(m):
        s = S[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        # f32 cancellation in extreme (already-fallen) states can push the
        # pivot slightly negative; clamp instead of emitting NaN
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-9))
        for i in range(j + 1, m):
            s = S[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    # forward solve L z = y
    z = [None] * m
    for i in range(m):
        s = y[..., i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    # back solve L^T x = z
    x = [None] * m
    for i in reversed(range(m)):
        s = z[i]
        for k in range(i + 1, m):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


# ---------------------------------------------------------------------------
# Forward dynamics + integration
# ---------------------------------------------------------------------------


def forward(model: Model, qpos: torch.Tensor, qvel: torch.Tensor,
            ctrl: torch.Tensor, terrain: Optional[Terrain] = None,
            dt: Optional[float] = None):
    """Forward dynamics with implicit-damping velocity update.

    Solves  (M + dt D) v' = M v + dt f_explicit  where ``D`` collects the
    stiff velocity-proportional terms (contact damper, friction
    linearisation, joint damping/friction-loss).  Returns (qvel_next, aux).
    """
    if dt is None:
        dt = model.timestep
    xpos, xquat = fk(model, qpos)
    origin = xpos[..., 0, :]
    S = motion_subspace(model, xpos, xquat, origin)
    V = body_velocities(model, S, qvel)
    I_O = _spatial_inertias(model, xpos, xquat, origin)

    M = mass_matrix(model, S, I_O)
    C = bias_forces(model, S, V, I_O, qvel)
    qfrc_act = actuator_forces(model, qpos, qvel, ctrl)
    tau_lim, d_diag = passive_terms(model, qpos, qvel)
    qfrc_con, D_con, contact = contact_terms(model, xpos, xquat, S, V, origin,
                                             terrain)

    f_explicit = qfrc_act + tau_lim + qfrc_con - C
    A = M + dt * (D_con + torch.diag_embed(d_diag))
    rhs = (M @ qvel[..., None])[..., 0] + dt * f_explicit
    qvel_next = arrow_solve(model, A, rhs)
    # firewall: a numerically failed solve (f32 overflow in a pathological
    # pose) must not inject NaN into the carried state; keep the previous
    # (clamped) velocity for that substep instead
    qvel_next = torch.where(torch.isfinite(qvel_next), qvel_next,
                            torch.clamp(qvel, -1e3, 1e3))
    return qvel_next, dict(xpos=xpos, xquat=xquat, contact=contact,
                           qfrc_actuator=qfrc_act, mass_matrix=M)


def integrate(model: Model, qpos: torch.Tensor, qvel: torch.Tensor,
              dt) -> torch.Tensor:
    """Semi-implicit position update with exact quaternion integration."""
    plan = _plan(model, qpos.device, qpos.dtype)
    parts = []
    for adr, dadr in plan.free_joints:
        parts.append(qpos[..., adr:adr + 3] + dt * qvel[..., dadr:dadr + 3])
        parts.append(spatial.quat_integrate(qpos[..., adr + 3:adr + 7],
                                            qvel[..., dadr + 3:dadr + 6], dt))
    if plan.hinge_qpos is not None:
        parts.append(qpos[..., plan.hinge_qpos]
                     + dt * qvel[..., plan.hinge_dofs])
    out = torch.cat(parts, dim=-1)
    return out if plan.int_perm is None else out[..., plan.int_perm]


def step(model: Model, state: State, ctrl: torch.Tensor,
         terrain: Optional[Terrain] = None,
         n_substeps: int = 1) -> Tuple[State, Optional[StepInfo]]:
    """Advance ``n_substeps`` physics substeps of ``model.timestep`` under a
    held control (MuJoCo ``frame_skip`` semantics).  ``state`` holds
    ``(..., nq)`` / ``(..., nv)`` and ``ctrl`` ``(..., nu)`` over the same
    leading axes; the info is that of the last substep.

    One Python loop serves both of the JAX step's forms (unrolled up to 8
    substeps, ``lax.scan`` beyond): they compute the same substeps."""
    use_full_fp32()
    dt = model.timestep
    qpos, qvel = state.qpos, state.qvel
    info = None
    for i in range(n_substeps):
        qvel2, aux = forward(model, qpos, qvel, ctrl, terrain, dt)
        # numerical firewall: physical robots never exceed these rates; the
        # clamp stops a single bad contact event from cascading into f32
        # overflow/NaN during large batched rollouts
        qvel2 = torch.clamp(qvel2, -1e3, 1e3)
        qpos2 = integrate(model, qpos, qvel2, dt)
        if i == n_substeps - 1:
            info = StepInfo(contact=aux["contact"],
                            qfrc_actuator=aux["qfrc_actuator"],
                            qacc=(qvel2 - qvel) / dt, xpos=aux["xpos"],
                            xquat=aux["xquat"])
        qpos, qvel = qpos2, qvel2
    return State(qpos=qpos, qvel=qvel,
                 time=state.time + dt * n_substeps), info


def foot_contact_summary(model: Model, contact: Contact):
    """Aggregate per-geom contact into per-foot quantities.

    Returns (force_world (..., nfeet, 3), force_body (..., nfeet, 3),
    in_contact (..., nfeet)) matching the reference's per-paw contact
    extraction (``walk_environment_reward_calc.py:318-370``)."""
    plan = _plan(model, contact.force_world.device, contact.force_world.dtype)
    fw = torch.einsum("fg,...gi->...fi", plan.foot_sel, contact.force_world)
    fb = torch.einsum("fg,...gi->...fi", plan.foot_sel, contact.force_body)
    ic = torch.any(contact.in_contact[..., None, :] & plan.foot_mask, dim=-1)
    return fw, fb, ic
