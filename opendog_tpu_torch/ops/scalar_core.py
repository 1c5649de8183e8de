"""Plain PyTorch version of the fused physics substep (kernel K1).

Port of ``opendog_tpu/ops/scalar_core.py`` in its flat-ground mode: the
whole Featherstone substep written as straight-line arithmetic over *lane
vectors* — every physical scalar a ``(K,)`` tensor with the rollout batch
along it, every 3-vector a Python tuple of three such tensors, and every
model constant a baked Python float, so that multiplications by 0 / ±1 in
the contact normal and the inertia products fold away when the function is
built (``pdot``, ``pscale_sub``, ``m3_mul_const_right``).

This is what the CUDA kernel (``csrc/substep_core.cuh``) is held against:
:mod:`.cuda_step` runs it for tensors on the CPU, and ``chip_smoke.py``
compares the kernel with it on the card.  It runs on any device.

Scope: floating-base quadrupeds with the block-arrow structure (free base +
serial leg chains), the plane z=0 as ground, position-servo actuators.  The
per-lane contact plane and payload modes (ROADMAP K2-K4) are not ported.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..physics.model import JNT_HINGE, Model
from ..physics import dynamics as dyn

# ---------------------------------------------------------------------------
# tuple-math helpers (operate on any array-like supporting + - * /)
# ---------------------------------------------------------------------------

V3 = Tuple  # (x, y, z)
QUAT = Tuple  # (w, x, y, z)
M3 = Tuple  # ((..),(..),(..)) rows


def v3(x, y, z):
    return (x, y, z)


def v_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def m3_from_quat(q):
    w, x, y, z = q
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)),
        (2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)),
        (2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)),
    )


def m3_apply(M, v):
    return (
        M[0][0] * v[0] + M[0][1] * v[1] + M[0][2] * v[2],
        M[1][0] * v[0] + M[1][1] * v[1] + M[1][2] * v[2],
        M[2][0] * v[0] + M[2][1] * v[1] + M[2][2] * v[2],
    )


def m3_apply_T(M, v):
    return (
        M[0][0] * v[0] + M[1][0] * v[1] + M[2][0] * v[2],
        M[0][1] * v[0] + M[1][1] * v[1] + M[2][1] * v[2],
        M[0][2] * v[0] + M[1][2] * v[1] + M[2][2] * v[2],
    )


def m3_mul(A, B):
    return tuple(
        tuple(sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3))
        for i in range(3)
    )


def m3_mul_const_right(M, C: np.ndarray):
    """M @ C with C a static numpy 3x3 (constants fold)."""
    return tuple(
        tuple(
            sum(M[i][k] * float(C[k, j]) for k in range(3) if C[k, j] != 0.0)
            if any(C[k, j] != 0.0 for k in range(3))
            else M[i][0] * 0.0
            for j in range(3)
        )
        for i in range(3)
    )


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def quat_mul_const(a, b_const: np.ndarray):
    """a ⊗ b with b a static unit quaternion (constants fold)."""
    bw, bx, by, bz = (float(v) for v in b_const)
    aw, ax, ay, az = a
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


# spatial vectors: (ang V3, lin V3)


def sv(ang, lin):
    return (ang, lin)


def sv_add(a, b):
    return (v_add(a[0], b[0]), v_add(a[1], b[1]))


def sv_dot(a, b):
    return v_dot(a[0], b[0]) + v_dot(a[1], b[1])


def sv_scale(a, s):
    return (v_scale(a[0], s), v_scale(a[1], s))


def motion_cross(v, m):
    w, vo = v
    mw, mv = m
    return (v_cross(w, mw), v_add(v_cross(w, mv), v_cross(vo, mw)))


def force_cross(v, f):
    w, vo = v
    tau, frc = f
    return (v_add(v_cross(w, tau), v_cross(vo, frc)), v_cross(w, frc))


# symmetric 3x3 as 6-tuple (xx, xy, xz, yy, yz, zz)


def sym3_apply(S, v):
    return (
        S[0] * v[0] + S[1] * v[1] + S[2] * v[2],
        S[1] * v[0] + S[3] * v[1] + S[4] * v[2],
        S[2] * v[0] + S[4] * v[1] + S[5] * v[2],
    )


# spatial inertia about the origin in block form: (I11 sym6, h V3, m scalar)
# momentum([w, v]) = (I11 w + h x v ... ) — we store:
#   top-left  A = I_c - m cx cx          (sym6)
#   top-right B = m cx                    (so B v = m c x v)
#   mass      m
# I @ [w; v] = (A w + m (c x v),  -m (c x w) + m v) = (A w + m c×v,
#               m (v - c×w))


def inertia_apply(I, svec):
    A, c, m = I
    w, v = svec
    top = v_add(sym3_apply(A, w), v_scale(v_cross(c, v), m))
    bot = v_scale(v_sub(v, v_cross(c, w)), m)
    return (top, bot)


# ---------------------------------------------------------------------------
# the substep builder
# ---------------------------------------------------------------------------


def _sqrt(x):
    return torch.sqrt(x)


def _max(a, b):
    return torch.clamp(a, min=b) if isinstance(b, float) else torch.maximum(a, b)


def _min(a, b):
    return torch.clamp(a, max=b) if isinstance(b, float) else torch.minimum(a, b)


def _where(c, a, b):
    return torch.where(c, a, b)


def build_substep(model: Model, dt: float,
                  with_plane: bool = False,
                  with_payload: bool = False) -> Callable:
    """Build ``substep(qpos_rows, qvel_rows, ctrl_rows) -> (qpos', qvel')``
    operating on tuples of lane vectors (``(K,)`` tensors).  All model
    constants are baked.  Flat ground (the plane z=0) only."""
    if with_plane or with_payload:
        raise NotImplementedError(
            "the per-lane contact plane and payload modes of the substep "
            "are not ported yet (ROADMAP K2-K4)")
    structure = dyn._arrow_structure(model)
    if structure is None:
        raise ValueError("scalar core needs the quadruped block-arrow "
                         "structure (free base + equal serial chains)")
    base, chains = structure
    nb, nv, nu = model.nbody, model.nv, model.nu

    def f64(name):
        return model.numpy(name).astype(np.float64)

    body_pos = f64("body_pos")
    body_quat = f64("body_quat")
    body_mass = f64("body_mass")
    body_com = f64("body_com")
    body_inertia = f64("body_inertia")
    jnt_axis = f64("jnt_axis")
    jnt_pos = f64("jnt_pos")
    dof_armature = f64("dof_armature")
    dof_damping = f64("dof_damping")
    dof_frictionloss = f64("dof_frictionloss")
    dof_limited = f64("dof_limited")
    dof_range = f64("dof_range")
    act_dof = model.numpy("actuator_dof")
    act_qadr = model.numpy("actuator_qposadr")
    act_kp = f64("actuator_kp")
    act_kv = f64("actuator_kv")
    act_fr = f64("actuator_forcerange")
    geom_body = np.asarray(model.geom_body_static)
    geom_pos = f64("geom_pos")
    geom_radius = f64("geom_radius")
    geom_mu = f64("geom_friction")[:, 0]
    geom_k = f64("geom_stiffness")
    geom_d = f64("geom_damping")
    gz = float(f64("gravity")[2])
    fric_eps = float(f64("friction_smoothing"))
    lim_k = float(f64("limit_stiffness"))
    lim_d = float(f64("limit_damping"))

    anc_mask = model.numpy("ancestor_mask")  # (nb, nv)
    dof_body = list(model.dof_body)
    # per-body dof list (ancestors incl. self), static
    body_dofs = [
        [j for j in range(nv) if anc_mask[b, j] > 0] for b in range(nb)
    ]
    # hinge dof -> (body, qpos addr)
    hinge_of_dof = {}
    for b in range(nb):
        if model.jnt_type[b] == JNT_HINGE:
            hinge_of_dof[model.body_dof_adr[b]] = (b, model.body_qpos_adr[b])

    pairs = arrow_pairs(model)

    def substep(qpos: Sequence, qvel: Sequence, ctrl: Sequence):
        zero = qpos[0] * 0.0
        one = zero + 1.0

        # ---------------- FK ----------------
        xpos: List = [None] * nb
        xquat: List = [None] * nb
        Rb: List = [None] * nb
        # base (free joint)
        q0 = (qpos[3], qpos[4], qpos[5], qpos[6])
        n = _sqrt(q0[0] * q0[0] + q0[1] * q0[1] + q0[2] * q0[2]
                  + q0[3] * q0[3])
        inv_n = 1.0 / _max(n, 1e-12)
        q0 = tuple(c * inv_n for c in q0)
        xpos[0] = (qpos[0], qpos[1], qpos[2])
        xquat[0] = q0
        Rb[0] = m3_from_quat(q0)
        for b in range(1, nb):
            p = model.body_parent[b]
            # fixed transform (constants)
            off = tuple(float(v) for v in body_pos[b])
            pp = v_add(xpos[p], m3_apply(Rb[p], off))
            q = (
                quat_mul_const(xquat[p], body_quat[b])
                if not np.allclose(body_quat[b], [1, 0, 0, 0])
                else xquat[p]
            )
            if model.jnt_type[b] == JNT_HINGE:
                # hinge rotation about static local axis
                theta = qpos[model.body_qpos_adr[b]]
                half = theta * 0.5
                ax = jnt_axis[b]
                qj = (torch.cos(half), torch.sin(half) * float(ax[0]),
                      torch.sin(half) * float(ax[1]),
                      torch.sin(half) * float(ax[2]))
                Rpre = m3_from_quat(q)
                anchor_l = tuple(float(v) for v in jnt_pos[b])
                anchor = v_add(pp, m3_apply(Rpre, anchor_l))
                q = quat_mul(q, qj)
                Rb[b] = m3_from_quat(q)
                xpos[b] = v_sub(anchor, m3_apply(Rb[b], anchor_l))
                xquat[b] = q
            else:  # welded body (e.g. paw plates): fixed transform only
                Rb[b] = m3_from_quat(q)
                xpos[b] = pp
                xquat[b] = q

        origin = xpos[0]

        # ---------------- motion subspace S ----------------
        S: List = [None] * nv
        for k in range(3):
            e = [0.0, 0.0, 0.0]
            e[k] = 1.0
            S[k] = ((zero, zero, zero),
                    tuple(zero + e[i] for i in range(3)))
        for k in range(3):
            col = (Rb[0][0][k], Rb[0][1][k], Rb[0][2][k])
            S[3 + k] = (col, (zero, zero, zero))
        for j, (b, qadr) in hinge_of_dof.items():
            ax = jnt_axis[b]
            a = m3_apply(Rb[b], tuple(float(v) for v in ax))
            anchor = v_add(
                xpos[b], m3_apply(Rb[b], tuple(float(v) for v in jnt_pos[b]))
            )
            r = v_sub(anchor, origin)
            S[j] = (a, v_cross(r, a))

        # ---------------- body spatial inertias at origin ----------------
        I_O: List = [None] * nb
        for b in range(nb):
            R = Rb[b]
            com = v_sub(
                v_add(xpos[b], m3_apply(R, tuple(float(v) for v in body_com[b]))),
                origin,
            )
            # I_w = R I_l R^T (I_l static)
            RI = m3_mul_const_right(R, body_inertia[b])
            I_w = tuple(
                tuple(v_dot(RI[i], (R[j][0], R[j][1], R[j][2]))
                      for j in range(3))
                for i in range(3)
            )
            m = float(body_mass[b])
            cx, cy, cz = com
            # A = I_w - m cx cx (sym6)
            A6 = (
                I_w[0][0] + m * (cy * cy + cz * cz),
                I_w[0][1] - m * cx * cy,
                I_w[0][2] - m * cx * cz,
                I_w[1][1] + m * (cx * cx + cz * cz),
                I_w[1][2] - m * cy * cz,
                I_w[2][2] + m * (cx * cx + cy * cy),
            )
            I_O[b] = (A6, com, m)

        # ---------------- velocities ----------------
        V: List = [None] * nb
        for b in range(nb):
            acc = ((zero, zero, zero), (zero, zero, zero))
            for j in body_dofs[b]:
                acc = sv_add(acc, sv_scale(S[j], qvel[j]))
            V[b] = acc

        # ---------------- bias forces (RNEA, qdd=0) ----------------
        g_sv = ((zero, zero, zero), (zero, zero, zero - gz))
        a_b: List = [None] * nb
        for b in range(nb):
            p = model.body_parent[b]
            a_p = g_sv if p < 0 else a_b[p]
            vJ = ((zero, zero, zero), (zero, zero, zero))
            own = [j for j in body_dofs[b] if dof_body[j] == b]
            for j in own:
                vJ = sv_add(vJ, sv_scale(S[j], qvel[j]))
            a_b[b] = sv_add(a_p, motion_cross(V[b], vJ))
        f_b: List = [None] * nb
        for b in range(nb):
            Ia = inertia_apply(I_O[b], a_b[b])
            Iv = inertia_apply(I_O[b], V[b])
            f_b[b] = sv_add(Ia, force_cross(V[b], Iv))
        # subtree sums (static topology)
        f_sub = [f_b[b] for b in range(nb)]
        for b in reversed(range(1, nb)):
            p = model.body_parent[b]
            f_sub[p] = sv_add(f_sub[p], f_sub[b])
        C = [sv_dot(S[j], f_sub[dof_body[j]]) for j in range(nv)]

        # ---------------- mass matrix (arrow entries only) -------------
        # composite inertia as (A6, B 3x3 rows, m); init from I_O
        comp = []
        for b in range(nb):
            A6, c, m = I_O[b]
            cx, cy, cz = c
            Bm = (
                (zero, (zero - cz) * m, cy * m),
                (cz * m, zero, (zero - cx) * m),
                ((zero - cy) * m, cx * m, zero),
            )
            comp.append([list(A6), [list(r) for r in Bm], zero + m])
        for b in reversed(range(1, nb)):
            p = model.body_parent[b]
            for i in range(6):
                comp[p][0][i] = comp[p][0][i] + comp[b][0][i]
            for i in range(3):
                for j in range(3):
                    comp[p][1][i][j] = comp[p][1][i][j] + comp[b][1][i][j]
            comp[p][2] = comp[p][2] + comp[b][2]

        def comp_apply(cb, svec):
            A6, Bm, m = cb
            w, v = svec
            top = v_add(
                sym3_apply(tuple(A6), w),
                m3_apply(tuple(tuple(r) for r in Bm), v),
            )
            bot = v_add(
                m3_apply_T(tuple(tuple(r) for r in Bm), w),
                v_scale(v, m),
            )
            return (top, bot)

        # F_j = IC[body(j)] S_j ; M[i,j] = S_i . F_j
        F = [comp_apply(comp[dof_body[j]], S[j]) for j in range(nv)]
        Mential = {}
        for (i, j) in pairs:
            Mential[(i, j)] = sv_dot(S[i], F[j])
        for j in range(nv):
            Mential[(j, j)] = Mential[(j, j)] + float(dof_armature[j])

        # ---------------- actuators + passive ----------------
        qfrc = [C[j] * (-1.0) for j in range(nv)]  # start from -C
        for a in range(nu):
            j = int(act_dof[a])
            qa = qpos[int(act_qadr[a])]
            tau = float(act_kp[a]) * (ctrl[a] - qa) - float(act_kv[a]) * qvel[j]
            tau = _min(_max(tau, float(act_fr[a][0])), float(act_fr[a][1]))
            qfrc[j] = qfrc[j] + tau
        d_diag = [None] * nv
        for j in range(nv):
            dd = float(dof_damping[j]) + float(dof_frictionloss[j]) / _max(
                torch.abs(qvel[j]), 0.05
            )
            if dof_limited[j] > 0:
                qj = qpos[hinge_of_dof[j][1]]
                lo, hi = float(dof_range[j][0]), float(dof_range[j][1])
                below = _max(lo - qj, 0.0)
                above = _max(qj - hi, 0.0)
                qfrc[j] = qfrc[j] + lim_k * (below - above)
                dd = dd + lim_d * _where((below > 0) | (above > 0), one, zero)
            d_diag[j] = dd

        # ---------------- contact (plane z=0) ----------------
        Dent = {}

        def dent_add(i, j, val):
            key = (i, j) if i <= j else (j, i)
            Dent[key] = Dent.get(key, zero) + val

        png, pdg = (0.0, 0.0, 1.0), 0.0  # python floats: terms fold

        def pdot(v, n):
            """v . n with n's zero terms skipped and unit terms unscaled
            when the function is built."""
            acc = None
            for vi, ni in zip(v, n):
                if ni == 0.0:
                    continue
                term = vi if ni == 1.0 else vi * ni
                acc = term if acc is None else acc + term
            return zero if acc is None else acc

        def pscale_sub(v, s, n):
            """v - s*n with the same constant folding."""
            out = []
            for vi, ni in zip(v, n):
                if ni == 0.0:
                    out.append(vi)
                    continue
                out.append(vi - s if ni == 1.0 else vi - s * ni)
            return tuple(out)

        for g in range(model.ngeom):
            b = int(geom_body[g])
            center = v_add(
                xpos[b], m3_apply(Rb[b], tuple(float(v) for v in geom_pos[g]))
            )
            phi = pdot(center, png) - pdg - float(geom_radius[g])
            pen = _min(_max(zero - phi, 0.0), 0.05)
            active = _where(phi < 0.0, one, zero)
            fn = _min(float(geom_k[g]) * pen, 1e4)
            # contact point: sphere surface point along -n
            pt = pscale_sub(center, float(geom_radius[g]), png)
            r = v_sub(pt, origin)
            w, vo = V[b]
            vpt = v_add(vo, v_cross(w, r))
            # flat ground: the tangential speed is the xy speed
            vt_norm = _sqrt(vpt[0] * vpt[0] + vpt[1] * vpt[1] + 1e-12)
            kappa = float(geom_mu[g]) * fn / _max(vt_norm, fric_eps)
            dn = float(geom_d[g]) * active
            kap = kappa * active
            # J rows for the ancestor dofs: Jj = S_lin + S_ang x r
            dofs = body_dofs[b]
            Jr = {}
            Jn = {}
            for j in dofs:
                sa, sl = S[j]
                Jr[j] = v_add(sl, v_cross(sa, r))
                Jn[j] = pdot(Jr[j], png)
            # qfrc += J^T (fn * n)
            for j in dofs:
                qfrc[j] = qfrc[j] + Jn[j] * (fn * active)
            # D += dn Jz Jz^T + kap (Jx Jx^T + Jy Jy^T): normal damping plus
            # tangential friction damping on the ground plane
            for ii, j1 in enumerate(dofs):
                for j2 in dofs[ii:]:
                    val = (dn * Jr[j1][2] * Jr[j2][2]
                           + kap * (Jr[j1][0] * Jr[j2][0]
                                    + Jr[j1][1] * Jr[j2][1]))
                    dent_add(j1, j2, val)

        # ---------------- assemble A = M + dt (D + diag) and solve -------
        Aent = {}
        for (i, j) in pairs:
            a_ij = Mential[(i, j)] + dt * Dent.get((i, j), zero)
            if i == j:
                a_ij = a_ij + dt * d_diag[i]
            Aent[(i, j)] = a_ij

        # rhs = M qvel + dt * qfrc
        rhs = [None] * nv
        for i in range(nv):
            acc = zero
            for j in range(nv):
                key = (i, j) if i <= j else (j, i)
                if key in Mential:
                    acc = acc + Mential[key] * qvel[j]
            rhs[i] = acc + dt * qfrc[i]

        x = _arrow_solve_scalar(Aent, rhs, base, chains, zero)
        # NaN firewall: a non-finite solve (degenerate contact state) falls
        # back to the clipped previous velocity instead of poisoning the lane
        qvel_new = [
            torch.where(torch.isfinite(xi),
                        _min(_max(xi, -1e3), 1e3),
                        _min(_max(qvel[i], -1e3), 1e3))
            for i, xi in enumerate(x)
        ]

        # ---------------- integrate ----------------
        qpos_new = list(qpos)
        for k in range(3):
            qpos_new[k] = qpos[k] + dt * qvel_new[k]
        wx, wy, wz = qvel_new[3] * dt, qvel_new[4] * dt, qvel_new[5] * dt
        ang = _sqrt(wx * wx + wy * wy + wz * wz)
        half = ang * 0.5
        sc = _where(ang > 1e-9, torch.sin(half) / _max(ang, 1e-9), 0.5)
        dq = (torch.cos(half), wx * sc, wy * sc, wz * sc)
        qn = quat_mul(q0, dq)
        nrm = _sqrt(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2]
                    + qn[3] * qn[3])
        inv = 1.0 / _max(nrm, 1e-12)
        for k in range(4):
            qpos_new[3 + k] = qn[k] * inv
        for j, (b, qadr) in hinge_of_dof.items():
            qpos_new[qadr] = qpos[qadr] + dt * qvel_new[j]
        return tuple(qpos_new), tuple(qvel_new)

    return substep


def arrow_pairs(model: Model) -> List[Tuple[int, int]]:
    """The (i, j), i <= j, entries of the mass matrix that the block-arrow
    structure leaves nonzero: dof pairs on one root path.  Every other
    entry of M, A and the ``M @ qvel`` sum is zero."""
    anc_mask = model.numpy("ancestor_mask")
    dof_body = model.dof_body
    pairs = []
    for j in range(model.nv):
        for i in range(j + 1):
            bi, bj = dof_body[i], dof_body[j]
            if anc_mask[bj, i] > 0 or anc_mask[bi, j] > 0 or i == j:
                pairs.append((i, j))
    return pairs


def _guard(x):
    """Keep |x| >= 1e-12 with its sign (zero counts as positive)."""
    return torch.where(torch.abs(x) < 1e-12,
                       torch.where(x < 0, -1e-12, 1e-12), x)


def _arrow_solve_scalar(Aent, b, base, chains, zero):
    """Block-arrow solve on scalar entry dicts: closed-form leg inverses,
    a 6x6 Schur complement and a guarded Cholesky, fully unrolled."""
    G, n = chains.shape

    def get(i, j):
        key = (i, j) if i <= j else (j, i)
        return Aent.get(key, zero)

    # leg block inverses (n <= 3 closed form)
    leg_inv = []
    for g in range(G):
        idx = [int(v) for v in chains[g]]
        if n == 1:
            inv = ((1.0 / _guard(get(idx[0], idx[0])),),)
        elif n == 2:
            a_, b_, d_ = get(idx[0], idx[0]), get(idx[0], idx[1]), get(idx[1], idx[1])
            det = _guard(a_ * d_ - b_ * b_)
            inv = ((d_ / det, -b_ / det), (-b_ / det, a_ / det))
        elif n == 3:
            m00, m01, m02 = get(idx[0], idx[0]), get(idx[0], idx[1]), get(idx[0], idx[2])
            m11, m12, m22 = get(idx[1], idx[1]), get(idx[1], idx[2]), get(idx[2], idx[2])
            c00 = m11 * m22 - m12 * m12
            c01 = m02 * m12 - m01 * m22
            c02 = m01 * m12 - m02 * m11
            c11 = m00 * m22 - m02 * m02
            c12 = m01 * m02 - m00 * m12
            c22 = m00 * m11 - m01 * m01
            det = _guard(m00 * c00 + m01 * c01 + m02 * c02)
            inv = (
                (c00 / det, c01 / det, c02 / det),
                (c01 / det, c11 / det, c12 / det),
                (c02 / det, c12 / det, c22 / det),
            )
        else:
            raise NotImplementedError(f"leg chains of {n} dofs")
        leg_inv.append(inv)

    nb_ = len(base)
    # Schur: S = Abb - sum_g Abl inv Alb ; yb = bb - sum Abl inv bl
    Ssch = [[get(int(base[i]), int(base[j])) for j in range(nb_)]
            for i in range(nb_)]
    yb = [b[int(base[i])] for i in range(nb_)]
    for g in range(G):
        idx = [int(v) for v in chains[g]]
        inv = leg_inv[g]
        Abl = [[get(int(base[i]), idx[m]) for m in range(n)]
               for i in range(nb_)]
        invb = [sum(inv[m][k] * b[idx[k]] for k in range(n)) for m in range(n)]
        invA = [
            [sum(inv[m][k] * Abl[j][k] for k in range(n)) for m in range(n)]
            for j in range(nb_)
        ]  # (6, n): inv(All) Alb rows per base dof
        for i in range(nb_):
            yb[i] = yb[i] - sum(Abl[i][m] * invb[m] for m in range(n))
            for j in range(nb_):
                Ssch[i][j] = Ssch[i][j] - sum(
                    Abl[i][m] * invA[j][m] for m in range(n)
                )
    # 6x6 cholesky solve (unrolled, guarded)
    L = [[None] * nb_ for _ in range(nb_)]
    for j in range(nb_):
        s = Ssch[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-9))
        for i in range(j + 1, nb_):
            s = Ssch[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    z = [None] * nb_
    for i in range(nb_):
        s = yb[i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    xb = [None] * nb_
    for i in reversed(range(nb_)):
        s = z[i]
        for k in range(i + 1, nb_):
            s = s - L[k][i] * xb[k]
        xb[i] = s / L[i][i]

    x = [None] * len(b)
    for i in range(nb_):
        x[int(base[i])] = xb[i]
    for g in range(G):
        idx = [int(v) for v in chains[g]]
        inv = leg_inv[g]
        rhs = [
            b[idx[m]] - sum(get(idx[m], int(base[i])) * xb[i]
                            for i in range(nb_))
            for m in range(n)
        ]
        for m in range(n):
            x[idx[m]] = sum(inv[m][k] * rhs[k] for k in range(n))
    return x


# ---------------------------------------------------------------------------
# operation count (for the kernel's roofline bound)
# ---------------------------------------------------------------------------

# weights per output element: one for arithmetic, comparisons and selects,
# more for transcendental functions (the weights of the JAX package's
# ``utils/profiling.count_flops``)
_OP_WEIGHTS = {"sqrt": 4, "rsqrt": 4, "exp": 8, "log": 8, "sin": 8, "cos": 8}
_FREE_OPS = {"clone", "copy_", "detach", "alias", "view", "expand",
             "unsqueeze", "squeeze", "select", "slice", "t", "transpose",
             "empty", "empty_like", "zeros", "zeros_like", "full", "lift_fresh",
             "_to_copy", "scalar_tensor", "stack", "unbind", "as_strided"}


def count_substep_ops(model: Model, dt: float) -> int:
    """Arithmetic operations of one flat substep for one rollout: the plain
    version is run once on a single lane and every elementwise operation
    it dispatches is counted (transcendentals weighted as in
    ``opendog_tpu/utils/profiling.py``).  The count does not depend on the
    data: both sides of every ``where`` are evaluated."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name not in _FREE_OPS and isinstance(out, torch.Tensor):
                self.ops += _OP_WEIGHTS.get(name, 1) * out.numel()
            return out

    sub = build_substep(model.to("cpu"), dt)
    qpos = model.key_qpos[0].detach().cpu().reshape(-1, 1)
    rows = lambda n: tuple(torch.zeros(n, 1)[i] for i in range(n))
    with _Count() as counter:
        sub(tuple(qpos[i] for i in range(model.nq)), rows(model.nv),
            rows(model.nu))
    return counter.ops
