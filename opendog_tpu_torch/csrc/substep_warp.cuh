// One physics substep for one rollout, spread over the 32 lanes of a warp.
//
// The same function as sc_substep of substep_core.cuh (the substep of
// opendog_tpu/ops/pallas_step.py::build_pallas_substep), cut into phases.
// Within a phase a lane writes only its own outputs and reads only what
// earlier phases wrote; the CUDA kernel puts a __syncwarp() between two
// phases, and the g++ host build runs each phase as a loop over the 32
// lanes, in either order.  Every float is made by the same operations, in
// the same order, as in sc_substep (and the plain PyTorch version): only the
// lane that makes it differs, so the two designs agree bit for bit.  Sums
// that several lanes could share stay whole on one lane, in their plain
// order (no atomics, no tree reductions):
//   fk         lane 0 the base, then one lane per body chain, in order;
//   s_ia       S per dof, inertias at the origin, payload, CB / Cm per body;
//   vel        V per body; lane 0 also ab[0] and fsub[0];
//   rnea       per body chain: ab, fsub, then the chain's backward sums of
//              fsub, IA, CB, Cm from its tail;
//   trunk      one lane per component of (fsub, IA, CB, Cm) of the base:
//              the chain heads added in descending body order;
//   dof_geom   per dof: bias, actuator and limit terms of qfrc, ddiag, F;
//              per sphere: on the terrain ground its heightfield and box
//              lookup, its contact scalars and J rows (workspace) and, in
//              the plane modes, each row's J.n;
//   pair       per arrow pair: M, the contact sum of D over its spheres in
//              increasing order, A; per dof: the contact terms of qfrc over
//              its spheres in increasing order;
//   rhs_inv    per dof rhs; per leg chain the closed-form leg inverse;
//   schur_pre  per (chain, base dof) inv A_bl, per chain inv b;
//   schur      per lower entry of the 6x6 Schur complement and per base
//              rhs entry: the chains subtracted for g = 0..G-1 in order;
//   chol       lane 0: guarded 6x6 Cholesky and both triangular solves;
//   back       per leg chain: back-substitution;
//   integ      per dof: NaN firewall, velocity clip, position update;
//   quat       lane 0: the base quaternion.
// The longest serial stretch is a base pair's contact sum over all spheres
// (78 for Go1, 24 for OpenDOG), next to the 6x6 Cholesky on lane 0.
#pragma once

#include <type_traits>

#include "substep_core.cuh"

#define SC_LANES 32
// The small size class of the workspace: models with at most this many
// collision spheres (OpenDOG has 24, mini 7; Go1's 78 take SC_NG_MAX).
#define SC_NG_SMALL 32

// A rollout's working arrays (shared memory in the kernel).  The
// sphere-indexed arrays (plane, fa / dn / kap, J and, in the plane modes,
// Jn) are sized for NG spheres, the workspace's size class: SC_NG_MAX, or
// fewer where a kernel is built for models with at most NG spheres (a
// smaller workspace fits more rollouts on an SM).
template <int NG>
struct SubstepWorkNG {
  float qpos[SC_NQ_MAX], qvel[SC_NV_MAX], ctrl[SC_NU_MAX];
  float plane[4 * NG];  // lane plane (4), per-geom planes or terrain normals
  float payload, m0;    // payload [kg]; the base's mass with it
  float q0[4];
  float xpos[SC_NB_MAX][3], xquat[SC_NB_MAX][4], R[SC_NB_MAX][9];
  float S[SC_NV_MAX][6];
  float IA[SC_NB_MAX][6], Ic[SC_NB_MAX][3], CB[SC_NB_MAX][9], Cm[SC_NB_MAX];
  float V[SC_NB_MAX][6], ab[SC_NB_MAX][6], fsub[SC_NB_MAX][6];
  float F[SC_NV_MAX][6];
  float qfrc[SC_NV_MAX], ddiag[SC_NV_MAX], rhs[SC_NV_MAX], x[SC_NV_MAX];
  float M[SC_NPAIR_MAX], A[SC_NPAIR_MAX];
  float fa[NG], dn[NG], kap[NG];  // fn active, dn, kap
  float J[NG][SC_ANC_MAX][3];     // J rows of each sphere's dofs
  float inv[SC_G_MAX][SC_NCH_MAX][SC_NCH_MAX];
  float invA[SC_G_MAX][6][SC_NCH_MAX], invb[SC_G_MAX][SC_NCH_MAX];
  float Ss[6][6], yb[6], xb[6];
};

// The plane modes' working arrays: J.n of each sphere's J rows besides
// (3,456 B at SC_NG_MAX spheres, which the flat modes do without).
template <int NG>
struct SubstepWorkPlaneNG : SubstepWorkNG<NG> {
  float Jn[NG][SC_ANC_MAX];
};

// the working arrays of a ground mode, in size class NG
template <int PLANE, int NG = SC_NG_MAX>
using SubstepWorkOf =
    typename std::conditional<PLANE == SC_PLANE_FLAT, SubstepWorkNG<NG>,
                              SubstepWorkPlaneNG<NG>>::type;

// Runs the statement for every lane: on the card each thread is its own lane and
// the warp synchronises after it; on the host a loop over the lanes, in
// reverse when `rev` is set.
#ifdef __CUDA_ARCH__
#define SC_PHASE(...) \
  {                   \
    __VA_ARGS__;      \
    __syncwarp();     \
  }
#else
#define SC_PHASE(...)                              \
  for (int l_ = 0; l_ < SC_LANES; ++l_) {          \
    const int lane = rev ? SC_LANES - 1 - l_ : l_; \
    __VA_ARGS__;                                   \
  }
#endif

template <bool PAYLOAD, class Work>
SC_HD float scw_mass(const SubstepModel& m, const Work& w, int b) {
  return (PAYLOAD && b == 0) ? w.m0 : m.body_mass[b];
}

// ---------------------------------------------------------------------------
// state in and out
// ---------------------------------------------------------------------------

template <int PLANE, bool PAYLOAD, class Work>
SC_HD void scw_load(const SubstepModel& m, Work& w, int lane,
                    const float* qpos, const float* qvel, const float* ctrl,
                    const float* plane, const float* payload, int K, int k) {
  for (int r = lane; r < m.nq; r += SC_LANES) w.qpos[r] = qpos[(size_t)r * K + k];
  for (int r = lane; r < m.nv; r += SC_LANES) w.qvel[r] = qvel[(size_t)r * K + k];
  for (int r = lane; r < m.nu; r += SC_LANES) w.ctrl[r] = ctrl[(size_t)r * K + k];
  const int nplane = PLANE == SC_PLANE_GEOM ? 4 * m.ng : PLANE == SC_PLANE_LANE ? 4 : 0;
  for (int r = lane; r < nplane; r += SC_LANES) w.plane[r] = plane[(size_t)r * K + k];
  if (lane == 0) w.payload = PAYLOAD ? payload[k] : 0.0f;
}

template <class Work>
SC_HD void scw_store(const SubstepModel& m, const Work& w, int lane,
                     float* qpos_out, float* qvel_out, int K, int k) {
  for (int r = lane; r < m.nq; r += SC_LANES) qpos_out[(size_t)r * K + k] = w.qpos[r];
  for (int r = lane; r < m.nv; r += SC_LANES) qvel_out[(size_t)r * K + k] = w.qvel[r];
}

// ---------------------------------------------------------------------------
// phases (sc_substep's line comments name the block each one follows)
// ---------------------------------------------------------------------------

// FK of the base: lane 0
template <class Work>
SC_HD void scw_fk_base(Work& w, int lane) {
  if (lane != 0) return;
  const float* qpos = w.qpos;
  const float n = sqrtf(qpos[3] * qpos[3] + qpos[4] * qpos[4] +
                        qpos[5] * qpos[5] + qpos[6] * qpos[6]);
  const float inv_n = 1.0f / sc_max(n, 1e-12f);
  for (int k = 0; k < 4; ++k) w.q0[k] = qpos[3 + k] * inv_n;
  for (int k = 0; k < 3; ++k) w.xpos[0][k] = qpos[k];
  for (int k = 0; k < 4; ++k) w.xquat[0][k] = w.q0[k];
  sc_quat_to_mat(w.q0, w.R[0]);
}

// FK of the bodies of body chain `lane`, root to tail
template <class Work>
SC_HD void scw_fk_chain(const SubstepModel& m, Work& w, int lane) {
  if (lane >= m.n_bchains) return;
  for (int i = 0; i < m.bchain_len[lane]; ++i) {
    const int b = m.bchain_body[lane * SC_BCHLEN_MAX + i];
    const int p = m.body_parent[b];
    float t[3], pp[3], q[4];
    sc_apply(w.R[p], m.body_pos + 3 * b, t);
    for (int k = 0; k < 3; ++k) pp[k] = w.xpos[p][k] + t[k];
    if (m.body_quat_ident[b]) {
      for (int k = 0; k < 4; ++k) q[k] = w.xquat[p][k];
    } else {
      sc_quat_mul(w.xquat[p], m.body_quat + 4 * b, q);
    }
    if (m.body_hinge[b]) {
      const float half = w.qpos[m.body_qadr[b]] * 0.5f;
      const float s = sinf(half), c = cosf(half);
      const float* ax = m.jnt_axis + 3 * b;
      const float qj[4] = {c, s * ax[0], s * ax[1], s * ax[2]};
      const float* anchor_l = m.jnt_pos + 3 * b;
      float Rpre[9], anchor[3];
      sc_quat_to_mat(q, Rpre);
      sc_apply(Rpre, anchor_l, t);
      for (int k = 0; k < 3; ++k) anchor[k] = pp[k] + t[k];
      sc_quat_mul(q, qj, w.xquat[b]);
      sc_quat_to_mat(w.xquat[b], w.R[b]);
      sc_apply(w.R[b], anchor_l, t);
      for (int k = 0; k < 3; ++k) w.xpos[b][k] = anchor[k] - t[k];
    } else {  // welded body: fixed transform only
      for (int k = 0; k < 4; ++k) w.xquat[b][k] = q[k];
      sc_quat_to_mat(q, w.R[b]);
      for (int k = 0; k < 3; ++k) w.xpos[b][k] = pp[k];
    }
  }
}

// S of dof `lane`; inertias at the origin, payload, CB and Cm of body `lane`
template <bool PAYLOAD, class Work>
SC_HD void scw_s_ia(const SubstepModel& m, Work& w, int lane) {
  const float* origin = w.xpos[0];
  const int j = lane;
  if (j < 3) {
    for (int i = 0; i < 6; ++i) w.S[j][i] = 0.0f;
    w.S[j][3 + j] = 1.0f;
  } else if (j < 6) {
    for (int i = 0; i < 3; ++i) w.S[j][i] = w.R[0][3 * i + (j - 3)];
    for (int i = 3; i < 6; ++i) w.S[j][i] = 0.0f;
  } else if (j < m.nv) {
    const int b = m.dof_hinge_body[j];
    float t[3], r[3];
    sc_apply(w.R[b], m.jnt_axis + 3 * b, w.S[j]);
    sc_apply(w.R[b], m.jnt_pos + 3 * b, t);
    for (int k = 0; k < 3; ++k) r[k] = (w.xpos[b][k] + t[k]) - origin[k];
    sc_cross(r, w.S[j], w.S[j] + 3);
  }
  const int b = lane;
  if (b >= m.nb) return;
  const float* Rb = w.R[b];
  const float* Il = m.body_inertia + 9 * b;
  float t[3];
  sc_apply(Rb, m.body_com + 3 * b, t);
  for (int k = 0; k < 3; ++k) w.Ic[b][k] = (w.xpos[b][k] + t[k]) - origin[k];
  float RI[9];  // R @ I_l, zero entries of I_l folded
  for (int i = 0; i < 3; ++i) {
    for (int jj = 0; jj < 3; ++jj) {
      float acc = 0.0f;
      bool any = false;
      for (int k = 0; k < 3; ++k) {
        const float c = Il[3 * k + jj];
        if (c != 0.0f) {
          acc = any ? acc + Rb[3 * i + k] * c : Rb[3 * i + k] * c;
          any = true;
        }
      }
      RI[3 * i + jj] = any ? acc : Rb[3 * i] * 0.0f;
    }
  }
  float Iw[9];  // R I_l R^T
  for (int i = 0; i < 3; ++i)
    for (int jj = 0; jj < 3; ++jj) Iw[3 * i + jj] = sc_dot(RI + 3 * i, Rb + 3 * jj);
  {
    const float mb = m.body_mass[b];
    const float cx = w.Ic[b][0], cy = w.Ic[b][1], cz = w.Ic[b][2];
    w.IA[b][0] = Iw[0] + mb * (cy * cy + cz * cz);
    w.IA[b][1] = Iw[1] - mb * cx * cy;
    w.IA[b][2] = Iw[2] - mb * cx * cz;
    w.IA[b][3] = Iw[4] + mb * (cx * cx + cz * cz);
    w.IA[b][4] = Iw[5] - mb * cy * cz;
    w.IA[b][5] = Iw[8] + mb * (cx * cx + cy * cy);
  }
  if (PAYLOAD && b == 0) {  // the point mass at the trunk origin
    const float m0 = m.body_mass[0];
    const float m_tot = w.payload + m0;
    const float scale = m0 / m_tot;
    for (int k = 0; k < 3; ++k) w.Ic[0][k] = w.Ic[0][k] * scale;
    w.m0 = m_tot;
  }
  const float mb = scw_mass<PAYLOAD>(m, w, b);
  const float cx = w.Ic[b][0], cy = w.Ic[b][1], cz = w.Ic[b][2];
  float* CB = w.CB[b];
  CB[0] = 0.0f;            CB[1] = (0.0f - cz) * mb; CB[2] = cy * mb;
  CB[3] = cz * mb;         CB[4] = 0.0f;             CB[5] = (0.0f - cx) * mb;
  CB[6] = (0.0f - cy) * mb; CB[7] = cx * mb;         CB[8] = 0.0f;
  w.Cm[b] = mb;
}

// RNEA forward step of body b (its parent's ab is final)
template <class Work>
SC_HD void scw_ab(const SubstepModel& m, Work& w, int b) {
  const int p = m.body_parent[b];
  float vJ[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int d = 0; d < m.body_ndof[b]; ++d) {
    const int j = m.body_dofs[b * SC_NV_MAX + d];
    if (m.dof_body[j] != b) continue;
    for (int i = 0; i < 6; ++i) vJ[i] = vJ[i] + w.S[j][i] * w.qvel[j];
  }
  float c1[3], c2[3], c3[3];
  sc_cross(w.V[b], vJ, c1);
  sc_cross(w.V[b], vJ + 3, c2);
  sc_cross(w.V[b] + 3, vJ, c3);
  for (int k = 0; k < 3; ++k) {
    const float pa = (p < 0) ? 0.0f : w.ab[p][k];
    const float pl = (p < 0) ? (k == 2 ? 0.0f - m.gz : 0.0f) : w.ab[p][3 + k];
    w.ab[b][k] = pa + c1[k];
    w.ab[b][3 + k] = pl + (c2[k] + c3[k]);
  }
}

// body force of body b before the backward pass (its own IA)
template <bool PAYLOAD, class Work>
SC_HD void scw_fsub(const SubstepModel& m, Work& w, int b) {
  float Ia[6], Iv[6], t1[3], t2[3];
  const float mb = scw_mass<PAYLOAD>(m, w, b);
  sc_inertia_apply(w.IA[b], w.Ic[b], mb, w.ab[b], Ia);
  sc_inertia_apply(w.IA[b], w.Ic[b], mb, w.V[b], Iv);
  sc_cross(w.V[b], Iv, t1);
  sc_cross(w.V[b] + 3, Iv + 3, t2);
  for (int k = 0; k < 3; ++k) w.fsub[b][k] = Ia[k] + (t1[k] + t2[k]);
  sc_cross(w.V[b], Iv + 3, t1);
  for (int k = 0; k < 3; ++k) w.fsub[b][3 + k] = Ia[3 + k] + t1[k];
}

// V of body `lane`; lane 0 then the base's ab and fsub
template <bool PAYLOAD, class Work>
SC_HD void scw_vel(const SubstepModel& m, Work& w, int lane) {
  const int b = lane;
  if (b >= m.nb) return;
  for (int i = 0; i < 6; ++i) w.V[b][i] = 0.0f;
  for (int d = 0; d < m.body_ndof[b]; ++d) {
    const int j = m.body_dofs[b * SC_NV_MAX + d];
    for (int i = 0; i < 6; ++i) w.V[b][i] = w.V[b][i] + w.S[j][i] * w.qvel[j];
  }
  if (b == 0) {
    scw_ab(m, w, 0);
    scw_fsub<PAYLOAD>(m, w, 0);
  }
}

// RNEA of body chain `lane`: forward, then the chain's own backward sums
template <bool PAYLOAD, class Work>
SC_HD void scw_rnea(const SubstepModel& m, Work& w, int lane) {
  if (lane >= m.n_bchains) return;
  const int* chain = m.bchain_body + lane * SC_BCHLEN_MAX;
  const int len = m.bchain_len[lane];
  for (int i = 0; i < len; ++i) {
    scw_ab(m, w, chain[i]);
    scw_fsub<PAYLOAD>(m, w, chain[i]);
  }
  for (int i = len - 1; i >= 1; --i) {
    const int b = chain[i], p = chain[i - 1];
    for (int c = 0; c < 6; ++c) w.fsub[p][c] = w.fsub[p][c] + w.fsub[b][c];
    for (int c = 0; c < 6; ++c) w.IA[p][c] = w.IA[p][c] + w.IA[b][c];
    for (int c = 0; c < 9; ++c) w.CB[p][c] = w.CB[p][c] + w.CB[b][c];
    w.Cm[p] = w.Cm[p] + w.Cm[b];
  }
}

// component `lane` of the base's (fsub 6, IA 6, CB 9, Cm 1): the chain
// heads added in descending body order
template <class Work>
SC_HD void scw_trunk(const SubstepModel& m, Work& w, int lane) {
  float* base;
  int stride;
  if (lane < 6) {
    base = &w.fsub[0][lane], stride = 6;
  } else if (lane < 12) {
    base = &w.IA[0][lane - 6], stride = 6;
  } else if (lane < 21) {
    base = &w.CB[0][lane - 12], stride = 9;
  } else if (lane == 21) {
    base = &w.Cm[0], stride = 1;
  } else {
    return;
  }
  for (int b = m.nb - 1; b >= 1; --b)
    if (m.body_parent[b] == 0) base[0] = base[0] + base[b * stride];
}

// dof `lane`: qfrc's bias, actuator and limit terms, ddiag, F; then the
// contact scalars and J rows of spheres lane, lane + 32, ... (and, in the
// plane modes, each row's J.n, which the pair phase reads).  On the terrain
// ground the lane looks up each of its spheres' normal and keeps it in the
// sphere's plane row (the row's d unused), where it reads it back.
template <int PLANE, class Work>
SC_HD void scw_dof_geom(const SubstepModel& m, Work& w, int lane,
                        const SubstepGround* ground = nullptr,
                        const float* heights = nullptr) {
  const int j = lane;
  if (j < m.nv) {
    const int b = m.dof_body[j];
    const float* f = w.fsub[b];
    const float* Sj = w.S[j];
    const float Cj = sc_dot(Sj, f) + sc_dot(Sj + 3, f + 3);
    float qf = Cj * -1.0f;
    for (int a = 0; a < m.nu; ++a) {
      if (m.act_dof[a] != j) continue;
      float tau = m.act_kp[a] * (w.ctrl[a] - w.qpos[m.act_qadr[a]]) - m.act_kv[a] * w.qvel[j];
      tau = sc_min(sc_max(tau, m.act_lo[a]), m.act_hi[a]);
      qf = qf + tau;
    }
    float dd = m.dof_damping[j] + m.dof_frictionloss[j] / sc_max(fabsf(w.qvel[j]), 0.05f);
    if (m.dof_limited[j]) {
      const float qj = w.qpos[m.body_qadr[m.dof_hinge_body[j]]];
      const float below = sc_max(m.dof_range[2 * j] - qj, 0.0f);
      const float above = sc_max(qj - m.dof_range[2 * j + 1], 0.0f);
      qf = qf + m.lim_k * (below - above);
      dd = dd + m.lim_d * ((below > 0.0f || above > 0.0f) ? 1.0f : 0.0f);
    }
    w.qfrc[j] = qf;
    w.ddiag[j] = dd;
    float t1[3], t2[3];
    sc_sym_apply(w.IA[b], Sj, t1);
    sc_apply(w.CB[b], Sj + 3, t2);
    for (int k = 0; k < 3; ++k) w.F[j][k] = t1[k] + t2[k];
    sc_apply_t(w.CB[b], Sj, t1);
    for (int k = 0; k < 3; ++k) w.F[j][3 + k] = t1[k] + Sj[3 + k] * w.Cm[b];
  }
  const float* origin = w.xpos[0];
  for (int g = lane; g < m.ng; g += SC_LANES) {
    const int b = m.geom_body[g];
    const float rad = m.geom_radius[g];
    const float* Vb = w.V[b];
    float center[3], t[3], r[3], fn, active, kappa;
    sc_apply(w.R[b], m.geom_pos + 3 * g, t);
    for (int k = 0; k < 3; ++k) center[k] = w.xpos[b][k] + t[k];
    if (PLANE != SC_PLANE_FLAT) {
      float phi_t = 0.0f;
      if constexpr (PLANE == SC_PLANE_TERRAIN)
        sc_terrain_ground(*ground, heights, center, rad, w.plane + 4 * g, &phi_t);
      const float* pl = w.plane + (PLANE == SC_PLANE_LANE ? 0 : 4 * g);
      const float n[3] = {pl[0], pl[1], pl[2]};
      const float phi = PLANE == SC_PLANE_TERRAIN
                            ? phi_t
                            : (center[0] * n[0] + center[1] * n[1] + center[2] * n[2]) - pl[3] - rad;
      const float pen = sc_min(sc_max(0.0f - phi, 0.0f), 0.05f);
      active = phi < 0.0f ? 1.0f : 0.0f;
      fn = sc_min(m.geom_k[g] * pen, 1e4f);
      for (int k = 0; k < 3; ++k) r[k] = (center[k] - rad * n[k]) - origin[k];
      float vpt[3];
      sc_cross(Vb, r, t);
      for (int k = 0; k < 3; ++k) vpt[k] = Vb[3 + k] + t[k];
      const float vn = vpt[0] * n[0] + vpt[1] * n[1] + vpt[2] * n[2];
      const float vsq = vpt[0] * vpt[0] + vpt[1] * vpt[1] + vpt[2] * vpt[2];
      const float vt = sqrtf(sc_max(vsq - vn * vn, 0.0f) + 1e-12f);
      kappa = m.geom_mu[g] * fn / sc_max(vt, m.fric_eps);
    } else {
      const float phi = center[2] - 0.0f - rad;
      const float pen = sc_min(sc_max(0.0f - phi, 0.0f), 0.05f);
      active = phi < 0.0f ? 1.0f : 0.0f;
      fn = sc_min(m.geom_k[g] * pen, 1e4f);
      r[0] = center[0] - origin[0];
      r[1] = center[1] - origin[1];
      r[2] = (center[2] - rad) - origin[2];
      float vpt[3];
      sc_cross(Vb, r, t);
      for (int k = 0; k < 3; ++k) vpt[k] = Vb[3 + k] + t[k];
      const float vt = sqrtf(vpt[0] * vpt[0] + vpt[1] * vpt[1] + 1e-12f);
      kappa = m.geom_mu[g] * fn / sc_max(vt, m.fric_eps);
    }
    w.fa[g] = fn * active;
    w.dn[g] = m.geom_d[g] * active;
    w.kap[g] = kappa * active;
    const int* dofs = m.body_dofs + b * SC_NV_MAX;
    const float* n = w.plane + (PLANE == SC_PLANE_LANE ? 0 : 4 * g);
    for (int d = 0; d < m.body_ndof[b]; ++d) {
      const float* Sj = w.S[dofs[d]];
      float Jd[3];
      sc_cross(Sj, r, t);
      for (int k = 0; k < 3; ++k) Jd[k] = w.J[g][d][k] = Sj[3 + k] + t[k];
      if constexpr (PLANE != SC_PLANE_FLAT)
        w.Jn[g][d] = Jd[0] * n[0] + Jd[1] * n[1] + Jd[2] * n[2];
    }
  }
}

// arrow pairs lane, lane + 32, ...: M, D's contact sum, A; dof
// SC_LANES - 1 - lane (the heavy base dofs go to the lanes of light pairs):
// qfrc's contact terms.  A base pair's sum over every sphere is the
// longest serial stretch; in the plane modes its terms read J.n from the
// sphere phase instead of making it twice more each.
template <int PLANE, class Work>
SC_HD void scw_pair(const SubstepModel& m, Work& w, int lane) {
  const float dt = m.dt;
  for (int p = lane; p < m.npair; p += SC_LANES) {
    const int i = m.pair_i[p], j = m.pair_j[p];
    float Mp = sc_dot(w.S[i], w.F[j]) + sc_dot(w.S[i] + 3, w.F[j] + 3);
    if (i == j) Mp = Mp + m.dof_armature[j];
    w.M[p] = Mp;
    const int d1 = m.dof_pos[i], d2 = m.dof_pos[j];
    const int* sph = m.dof_sph + m.dof_sph_off[j];
    float D = 0.0f;
    for (int s = 0; s < m.dof_nsph[j]; ++s) {
      const int g = sph[s];
      const float* J1 = w.J[g][d1];
      const float* J2 = w.J[g][d2];
      float val;
      if constexpr (PLANE != SC_PLANE_FLAT) {
        const float jn1 = w.Jn[g][d1], jn2 = w.Jn[g][d2];
        const float jj = J1[0] * J2[0] + J1[1] * J2[1] + J1[2] * J2[2];
        val = w.dn[g] * jn1 * jn2 + w.kap[g] * (jj - jn1 * jn2);
      } else {
        val = w.dn[g] * J1[2] * J2[2] + w.kap[g] * (J1[0] * J2[0] + J1[1] * J2[1]);
      }
      D = D + val;
    }
    float Ap = Mp + dt * D;
    if (i == j) Ap = Ap + dt * w.ddiag[i];
    w.A[p] = Ap;
  }
  const int j = SC_LANES - 1 - lane;
  if (j >= m.nv) return;
  const int d = m.dof_pos[j];
  const int* sph = m.dof_sph + m.dof_sph_off[j];
  float qf = w.qfrc[j];
  for (int s = 0; s < m.dof_nsph[j]; ++s) {
    const int g = sph[s];
    float jz;
    if constexpr (PLANE != SC_PLANE_FLAT) {
      jz = w.Jn[g][d];
    } else {
      jz = w.J[g][d][2];
    }
    qf = qf + jz * w.fa[g];
  }
  w.qfrc[j] = qf;
}

// A(i, j) from the packed pairs; zero outside the arrow pattern
#define SCW_A(i, j) \
  (m.pair_index[(i) * SC_NV_MAX + (j)] >= 0 ? w.A[m.pair_index[(i) * SC_NV_MAX + (j)]] : 0.0f)

// rhs of dof `lane`; the inverse of leg chain `lane`'s block
template <class Work>
SC_HD void scw_rhs_inv(const SubstepModel& m, Work& w, int lane) {
  const int nv = m.nv;
  if (lane < nv) {
    const int i = lane;
    float acc = 0.0f;
    for (int j = 0; j < nv; ++j) {
      const int p = m.pair_index[i * SC_NV_MAX + j];
      if (p >= 0) acc = acc + w.M[p] * w.qvel[j];
    }
    w.rhs[i] = acc + m.dt * w.qfrc[i];
  }
  const int g = lane, n = m.chain_len;
  if (g >= m.n_chains) return;
  const int* idx = m.chains + g * SC_NCH_MAX;
  float (*inv)[SC_NCH_MAX] = w.inv[g];
  if (n == 1) {
    inv[0][0] = 1.0f / sc_guard(SCW_A(idx[0], idx[0]));
  } else if (n == 2) {
    const float a_ = SCW_A(idx[0], idx[0]), b_ = SCW_A(idx[0], idx[1]),
                d_ = SCW_A(idx[1], idx[1]);
    const float det = sc_guard(a_ * d_ - b_ * b_);
    inv[0][0] = d_ / det;
    inv[0][1] = -b_ / det;
    inv[1][0] = -b_ / det;
    inv[1][1] = a_ / det;
  } else {
    const float m00 = SCW_A(idx[0], idx[0]), m01 = SCW_A(idx[0], idx[1]),
                m02 = SCW_A(idx[0], idx[2]), m11 = SCW_A(idx[1], idx[1]),
                m12 = SCW_A(idx[1], idx[2]), m22 = SCW_A(idx[2], idx[2]);
    const float c00 = m11 * m22 - m12 * m12;
    const float c01 = m02 * m12 - m01 * m22;
    const float c02 = m01 * m12 - m02 * m11;
    const float c11 = m00 * m22 - m02 * m02;
    const float c12 = m01 * m02 - m00 * m12;
    const float c22 = m00 * m11 - m01 * m01;
    const float det = sc_guard(m00 * c00 + m01 * c01 + m02 * c02);
    inv[0][0] = c00 / det; inv[0][1] = c01 / det; inv[0][2] = c02 / det;
    inv[1][0] = c01 / det; inv[1][1] = c11 / det; inv[1][2] = c12 / det;
    inv[2][0] = c02 / det; inv[2][1] = c12 / det; inv[2][2] = c22 / det;
  }
}

// lane = 6 g + j < 6 G: inv_g A_bl(j, :) of chain g; lane = 6 G + g: inv_g b_g
template <class Work>
SC_HD void scw_schur_pre(const SubstepModel& m, Work& w, int lane) {
  const int G = m.n_chains, n = m.chain_len;
  if (lane >= 7 * G) return;
  const int g = lane < 6 * G ? lane / 6 : lane - 6 * G;
  const int* idx = m.chains + g * SC_NCH_MAX;
  float (*inv)[SC_NCH_MAX] = w.inv[g];
  if (lane < 6 * G) {
    const int j = lane % 6;
    float Abl[SC_NCH_MAX];
    for (int k = 0; k < n; ++k) Abl[k] = SCW_A(j, idx[k]);
    for (int c = 0; c < n; ++c) {
      float s = 0.0f;
      for (int k = 0; k < n; ++k) s = s + inv[c][k] * Abl[k];
      w.invA[g][j][c] = s;
    }
  } else {
    for (int c = 0; c < n; ++c) {
      float s = 0.0f;
      for (int k = 0; k < n; ++k) s = s + inv[c][k] * w.rhs[idx[k]];
      w.invb[g][c] = s;
    }
  }
}

// lane < 21: lower entry (i, j) of the Schur complement (the Cholesky reads
// no other); lane 21 + i: base rhs entry i
template <class Work>
SC_HD void scw_schur(const SubstepModel& m, Work& w, int lane) {
  const int G = m.n_chains, n = m.chain_len;
  if (lane >= 27) return;
  if (lane < 21) {
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= lane) ++i;
    const int j = lane - i * (i + 1) / 2;
    float v = SCW_A(i, j);
    for (int g = 0; g < G; ++g) {
      const int* idx = m.chains + g * SC_NCH_MAX;
      float t = 0.0f;
      for (int c = 0; c < n; ++c) t = t + SCW_A(i, idx[c]) * w.invA[g][j][c];
      v = v - t;
    }
    w.Ss[i][j] = v;
  } else {
    const int i = lane - 21;
    float v = w.rhs[i];
    for (int g = 0; g < G; ++g) {
      const int* idx = m.chains + g * SC_NCH_MAX;
      float s = 0.0f;
      for (int c = 0; c < n; ++c) s = s + SCW_A(i, idx[c]) * w.invb[g][c];
      v = v - s;
    }
    w.yb[i] = v;
  }
}

// lane 0: guarded 6x6 Cholesky solve of the base block
template <class Work>
SC_HD void scw_chol(Work& w, int lane) {
  if (lane != 0) return;
  float L[6][6], z[6];
  for (int j = 0; j < 6; ++j) {
    float s = w.Ss[j][j];
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(sc_max(s, 1e-9f));
    for (int i = j + 1; i < 6; ++i) {
      float t = w.Ss[i][j];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
  for (int i = 0; i < 6; ++i) {
    float s = w.yb[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * z[k];
    z[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = z[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * w.xb[k];
    w.xb[i] = s / L[i][i];
  }
  for (int i = 0; i < 6; ++i) w.x[i] = w.xb[i];
}

// leg chain `lane`: back-substitution
template <class Work>
SC_HD void scw_back(const SubstepModel& m, Work& w, int lane) {
  const int g = lane, n = m.chain_len;
  if (g >= m.n_chains) return;
  const int* idx = m.chains + g * SC_NCH_MAX;
  float r2[SC_NCH_MAX];
  for (int c = 0; c < n; ++c) {
    float s = 0.0f;
    for (int i = 0; i < 6; ++i) s = s + SCW_A(idx[c], i) * w.xb[i];
    r2[c] = w.rhs[idx[c]] - s;
  }
  for (int c = 0; c < n; ++c) {
    float s = 0.0f;
    for (int k = 0; k < n; ++k) s = s + w.inv[g][c][k] * r2[k];
    w.x[idx[c]] = s;
  }
}
#undef SCW_A

// dof `lane`: NaN firewall (a non-finite solve keeps the clipped previous
// velocity), then its position update (base translation, hinge angle)
template <class Work>
SC_HD void scw_integ(const SubstepModel& m, Work& w, int lane) {
  const int i = lane;
  if (i >= m.nv) return;
  const float src = sc_isfinite(w.x[i]) ? w.x[i] : w.qvel[i];
  const float v = sc_min(sc_max(src, -1e3f), 1e3f);
  w.qvel[i] = v;
  if (i < 3) {
    w.qpos[i] = w.qpos[i] + m.dt * v;
  } else if (i >= 6) {
    const int qa = m.body_qadr[m.dof_hinge_body[i]];
    w.qpos[qa] = w.qpos[qa] + m.dt * v;
  }
}

// lane 0: the normalised base quaternion integrated
template <class Work>
SC_HD void scw_quat(const SubstepModel& m, Work& w, int lane) {
  if (lane != 0) return;
  const float dt = m.dt;
  const float wx = w.qvel[3] * dt, wy = w.qvel[4] * dt, wz = w.qvel[5] * dt;
  const float ang = sqrtf(wx * wx + wy * wy + wz * wz);
  const float half = ang * 0.5f;
  const float sc = ang > 1e-9f ? sinf(half) / sc_max(ang, 1e-9f) : 0.5f;
  const float dq[4] = {cosf(half), wx * sc, wy * sc, wz * sc};
  float qn[4];
  sc_quat_mul(w.q0, dq, qn);
  const float nrm = sqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]);
  const float inv_nrm = 1.0f / sc_max(nrm, 1e-12f);
  for (int k = 0; k < 4; ++k) w.qpos[3 + k] = qn[k] * inv_nrm;
}

// ---------------------------------------------------------------------------
// the substep: advances w.qpos and w.qvel.  On the card `lane` is the
// calling thread's lane and `rev` is unused; on the host `lane` is unused and
// every phase loops over the lanes (in reverse with `rev`).  `ground` and
// `heights` are SC_PLANE_TERRAIN's (sc_substep's `ground` and `plane`).
// ---------------------------------------------------------------------------

template <int PLANE, bool PAYLOAD, class Work>
SC_HD void sc_warp_substep(const SubstepModel& m, Work& w, int lane,
                           bool rev, const SubstepGround* ground = nullptr,
                           const float* heights = nullptr) {
  (void)lane;
  (void)rev;
  SC_PHASE(scw_fk_base(w, lane));
  SC_PHASE(scw_fk_chain(m, w, lane));
  SC_PHASE(scw_s_ia<PAYLOAD>(m, w, lane));
  SC_PHASE(scw_vel<PAYLOAD>(m, w, lane));
  SC_PHASE(scw_rnea<PAYLOAD>(m, w, lane));
  SC_PHASE(scw_trunk(m, w, lane));
  SC_PHASE(scw_dof_geom<PLANE>(m, w, lane, ground, heights));
  SC_PHASE(scw_pair<PLANE>(m, w, lane));
  SC_PHASE(scw_rhs_inv(m, w, lane));
  SC_PHASE(scw_schur_pre(m, w, lane));
  SC_PHASE(scw_schur(m, w, lane));
  SC_PHASE(scw_chol(w, lane));
  SC_PHASE(scw_back(m, w, lane));
  SC_PHASE(scw_integ(m, w, lane));
  SC_PHASE(scw_quat(m, w, lane));
}
