// One flat-ground physics substep for one rollout, table-driven.
//
// Replaces the math of opendog_tpu/ops/pallas_step.py::build_pallas_substep
// in its flat mode (with_plane=False, with_payload=False), whose body is
// opendog_tpu/ops/scalar_core.py::build_substep plus _arrow_solve_scalar.
// The TPU kernel bakes every model constant into a straight-line graph of
// ~49k vector operations; here the loops over bodies, dofs, geoms and
// arrow pairs run at run time over the tables of a SubstepModel, built once
// in Python (opendog_tpu_torch/ops/cuda_step.py) from the Model.
//
// The arithmetic follows the plain PyTorch version
// (opendog_tpu_torch/ops/scalar_core.py) operation by operation, in the same
// order, so that the two agree to float32 rounding (and FMA contraction
// under nvcc).  Everything is float32; no fast-math intrinsics.
//
// This header is plain C++ with __host__ __device__ functions: nvcc builds it
// into the CUDA kernel (substep_kernel.cu) and g++ builds it into a
// host-only library (substep_host.cpp) that the CPU tests compare with the
// plain version.
#pragma once

#include <math.h>

#include <cmath>

#ifdef __CUDACC__
#define SC_HD __host__ __device__ __forceinline__
#else
#define SC_HD inline
#endif

// Compile-time maximums; the Python wrapper refuses a model that exceeds one.
#define SC_NB_MAX 16       // bodies
#define SC_NV_MAX 18       // dofs
#define SC_NQ_MAX 19       // qpos entries
#define SC_NU_MAX 12       // actuators
#define SC_NG_MAX 96       // collision spheres
#define SC_G_MAX 4         // leg chains
#define SC_NCH_MAX 3       // dofs per chain
#define SC_NPAIR_MAX 171   // SC_NV_MAX * (SC_NV_MAX + 1) / 2
#define SC_MAGIC 0x53425331

// The table layout, one entry per line: INT / FLT for a scalar, INTS / FLTS
// for a flat array and its length.  The Python wrapper reads this list to
// build the matching ctypes structure, so it is the only statement of the
// layout.  2-D tables are flattened row-major (e.g. body_pos[b * 3 + k]).
#define SUBSTEP_MODEL_FIELDS(INT, FLT, INTS, FLTS)            \
  INT(magic)                                                   \
  INT(nb)                                                      \
  INT(nv)                                                      \
  INT(nq)                                                      \
  INT(nu)                                                      \
  INT(ng)                                                      \
  INT(n_chains)                                                \
  INT(chain_len)                                               \
  FLT(dt)                                                      \
  FLT(gz)                                                      \
  FLT(fric_eps)                                                \
  FLT(lim_k)                                                   \
  FLT(lim_d)                                                   \
  INTS(body_parent, SC_NB_MAX)                                 \
  INTS(body_hinge, SC_NB_MAX)                                  \
  INTS(body_qadr, SC_NB_MAX)                                   \
  INTS(body_quat_ident, SC_NB_MAX)                             \
  FLTS(body_pos, SC_NB_MAX * 3)                                \
  FLTS(body_quat, SC_NB_MAX * 4)                               \
  FLTS(body_mass, SC_NB_MAX)                                   \
  FLTS(body_com, SC_NB_MAX * 3)                                \
  FLTS(body_inertia, SC_NB_MAX * 9)                            \
  FLTS(jnt_axis, SC_NB_MAX * 3)                                \
  FLTS(jnt_pos, SC_NB_MAX * 3)                                 \
  INTS(body_ndof, SC_NB_MAX)                                   \
  INTS(body_dofs, SC_NB_MAX * SC_NV_MAX)                       \
  INTS(dof_body, SC_NV_MAX)                                    \
  INTS(dof_hinge_body, SC_NV_MAX)                              \
  INTS(dof_limited, SC_NV_MAX)                                 \
  FLTS(dof_armature, SC_NV_MAX)                                \
  FLTS(dof_damping, SC_NV_MAX)                                 \
  FLTS(dof_frictionloss, SC_NV_MAX)                            \
  FLTS(dof_range, SC_NV_MAX * 2)                               \
  INTS(act_dof, SC_NU_MAX)                                     \
  INTS(act_qadr, SC_NU_MAX)                                    \
  FLTS(act_kp, SC_NU_MAX)                                      \
  FLTS(act_kv, SC_NU_MAX)                                      \
  FLTS(act_lo, SC_NU_MAX)                                      \
  FLTS(act_hi, SC_NU_MAX)                                      \
  INTS(geom_body, SC_NG_MAX)                                   \
  FLTS(geom_pos, SC_NG_MAX * 3)                                \
  FLTS(geom_radius, SC_NG_MAX)                                 \
  FLTS(geom_mu, SC_NG_MAX)                                     \
  FLTS(geom_k, SC_NG_MAX)                                      \
  FLTS(geom_d, SC_NG_MAX)                                      \
  INTS(chains, SC_G_MAX * SC_NCH_MAX)                          \
  INTS(pair_index, SC_NV_MAX * SC_NV_MAX)

#define SC_DECL_INT(name) int name;
#define SC_DECL_FLT(name) float name;
#define SC_DECL_INTS(name, n) int name[n];
#define SC_DECL_FLTS(name, n) float name[n];

struct SubstepModel {
  SUBSTEP_MODEL_FIELDS(SC_DECL_INT, SC_DECL_FLT, SC_DECL_INTS, SC_DECL_FLTS)
};

// ---------------------------------------------------------------------------
// float helpers: max/min keep a NaN first argument (as torch.clamp does)
// ---------------------------------------------------------------------------

SC_HD float sc_max(float a, float b) { return (a != a) ? a : (a > b ? a : b); }
SC_HD float sc_min(float a, float b) { return (a != a) ? a : (a < b ? a : b); }

SC_HD bool sc_isfinite(float x) {
#ifdef __CUDA_ARCH__
  return isfinite(x);
#else
  return std::isfinite(x);
#endif
}

SC_HD float sc_guard(float x) {  // |x| >= 1e-12 with its sign kept
  return fabsf(x) < 1e-12f ? (x < 0.0f ? -1e-12f : 1e-12f) : x;
}

// r = a x b
SC_HD void sc_cross(const float* a, const float* b, float* r) {
  r[0] = a[1] * b[2] - a[2] * b[1];
  r[1] = a[2] * b[0] - a[0] * b[2];
  r[2] = a[0] * b[1] - a[1] * b[0];
}

SC_HD float sc_dot(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// r = M v (M row-major 3x3)
SC_HD void sc_apply(const float* M, const float* v, float* r) {
  r[0] = M[0] * v[0] + M[1] * v[1] + M[2] * v[2];
  r[1] = M[3] * v[0] + M[4] * v[1] + M[5] * v[2];
  r[2] = M[6] * v[0] + M[7] * v[1] + M[8] * v[2];
}

// r = M^T v
SC_HD void sc_apply_t(const float* M, const float* v, float* r) {
  r[0] = M[0] * v[0] + M[3] * v[1] + M[6] * v[2];
  r[1] = M[1] * v[0] + M[4] * v[1] + M[7] * v[2];
  r[2] = M[2] * v[0] + M[5] * v[1] + M[8] * v[2];
}

// r = S v with S symmetric as (xx, xy, xz, yy, yz, zz)
SC_HD void sc_sym_apply(const float* S, const float* v, float* r) {
  r[0] = S[0] * v[0] + S[1] * v[1] + S[2] * v[2];
  r[1] = S[1] * v[0] + S[3] * v[1] + S[4] * v[2];
  r[2] = S[2] * v[0] + S[4] * v[1] + S[5] * v[2];
}

SC_HD void sc_quat_to_mat(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.0f - 2.0f * (y * y + z * z);
  R[1] = 2.0f * (x * y - z * w);
  R[2] = 2.0f * (x * z + y * w);
  R[3] = 2.0f * (x * y + z * w);
  R[4] = 1.0f - 2.0f * (x * x + z * z);
  R[5] = 2.0f * (y * z - x * w);
  R[6] = 2.0f * (x * z - y * w);
  R[7] = 2.0f * (y * z + x * w);
  R[8] = 1.0f - 2.0f * (x * x + y * y);
}

// r = a (x) b; r may alias neither input
SC_HD void sc_quat_mul(const float* a, const float* b, float* r) {
  r[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  r[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  r[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  r[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// inertia (A sym6, c, m) applied to the spatial vector (w, v):
// (A w + (c x v) m, (v - c x w) m)
SC_HD void sc_inertia_apply(const float* A, const float* c, float m,
                            const float* sv, float* out) {
  float t[3], cx[3];
  sc_sym_apply(A, sv, t);
  sc_cross(c, sv + 3, cx);
  for (int i = 0; i < 3; ++i) out[i] = t[i] + cx[i] * m;
  sc_cross(c, sv, cx);
  for (int i = 0; i < 3; ++i) out[3 + i] = (sv[3 + i] - cx[i]) * m;
}

// ---------------------------------------------------------------------------
// the substep: advances qpos (nq) and qvel (nv) of one rollout in place
// ---------------------------------------------------------------------------

SC_HD void sc_substep(const SubstepModel& m, float* qpos, float* qvel,
                      const float* ctrl) {
  const int nb = m.nb, nv = m.nv;
  const float dt = m.dt;

  // ---------------- FK ----------------
  float xpos[SC_NB_MAX][3], xquat[SC_NB_MAX][4], R[SC_NB_MAX][9];
  float q0[4];
  {
    const float n = sqrtf(qpos[3] * qpos[3] + qpos[4] * qpos[4] +
                          qpos[5] * qpos[5] + qpos[6] * qpos[6]);
    const float inv_n = 1.0f / sc_max(n, 1e-12f);
    for (int k = 0; k < 4; ++k) q0[k] = qpos[3 + k] * inv_n;
  }
  for (int k = 0; k < 3; ++k) xpos[0][k] = qpos[k];
  for (int k = 0; k < 4; ++k) xquat[0][k] = q0[k];
  sc_quat_to_mat(q0, R[0]);
  for (int b = 1; b < nb; ++b) {
    const int p = m.body_parent[b];
    float t[3], pp[3], q[4];
    sc_apply(R[p], m.body_pos + 3 * b, t);
    for (int k = 0; k < 3; ++k) pp[k] = xpos[p][k] + t[k];
    if (m.body_quat_ident[b]) {
      for (int k = 0; k < 4; ++k) q[k] = xquat[p][k];
    } else {
      sc_quat_mul(xquat[p], m.body_quat + 4 * b, q);
    }
    if (m.body_hinge[b]) {
      const float half = qpos[m.body_qadr[b]] * 0.5f;
      const float s = sinf(half), c = cosf(half);
      const float* ax = m.jnt_axis + 3 * b;
      const float qj[4] = {c, s * ax[0], s * ax[1], s * ax[2]};
      const float* anchor_l = m.jnt_pos + 3 * b;
      float Rpre[9], anchor[3];
      sc_quat_to_mat(q, Rpre);
      sc_apply(Rpre, anchor_l, t);
      for (int k = 0; k < 3; ++k) anchor[k] = pp[k] + t[k];
      sc_quat_mul(q, qj, xquat[b]);
      sc_quat_to_mat(xquat[b], R[b]);
      sc_apply(R[b], anchor_l, t);
      for (int k = 0; k < 3; ++k) xpos[b][k] = anchor[k] - t[k];
    } else {  // welded body: fixed transform only
      for (int k = 0; k < 4; ++k) xquat[b][k] = q[k];
      sc_quat_to_mat(q, R[b]);
      for (int k = 0; k < 3; ++k) xpos[b][k] = pp[k];
    }
  }
  const float* origin = xpos[0];

  // ---------------- motion subspace S (ang, lin) ----------------
  float S[SC_NV_MAX][6];
  for (int k = 0; k < 3; ++k) {
    for (int i = 0; i < 6; ++i) S[k][i] = 0.0f;
    S[k][3 + k] = 1.0f;
    for (int i = 0; i < 3; ++i) S[3 + k][i] = R[0][3 * i + k];
    for (int i = 3; i < 6; ++i) S[3 + k][i] = 0.0f;
  }
  for (int j = 6; j < nv; ++j) {
    const int b = m.dof_hinge_body[j];
    float t[3], r[3];
    sc_apply(R[b], m.jnt_axis + 3 * b, S[j]);
    sc_apply(R[b], m.jnt_pos + 3 * b, t);
    for (int k = 0; k < 3; ++k) r[k] = (xpos[b][k] + t[k]) - origin[k];
    sc_cross(r, S[j], S[j] + 3);
  }

  // ---------------- body spatial inertias at the origin ----------------
  float IA[SC_NB_MAX][6], Ic[SC_NB_MAX][3];
  for (int b = 0; b < nb; ++b) {
    const float* Rb = R[b];
    const float* Il = m.body_inertia + 9 * b;
    float t[3];
    sc_apply(Rb, m.body_com + 3 * b, t);
    for (int k = 0; k < 3; ++k) Ic[b][k] = (xpos[b][k] + t[k]) - origin[k];
    float RI[9];  // R @ I_l, zero entries of I_l folded
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        float acc = 0.0f;
        bool any = false;
        for (int k = 0; k < 3; ++k) {
          const float c = Il[3 * k + j];
          if (c != 0.0f) {
            acc = any ? acc + Rb[3 * i + k] * c : Rb[3 * i + k] * c;
            any = true;
          }
        }
        RI[3 * i + j] = any ? acc : Rb[3 * i] * 0.0f;
      }
    }
    float Iw[9];  // R I_l R^T
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Iw[3 * i + j] = sc_dot(RI + 3 * i, Rb + 3 * j);
    const float mb = m.body_mass[b];
    const float cx = Ic[b][0], cy = Ic[b][1], cz = Ic[b][2];
    IA[b][0] = Iw[0] + mb * (cy * cy + cz * cz);
    IA[b][1] = Iw[1] - mb * cx * cy;
    IA[b][2] = Iw[2] - mb * cx * cz;
    IA[b][3] = Iw[4] + mb * (cx * cx + cz * cz);
    IA[b][4] = Iw[5] - mb * cy * cz;
    IA[b][5] = Iw[8] + mb * (cx * cx + cy * cy);
  }

  // ---------------- body velocities ----------------
  float V[SC_NB_MAX][6];
  for (int b = 0; b < nb; ++b) {
    for (int i = 0; i < 6; ++i) V[b][i] = 0.0f;
    for (int d = 0; d < m.body_ndof[b]; ++d) {
      const int j = m.body_dofs[b * SC_NV_MAX + d];
      for (int i = 0; i < 6; ++i) V[b][i] = V[b][i] + S[j][i] * qvel[j];
    }
  }

  // ---------------- bias forces (RNEA, qdd = 0) ----------------
  float ab[SC_NB_MAX][6], fsub[SC_NB_MAX][6];
  for (int b = 0; b < nb; ++b) {
    const int p = m.body_parent[b];
    float vJ[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int d = 0; d < m.body_ndof[b]; ++d) {
      const int j = m.body_dofs[b * SC_NV_MAX + d];
      if (m.dof_body[j] != b) continue;
      for (int i = 0; i < 6; ++i) vJ[i] = vJ[i] + S[j][i] * qvel[j];
    }
    // motion cross: (w x mw, w x mv + vo x mw)
    float c1[3], c2[3], c3[3];
    sc_cross(V[b], vJ, c1);
    sc_cross(V[b], vJ + 3, c2);
    sc_cross(V[b] + 3, vJ, c3);
    for (int k = 0; k < 3; ++k) {
      const float pa = (p < 0) ? 0.0f : ab[p][k];
      const float pl = (p < 0) ? (k == 2 ? 0.0f - m.gz : 0.0f) : ab[p][3 + k];
      ab[b][k] = pa + c1[k];
      ab[b][3 + k] = pl + (c2[k] + c3[k]);
    }
  }
  for (int b = 0; b < nb; ++b) {
    float Ia[6], Iv[6], t1[3], t2[3];
    sc_inertia_apply(IA[b], Ic[b], m.body_mass[b], ab[b], Ia);
    sc_inertia_apply(IA[b], Ic[b], m.body_mass[b], V[b], Iv);
    // force cross: (w x tau + vo x frc, w x frc)
    sc_cross(V[b], Iv, t1);
    sc_cross(V[b] + 3, Iv + 3, t2);
    for (int k = 0; k < 3; ++k) fsub[b][k] = Ia[k] + (t1[k] + t2[k]);
    sc_cross(V[b], Iv + 3, t1);
    for (int k = 0; k < 3; ++k) fsub[b][3 + k] = Ia[3 + k] + t1[k];
  }
  for (int b = nb - 1; b >= 1; --b) {
    const int p = m.body_parent[b];
    for (int i = 0; i < 6; ++i) fsub[p][i] = fsub[p][i] + fsub[b][i];
  }
  float qfrc[SC_NV_MAX];
  for (int j = 0; j < nv; ++j) {
    const float* f = fsub[m.dof_body[j]];
    const float Cj = sc_dot(S[j], f) + sc_dot(S[j] + 3, f + 3);
    qfrc[j] = Cj * -1.0f;
  }

  // ---------------- mass matrix (arrow entries only) ----------------
  // composite inertias (A sym6, B 3x3, m), reusing IA as the A block
  float CB[SC_NB_MAX][9], Cm[SC_NB_MAX];
  for (int b = 0; b < nb; ++b) {
    const float mb = m.body_mass[b];
    const float cx = Ic[b][0], cy = Ic[b][1], cz = Ic[b][2];
    CB[b][0] = 0.0f;            CB[b][1] = (0.0f - cz) * mb; CB[b][2] = cy * mb;
    CB[b][3] = cz * mb;         CB[b][4] = 0.0f;             CB[b][5] = (0.0f - cx) * mb;
    CB[b][6] = (0.0f - cy) * mb; CB[b][7] = cx * mb;         CB[b][8] = 0.0f;
    Cm[b] = mb;
  }
  for (int b = nb - 1; b >= 1; --b) {
    const int p = m.body_parent[b];
    for (int i = 0; i < 6; ++i) IA[p][i] = IA[p][i] + IA[b][i];
    for (int i = 0; i < 9; ++i) CB[p][i] = CB[p][i] + CB[b][i];
    Cm[p] = Cm[p] + Cm[b];
  }
  float F[SC_NV_MAX][6];
  for (int j = 0; j < nv; ++j) {
    const int b = m.dof_body[j];
    float t1[3], t2[3];
    sc_sym_apply(IA[b], S[j], t1);
    sc_apply(CB[b], S[j] + 3, t2);
    for (int k = 0; k < 3; ++k) F[j][k] = t1[k] + t2[k];
    sc_apply_t(CB[b], S[j], t1);
    for (int k = 0; k < 3; ++k) F[j][3 + k] = t1[k] + S[j][3 + k] * Cm[b];
  }
  float M[SC_NPAIR_MAX], D[SC_NPAIR_MAX];
  for (int j = 0; j < nv; ++j) {
    for (int i = 0; i <= j; ++i) {
      const int p = m.pair_index[i * SC_NV_MAX + j];
      if (p < 0) continue;
      M[p] = sc_dot(S[i], F[j]) + sc_dot(S[i] + 3, F[j] + 3);
      D[p] = 0.0f;
    }
    const int pd = m.pair_index[j * SC_NV_MAX + j];
    M[pd] = M[pd] + m.dof_armature[j];
  }

  // ---------------- actuators + passive terms ----------------
  for (int a = 0; a < m.nu; ++a) {
    const int j = m.act_dof[a];
    float tau = m.act_kp[a] * (ctrl[a] - qpos[m.act_qadr[a]]) - m.act_kv[a] * qvel[j];
    tau = sc_min(sc_max(tau, m.act_lo[a]), m.act_hi[a]);
    qfrc[j] = qfrc[j] + tau;
  }
  float ddiag[SC_NV_MAX];
  for (int j = 0; j < nv; ++j) {
    float dd = m.dof_damping[j] + m.dof_frictionloss[j] / sc_max(fabsf(qvel[j]), 0.05f);
    if (m.dof_limited[j]) {
      const float qj = qpos[m.body_qadr[m.dof_hinge_body[j]]];
      const float below = sc_max(m.dof_range[2 * j] - qj, 0.0f);
      const float above = sc_max(qj - m.dof_range[2 * j + 1], 0.0f);
      qfrc[j] = qfrc[j] + m.lim_k * (below - above);
      dd = dd + m.lim_d * ((below > 0.0f || above > 0.0f) ? 1.0f : 0.0f);
    }
    ddiag[j] = dd;
  }

  // ---------------- contact: spheres vs the plane z = 0 ----------------
  for (int g = 0; g < m.ng; ++g) {
    const int b = m.geom_body[g];
    const float rad = m.geom_radius[g];
    float center[3], t[3];
    sc_apply(R[b], m.geom_pos + 3 * g, t);
    for (int k = 0; k < 3; ++k) center[k] = xpos[b][k] + t[k];
    const float phi = center[2] - 0.0f - rad;
    const float pen = sc_min(sc_max(0.0f - phi, 0.0f), 0.05f);
    const float active = phi < 0.0f ? 1.0f : 0.0f;
    const float fn = sc_min(m.geom_k[g] * pen, 1e4f);
    const float r[3] = {center[0] - origin[0], center[1] - origin[1],
                        (center[2] - rad) - origin[2]};
    float vpt[3];
    sc_cross(V[b], r, t);
    for (int k = 0; k < 3; ++k) vpt[k] = V[b][3 + k] + t[k];
    // flat ground: the tangential speed is the xy speed
    const float vt = sqrtf(vpt[0] * vpt[0] + vpt[1] * vpt[1] + 1e-12f);
    const float kappa = m.geom_mu[g] * fn / sc_max(vt, m.fric_eps);
    const float dn = m.geom_d[g] * active;
    const float kap = kappa * active;
    const int nd = m.body_ndof[b];
    const int* dofs = m.body_dofs + b * SC_NV_MAX;
    float J[SC_NV_MAX][3];  // J rows of the ancestor dofs: S_lin + S_ang x r
    for (int d = 0; d < nd; ++d) {
      const int j = dofs[d];
      sc_cross(S[j], r, t);
      for (int k = 0; k < 3; ++k) J[d][k] = S[j][3 + k] + t[k];
      qfrc[j] = qfrc[j] + J[d][2] * (fn * active);
    }
    // D += dn Jz Jz^T + kap (Jx Jx^T + Jy Jy^T)
    for (int d1 = 0; d1 < nd; ++d1) {
      for (int d2 = d1; d2 < nd; ++d2) {
        const float val = dn * J[d1][2] * J[d2][2] +
                          kap * (J[d1][0] * J[d2][0] + J[d1][1] * J[d2][1]);
        const int p = m.pair_index[dofs[d1] * SC_NV_MAX + dofs[d2]];
        D[p] = D[p] + val;
      }
    }
  }

  // ---------------- A = M + dt (D + diag), rhs = M qvel + dt qfrc ------------
  float A[SC_NPAIR_MAX], rhs[SC_NV_MAX];
  for (int j = 0; j < nv; ++j) {
    for (int i = 0; i <= j; ++i) {
      const int p = m.pair_index[i * SC_NV_MAX + j];
      if (p < 0) continue;
      A[p] = M[p] + dt * D[p];
      if (i == j) A[p] = A[p] + dt * ddiag[i];
    }
  }
  for (int i = 0; i < nv; ++i) {
    float acc = 0.0f;
    for (int j = 0; j < nv; ++j) {
      const int p = m.pair_index[i * SC_NV_MAX + j];
      if (p >= 0) acc = acc + M[p] * qvel[j];
    }
    rhs[i] = acc + dt * qfrc[i];
  }

  // ---------------- block-arrow solve ----------------
  // A(i, j) from the packed pairs; zero outside the arrow pattern
#define SC_A(i, j) (m.pair_index[(i) * SC_NV_MAX + (j)] >= 0 ? A[m.pair_index[(i) * SC_NV_MAX + (j)]] : 0.0f)
  const int G = m.n_chains, n = m.chain_len;
  float inv[SC_G_MAX][SC_NCH_MAX][SC_NCH_MAX];
  for (int g = 0; g < G; ++g) {
    const int* idx = m.chains + g * SC_NCH_MAX;
    if (n == 1) {
      inv[g][0][0] = 1.0f / sc_guard(SC_A(idx[0], idx[0]));
    } else if (n == 2) {
      const float a_ = SC_A(idx[0], idx[0]), b_ = SC_A(idx[0], idx[1]),
                  d_ = SC_A(idx[1], idx[1]);
      const float det = sc_guard(a_ * d_ - b_ * b_);
      inv[g][0][0] = d_ / det;
      inv[g][0][1] = -b_ / det;
      inv[g][1][0] = -b_ / det;
      inv[g][1][1] = a_ / det;
    } else {
      const float m00 = SC_A(idx[0], idx[0]), m01 = SC_A(idx[0], idx[1]),
                  m02 = SC_A(idx[0], idx[2]), m11 = SC_A(idx[1], idx[1]),
                  m12 = SC_A(idx[1], idx[2]), m22 = SC_A(idx[2], idx[2]);
      const float c00 = m11 * m22 - m12 * m12;
      const float c01 = m02 * m12 - m01 * m22;
      const float c02 = m01 * m12 - m02 * m11;
      const float c11 = m00 * m22 - m02 * m02;
      const float c12 = m01 * m02 - m00 * m12;
      const float c22 = m00 * m11 - m01 * m01;
      const float det = sc_guard(m00 * c00 + m01 * c01 + m02 * c02);
      inv[g][0][0] = c00 / det; inv[g][0][1] = c01 / det; inv[g][0][2] = c02 / det;
      inv[g][1][0] = c01 / det; inv[g][1][1] = c11 / det; inv[g][1][2] = c12 / det;
      inv[g][2][0] = c02 / det; inv[g][2][1] = c12 / det; inv[g][2][2] = c22 / det;
    }
  }
  // Schur complement of the legs onto the 6 base dofs
  float Ss[6][6], yb[6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) Ss[i][j] = SC_A(i, j);
    yb[i] = rhs[i];
  }
  for (int g = 0; g < G; ++g) {
    const int* idx = m.chains + g * SC_NCH_MAX;
    float Abl[6][SC_NCH_MAX], invb[SC_NCH_MAX], invA[6][SC_NCH_MAX];
    for (int i = 0; i < 6; ++i)
      for (int c = 0; c < n; ++c) Abl[i][c] = SC_A(i, idx[c]);
    for (int c = 0; c < n; ++c) {
      float s = 0.0f;
      for (int k = 0; k < n; ++k) s = s + inv[g][c][k] * rhs[idx[k]];
      invb[c] = s;
    }
    for (int j = 0; j < 6; ++j) {
      for (int c = 0; c < n; ++c) {
        float s = 0.0f;
        for (int k = 0; k < n; ++k) s = s + inv[g][c][k] * Abl[j][k];
        invA[j][c] = s;
      }
    }
    for (int i = 0; i < 6; ++i) {
      float s = 0.0f;
      for (int c = 0; c < n; ++c) s = s + Abl[i][c] * invb[c];
      yb[i] = yb[i] - s;
      for (int j = 0; j < 6; ++j) {
        float t = 0.0f;
        for (int c = 0; c < n; ++c) t = t + Abl[i][c] * invA[j][c];
        Ss[i][j] = Ss[i][j] - t;
      }
    }
  }
  // guarded 6x6 Cholesky solve
  float L[6][6], z[6], xb[6];
  for (int j = 0; j < 6; ++j) {
    float s = Ss[j][j];
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(sc_max(s, 1e-9f));
    for (int i = j + 1; i < 6; ++i) {
      float t = Ss[i][j];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
  for (int i = 0; i < 6; ++i) {
    float s = yb[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * z[k];
    z[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = z[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * xb[k];
    xb[i] = s / L[i][i];
  }
  float x[SC_NV_MAX];
  for (int i = 0; i < 6; ++i) x[i] = xb[i];
  for (int g = 0; g < G; ++g) {
    const int* idx = m.chains + g * SC_NCH_MAX;
    float r2[SC_NCH_MAX];
    for (int c = 0; c < n; ++c) {
      float s = 0.0f;
      for (int i = 0; i < 6; ++i) s = s + SC_A(idx[c], i) * xb[i];
      r2[c] = rhs[idx[c]] - s;
    }
    for (int c = 0; c < n; ++c) {
      float s = 0.0f;
      for (int k = 0; k < n; ++k) s = s + inv[g][c][k] * r2[k];
      x[idx[c]] = s;
    }
  }
#undef SC_A

  // ---------------- NaN firewall + integration ----------------
  // a non-finite solve keeps the clipped previous velocity of that dof
  for (int i = 0; i < nv; ++i) {
    const float src = sc_isfinite(x[i]) ? x[i] : qvel[i];
    qvel[i] = sc_min(sc_max(src, -1e3f), 1e3f);
  }
  for (int k = 0; k < 3; ++k) qpos[k] = qpos[k] + dt * qvel[k];
  {
    const float wx = qvel[3] * dt, wy = qvel[4] * dt, wz = qvel[5] * dt;
    const float ang = sqrtf(wx * wx + wy * wy + wz * wz);
    const float half = ang * 0.5f;
    const float sc = ang > 1e-9f ? sinf(half) / sc_max(ang, 1e-9f) : 0.5f;
    const float dq[4] = {cosf(half), wx * sc, wy * sc, wz * sc};
    float qn[4];
    sc_quat_mul(q0, dq, qn);  // the normalised base quaternion is integrated
    const float nrm = sqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]);
    const float inv_nrm = 1.0f / sc_max(nrm, 1e-12f);
    for (int k = 0; k < 4; ++k) qpos[3 + k] = qn[k] * inv_nrm;
  }
  for (int j = 6; j < nv; ++j) {
    const int qa = m.body_qadr[m.dof_hinge_body[j]];
    qpos[qa] = qpos[qa] + dt * qvel[j];
  }
}
