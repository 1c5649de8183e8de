// Host-only build of substep_core.cuh and substep_warp.cuh, for the CPU
// tests: g++ compiles the warp design of the CUDA kernels in every mode and
// workspace size class that they build, and the serial substep sc_substep,
// which no kernel runs: it is the oracle that the tests hold the warp design
// to, bit for bit, and both are compared with the plain version; the same
// for the exact plant's terrain ground (exact_plant_host) and the rollouts'
// tracking cost (tracking_cost_host).  No entry point of the package
// reaches it.
#include <math.h>
#include <stddef.h>

#include <limits>

#include "substep_core.cuh"
#include "substep_warp.cuh"
#include "tracking_cost.cuh"

extern "C" int substep_model_size() { return (int)sizeof(SubstepModel); }

// `plane` is the (rows, K) planes, or on the terrain ground (with `g`)
// the heights of g's grid.
template <int PLANE, bool PAYLOAD>
static void run(const SubstepModel* m, const float* qpos, const float* qvel,
                const float* ctrl, const float* plane, const float* payload,
                float* qpos_out, float* qvel_out, int K, int n_substeps,
                const SubstepGround* g = nullptr) {
  for (int k = 0; k < K; ++k) {
    float qp[SC_NQ_MAX], qv[SC_NV_MAX], ct[SC_NU_MAX];
    for (int r = 0; r < m->nq; ++r) qp[r] = qpos[r * K + k];
    for (int r = 0; r < m->nv; ++r) qv[r] = qvel[r * K + k];
    for (int r = 0; r < m->nu; ++r) ct[r] = ctrl[r * K + k];
    const float pl = PAYLOAD ? payload[k] : 0.0f;
    const float* pk = PLANE == SC_PLANE_FLAT      ? nullptr
                      : PLANE == SC_PLANE_TERRAIN ? plane
                                                  : plane + k;
    for (int s = 0; s < n_substeps; ++s)
      sc_substep<PLANE, PAYLOAD>(*m, qp, qv, ct, pk, K, pl, g);
    for (int r = 0; r < m->nq; ++r) qpos_out[r * K + k] = qp[r];
    for (int r = 0; r < m->nv; ++r) qvel_out[r * K + k] = qv[r];
  }
}

// The warp design with each phase run as a loop over the 32 lanes, in
// reverse with `rev`, on a workspace of size class NG.  Before every
// substep the workspace past the carried state (qpos, qvel, ctrl, plane,
// payload) is filled with NaN, so that a phase that read a value no earlier
// phase of the substep wrote would show; on the terrain ground, whose
// plane rows are the sphere phase's own, those too.
template <int PLANE, bool PAYLOAD, int NG>
static void run_warp(const SubstepModel* m, const float* qpos,
                     const float* qvel, const float* ctrl, const float* plane,
                     const float* payload, float* qpos_out, float* qvel_out,
                     int K, int n_substeps, bool rev,
                     const SubstepGround* g = nullptr) {
  SubstepWorkOf<PLANE, NG> w;
  const size_t carried = offsetof(SubstepWorkNG<NG>, m0);
  const size_t rest = (sizeof(w) - carried) / sizeof(float);
  float* scratch = reinterpret_cast<float*>(reinterpret_cast<char*>(&w) + carried);
  const int lane = 0;  // unused on the host: SC_PHASE loops over the lanes
  for (int k = 0; k < K; ++k) {
    SC_PHASE(scw_load<PLANE, PAYLOAD>(*m, w, lane, qpos, qvel, ctrl, plane,
                                      payload, K, k));
    for (int s = 0; s < n_substeps; ++s) {
      for (size_t i = 0; i < rest; ++i)
        scratch[i] = std::numeric_limits<float>::quiet_NaN();
      if (PLANE == SC_PLANE_TERRAIN)
        for (int i = 0; i < 4 * NG; ++i)
          w.plane[i] = std::numeric_limits<float>::quiet_NaN();
      sc_warp_substep<PLANE, PAYLOAD>(*m, w, lane, rev, g, plane);
    }
    SC_PHASE(scw_store(*m, w, lane, qpos_out, qvel_out, K, k));
  }
}

#define SC_DISPATCH(RUN)                                  \
  if (plane_mode == SC_PLANE_FLAT && !with_payload) {      \
    RUN(SC_PLANE_FLAT, false);                             \
  } else if (plane_mode == SC_PLANE_FLAT && with_payload) { \
    RUN(SC_PLANE_FLAT, true);                              \
  } else if (plane_mode == SC_PLANE_LANE && !with_payload) { \
    RUN(SC_PLANE_LANE, false);                             \
  } else if (plane_mode == SC_PLANE_GEOM && !with_payload) { \
    RUN(SC_PLANE_GEOM, false);                             \
  } else if (plane_mode == SC_PLANE_LANE && with_payload) { \
    RUN(SC_PLANE_LANE, true);                              \
  } else if (plane_mode == SC_PLANE_GEOM && with_payload) { \
    RUN(SC_PLANE_GEOM, true);                              \
  } else {                                                 \
    return 2;                                              \
  }

// qpos (nq, K), qvel (nv, K), ctrl (nu, K), plane (4, K) or (4 * ngeom, K),
// payload (1, K), row-major, as the kernels take them; writes qpos_out /
// qvel_out after n_substeps substeps of the serial oracle, one rollout at a
// time (sc_substep of substep_core.cuh).  Returns 1 for a bad table and 2
// for an unknown mode.
extern "C" int substep_host(const SubstepModel* m, const float* qpos,
                            const float* qvel, const float* ctrl,
                            const float* plane, const float* payload,
                            float* qpos_out, float* qvel_out, int K,
                            int n_substeps, int plane_mode, int with_payload) {
  if (m->magic != SC_MAGIC) return 1;
#define SC_RUN(P, PL) \
  run<P, PL>(m, qpos, qvel, ctrl, plane, payload, qpos_out, qvel_out, K, n_substeps)
  SC_DISPATCH(SC_RUN)
#undef SC_RUN
  return 0;
}

// The same for the warp design (substep_warp.cuh), its lanes run in order,
// or in reverse when `reverse` is not 0, on a workspace of size class
// ng_class: SC_NG_MAX in every mode, or SC_NG_SMALL in the plane + payload
// mode, the one whose kernel is built in both.  Returns 3 for another class
// or a model with more spheres than the class holds.
extern "C" int substep_host_warp(const SubstepModel* m, const float* qpos,
                                 const float* qvel, const float* ctrl,
                                 const float* plane, const float* payload,
                                 float* qpos_out, float* qvel_out, int K,
                                 int n_substeps, int plane_mode,
                                 int with_payload, int ng_class,
                                 int reverse) {
  if (m->magic != SC_MAGIC) return 1;
#define SC_RUN_NG(P, PL, NG)                                          \
  run_warp<P, PL, NG>(m, qpos, qvel, ctrl, plane, payload, qpos_out, \
                      qvel_out, K, n_substeps, reverse != 0)
  if (ng_class == SC_NG_SMALL && m->ng <= SC_NG_SMALL &&
      plane_mode == SC_PLANE_LANE && with_payload) {
    SC_RUN_NG(SC_PLANE_LANE, true, SC_NG_SMALL);
    return 0;
  }
  if (ng_class != SC_NG_MAX) return 3;
#define SC_RUN(P, PL) SC_RUN_NG(P, PL, SC_NG_MAX)
  SC_DISPATCH(SC_RUN)
#undef SC_RUN
#undef SC_RUN_NG
  return 0;
}

extern "C" int exact_plant_ground_size() { return (int)sizeof(SubstepGround); }

// The exact plant (the SC_PLANE_TERRAIN ground, no payload) on the host:
// design 0 the serial oracle sc_substep, 1 the warp design with its lanes
// in order, 2 in reverse (on a NaN-filled workspace, as substep_host_warp).
// heights is the (nrow, ncol) grid of `g`.  Returns 1 for a bad table and 3
// for an unknown design.
extern "C" int exact_plant_host(const SubstepModel* m, const SubstepGround* g,
                                const float* heights, const float* qpos,
                                const float* qvel, const float* ctrl,
                                float* qpos_out, float* qvel_out, int K,
                                int n_substeps, int design) {
  if (m->magic != SC_MAGIC || g->magic != SC_GROUND_MAGIC) return 1;
  if (design == 0)
    run<SC_PLANE_TERRAIN, false>(m, qpos, qvel, ctrl, heights, nullptr,
                                 qpos_out, qvel_out, K, n_substeps, g);
  else if (design == 1 || design == 2)
    run_warp<SC_PLANE_TERRAIN, false, SC_NG_MAX>(
        m, qpos, qvel, ctrl, heights, nullptr, qpos_out, qvel_out, K,
        n_substeps, design == 2, g);
  else
    return 3;
  return 0;
}

// The terrain ground's lookup alone (sc_terrain_ground) at K sphere centres
// (3, K) of radii (K): normals (3, K) and penetrations (K).  Returns 1 for a
// bad table.
extern "C" int exact_plant_ground_host(const SubstepGround* g,
                                       const float* heights,
                                       const float* centers,
                                       const float* radius, float* n_out,
                                       float* phi_out, int K) {
  if (g->magic != SC_GROUND_MAGIC) return 1;
  for (int k = 0; k < K; ++k) {
    const float c[3] = {centers[k], centers[K + k], centers[2 * K + k]};
    float n[3];
    sc_terrain_ground(*g, heights, c, radius[k], n, phi_out + k);
    for (int i = 0; i < 3; ++i) n_out[i * K + k] = n[i];
  }
  return 0;
}

extern "C" int tracking_cost_size() { return (int)sizeof(TrackingCost); }

// The rollouts' tracking cost on the host, what rollout_tracking_cost adds
// on the card: total[l] = c * disc (accumulate == 0) or total[l] + c * disc
// for each of the L lanes.  Returns 1 for a bad table.
extern "C" int tracking_cost_host(const TrackingCost* p, const float* qpos,
                                  const float* qvel, const float* ctrl,
                                  const float* prev, float* total, int L,
                                  float disc, int accumulate) {
  if (p->magic != TC_MAGIC) return 1;
  for (int l = 0; l < L; ++l)
    tc_add_step(*p, qpos, qvel, ctrl, prev, total, L, l, disc, accumulate);
  return 0;
}
