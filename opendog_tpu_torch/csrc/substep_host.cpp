// Host-only build of substep_core.cuh and substep_warp.cuh, for the CPU
// tests: g++ compiles the same substep arithmetic as the CUDA kernels, in
// every mode and in both designs, and the tests compare it with the plain
// version and the two designs with each other.  No entry point of the
// package reaches it.
#include <math.h>
#include <stddef.h>

#include <limits>

#include "substep_core.cuh"
#include "substep_warp.cuh"

extern "C" int substep_model_size() { return (int)sizeof(SubstepModel); }

template <int PLANE, bool PAYLOAD>
static void run(const SubstepModel* m, const float* qpos, const float* qvel,
                const float* ctrl, const float* plane, const float* payload,
                float* qpos_out, float* qvel_out, int K, int n_substeps) {
  for (int k = 0; k < K; ++k) {
    float qp[SC_NQ_MAX], qv[SC_NV_MAX], ct[SC_NU_MAX];
    for (int r = 0; r < m->nq; ++r) qp[r] = qpos[r * K + k];
    for (int r = 0; r < m->nv; ++r) qv[r] = qvel[r * K + k];
    for (int r = 0; r < m->nu; ++r) ct[r] = ctrl[r * K + k];
    const float pl = PAYLOAD ? payload[k] : 0.0f;
    const float* pk = PLANE == SC_PLANE_FLAT ? nullptr : plane + k;
    for (int s = 0; s < n_substeps; ++s)
      sc_substep<PLANE, PAYLOAD>(*m, qp, qv, ct, pk, K, pl);
    for (int r = 0; r < m->nq; ++r) qpos_out[r * K + k] = qp[r];
    for (int r = 0; r < m->nv; ++r) qvel_out[r * K + k] = qv[r];
  }
}

// The warp design with each phase run as a loop over the 32 lanes, in
// reverse with `rev`.  Before every substep the workspace past the carried
// state (qpos, qvel, ctrl, plane, payload) is filled with NaN, so that a
// phase that read a value no earlier phase of the substep wrote would show.
template <int PLANE, bool PAYLOAD>
static void run_warp(const SubstepModel* m, const float* qpos,
                     const float* qvel, const float* ctrl, const float* plane,
                     const float* payload, float* qpos_out, float* qvel_out,
                     int K, int n_substeps, bool rev) {
  SubstepWorkOf<PLANE> w;
  const size_t carried = offsetof(SubstepWork, m0);
  const size_t rest = (sizeof(w) - carried) / sizeof(float);
  float* scratch = reinterpret_cast<float*>(reinterpret_cast<char*>(&w) + carried);
  const int lane = 0;  // unused on the host: SC_PHASE loops over the lanes
  for (int k = 0; k < K; ++k) {
    SC_PHASE(scw_load<PLANE, PAYLOAD>(*m, w, lane, qpos, qvel, ctrl, plane,
                                      payload, K, k));
    for (int s = 0; s < n_substeps; ++s) {
      for (size_t i = 0; i < rest; ++i)
        scratch[i] = std::numeric_limits<float>::quiet_NaN();
      sc_warp_substep<PLANE, PAYLOAD>(*m, w, lane, rev);
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
// qvel_out after n_substeps substeps of the one-thread design
// (substep_core.cuh).  Returns 1 for a bad table and 2 for an unknown mode.
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
// or in reverse when `reverse` is not 0.
extern "C" int substep_host_warp(const SubstepModel* m, const float* qpos,
                                 const float* qvel, const float* ctrl,
                                 const float* plane, const float* payload,
                                 float* qpos_out, float* qvel_out, int K,
                                 int n_substeps, int plane_mode,
                                 int with_payload, int reverse) {
  if (m->magic != SC_MAGIC) return 1;
#define SC_RUN(P, PL)                                                     \
  run_warp<P, PL>(m, qpos, qvel, ctrl, plane, payload, qpos_out, qvel_out, \
                  K, n_substeps, reverse != 0)
  SC_DISPATCH(SC_RUN)
#undef SC_RUN
  return 0;
}
