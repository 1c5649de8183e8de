// Host-only build of substep_core.cuh, for the CPU tests: g++ compiles the
// same substep arithmetic as the CUDA kernels, in every mode, and the tests
// compare it with the plain PyTorch version.  No entry point of the package
// reaches it.
#include <math.h>

#include "substep_core.cuh"

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

// qpos (nq, K), qvel (nv, K), ctrl (nu, K), plane (4, K) or (4 * ngeom, K),
// payload (1, K), row-major, as the kernels take them; writes qpos_out /
// qvel_out after n_substeps substeps.  Returns 1 for a bad table and 2 for a
// mode that the kernels do not instantiate.
extern "C" int substep_host(const SubstepModel* m, const float* qpos,
                            const float* qvel, const float* ctrl,
                            const float* plane, const float* payload,
                            float* qpos_out, float* qvel_out, int K,
                            int n_substeps, int plane_mode, int with_payload) {
  if (m->magic != SC_MAGIC) return 1;
#define SC_RUN(P, PL) \
  run<P, PL>(m, qpos, qvel, ctrl, plane, payload, qpos_out, qvel_out, K, n_substeps)
  if (plane_mode == SC_PLANE_FLAT && !with_payload) {
    SC_RUN(SC_PLANE_FLAT, false);
  } else if (plane_mode == SC_PLANE_FLAT && with_payload) {
    SC_RUN(SC_PLANE_FLAT, true);
  } else if (plane_mode == SC_PLANE_LANE && !with_payload) {
    SC_RUN(SC_PLANE_LANE, false);
  } else if (plane_mode == SC_PLANE_GEOM && !with_payload) {
    SC_RUN(SC_PLANE_GEOM, false);
  } else if (plane_mode == SC_PLANE_LANE && with_payload) {
    SC_RUN(SC_PLANE_LANE, true);
  } else {
    return 2;
  }
#undef SC_RUN
  return 0;
}
