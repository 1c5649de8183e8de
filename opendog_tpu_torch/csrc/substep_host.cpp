// Host-only build of substep_core.cuh, for the CPU tests: g++ compiles the
// same substep arithmetic as the CUDA kernel and the tests compare it with
// the plain PyTorch version.  No entry point of the package reaches it.
#include <math.h>

#include "substep_core.cuh"

extern "C" int substep_model_size() { return (int)sizeof(SubstepModel); }

// qpos (nq, K), qvel (nv, K), ctrl (nu, K) row-major, as the kernel takes
// them; writes qpos_out / qvel_out after n_substeps substeps.
extern "C" int substep_host(const SubstepModel* m, const float* qpos,
                            const float* qvel, const float* ctrl,
                            float* qpos_out, float* qvel_out, int K,
                            int n_substeps) {
  if (m->magic != SC_MAGIC) return 1;
  for (int k = 0; k < K; ++k) {
    float qp[SC_NQ_MAX], qv[SC_NV_MAX], ct[SC_NU_MAX];
    for (int r = 0; r < m->nq; ++r) qp[r] = qpos[r * K + k];
    for (int r = 0; r < m->nv; ++r) qv[r] = qvel[r * K + k];
    for (int r = 0; r < m->nu; ++r) ct[r] = ctrl[r * K + k];
    for (int s = 0; s < n_substeps; ++s) sc_substep(*m, qp, qv, ct);
    for (int r = 0; r < m->nq; ++r) qpos_out[r * K + k] = qp[r];
    for (int r = 0; r < m->nv; ++r) qvel_out[r * K + k] = qv[r];
  }
  return 0;
}
