// CUDA kernel K1: the fused flat-ground physics substep, one thread per
// rollout.
//
// Replaces opendog_tpu/ops/pallas_step.py::build_pallas_substep in its flat
// mode (the pl.pallas_call at pallas_step.py:115), which runs n_substeps
// Featherstone substeps per launch for K rollouts laid out as (rows, K).
//
// Design.  Thread k owns rollout k (the counterpart of one TPU vector lane):
// it loads column k of qpos (nq, K), qvel (nv, K) and ctrl (nu, K) -- the
// threads of a warp read neighbouring addresses of each row, so the loads and
// stores are coalesced -- runs n_substeps substeps of substep_core.cuh in
// registers and local memory, and writes column k of the outputs.  The model
// tables (SubstepModel, ~9.4 KB) are copied from device memory into shared
// memory once per block; every thread then reads the same address, which
// shared memory broadcasts.  The loop over substeps runs inside the kernel, so
// the 10-substep plant step (K = 1) is one launch.
//
// What bounds it on an H100: float32 arithmetic in long serial dependency
// chains (~49k operations per rollout and substep, see
// opendog_tpu_torch/ops/scalar_core.py::count_substep_ops) against a few
// hundred bytes of state per rollout, so bytes are negligible.  The
// per-thread working arrays (~7.5 KB) live in local memory (the stack frame
// of chip_smoke.py's ptxas report), which L1 mostly absorbs.  At the main
// path's K = 256 the grid is 2 blocks of 128 threads: 2 of the card's 132
// SMs, each with 4 warps to hide the latency of those chains, and the K = 1
// plant step is a single thread.  Spreading one rollout's substep over
// several threads (per body, per geom, per arrow block) is the lever for a
// later change.
#include <cuda_runtime.h>

#include "substep_core.cuh"

#define SC_BLOCK 128

__global__ void __launch_bounds__(SC_BLOCK)
substep_kernel(const SubstepModel* __restrict__ model,
               const float* __restrict__ qpos, const float* __restrict__ qvel,
               const float* __restrict__ ctrl, float* __restrict__ qpos_out,
               float* __restrict__ qvel_out, int K, int n_substeps) {
  __shared__ SubstepModel sm;
  {
    const int* src = reinterpret_cast<const int*>(model);
    int* dst = reinterpret_cast<int*>(&sm);
    const int words = (int)(sizeof(SubstepModel) / sizeof(int));
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float qp[SC_NQ_MAX], qv[SC_NV_MAX], ct[SC_NU_MAX];
  for (int r = 0; r < sm.nq; ++r) qp[r] = qpos[(size_t)r * K + k];
  for (int r = 0; r < sm.nv; ++r) qv[r] = qvel[(size_t)r * K + k];
  for (int r = 0; r < sm.nu; ++r) ct[r] = ctrl[(size_t)r * K + k];
  for (int s = 0; s < n_substeps; ++s) sc_substep(sm, qp, qv, ct);
  for (int r = 0; r < sm.nq; ++r) qpos_out[(size_t)r * K + k] = qp[r];
  for (int r = 0; r < sm.nv; ++r) qvel_out[(size_t)r * K + k] = qv[r];
}

extern "C" int substep_model_size() { return (int)sizeof(SubstepModel); }

// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise.  `model` is a device copy of a SubstepModel.
extern "C" int substep_launch(const void* model, const float* qpos,
                              const float* qvel, const float* ctrl,
                              float* qpos_out, float* qvel_out, int K,
                              int n_substeps, void* stream) {
  const int grid = (K + SC_BLOCK - 1) / SC_BLOCK;
  substep_kernel<<<grid, SC_BLOCK, 0, (cudaStream_t)stream>>>(
      (const SubstepModel*)model, qpos, qvel, ctrl, qpos_out, qvel_out, K,
      n_substeps);
  return (int)cudaGetLastError();
}
