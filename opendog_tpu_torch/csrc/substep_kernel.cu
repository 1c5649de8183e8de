// CUDA kernels K1-K4: the fused physics substep, one thread per rollout, in
// each mode of the TPU kernel.
//
// Replaces opendog_tpu/ops/pallas_step.py::build_pallas_substep (the
// pl.pallas_call at pallas_step.py:115), which runs n_substeps Featherstone
// substeps per launch for K rollouts laid out as (rows, K).  Its modes are
// different work, so each is its own instantiation of the substep template
// of substep_core.cuh and its own entry point:
//   substep_flat          K1  ground z = 0
//   substep_payload       K2  z = 0, a point mass at the trunk origin per
//                             rollout (payload (1, K))
//   substep_plane         K3  one contact plane per rollout (plane (4, K))
//   substep_pergeom       K4  one plane per collision geom and rollout
//                             (plane (4 * ngeom, K))
//   substep_plane_payload K2 + K3 together (the domain-randomised batch)
//
// Design.  Thread k owns rollout k (the counterpart of one TPU vector lane):
// it loads column k of qpos (nq, K), qvel (nv, K) and ctrl (nu, K) -- the
// threads of a warp read neighbouring addresses of each row, so the loads and
// stores are coalesced -- runs n_substeps substeps of substep_core.cuh in
// registers and local memory, and writes column k of the outputs.  The lane
// plane (4 values) and the payload are loaded once per launch; the per-geom
// planes are read from device memory inside the contact loop, column k of
// each row, coalesced across the warp like the state (96 rows for OpenDOG:
// copying them into the thread's local memory would add 384 B to a stack
// frame of ~7.5 KB for values read once per substep).  The model tables
// (SubstepModel, ~9.4 KB) are copied from device memory into shared memory
// once per block; every thread then reads the same address, which shared
// memory broadcasts.  The loop over substeps runs inside the kernel, so the
// 10-substep plant step (K = 1) is one launch.
//
// What bounds it on an H100: float32 arithmetic in long serial dependency
// chains (~49k operations per Go1 rollout and flat substep, see
// opendog_tpu_torch/ops/scalar_core.py::count_substep_ops) against a few
// hundred bytes of state per rollout, so bytes are negligible.  The
// per-thread working arrays live in local memory (the stack frame of
// chip_smoke.py's ptxas report), which L1 mostly absorbs.  At the MPPI
// paths' K = 256 the grid is 2 blocks of 128 threads: 2 of the card's 132
// SMs, each with 4 warps to hide the latency of those chains, and the K = 1
// plant step is a single thread.  Spreading one rollout's substep over
// several threads (per body, per geom, per arrow block) is the lever for a
// later change.
#include <cuda_runtime.h>

#include "substep_core.cuh"

#define SC_BLOCK 128

template <int PLANE, bool PAYLOAD>
__device__ __forceinline__ void substep_body(
    const SubstepModel* __restrict__ model, const float* __restrict__ qpos,
    const float* __restrict__ qvel, const float* __restrict__ ctrl,
    const float* __restrict__ plane, const float* __restrict__ payload,
    float* __restrict__ qpos_out, float* __restrict__ qvel_out, int K,
    int n_substeps) {
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
  const float pl = PAYLOAD ? payload[k] : 0.0f;
  float lane_plane[4];
  const float* pk = nullptr;
  int stride = 0;
  if (PLANE == SC_PLANE_LANE) {
    for (int r = 0; r < 4; ++r) lane_plane[r] = plane[(size_t)r * K + k];
    pk = lane_plane;
    stride = 1;
  } else if (PLANE == SC_PLANE_GEOM) {
    pk = plane + k;
    stride = K;
  }
  for (int s = 0; s < n_substeps; ++s)
    sc_substep<PLANE, PAYLOAD>(sm, qp, qv, ct, pk, stride, pl);
  for (int r = 0; r < sm.nq; ++r) qpos_out[(size_t)r * K + k] = qp[r];
  for (int r = 0; r < sm.nv; ++r) qvel_out[(size_t)r * K + k] = qv[r];
}

#define SC_KERNEL(NAME, PLANE, PAYLOAD)                                       \
  extern "C" __global__ void __launch_bounds__(SC_BLOCK) NAME(                \
      const SubstepModel* __restrict__ model, const float* __restrict__ qpos, \
      const float* __restrict__ qvel, const float* __restrict__ ctrl,         \
      const float* __restrict__ plane, const float* __restrict__ payload,     \
      float* __restrict__ qpos_out, float* __restrict__ qvel_out, int K,      \
      int n_substeps) {                                                       \
    substep_body<PLANE, PAYLOAD>(model, qpos, qvel, ctrl, plane, payload,     \
                                 qpos_out, qvel_out, K, n_substeps);          \
  }

SC_KERNEL(substep_flat, SC_PLANE_FLAT, false)
SC_KERNEL(substep_payload, SC_PLANE_FLAT, true)
SC_KERNEL(substep_plane, SC_PLANE_LANE, false)
SC_KERNEL(substep_pergeom, SC_PLANE_GEOM, false)
SC_KERNEL(substep_plane_payload, SC_PLANE_LANE, true)

extern "C" int substep_model_size() { return (int)sizeof(SubstepModel); }

// Launches the instantiation of (plane_mode = SC_PLANE_*, with_payload) on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a combination that is not instantiated; does not
// synchronise.  `model` is a device copy of a SubstepModel; `plane` and
// `payload` may be null where the mode does not read them.
extern "C" int substep_launch(const void* model, const float* qpos,
                              const float* qvel, const float* ctrl,
                              const float* plane, const float* payload,
                              float* qpos_out, float* qvel_out, int K,
                              int n_substeps, int plane_mode, int with_payload,
                              void* stream) {
  const int grid = (K + SC_BLOCK - 1) / SC_BLOCK;
  const SubstepModel* m = (const SubstepModel*)model;
  cudaStream_t s = (cudaStream_t)stream;
#define SC_LAUNCH(NAME) \
  NAME<<<grid, SC_BLOCK, 0, s>>>(m, qpos, qvel, ctrl, plane, payload, \
                                 qpos_out, qvel_out, K, n_substeps)
  if (plane_mode == SC_PLANE_FLAT && !with_payload) {
    SC_LAUNCH(substep_flat);
  } else if (plane_mode == SC_PLANE_FLAT && with_payload) {
    SC_LAUNCH(substep_payload);
  } else if (plane_mode == SC_PLANE_LANE && !with_payload) {
    SC_LAUNCH(substep_plane);
  } else if (plane_mode == SC_PLANE_GEOM && !with_payload) {
    SC_LAUNCH(substep_pergeom);
  } else if (plane_mode == SC_PLANE_LANE && with_payload) {
    SC_LAUNCH(substep_plane_payload);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef SC_LAUNCH
  return (int)cudaGetLastError();
}
