// CUDA kernels K1-K4: the fused physics substep in each mode of the TPU
// kernel.
//
// Replaces opendog_tpu/ops/pallas_step.py::build_pallas_substep (the
// pl.pallas_call at pallas_step.py:115), which runs n_substeps Featherstone
// substeps per launch for K rollouts laid out as (rows, K).  Its modes are
// different work, so each is its own instantiation and its own entry point:
//   substep_flat            K1  ground z = 0                     (warp)
//   substep_payload         K2  z = 0, a point mass at the trunk origin per
//                               rollout (payload (1, K))          (warp)
//   substep_plane           K3  one contact plane per rollout (plane (4, K))
//                                                                 (warp)
//   substep_pergeom         K4  one plane per collision geom and rollout
//                               (plane (4 * ngeom, K))            (warp)
//   substep_plane_payload   K2 + K3 (the domain-randomised batch) (thread)
//   substep_pergeom_payload K2 + K4                               (thread)
// Two designs: K1-K4 run the warp design of substep_warp.cuh, the two plane
// modes with a payload still the one-thread design of substep_core.cuh.
// Both compute the same floats in the same order.
//
// Warp design (K1-K4).  Warp w of a block owns rollout blockIdx.x * W + w
// (W = SC_WARPS rollouts per block) and its 32 lanes split that rollout's
// substep into phases with a __syncwarp() between two (substep_warp.cuh
// lists them).  Each rollout's working arrays live in dynamic shared memory
// after the block's copy of the model tables (SubstepModel, ~14 KB), not in
// local memory: SubstepWork (~20 KB) in the flat modes, 93 KB per block at
// W = 4; SubstepWorkPlane (~23 KB, J.n of every J row besides) in the plane
// modes, 107 KB per block; two blocks per SM either way.  The lane plane or
// the per-geom planes are loaded into the workspace once per launch.  A warp
// whose rollout is >= K helps copy the table and does nothing else.  What
// bounds it on an H100: scalar float32 work in short dependency chains on a
// few hundred bytes of state per rollout; the matrices are 3x3 and 6x6, at
// most 9 dofs per sphere, so wgmma and TMA do not apply (no 64-row tiles,
// nothing worth a bulk copy).  The levers are shared memory in place of
// local memory, more SMs busy at the MPPI paths' K = 256 (256 warps instead
// of 2 blocks of 128 threads), and a shorter critical path per substep: a
// base pair's contact sum over every sphere (78 for Go1, 24 for OpenDOG) is
// its longest serial stretch, and in the plane modes each of its terms
// reads J.n instead of making it.
//
// One-thread design (the plane + payload modes).  Thread k owns rollout k:
// it loads column k of qpos (nq, K), qvel (nv, K) and ctrl (nu, K)
// (coalesced across the warp), runs n_substeps substeps of substep_core.cuh
// in registers and local memory (a ~7.5 KB stack frame), and writes column
// k of the outputs.  The lane plane and the payload are loaded once per
// launch; the per-geom planes are read from device memory inside the
// contact loop, column k of each row.  The model tables are copied into
// shared memory once per block.  At K = 256 this fills 2 of the 132 SMs;
// these modes move to the warp design in later changes.
//
// Both designs loop over the substeps inside the kernel, so a 10-substep
// plant step (K = 1) is one launch.
#include <cuda_runtime.h>

#include "substep_core.cuh"
#include "substep_warp.cuh"

#define SC_BLOCK 128  // threads per block of the one-thread design

// Rollouts (warps) per block of the warp design: of 1, 2, 4 and 8, 4 was
// the fastest at the K = 256 path shapes of K1-K4 on an H100 and within
// 1.2% of 8 at K = 1 (PERF.md, measured with scripts/torch_warp_sweep.py,
// which overrides it to measure).
#ifndef SC_WARPS
#define SC_WARPS 4
#endif

#define SC_ARGS                                                             \
  const SubstepModel *__restrict__ model, const float *__restrict__ qpos,   \
      const float *__restrict__ qvel, const float *__restrict__ ctrl,       \
      const float *__restrict__ plane, const float *__restrict__ payload,   \
      float *__restrict__ qpos_out, float *__restrict__ qvel_out, int K,    \
      int n_substeps
#define SC_PASS \
  model, qpos, qvel, ctrl, plane, payload, qpos_out, qvel_out, K, n_substeps

// ---------------------------------------------------------------------------
// one-thread design
// ---------------------------------------------------------------------------

template <int PLANE, bool PAYLOAD>
__device__ __forceinline__ void substep_body(SC_ARGS) {
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

#define SC_KERNEL(NAME, PLANE, PAYLOAD)                                   \
  extern "C" __global__ void __launch_bounds__(SC_BLOCK) NAME(SC_ARGS) { \
    substep_body<PLANE, PAYLOAD>(SC_PASS);                                \
  }

SC_KERNEL(substep_plane_payload, SC_PLANE_LANE, true)
SC_KERNEL(substep_pergeom_payload, SC_PLANE_GEOM, true)

// ---------------------------------------------------------------------------
// warp design
// ---------------------------------------------------------------------------

// dynamic shared memory of a block: the table, then SC_WARPS workspaces
#define SC_TABLE_BYTES ((sizeof(SubstepModel) + 15) / 16 * 16)
template <int PLANE>
constexpr size_t sc_warp_smem() {
  return SC_TABLE_BYTES + SC_WARPS * sizeof(SubstepWorkOf<PLANE>);
}

template <int PLANE, bool PAYLOAD>
__device__ __forceinline__ void substep_warp_body(SC_ARGS) {
  extern __shared__ __align__(16) unsigned char sc_smem[];
  SubstepModel& sm = *reinterpret_cast<SubstepModel*>(sc_smem);
  {
    const int* src = reinterpret_cast<const int*>(model);
    int* dst = reinterpret_cast<int*>(sc_smem);
    const int words = (int)(sizeof(SubstepModel) / sizeof(int));
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / SC_LANES, lane = threadIdx.x % SC_LANES;
  const int k = blockIdx.x * SC_WARPS + warp;
  if (k >= K) return;  // the whole warp: the ragged tail of the last block
  SubstepWorkOf<PLANE>& w =
      reinterpret_cast<SubstepWorkOf<PLANE>*>(sc_smem + SC_TABLE_BYTES)[warp];
  scw_load<PLANE, PAYLOAD>(sm, w, lane, qpos, qvel, ctrl, plane, payload, K,
                           k);
  __syncwarp();
  for (int s = 0; s < n_substeps; ++s)
    sc_warp_substep<PLANE, PAYLOAD>(sm, w, lane, false);
  scw_store(sm, w, lane, qpos_out, qvel_out, K, k);
}

#define SC_WARP_KERNEL(NAME, PLANE, PAYLOAD)                      \
  extern "C" __global__ void __launch_bounds__(SC_LANES* SC_WARPS) \
      NAME(SC_ARGS) {                                              \
    substep_warp_body<PLANE, PAYLOAD>(SC_PASS);                    \
  }

SC_WARP_KERNEL(substep_flat, SC_PLANE_FLAT, false)
SC_WARP_KERNEL(substep_payload, SC_PLANE_FLAT, true)
SC_WARP_KERNEL(substep_plane, SC_PLANE_LANE, false)
SC_WARP_KERNEL(substep_pergeom, SC_PLANE_GEOM, false)

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

extern "C" int substep_model_size() { return (int)sizeof(SubstepModel); }

// rollouts per block of the warp kernels, and dynamic shared memory per
// block [B] of the warp kernel of plane_mode = SC_PLANE_* (0 for another)
extern "C" int substep_warps_per_block() { return SC_WARPS; }
extern "C" int substep_warp_smem_bytes(int plane_mode) {
  if (plane_mode == SC_PLANE_FLAT) return (int)sc_warp_smem<SC_PLANE_FLAT>();
  if (plane_mode == SC_PLANE_LANE) return (int)sc_warp_smem<SC_PLANE_LANE>();
  if (plane_mode == SC_PLANE_GEOM) return (int)sc_warp_smem<SC_PLANE_GEOM>();
  return 0;
}

typedef void (*SubstepKernel)(SC_ARGS);

template <int PLANE>
static int launch_warp(SubstepKernel kern, SC_ARGS, cudaStream_t s) {
  const size_t smem = sc_warp_smem<PLANE>();
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (K + SC_WARPS - 1) / SC_WARPS;
  kern<<<grid, SC_LANES * SC_WARPS, smem, s>>>(SC_PASS);
  return (int)cudaGetLastError();
}

static int launch_thread(SubstepKernel kern, SC_ARGS, cudaStream_t s) {
  const int grid = (K + SC_BLOCK - 1) / SC_BLOCK;
  kern<<<grid, SC_BLOCK, 0, s>>>(SC_PASS);
  return (int)cudaGetLastError();
}

// Launches the instantiation of (plane_mode = SC_PLANE_*, with_payload) on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.  `model` is a device copy of a SubstepModel; `plane` and
// `payload` may be null where the mode does not read them.
extern "C" int substep_launch(const void* model_, const float* qpos,
                              const float* qvel, const float* ctrl,
                              const float* plane, const float* payload,
                              float* qpos_out, float* qvel_out, int K,
                              int n_substeps, int plane_mode, int with_payload,
                              void* stream) {
  const SubstepModel* model = (const SubstepModel*)model_;
  cudaStream_t s = (cudaStream_t)stream;
  if (plane_mode == SC_PLANE_FLAT)
    return launch_warp<SC_PLANE_FLAT>(
        with_payload ? substep_payload : substep_flat, SC_PASS, s);
  if (plane_mode == SC_PLANE_LANE)
    return with_payload
               ? launch_thread(substep_plane_payload, SC_PASS, s)
               : launch_warp<SC_PLANE_LANE>(substep_plane, SC_PASS, s);
  if (plane_mode == SC_PLANE_GEOM)
    return with_payload
               ? launch_thread(substep_pergeom_payload, SC_PASS, s)
               : launch_warp<SC_PLANE_GEOM>(substep_pergeom, SC_PASS, s);
  return (int)cudaErrorInvalidValue;
}
