// CUDA kernels K1-K4: the fused physics substep in each mode of the TPU
// kernel.
//
// Replaces opendog_tpu/ops/pallas_step.py::build_pallas_substep (the
// pl.pallas_call at pallas_step.py:115), which runs n_substeps Featherstone
// substeps per launch for K rollouts laid out as (rows, K).  Its modes are
// different work, so each is its own instantiation and its own entry point:
//   substep_flat            K1  ground z = 0
//   substep_payload         K2  z = 0, a point mass at the trunk origin per
//                               rollout (payload (1, K))
//   substep_plane           K3  one contact plane per rollout (plane (4, K))
//   substep_pergeom         K4  one plane per collision geom and rollout
//                               (plane (4 * ngeom, K))
//   substep_plane_payload   K2 + K3 (the domain-randomised batch)
//   substep_pergeom_payload K2 + K4
// All six run one design, one warp per rollout (substep_warp.cuh).  The
// serial substep of substep_core.cuh (sc_substep) is not built here: it is
// the g++ oracle that the CPU tests hold this design to, bit for bit.
//
// Warp w of a block owns rollout blockIdx.x * W + w (W rollouts per block)
// and its 32 lanes split that rollout's substep into phases with a
// __syncwarp() between two (substep_warp.cuh lists them).  Each rollout's
// working arrays live in dynamic shared memory after the block's copy of
// the model table (SubstepModel, 13,808 B), not in local memory: 19,860 B
// per rollout in the flat modes, 93,248 B per block at W = 4; 23,316 B in
// the plane modes (J.n of every J row besides), 107,072 B per block; two
// blocks (8 warps) per SM either way.  The lane plane or the per-geom
// planes and the payload are loaded into the workspace once per launch.  A
// warp whose rollout is >= K helps copy the table and does nothing else.
// The loop over the substeps runs inside the kernel, so a 10-substep plant
// step (K = 1) is one launch.
//
// What bounds it on an H100: scalar float32 work in short dependency chains
// on a few hundred bytes of state per rollout, each phase behind a
// __syncwarp(); the matrices are 3x3 and 6x6, at most 9 dofs per sphere, so
// wgmma and TMA do not apply (no 64-row tiles, nothing worth a bulk copy).
// One warp is latency-bound, so the time of a launch is its waves of warps
// times a warp's substeps: at the MPPI paths' K = 256 every warp is
// resident at once (256 warps over 132 SMs), and the levers are the
// critical path per substep (a base pair's contact sum over every sphere,
// 78 for Go1, 24 for OpenDOG, is its longest serial stretch; in the plane
// modes each term reads J.n instead of making it).
//
// The batch (K2 + K3 at K = 4096) is the one shape with more warps than
// fit at once, so there shared memory per rollout sets the time: the
// workspace's sphere-indexed arrays are sized by a size class
// (SubstepWorkOf<PLANE, NG>).  With SC_NG_MAX = 96 spheres two blocks of 4
// fit on an SM and 4,096 rollouts take four waves (0.83 ms on an H100);
// the launcher gives a model with at most SC_NG_SMALL = 32 spheres (OpenDOG
// has 24) the plane + payload kernel built for that class (12,308 B per
// rollout) with SC_WARPS_SMALL = 8 rollouts per block: two blocks (16
// warps) per SM, two waves, 0.52 ms (PERF.md).  That is a layout chosen on
// the host from the model, not a fallback.
#include <cuda_runtime.h>

#include "substep_core.cuh"
#include "substep_warp.cuh"

// Rollouts (warps) per block, of 1, 2, 4 and 8 on an H100 (PERF.md,
// measured with scripts/torch_warp_sweep.py, which overrides both constants
// to measure): 4 was the fastest at the K = 256 path shapes and within 1.2%
// of 8 at K = 1; 8 for the batch's small size class, whose K = 4096 it
// takes in two waves where 4 takes three.
#ifndef SC_WARPS
#define SC_WARPS 4
#endif
#ifndef SC_WARPS_SMALL
#define SC_WARPS_SMALL 8
#endif

#define SC_ARGS                                                             \
  const SubstepModel *__restrict__ model, const float *__restrict__ qpos,   \
      const float *__restrict__ qvel, const float *__restrict__ ctrl,       \
      const float *__restrict__ plane, const float *__restrict__ payload,   \
      float *__restrict__ qpos_out, float *__restrict__ qvel_out, int K,    \
      int n_substeps
#define SC_PASS \
  model, qpos, qvel, ctrl, plane, payload, qpos_out, qvel_out, K, n_substeps

// dynamic shared memory of a block: the table, then W workspaces
#define SC_TABLE_BYTES ((sizeof(SubstepModel) + 15) / 16 * 16)
template <int PLANE, int NG, int W>
constexpr size_t sc_warp_smem() {
  return SC_TABLE_BYTES + W * sizeof(SubstepWorkOf<PLANE, NG>);
}

template <int PLANE, bool PAYLOAD, int NG, int W>
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
  const int k = blockIdx.x * W + warp;
  if (k >= K) return;  // the whole warp: the ragged tail of the last block
  SubstepWorkOf<PLANE, NG>& w = reinterpret_cast<SubstepWorkOf<PLANE, NG>*>(
      sc_smem + SC_TABLE_BYTES)[warp];
  scw_load<PLANE, PAYLOAD>(sm, w, lane, qpos, qvel, ctrl, plane, payload, K,
                           k);
  __syncwarp();
  for (int s = 0; s < n_substeps; ++s)
    sc_warp_substep<PLANE, PAYLOAD>(sm, w, lane, false);
  scw_store(sm, w, lane, qpos_out, qvel_out, K, k);
}

// An entry point in size class NG with W rollouts per block.
#define SC_WARP_KERNEL_OF(NAME, PLANE, PAYLOAD, NG, W)                    \
  extern "C" __global__ void __launch_bounds__(SC_LANES*(W)) NAME(SC_ARGS) { \
    substep_warp_body<PLANE, PAYLOAD, NG, W>(SC_PASS);                     \
  }
// An entry point of a mode: every size of model, SC_WARPS per block.
#define SC_WARP_KERNEL(NAME, PLANE, PAYLOAD) \
  SC_WARP_KERNEL_OF(NAME, PLANE, PAYLOAD, SC_NG_MAX, SC_WARPS)

SC_WARP_KERNEL(substep_flat, SC_PLANE_FLAT, false)
SC_WARP_KERNEL(substep_payload, SC_PLANE_FLAT, true)
SC_WARP_KERNEL(substep_plane, SC_PLANE_LANE, false)
SC_WARP_KERNEL(substep_pergeom, SC_PLANE_GEOM, false)
SC_WARP_KERNEL(substep_plane_payload, SC_PLANE_LANE, true)
SC_WARP_KERNEL(substep_pergeom_payload, SC_PLANE_GEOM, true)
// the batch's kernel for models with at most SC_NG_SMALL spheres
SC_WARP_KERNEL_OF(substep_plane_payload_small, SC_PLANE_LANE, true,
                  SC_NG_SMALL, SC_WARPS_SMALL)

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

typedef void (*SubstepKernel)(SC_ARGS);

// A kernel with its launch shape: W rollouts per block, dynamic shared
// memory per block [B], and the name of its entry point.
struct WarpKernel {
  SubstepKernel fn;
  int warps;
  size_t smem;
  const char* name;
};

template <int PLANE, int NG, int W>
static WarpKernel warp_kernel(SubstepKernel fn, const char* name) {
  return {fn, W, sc_warp_smem<PLANE, NG, W>(), name};
}
// an entry point and its name
#define SC_ENTRY(NAME) NAME, #NAME

// The kernel of (plane_mode = SC_PLANE_*, with_payload) for a model with
// `ngeom` collision spheres (a larger value picks the larger size class);
// fn is null for an unknown mode.
static WarpKernel pick_kernel(int plane_mode, int with_payload, int ngeom) {
  if (plane_mode == SC_PLANE_FLAT && with_payload)
    return warp_kernel<SC_PLANE_FLAT, SC_NG_MAX, SC_WARPS>(
        SC_ENTRY(substep_payload));
  if (plane_mode == SC_PLANE_FLAT)
    return warp_kernel<SC_PLANE_FLAT, SC_NG_MAX, SC_WARPS>(
        SC_ENTRY(substep_flat));
  if (plane_mode == SC_PLANE_LANE && !with_payload)
    return warp_kernel<SC_PLANE_LANE, SC_NG_MAX, SC_WARPS>(
        SC_ENTRY(substep_plane));
  if (plane_mode == SC_PLANE_LANE && ngeom <= SC_NG_SMALL)
    return warp_kernel<SC_PLANE_LANE, SC_NG_SMALL, SC_WARPS_SMALL>(
        SC_ENTRY(substep_plane_payload_small));
  if (plane_mode == SC_PLANE_LANE)
    return warp_kernel<SC_PLANE_LANE, SC_NG_MAX, SC_WARPS>(
        SC_ENTRY(substep_plane_payload));
  if (plane_mode == SC_PLANE_GEOM && with_payload)
    return warp_kernel<SC_PLANE_GEOM, SC_NG_MAX, SC_WARPS>(
        SC_ENTRY(substep_pergeom_payload));
  if (plane_mode == SC_PLANE_GEOM)
    return warp_kernel<SC_PLANE_GEOM, SC_NG_MAX, SC_WARPS>(
        SC_ENTRY(substep_pergeom));
  return {nullptr, 0, 0, nullptr};
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
static cudaError_t opt_in(const WarpKernel& k) {
  if (k.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)k.fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)k.smem);
}

extern "C" int substep_model_size() { return (int)sizeof(SubstepModel); }

// Rollouts per block, dynamic shared memory per block [B], and blocks
// resident per SM on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the kernel that
// substep_launch picks for these arguments; -1 for an unknown mode or a
// CUDA error.
extern "C" int substep_warps_per_block(int plane_mode, int with_payload,
                                       int ngeom) {
  const WarpKernel k = pick_kernel(plane_mode, with_payload, ngeom);
  return k.fn ? k.warps : -1;
}
// The name of that kernel's entry point (the plane + payload mode's
// "substep_plane_payload_small" for a model within SC_NG_SMALL spheres);
// null for an unknown mode.
extern "C" const char* substep_entry(int plane_mode, int with_payload,
                                     int ngeom) {
  return pick_kernel(plane_mode, with_payload, ngeom).name;
}
extern "C" int substep_warp_smem_bytes(int plane_mode, int with_payload,
                                       int ngeom) {
  const WarpKernel k = pick_kernel(plane_mode, with_payload, ngeom);
  return k.fn ? (int)k.smem : -1;
}
extern "C" int substep_warp_occupancy(int plane_mode, int with_payload,
                                      int ngeom) {
  const WarpKernel k = pick_kernel(plane_mode, with_payload, ngeom);
  int blocks = 0;
  if (!k.fn || opt_in(k) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, (const void*)k.fn, SC_LANES * k.warps, k.smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// Launches the kernel of (plane_mode = SC_PLANE_*, with_payload) for a
// model of `ngeom` spheres on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise.  `model` is a device copy of the model's
// SubstepModel; `plane` and `payload` may be null where the mode does not
// read them.
extern "C" int substep_launch(const void* model_, const float* qpos,
                              const float* qvel, const float* ctrl,
                              const float* plane, const float* payload,
                              float* qpos_out, float* qvel_out, int K,
                              int n_substeps, int plane_mode, int with_payload,
                              int ngeom, void* stream) {
  const SubstepModel* model = (const SubstepModel*)model_;
  const WarpKernel k = pick_kernel(plane_mode, with_payload, ngeom);
  if (!k.fn) return (int)cudaErrorInvalidValue;
  const cudaError_t e = opt_in(k);
  if (e != cudaSuccess) return (int)e;
  const int grid = (K + k.warps - 1) / k.warps;
  k.fn<<<grid, SC_LANES * k.warps, k.smem, (cudaStream_t)stream>>>(SC_PASS);
  return (int)cudaGetLastError();
}
