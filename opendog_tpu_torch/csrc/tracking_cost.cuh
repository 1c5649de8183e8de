// The tracking cost of the MPPI rollouts for one lane at one control step.
//
// Replaces the torch ops of opendog_tpu_torch/solvers/costs.py::
// tracking_cost's step cost (and so standing_cost's) where
// solvers/mppi.py::rollout_costs_kernel runs it on the substep kernel's
// carry: ~57 kernels of a few hundred lanes each per control step become
// one launch of rollout_tracking_cost (substep_kernel.cu), one thread a
// lane, which reads the carry's (rows, L) layout in place and adds the
// step's discounted cost into the running total.
//
// The arithmetic follows the op path operation by operation, in its order:
// quat_to_ypr's roll and pitch (its yaw feeds no term), the seven terms,
// and their sum from left to right.  The two sums over an axis (the joint
// posture over qpos[7:], the control rate over nu) add their terms in the
// order of PyTorch's CUDA reduction for the layout the op path gives them
// (tc_sum_outer, tc_sum_inner), so that on the card the cost rounds as the
// op path does.  That order is PyTorch's (2.11 on an H100), read off the
// card, not a documented contract: tests/test_torch_gpu.py::
// test_cost_kernel_rollout_total_matches_op_path holds the kernel to the
// op path bit for bit at 8 joints and controls (OpenDOG) and at 12 (Go1),
// and chip_smoke.py's [check] does at every lane count its paths launch.
// atan2f and asinf are CUDA's on the card, as PyTorch's are
// there; libm's in the host build.  A NaN or Inf in the state reaches the
// cost as it reaches the op path's: the clamp of sin(pitch) lets NaN
// through, as torch.clamp does.
//
// Plain C++ with __host__ __device__ functions, like substep_core.cuh:
// nvcc builds it into the kernel, g++ into the host library
// (substep_host.cpp, tracking_cost_host), the CPU tests' oracle.
#pragma once

#include <math.h>

#include "substep_core.cuh"

#define TC_MAGIC 0x54434331

// The cost's constants, one entry per line as SUBSTEP_MODEL_FIELDS: the
// Python wrapper (ops/cuda_step.py::tracking_cost_table) builds the
// matching ctypes structure from this list.  nj = nq - 7 joints follow the
// free base; home_j holds their home positions.
#define TRACKING_COST_FIELDS(INT, FLT, INTS, FLTS) \
  INT(magic)                                       \
  INT(nq)                                          \
  INT(nv)                                          \
  INT(nu)                                          \
  FLT(w_vel)                                       \
  FLT(w_yaw_rate)                                  \
  FLT(w_height)                                    \
  FLT(w_upright)                                   \
  FLT(w_joint_posture)                             \
  FLT(w_ctrl_rate)                                 \
  FLT(w_lateral)                                   \
  FLTS(desired_vel, 2)                             \
  FLT(desired_yaw_rate)                            \
  FLT(target_height)                               \
  FLTS(home_j, SC_NQ_MAX)

struct TrackingCost {
  TRACKING_COST_FIELDS(SC_DECL_INT, SC_DECL_FLT, SC_DECL_INTS, SC_DECL_FLTS)
};

// torch.sum(x, dim=-1) of (L, n) terms whose reduced axis is not the
// fastest (the op path's qpos[..., 7:] - home_j, a view of the carry's
// (nq, L) rows): each CUDA thread sums one output's n terms into four
// accumulators, term i into accumulator i % 4, then adds the four in order.
SC_HD float tc_sum_outer(const float* x, int n) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < n; ++i) acc[i % 4] = acc[i % 4] + x[i];
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

// The same over the fastest axis (the op path's ctrl - prev_ctrl, rows of
// the (L, H, nu) candidates): a row of w threads, w the largest power of two
// <= n (at most 32), thread t adding terms t, t + w, ... into four
// accumulators as above, then a shuffle tree in which thread t adds thread
// t + off's partial at offsets w / 2, w / 4, ..., 1.
SC_HD float tc_sum_inner(const float* x, int n) {
  int w = 1;
  while (2 * w <= n && 2 * w <= 32) w *= 2;
  float part[32];
  for (int t = 0; t < w; ++t) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = t, j = 0; i < n; i += w, ++j) acc[j % 4] = acc[j % 4] + x[i];
    part[t] = ((acc[0] + acc[1]) + acc[2]) + acc[3];
  }
  for (int off = w / 2; off > 0; off /= 2)
    for (int t = 0; t < off; ++t) part[t] = part[t] + part[t + off];
  return part[0];
}

// The step cost of lane l: qpos (nq, L), qvel (nv, L), ctrl and prev
// (nu, L), row-major, as the substep kernels lay out the carry.
SC_HD float tc_step_cost(const TrackingCost& p, const float* qpos,
                         const float* qvel, const float* ctrl,
                         const float* prev, int L, int l) {
  // quat_to_ypr's roll and pitch (physics/spatial.py)
  const float q0 = qpos[3 * L + l], q1 = qpos[4 * L + l];
  const float q2 = qpos[5 * L + l], q3 = qpos[6 * L + l];
  const float sinr_cosp = 2.0f * (q0 * q1 + q2 * q3);
  const float cosr_cosp = 1.0f - 2.0f * (q1 * q1 + q2 * q2);
  const float roll = atan2f(sinr_cosp, cosr_cosp);
  float sinp = 2.0f * (q0 * q2 - q3 * q1);
  sinp = sinp < -1.0f ? -1.0f : sinp > 1.0f ? 1.0f : sinp;  // NaN stays
  const float pitch = asinf(sinp);

  const float vx = qvel[l] - p.desired_vel[0];
  const float vy = qvel[L + l] - p.desired_vel[1];
  const float c_vel = p.w_vel * (vx * vx + vy * vy);
  const float yr = qvel[5 * L + l] - p.desired_yaw_rate;
  const float c_yaw = p.w_yaw_rate * (yr * yr);
  const float dz = qpos[2 * L + l] - p.target_height;
  const float c_h = p.w_height * (dz * dz);
  const float c_up = p.w_upright * (roll * roll + pitch * pitch);
  float sq[SC_NQ_MAX];
  const int nj = p.nq - 7;
  for (int j = 0; j < nj; ++j) {
    const float d = qpos[(7 + j) * L + l] - p.home_j[j];
    sq[j] = d * d;
  }
  const float c_post = p.w_joint_posture * tc_sum_outer(sq, nj);
  for (int i = 0; i < p.nu; ++i) {
    const float d = ctrl[i * L + l] - prev[i * L + l];
    sq[i] = d * d;
  }
  const float c_rate = p.w_ctrl_rate * tc_sum_inner(sq, p.nu);
  const float wy = qvel[L + l];
  const float c_lat = p.w_lateral * (wy * wy);
  return c_vel + c_yaw + c_h + c_up + c_post + c_rate + c_lat;
}

// total[l] = c * disc at the first step (accumulate == 0), total[l] + c *
// disc after it: the op path's `c = cost * disc; total = c if total is None
// else total + c`.
SC_HD void tc_add_step(const TrackingCost& p, const float* qpos,
                       const float* qvel, const float* ctrl,
                       const float* prev, float* total, int L, int l,
                       float disc, int accumulate) {
  const float c = tc_step_cost(p, qpos, qvel, ctrl, prev, L, l) * disc;
  total[l] = accumulate ? total[l] + c : c;
}
