// The row pipeline shared by the RMSNorm forward and backward kernels
// (rmsnorm.cu, rmsnorm_bwd.cu).
//
// A persistent grid of about two blocks an SM (kernels/rmsnorm_cuda.py::
// row_plan) walks the rows: block b takes rows [b * per, (b + 1) * per).
// Each of a block's kThreads threads owns the same 16-byte column chunks
// in every row (chunk i = threadIdx.x + c * kThreads, c < kChunks), so it
// loads its scale chunks once, as float4s, and keeps them in registers.
// Rows arrive through a ring of kStages shared-memory stages filled by
// 16-byte cp.async copies, kStages - 1 rows ahead of the row in hand:
// every thread copies and later reads only its own chunks, so a stage
// needs no barrier, only the thread's own cp.async.wait_group.  The row in
// hand stays in registers from its sum to its output, so every element is
// read from device memory once.  The one block reduction a row costs a
// single barrier: consecutive rows write their warp sums to alternate
// halves of `red`.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace rn {

constexpr int kThreads = 256;
constexpr int kStages = 3;      // the row in hand and two rows in flight
constexpr int kRed = 2 * 32;    // floats of the reduction scratch

// this thread's scale chunk i (kVec floats) into registers; float4 loads
// where the vector is 16-byte aligned
template <int kVec>
__device__ __forceinline__ void load_scale(float (&s)[kVec],
                                           const float* __restrict__ scale,
                                           int i, bool aligned) {
  if (aligned) {
    const float4* p = reinterpret_cast<const float4*>(scale + i * kVec);
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const float4 f = p[q];
      s[4 * q] = f.x;
      s[4 * q + 1] = f.y;
      s[4 * q + 2] = f.z;
      s[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < kVec; ++t) s[t] = scale[i * kVec + t];
  }
}

// issue the copies of this thread's chunks of one row into a stage of
// nvec 16-byte chunks
template <int kChunks>
__device__ __forceinline__ void stage_row(uint4* dst, const void* row,
                                          int nvec) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = threadIdx.x + c * kThreads;
    if (i < nvec) mt::cp_async16(mt::smem_u32(dst + i), src + i, true);
  }
}

// The sum of v over the block, the same value in every thread, with one
// barrier: row parity p writes its warp sums to red[32 p ...].  A thread
// reuses a half only two rows later, after the next row's barrier, which
// every thread reaches only when it has read this row's sums.
__device__ __forceinline__ float row_sum(float v, float* red, int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = rt::warp_sum(v);
  float* r = red + 32 * parity;
  if (lane == 0) r[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += r[w];
  return t;
}

// Allow `smem` bytes of dynamic shared memory for `kernel` beside its
// static arrays (the default allows 48 KB for both together); once for each
// size it grows to, since the attribute is a driver call.
template <typename K>
inline cudaError_t allow_smem(K* kernel, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *allowed = smem;
  return err;
}

}  // namespace rn
