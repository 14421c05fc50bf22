// Shared device helpers for the port's hand-written Hopper kernels:
// dtype codes of the C interface, f32 <-> storage conversions, warp and
// block reductions and the masking constants of the TPU kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rt {

// dtype codes passed through the C interface (kernels/build.py mirrors
// them); int8 is a KV-cache type only, always with per-row f32 scales
enum DType : int { kF32 = 0, kBF16 = 1, kInt8 = 2 };

// Masking constants of the TPU kernels (decode_attention.py:40,95;
// flash_attention.py:33,260): a finite "minus infinity", so a row with no
// valid key yields the finite mean of v instead of NaN, and a floor on the
// softmax denominator.  Never -inf.
constexpr float kNeg = -1e30f;
constexpr float kLFloor = 1e-30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over a block of kThreads threads; every thread gets the total.
// `red` is 32 floats of shared memory; the trailing barrier frees it for
// the block's next call.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kThreads / 32 ? red[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();
  return t;
}

}  // namespace rt
