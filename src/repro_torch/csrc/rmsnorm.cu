// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm_fwd (Pallas body `_kernel`).
//   y = x * rsqrt(mean(x^2) + eps) * scale, f32 math, stored in x's dtype;
//   with an rstd buffer (the TPU kernel's save_residuals) also the per-row
//   rsqrt(mean(x^2) + eps) in f32, the one statistic the backward needs.
//
// Bound on the H100: memory.  Each row is read and written once, with a
// handful of operations per element, so the least time is
// rows * d * (in + out bytes) / 3.35 TB/s.
//
// Design: one block of 256 threads per row; each thread moves 16 bytes per
// load and store (8 bf16 or 4 f32 values), so rows must be whole 16-byte
// chunks on 16-byte boundaries (every d_model the port runs is a multiple of
// 8, and activations are fresh contiguous allocations).  The sum of
// squares is reduced in f32 through warp shuffles and a 32-entry shared
// array; the second pass re-reads the row, which the first pass has just
// brought into L1/L2, so device memory still sees one read per element.
// The rstd output adds 4 bytes a row.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, float* __restrict__ rstd_out, int d,
                   float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  uint4* yv = reinterpret_cast<uint4*>(yr);
  float ss = 0.f;
  for (int i = threadIdx.x; i < d / kVec; i += kThreads) {
    uint4 u = xv[i];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      float f = rt::to_f32(e[t]);
      ss += f * f;
    }
  }
  // mean over the real width, as the TPU kernel's d_real
  const float rstd = rsqrtf(rt::block_sum<kThreads>(ss, red) / (float)d + eps);
  if (rstd_out != nullptr && threadIdx.x == 0) rstd_out[row] = rstd;

  for (int i = threadIdx.x; i < d / kVec; i += kThreads) {
    uint4 u = xv[i];
    uint4 o;
    const T* e = reinterpret_cast<const T*>(&u);
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int t = 0; t < kVec; ++t)
      oe[t] = rt::from_f32<T>(rt::to_f32(e[t]) * rstd * scale[i * kVec + t]);
    yv[i] = o;
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* y, float* rstd,
           long long rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(y) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<T><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), rstd, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, d) f32 or bf16, scale (d,) f32, y (rows, d) x's dtype, rstd
// (rows,) f32 or null (not written); all contiguous, x and y 16-byte
// aligned, d a multiple of 16 / sizeof(x).  Returns the CUDA error code of
// the launch (0 = success).
extern "C" int rt_rmsnorm_fwd(const void* x, const void* scale, void* y,
                              void* rstd, long long rows, int d, float eps,
                              int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(x, scale, y, static_cast<float*>(rstd), rows, d,
                           eps, s);
    case rt::kBF16:
      return launch<__nv_bfloat16>(x, scale, y, static_cast<float*>(rstd),
                                   rows, d, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
