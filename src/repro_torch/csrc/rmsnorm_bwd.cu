// RMSNorm backward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm_bwd (Pallas body
//   `_bwd_kernel`).  From the forward's saved per-row r = rstd:
//     dx     = r * (dy * s - x * r^2 * mean(dy * s * x))     (x's dtype)
//     dscale = sum over rows of dy * x * r                    (f32)
//   f32 math throughout, in the TPU kernel's order of operations.
//
// Bound on the H100: memory.  x and dy are read once and dx written once,
// rows * d * 3 * itemsize bytes over 3.35 TB/s; the operations are a
// handful per element.  The dscale partials add n_blocks * d * 4 bytes
// written here and read once by the wrapper's sum (8 MB at the train shape,
// about 8 % of the rows' 100 MB).
//
// Design: one block of 256 threads per group of `rows_per_block`
// consecutive rows, walking them one row at a time as the forward does:
// the whole block reduces one row's mean(dy * s * x) through warp shuffles,
// then writes that row's dx with 16-byte stores.  Each thread owns the
// same columns in every row, so it sums dy * x * r for its columns over the
// block's rows in shared memory, without atomics, and the block writes its
// row of the (n_blocks, d) dscale partials; the wrapper adds the rows with
// one torch.sum, as the TPU wrapper sums its per-block partials outside the
// kernel.  Nothing depends on the order blocks run in, so the result is the
// same in every run.  The wrapper picks rows_per_block so that there are
// about four blocks per SM.  The second pass over a row re-reads x and dy,
// which the first has just brought into L1/L2.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ scale,
                       const float* __restrict__ rstd, T* __restrict__ dx,
                       float* __restrict__ dscale_part, long long rows, int d,
                       int rows_per_block) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float dscale_acc[];  // d floats: this block's partial
  __shared__ float red[32];
  const int nvec = d / kVec;
  // each thread zeroes, updates and stores only its own columns
  for (int i = threadIdx.x; i < nvec; i += kThreads)
#pragma unroll
    for (int t = 0; t < kVec; ++t) dscale_acc[i * kVec + t] = 0.f;

  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(rows, r_begin + rows_per_block);
  for (long long row = r_begin; row < r_end; ++row) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* dyv = reinterpret_cast<const uint4*>(dy + row * d);
    uint4* dxv = reinterpret_cast<uint4*>(dx + row * d);

    float part = 0.f;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 ux = xv[i], ud = dyv[i];
      const T* ex = reinterpret_cast<const T*>(&ux);
      const T* ed = reinterpret_cast<const T*>(&ud);
#pragma unroll
      for (int t = 0; t < kVec; ++t)
        part += rt::to_f32(ed[t]) * scale[i * kVec + t] * rt::to_f32(ex[t]);
    }
    // mean over the real width, as the TPU kernel's d_real
    const float c = rt::block_sum<kThreads>(part, red) / (float)d;
    const float r = rstd[row];

    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 ux = xv[i], ud = dyv[i];
      uint4 o;
      const T* ex = reinterpret_cast<const T*>(&ux);
      const T* ed = reinterpret_cast<const T*>(&ud);
      T* eo = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        const float xf = rt::to_f32(ex[t]), dyf = rt::to_f32(ed[t]);
        const float dys = dyf * scale[i * kVec + t];
        eo[t] = rt::from_f32<T>((dys - xf * (r * r) * c) * r);
        dscale_acc[i * kVec + t] += dyf * xf * r;
      }
      dxv[i] = o;
    }
  }
  float* out = dscale_part + (long long)blockIdx.x * d;
  for (int i = threadIdx.x; i < nvec; i += kThreads)
#pragma unroll
    for (int t = 0; t < kVec; ++t)
      out[i * kVec + t] = dscale_acc[i * kVec + t];
}

template <typename T>
int launch(const void* x, const void* dy, const void* scale, const void* rstd,
           void* dx, void* dscale_part, long long rows, int d,
           int rows_per_block, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec != 0 || ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)d;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_bwd_kernel<T><<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(scale), static_cast<const float*>(rstd),
      static_cast<T*>(dx), static_cast<float*>(dscale_part), rows, d,
      rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx (rows, d) in one dtype (f32 or bf16); scale (d,) f32; rstd
// (rows,) f32; dscale_part (ceil(rows / rows_per_block), d) f32.  All
// contiguous, x, dy and dx 16-byte aligned, d a multiple of
// 16 / sizeof(x).  Returns the CUDA error code of the launch.
extern "C" int rt_rmsnorm_bwd(const void* x, const void* dy,
                              const void* scale, const void* rstd, void* dx,
                              void* dscale_part, long long rows, int d,
                              int rows_per_block, int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || rows_per_block <= 0 ||
      (rows + rows_per_block - 1) / rows_per_block > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(x, dy, scale, rstd, dx, dscale_part, rows, d,
                           rows_per_block, s);
    case rt::kBF16:
      return launch<__nv_bfloat16>(x, dy, scale, rstd, dx, dscale_part, rows,
                                   d, rows_per_block, s);
  }
  return (int)cudaErrorInvalidValue;
}
