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
// Design (rmsnorm_rows.cuh): a persistent grid of about two blocks an SM
// walks the rows, each thread owning the same 16-byte chunks of every row
// (8 bf16 or 4 f32 values; kChunks of them, so d <= kChunks * 256 * 8 for
// bf16), with its scale chunks in registers, loaded once per block.  Rows
// are staged two ahead by cp.async into a ring of shared-memory stages, so
// a block keeps three rows of loads in flight while it reduces and writes
// the row in hand; the row stays in registers from its sum of squares to
// its output.  The sum is reduced in f32 through warp shuffles and one
// barrier.  Rows must be whole 16-byte chunks on 16-byte boundaries (every
// d_model the port runs is a multiple of 8, and activations are fresh
// contiguous allocations).  The rstd output adds 4 bytes a row.
#include <stdint.h>

#include "rmsnorm_rows.cuh"

namespace {

using rn::kStages;
using rn::kThreads;

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, float* __restrict__ rstd_out,
                   long long rows, int d, int rows_per_block, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ uint4 stage[];  // kStages x nvec chunks
  __shared__ float red[rn::kRed];
  const int nvec = d / kVec;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);

  float s[kChunks][kVec];
  const bool aligned = (reinterpret_cast<uintptr_t>(scale) & 15) == 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = threadIdx.x + c * kThreads;
    if (i < nvec) rn::load_scale<kVec>(s[c], scale, i, aligned);
  }
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (r0 + k < r1) rn::stage_row<kChunks>(stage + k * nvec, x + (r0 + k) * d,
                                            nvec);
    mt::cp_async_commit();
  }

  for (long long row = r0; row < r1; ++row) {
    const int it = (int)(row - r0);
    const long long ahead = row + kStages - 1;
    if (ahead < r1)
      rn::stage_row<kChunks>(stage + ((it + kStages - 1) % kStages) * nvec,
                             x + ahead * d, nvec);
    mt::cp_async_commit();
    mt::cp_async_wait<kStages - 1>();  // this row's copies have landed
    const uint4* cur = stage + (it % kStages) * nvec;

    uint4 v[kChunks];
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = threadIdx.x + c * kThreads;
      if (i < nvec) {
        v[c] = cur[i];
        const T* e = reinterpret_cast<const T*>(&v[c]);
#pragma unroll
        for (int t = 0; t < kVec; ++t) {
          const float f = rt::to_f32(e[t]);
          ss += f * f;
        }
      }
    }
    // mean over the real width, as the TPU kernel's d_real
    const float rstd = rsqrtf(rn::row_sum(ss, red, it & 1) / (float)d + eps);
    if (rstd_out != nullptr && threadIdx.x == 0) rstd_out[row] = rstd;

    uint4* yv = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = threadIdx.x + c * kThreads;
      if (i < nvec) {
        uint4 o;
        const T* e = reinterpret_cast<const T*>(&v[c]);
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int t = 0; t < kVec; ++t)
          oe[t] = rt::from_f32<T>(rt::to_f32(e[t]) * rstd * s[c][t]);
        yv[i] = o;
      }
    }
  }
}

template <typename T, int kChunks>
int launch(const void* x, const void* scale, void* y, float* rstd,
           long long rows, int d, int rows_per_block, float eps,
           cudaStream_t stream) {
  static size_t allowed = 0;
  const size_t smem = (size_t)kStages * d * sizeof(T);
  cudaError_t err =
      rn::allow_smem(rmsnorm_kernel<T, kChunks>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_kernel<T, kChunks><<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), rstd, rows, d, rows_per_block, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* scale, void* y, float* rstd,
             long long rows, int d, int rows_per_block, int chunks, float eps,
             cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec != 0 || d / kVec > chunks * kThreads ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  switch (chunks) {
    case 1:
      return launch<T, 1>(x, scale, y, rstd, rows, d, rows_per_block, eps, s);
    case 2:
      return launch<T, 2>(x, scale, y, rstd, rows, d, rows_per_block, eps, s);
    case 4:
      return launch<T, 4>(x, scale, y, rstd, rows, d, rows_per_block, eps, s);
    case 8:
      return launch<T, 8>(x, scale, y, rstd, rows, d, rows_per_block, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (rows, d) f32 or bf16, scale (d,) f32, y (rows, d) x's dtype, rstd
// (rows,) f32 or null (not written); all contiguous, x and y 16-byte
// aligned, d a multiple of 16 / sizeof(x).  Block b normalises rows
// [b * rows_per_block, (b + 1) * rows_per_block); each thread owns
// `chunks` (1, 2, 4 or 8) 16-byte chunks of a row (kernels/rmsnorm_cuda.py
// ::row_plan).  Returns the CUDA error code of the launch (0 = success).
extern "C" int rt_rmsnorm_fwd(const void* x, const void* scale, void* y,
                              void* rstd, long long rows, int d,
                              int rows_per_block, int chunks, float eps,
                              int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || rows_per_block <= 0 ||
      (rows + rows_per_block - 1) / rows_per_block > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  switch (dtype) {
    case rt::kF32:
      return dispatch<float>(x, scale, y, r, rows, d, rows_per_block, chunks,
                             eps, s);
    case rt::kBF16:
      return dispatch<__nv_bfloat16>(x, scale, y, r, rows, d, rows_per_block,
                                     chunks, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
