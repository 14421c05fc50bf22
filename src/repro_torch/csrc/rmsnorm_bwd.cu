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
// written once and read once (at most 2 x 132 rows: 4.3 MB at the train
// shape, about 4 % of the rows' 100 MB).
//
// Design (rmsnorm_rows.cuh): a persistent grid of about two blocks an SM,
// block b walking rows [b * per, (b + 1) * per) in order.  Each thread owns
// the same 16-byte column chunks of every row, holds its scale chunks and
// its share of the block's dscale partial in registers (16 floats each at
// d = 4096 in bf16), and stages x and dy of the rows two ahead by cp.async
// into a ring of shared-memory stages.  A row's x and dy stay in registers
// between the reduction of mean(dy * s * x) (one barrier) and the pass
// that writes dx and adds dy * x * r to the partial.  At the end each block
// writes its partial, one row of (n_blocks, d).  A second launch adds the
// rows, as the TPU wrapper sums its block partials outside the kernel:
// each lane owns a float4 column, 32 warps each add a run of consecutive
// rows in order (8 at the train shape, all loads in flight at once), then
// the 32 sums are added in order.  No atomics, so the result is the same
// in every run.  (torch.sum over the 256 partial rows of the train shape
// took about a third of the whole call on an H100: chip_rmsnorm_sweep.py.)
#include <stdint.h>

#include "rmsnorm_rows.cuh"

namespace {

using rn::kStages;
using rn::kThreads;

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ scale,
                       const float* __restrict__ rstd, T* __restrict__ dx,
                       float* __restrict__ dscale_part, long long rows, int d,
                       int rows_per_block) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ uint4 stage[];  // kStages x (x, dy) x nvec chunks
  __shared__ float red[rn::kRed];
  const int nvec = d / kVec;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);

  float s[kChunks][kVec], acc[kChunks][kVec];
  const bool aligned = (reinterpret_cast<uintptr_t>(scale) & 15) == 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = threadIdx.x + c * kThreads;
    if (i < nvec) rn::load_scale<kVec>(s[c], scale, i, aligned);
#pragma unroll
    for (int t = 0; t < kVec; ++t) acc[c][t] = 0.f;
  }
  auto issue = [&](long long row, int slot) {
    uint4* st = stage + slot * 2 * nvec;
    rn::stage_row<kChunks>(st, x + row * d, nvec);
    rn::stage_row<kChunks>(st + nvec, dy + row * d, nvec);
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (r0 + k < r1) issue(r0 + k, k);
    mt::cp_async_commit();
  }

  for (long long row = r0; row < r1; ++row) {
    const int it = (int)(row - r0);
    const long long ahead = row + kStages - 1;
    if (ahead < r1) issue(ahead, (it + kStages - 1) % kStages);
    mt::cp_async_commit();
    const float r = rstd[row];
    mt::cp_async_wait<kStages - 1>();  // this row's copies have landed
    const uint4* cx = stage + (it % kStages) * 2 * nvec;
    const uint4* cd = cx + nvec;

    uint4 vx[kChunks], vd[kChunks];
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = threadIdx.x + c * kThreads;
      if (i < nvec) {
        vx[c] = cx[i];
        vd[c] = cd[i];
        const T* ex = reinterpret_cast<const T*>(&vx[c]);
        const T* ed = reinterpret_cast<const T*>(&vd[c]);
#pragma unroll
        for (int t = 0; t < kVec; ++t)
          part += rt::to_f32(ed[t]) * s[c][t] * rt::to_f32(ex[t]);
      }
    }
    // mean over the real width, as the TPU kernel's d_real
    const float m = rn::row_sum(part, red, it & 1) / (float)d;

    uint4* dxv = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = threadIdx.x + c * kThreads;
      if (i < nvec) {
        uint4 o;
        const T* ex = reinterpret_cast<const T*>(&vx[c]);
        const T* ed = reinterpret_cast<const T*>(&vd[c]);
        T* eo = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int t = 0; t < kVec; ++t) {
          const float xf = rt::to_f32(ex[t]), dyf = rt::to_f32(ed[t]);
          const float dys = dyf * s[c][t];
          eo[t] = rt::from_f32<T>((dys - xf * (r * r) * m) * r);
          acc[c][t] += dyf * xf * r;
        }
        dxv[i] = o;
      }
    }
  }

  float4* out =
      reinterpret_cast<float4*>(dscale_part + (long long)blockIdx.x * d);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = threadIdx.x + c * kThreads;
    if (i < nvec) {
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q)
        out[i * (kVec / 4) + q] =
            make_float4(acc[c][4 * q], acc[c][4 * q + 1], acc[c][4 * q + 2],
                        acc[c][4 * q + 3]);
    }
  }
}

constexpr int kSumWarps = 32;

// dscale (d,) = the sum of the n rows of part (n, d), d / 4 float4 columns
// (ncol4), 32 columns a block of kSumWarps warps
__global__ void __launch_bounds__(kSumWarps * 32)
    dscale_sum_kernel(const float4* __restrict__ part,
                      float4* __restrict__ dscale, int n, int ncol4) {
  __shared__ float4 sums[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int per = (n + kSumWarps - 1) / kSumWarps;
  const int r1 = min(n, (warp + 1) * per);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < ncol4) {
    constexpr int kUnroll = 8;  // loads in flight before the ordered adds
    int r = warp * per;
    for (; r + kUnroll <= r1; r += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = part[(long long)(r + u) * ncol4 + col];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s.x += v[u].x;
        s.y += v[u].y;
        s.z += v[u].z;
        s.w += v[u].w;
      }
    }
    for (; r < r1; ++r) {
      const float4 v = part[(long long)r * ncol4 + col];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < ncol4) {
#pragma unroll
    for (int w = 1; w < kSumWarps; ++w) {
      s.x += sums[w][lane].x;
      s.y += sums[w][lane].y;
      s.z += sums[w][lane].z;
      s.w += sums[w][lane].w;
    }
    dscale[col] = s;
  }
}

template <typename T, int kChunks>
int launch(const void* x, const void* dy, const void* scale, const void* rstd,
           void* dx, void* dscale_part, void* dscale, long long rows, int d,
           int rows_per_block, cudaStream_t stream) {
  static size_t allowed = 0;
  const size_t smem = (size_t)kStages * 2 * d * sizeof(T);
  cudaError_t err =
      rn::allow_smem(rmsnorm_bwd_kernel<T, kChunks>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_bwd_kernel<T, kChunks>
      <<<(unsigned)n_blocks, kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy),
          static_cast<const float*>(scale), static_cast<const float*>(rstd),
          static_cast<T*>(dx), static_cast<float*>(dscale_part), rows, d,
          rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ncol4 = d / 4;
  dscale_sum_kernel<<<(ncol4 + 31) / 32, kSumWarps * 32, 0, stream>>>(
      static_cast<const float4*>(dscale_part), static_cast<float4*>(dscale),
      (int)n_blocks, ncol4);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dy, const void* scale,
             const void* rstd, void* dx, void* part, void* dscale,
             long long rows, int d, int rows_per_block, int chunks,
             cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec != 0 || d / kVec > chunks * kThreads ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
        reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(part) |
        reinterpret_cast<uintptr_t>(dscale)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  switch (chunks) {
    case 1:
      return launch<T, 1>(x, dy, scale, rstd, dx, part, dscale, rows, d,
                          rows_per_block, s);
    case 2:
      return launch<T, 2>(x, dy, scale, rstd, dx, part, dscale, rows, d,
                          rows_per_block, s);
    case 4:
      return launch<T, 4>(x, dy, scale, rstd, dx, part, dscale, rows, d,
                          rows_per_block, s);
    case 8:
      return launch<T, 8>(x, dy, scale, rstd, dx, part, dscale, rows, d,
                          rows_per_block, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx (rows, d) in one dtype (f32 or bf16); scale (d,) f32; rstd
// (rows,) f32; dscale_part (ceil(rows / rows_per_block), d) f32 scratch;
// dscale (d,) f32.  All contiguous, x, dy, dx, dscale_part and dscale
// 16-byte aligned, d a multiple of 16 / sizeof(x).  Block b takes rows
// [b * rows_per_block, (b + 1) * rows_per_block) and writes partial row b;
// each thread owns `chunks` (1, 2, 4 or 8) 16-byte chunks of a row
// (kernels/rmsnorm_cuda.py::row_plan); a second launch sums the partial
// rows into dscale.  With no rows nothing is launched and dscale is left
// as it is.  Returns the CUDA error code of the launches.
extern "C" int rt_rmsnorm_bwd(const void* x, const void* dy,
                              const void* scale, const void* rstd, void* dx,
                              void* dscale_part, void* dscale, long long rows,
                              int d, int rows_per_block, int chunks,
                              int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || rows_per_block <= 0 ||
      (rows + rows_per_block - 1) / rows_per_block > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return dispatch<float>(x, dy, scale, rstd, dx, dscale_part, dscale,
                             rows, d, rows_per_block, chunks, s);
    case rt::kBF16:
      return dispatch<__nv_bfloat16>(x, dy, scale, rstd, dx, dscale_part,
                                     dscale, rows, d, rows_per_block, chunks,
                                     s);
  }
  return (int)cudaErrorInvalidValue;
}
