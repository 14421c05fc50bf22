// Shared-RMSProp update (paper Eq. 8-9) for Hopper (sm_90a), over many
// parameter leaves in one launch.
//
// Replaces: src/repro/kernels/shared_rmsprop.py::rmsprop_update_2d (Pallas
//   body `_kernel`).  Per element of a parameter leaf, in f32:
//     g'  = alpha * g + (1 - alpha) * grad^2
//     upd = lr * grad / sqrt(g' + eps)
//   The TPU kernel multiplies by rsqrt; this kernel divides by an IEEE
//   sqrt, as the reference's unfused optimizer and the plain version do.
//   Every product, sum, root and quotient is rounded on its own (the _rn
//   intrinsics: nvcc contracts nothing into an FMA), in the plain
//   version's order, so both modes below give the same bits as the update
//   mode followed by a separate p - upd.
//
// Two modes of one body.  Update mode writes g' over g and upd to its own
// buffer (the optimizer API that returns updates).  Apply mode writes g'
// over g and p - upd over the parameter p, and never stores upd.
//
// Bound on the H100: memory.  Update mode moves 16 bytes an element (read
// g and grad, write g' and upd), apply mode 20 (read g, grad and p, write
// g' and p), over 3.35 TB/s, with a handful of operations an element.
// Apply mode saves the 12 bytes an element that a separate subtraction
// pays (read upd and p, write p) and its launch.
//
// Design: the leaves of one update (up to kMaxLeaves a launch) travel by
// value in the kernel's parameter block (a __grid_constant__ table of
// pointers, sizes and first blocks; 2.3 KB of the 4 KB limit), so a launch
// needs no host-to-device copy.  Each leaf owns ceil(n / kSpan) blocks of
// kSpan elements, one float4 a thread; a block finds its leaf by a binary
// search over the first blocks, and the last, partial chunk of four is
// masked (any element count works, one element included).  No loop: a
// thread holds 32-odd registers, so eight blocks an SM keep their loads
// in flight, and a large leaf simply has many blocks.  A worker update of
// the paper's network (13 leaves) is one launch instead of 13 updates and
// 13 subtractions; a train step's 148 leaves take three.  lr, alpha and
// 1 - alpha arrive by value as host floats, so no device scalar is read
// and the host never waits.  g and p are each read and then written by
// the same thread, in place.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = kThreads * 4;   // elements a block: a float4 a thread
constexpr int kMaxLeaves = 64;

struct LeafTable {
  float* g[kMaxLeaves];
  const float* grad[kMaxLeaves];
  float* out[kMaxLeaves];        // upd (update mode) or p (apply mode)
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];     // first block of each leaf; [count] = all
  int count;
};
static_assert(sizeof(LeafTable) + 16 <= 4096,
              "the leaf table must fit the kernel parameter block");

template <bool kApply>
__global__ void __launch_bounds__(kThreads)
    rmsprop_kernel(const __grid_constant__ LeafTable t, float lr,
                   float alpha, float one_minus_alpha, float eps) {
  const int blk = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // the last leaf whose first block <= blk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= blk)
      lo = mid;
    else
      hi = mid - 1;
  }
  float* const g = t.g[lo];
  const float* const grad = t.grad[lo];
  float* const out = t.out[lo];
  const long long n = t.n[lo];
  // this thread's chunk of four elements
  const long long c = (long long)(blk - t.first[lo]) * kThreads + threadIdx.x;
  const long long e = c * 4;
  if (e >= n) return;
  const bool whole = e + 4 <= n;
  float4 gv, dv, pv;
  if (whole) {
    gv = reinterpret_cast<const float4*>(g)[c];
    dv = reinterpret_cast<const float4*>(grad)[c];
    if constexpr (kApply) pv = reinterpret_cast<const float4*>(out)[c];
  } else {  // the last, partial chunk
    float* gp = &gv.x;
    float* dp = &dv.x;
    float* pp = &pv.x;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      gp[u] = e + u < n ? g[e + u] : 0.f;
      dp[u] = e + u < n ? grad[e + u] : 0.f;
      pp[u] = kApply && e + u < n ? out[e + u] : 0.f;
    }
  }
  const float* gp = &gv.x;
  const float* dp = &dv.x;
  const float* pp = &pv.x;
  float4 ng, ov;
  float* ngp = &ng.x;
  float* ovp = &ov.x;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    ngp[u] = __fadd_rn(__fmul_rn(alpha, gp[u]),
                       __fmul_rn(one_minus_alpha, __fmul_rn(dp[u], dp[u])));
    const float up = __fdiv_rn(__fmul_rn(lr, dp[u]),
                               __fsqrt_rn(__fadd_rn(ngp[u], eps)));
    ovp[u] = kApply ? __fsub_rn(pp[u], up) : up;
  }
  if (whole) {
    reinterpret_cast<float4*>(g)[c] = ng;
    reinterpret_cast<float4*>(out)[c] = ov;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e + u < n) {
        g[e + u] = ngp[u];
        out[e + u] = ovp[u];
      }
    }
  }
}

}  // namespace

// The leaves of one launch: `count` rows of five int64 each in host
// memory, (g, grad, out, n, first block) as kernels/rmsprop_cuda.py::plan
// lays them out; `blocks` is the launch's total.  g, grad and out of each
// leaf: n f32 each, contiguous and 16-byte aligned; out is the update
// (apply = 0) or the parameter (apply = 1).  g and out are written in
// place.  Returns the CUDA error code of the launch.
extern "C" int rt_rmsprop_multi(const long long* table, int count,
                                int blocks, int apply, float lr, float alpha,
                                float one_minus_alpha, float eps,
                                void* stream) {
  if (count <= 0 || blocks <= 0) return 0;
  if (count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  LeafTable t;
  for (int i = 0; i < count; ++i) {
    const long long* row = table + 5 * i;
    if (((uint64_t)row[0] | (uint64_t)row[1] | (uint64_t)row[2]) & 15)
      return (int)cudaErrorInvalidValue;  // each leaf on 16 bytes
    t.g[i] = reinterpret_cast<float*>(row[0]);
    t.grad[i] = reinterpret_cast<const float*>(row[1]);
    t.out[i] = reinterpret_cast<float*>(row[2]);
    t.n[i] = row[3];
    t.first[i] = (int)row[4];
  }
  t.first[count] = blocks;
  for (int i = 0; i < count; ++i)  // each leaf's blocks cover it exactly
    if (t.n[i] <= 0 || t.first[0] != 0 ||
        t.first[i + 1] - t.first[i] != (t.n[i] + kSpan - 1) / kSpan)
      return (int)cudaErrorInvalidValue;
  t.count = count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (apply)
    rmsprop_kernel<true><<<blocks, kThreads, 0, s>>>(t, lr, alpha,
                                                     one_minus_alpha, eps);
  else
    rmsprop_kernel<false><<<blocks, kThreads, 0, s>>>(t, lr, alpha,
                                                      one_minus_alpha, eps);
  return (int)cudaGetLastError();
}
