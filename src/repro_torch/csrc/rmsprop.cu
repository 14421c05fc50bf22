// Shared-RMSProp update (paper Eq. 8-9) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/shared_rmsprop.py::rmsprop_update_2d (Pallas
//   body `_kernel`).  Per element of one parameter leaf, in f32:
//     g'  = alpha * g + (1 - alpha) * grad^2
//     upd = lr * grad / sqrt(g' + eps)
//   The caller subtracts upd from the parameter.  The TPU kernel multiplies
//   by rsqrt; this kernel divides by an IEEE sqrt, as the reference's
//   unfused optimizer and the plain version do.  The two differ by f32
//   rounding only.
//
// Bound on the H100: memory.  16 bytes per element (read g and grad, write
// g' and upd) over 3.35 TB/s, with a handful of operations per element.
//
// Design: a flat grid-stride loop over the leaf; each thread moves 16 bytes
// (four floats) of every array per step.  The last, partial chunk of four
// is masked inside the same loop, so any element count works with no second
// path.  The TPU wrapper's (rows, 1024) lane layout and its padding are TPU
// choices and do not carry over.  lr, alpha and 1 - alpha arrive by value as
// host floats, so no device scalar is read and the host never waits.
// new_g may alias g: each element is read and then written by the same
// thread, so the optimizer updates its accumulator in place.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

__global__ void __launch_bounds__(kThreads)
    rmsprop_kernel(const float* g, const float* __restrict__ grad,
                   float* new_g, float* __restrict__ upd, long long n,
                   float lr, float alpha, float one_minus_alpha, float eps) {
  const long long n_chunks = (n + 3) / 4;
  for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
       c < n_chunks; c += (long long)gridDim.x * kThreads) {
    const long long e = c * 4;
    const bool whole = e + 4 <= n;
    alignas(16) float gv[4];
    alignas(16) float dv[4];
    if (whole) {
      *reinterpret_cast<float4*>(gv) = reinterpret_cast<const float4*>(g)[c];
      *reinterpret_cast<float4*>(dv) =
          reinterpret_cast<const float4*>(grad)[c];
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        gv[t] = e + t < n ? g[e + t] : 0.f;
        dv[t] = e + t < n ? grad[e + t] : 0.f;
      }
    }
    alignas(16) float ng[4];
    alignas(16) float up[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      ng[t] = alpha * gv[t] + one_minus_alpha * (dv[t] * dv[t]);
      up[t] = lr * dv[t] / sqrtf(ng[t] + eps);
    }
    if (whole) {
      reinterpret_cast<float4*>(new_g)[c] = *reinterpret_cast<float4*>(ng);
      reinterpret_cast<float4*>(upd)[c] = *reinterpret_cast<float4*>(up);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (e + t < n) {
          new_g[e + t] = ng[t];
          upd[e + t] = up[t];
        }
      }
    }
  }
}

}  // namespace

// g, grad, new_g, upd: n f32 each, contiguous and 16-byte aligned; new_g
// may be g (in place).  Returns the CUDA error code of the launch.
extern "C" int rt_rmsprop_update(const void* g, const void* grad, void* new_g,
                                 void* upd, long long n, float lr, float alpha,
                                 float one_minus_alpha, float eps,
                                 void* stream) {
  if (n <= 0) return 0;
  if (((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(grad) |
        reinterpret_cast<uintptr_t>(new_g) |
        reinterpret_cast<uintptr_t>(upd)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n + 3) / 4;
  const long long want = (n_chunks + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  rmsprop_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(grad),
      static_cast<float*>(new_g), static_cast<float*>(upd), n, lr, alpha,
      one_minus_alpha, eps);
  return (int)cudaGetLastError();
}
