// Append-mode flash attention for Hopper (sm_90a): a prompt chunk against
// the key stream made of the KV-cache prefix plus the chunk itself.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_append
//   (Pallas body `_append_kernel`).  Chunk row i sits at absolute position
//   qpos = pos0 + i; key row j is valid for it iff kpos[b, j] >= 0,
//   kpos <= qpos and, with a window, kpos > qpos - window.  With
//   kpos_linear (key row index == absolute position wherever valid) whole
//   key tiles beyond the causal bound or below the window floor are skipped,
//   as the TPU kernel's tile_live; ring layouts visit every tile.  An int8
//   key stream carries per-(row, kv head) f32 scales (B, Sk, Hkv, 1) and
//   each staged K/V tile is dequantised right after its 16-byte loads, as
//   the TPU body dequantises in VMEM: the device-memory stream stays int8.
//
// Bound on the H100: at the serving shapes (C = 128 rows against a prefix
// of up to ~1k keys) the operations dominate: 4 * B * Hq * D * live_pairs
// over 989 TFLOP/s (bf16) against the bytes of q, k, v and out over
// 3.35 TB/s (int8: one byte a K/V element plus 4 bytes of scale a row and
// kv head).
//
// Design: the TPU grid (batch, q head, q block, k block) becomes one block
// per (q tile of 64 rows, q head, batch row) that loops over key tiles of
// 32 rows; the kv head is h / G, so the kv heads are never repeated in
// memory.  Q, K and V tiles are staged in shared memory as f32 and the
// products are plain FMAs (scores, m, l and acc in f32): simple and right
// first; tensor cores (mma.sync / wgmma) and TMA staging are the later
// speed-up.  The ragged edges (C or Sk not a tile multiple) are masked
// here, so no alignment rule pushes a call off the kernel.
#include <cmath>

#include "attention_tiles.cuh"

namespace {

constexpr int kBQ = 64;  // chunk rows per block
constexpr int kBK = 32;  // keys per tile

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(rt::kThreads)
    append_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ kpos,
                  TQ* __restrict__ out, int C, int Sk, int Hq, int Hkv,
                  int pos0, int window, int kpos_linear, float scale) {
  using Smem = rt::TileSmem<D, kBK, kBQ>;
  using Rows = rt::AccRows<D, kBQ>;
  extern __shared__ float smem_raw[];
  const Smem sm(smem_raw);
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int i0 = iq * kBQ;
  const int tid = threadIdx.x;

  // chunk rows i0 .. i0 + kBQ of head h; rows past C are zero and unused
  {
    float* const dst[1] = {sm.q};
    const TQ* const src[1] = {q + (((long long)b * C + i0) * Hq + h) * D};
    rt::load_rows_f32<D, kBQ, 1, TQ>(dst, D, src, (long long)Hq * D, C - i0);
  }
  for (int r = tid; r < kBQ; r += rt::kThreads) {
    sm.m[r] = rt::kNeg;
    sm.l[r] = 0.f;
    sm.qpos[r] = pos0 + i0 + r;
  }
  float acc[Rows::kCount];
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) acc[i] = 0.f;

  // tile_live on a linear key layout: tile kt holds key positions
  // [kt * kBK, kt * kBK + kBK) where valid; it is dead when its first key is
  // past the block's last query, or its last key is at or below the block's
  // first query's window floor
  int kt_begin = 0, kt_end = (Sk + kBK - 1) / kBK;
  if (kpos_linear) {
    const int q_lo = pos0 + i0, q_hi = pos0 + i0 + kBQ - 1;
    kt_end = min(kt_end, q_hi / kBK + 1);
    if (window > 0) {
      const int t = q_lo - window + 1;  // live iff (kt + 1) * kBK > t
      if (t > 0) kt_begin = t / kBK;
    }
  }
  __syncthreads();

  const long long kv_off = (long long)b * Sk * Hkv * D + (long long)hk * D;
  const long long sc_off = (long long)b * Sk * Hkv + hk;
  rt::attend_tiles<D, kBK, kBQ, TKV>(
      sm, kBQ, window, k + kv_off, v + kv_off, (long long)Hkv * D,
      kpos + (long long)b * Sk, Sk, kt_begin, kt_end, scale, acc,
      /*causal=*/true, ks != nullptr ? ks + sc_off : nullptr,
      vs != nullptr ? vs + sc_off : nullptr, Hkv);

  const int d = tid % D, a0 = tid / D;
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) {
    const int r = a0 + i * Rows::kStep, row = i0 + r;
    if (row < C)
      out[(((long long)b * C + row) * Hq + h) * D + d] =
          rt::from_f32<TQ>(acc[i] / fmaxf(sm.l[r], rt::kLFloor));
  }
}

template <int D, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const void* kpos, void* out, int B, int C, int Sk,
           int Hq, int Hkv, int pos0, int window, int kpos_linear,
           cudaStream_t stream) {
  using Smem = rt::TileSmem<D, kBK, kBQ>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        append_kernel<D, TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((C + kBQ - 1) / kBQ, Hq, B);
  append_kernel<D, TQ, TKV><<<grid, rt::kThreads, Smem::kBytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, static_cast<const int*>(kpos),
      static_cast<TQ*>(out), C, Sk, Hq, Hkv, pos0, window, kpos_linear,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D, typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
              const float* ks, const float* vs, const void* kpos, void* out,
              int B, int C, int Sk, int Hq, int Hkv, int pos0, int window,
              int kpos_linear, cudaStream_t s) {
  switch (kv_dtype) {
    case rt::kF32:
      return launch<D, TQ, float>(q, k, v, ks, vs, kpos, out, B, C, Sk, Hq,
                                  Hkv, pos0, window, kpos_linear, s);
    case rt::kBF16:
      return launch<D, TQ, __nv_bfloat16>(q, k, v, ks, vs, kpos, out, B, C,
                                          Sk, Hq, Hkv, pos0, window,
                                          kpos_linear, s);
    case rt::kInt8:
      return launch<D, TQ, int8_t>(q, k, v, ks, vs, kpos, out, B, C, Sk, Hq,
                                   Hkv, pos0, window, kpos_linear, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_q(int q_dtype, int kv_dtype, const void* q, const void* k,
             const void* v, const float* ks, const float* vs,
             const void* kpos, void* out, int B, int C, int Sk, int Hq,
             int Hkv, int pos0, int window, int kpos_linear, cudaStream_t s) {
  switch (q_dtype) {
    case rt::kF32:
      return launch_kv<D, float>(kv_dtype, q, k, v, ks, vs, kpos, out, B, C,
                                 Sk, Hq, Hkv, pos0, window, kpos_linear, s);
    case rt::kBF16:
      return launch_kv<D, __nv_bfloat16>(kv_dtype, q, k, v, ks, vs, kpos, out,
                                         B, C, Sk, Hq, Hkv, pos0, window,
                                         kpos_linear, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, C, Hq, D); k, v (B, Sk, Hkv, D) f32, bf16 or int8, with ks, vs
// (B, Sk, Hkv, 1) f32 exactly when int8 (else null); kpos (B, Sk) int32;
// out (B, C, Hq, D) in q's dtype; all contiguous, q, k and v 16-byte
// aligned.  D in {64, 128}, Hq % Hkv == 0; window <= 0 means none.  Returns
// the CUDA error code.
extern "C" int rt_flash_append_fwd(const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, const void* kpos, void* out,
                                   int B, int C, int Sk, int Hq, int Hkv,
                                   int D, int pos0, int window,
                                   int kpos_linear, int q_dtype, int kv_dtype,
                                   void* stream) {
  if (B <= 0 || C <= 0 || Hq <= 0) return 0;
  if (Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || pos0 < 0 || B > 65535 ||
      Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  if ((kv_dtype == rt::kInt8) != (ksf != nullptr && vsf != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_q<64>(q_dtype, kv_dtype, q, k, v, ksf, vsf, kpos, out, B,
                          C, Sk, Hq, Hkv, pos0, window, kpos_linear, s);
    case 128:
      return launch_q<128>(q_dtype, kv_dtype, q, k, v, ksf, vsf, kpos, out, B,
                           C, Sk, Hq, Hkv, pos0, window, kpos_linear, s);
  }
  return (int)cudaErrorInvalidValue;
}
