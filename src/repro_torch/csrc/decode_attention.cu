// Per-slot decode attention for Hopper (sm_90a): one query token per batch
// row against its KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_fwd
//   (Pallas body `_kernel` via `_call`).  Validity is per slot:
//   0 <= kpos[b, l] <= pos[b]; masked scores are the finite NEG and the
//   output is acc / max(l, 1e-30), so a slot with no valid key (an idle
//   engine slot) gets the finite mean of v, as ref.decode_attention_ref.
//
// Bound on the H100: memory.  A slot needs K and V of its valid cache rows
// only, so the least time is 2 * (valid rows) * Hkv * D * kv_bytes /
// 3.35 TB/s; the arithmetic (2 * Hq * D operations per valid row) is far
// below the bf16 ridge.  This kernel walks every cache row, valid or not.
//
// Design: the TPU grid (batch, kv head, key block) becomes one block per
// (kv head, batch row) that loops over key tiles itself.  The block loads
// the G = Hq / Hkv query heads that share its kv head once and scores all
// of them against each K tile staged in shared memory, so the cache is read
// once for all G heads, with no repeat of the kv heads.  Scores, m, l and
// acc stay in f32; q and the cache may each be f32 or bf16 (the engine's
// default cache is f32 while activations are bf16).  At B = 4 and Hkv = 4
// this is 16 blocks on 132 SMs: splitting the key range across blocks
// (the split-K that decode_attention_partials prefigures) is the later fix.
#include <cmath>

#include "attention_tiles.cuh"

namespace {

constexpr int kBK = 64;     // keys per tile
constexpr int kGMax = 16;   // query heads per kv head one block can hold

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(rt::kThreads)
    decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, const int* __restrict__ kpos,
                  const int* __restrict__ pos, TQ* __restrict__ out, int L,
                  int Hq, int Hkv, float scale) {
  using Smem = rt::TileSmem<D, kBK, kGMax>;
  using Rows = rt::AccRows<D, kGMax>;
  extern __shared__ float smem_raw[];
  const Smem sm(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;

  // the G query rows of this kv head are contiguous in q (B, Hq, D)
  {
    float* const dst[1] = {sm.q};
    const TQ* const src[1] = {q + ((long long)b * Hq + (long long)h * G) * D};
    rt::load_rows_f32<D, kGMax, 1, TQ>(dst, D, src, D, G);
  }
  const int p = pos[b];
  for (int r = tid; r < G; r += rt::kThreads) {
    sm.m[r] = rt::kNeg;
    sm.l[r] = 0.f;
    sm.qpos[r] = p;
  }
  float acc[Rows::kCount];
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) acc[i] = 0.f;
  __syncthreads();

  const long long kv_off = (long long)b * L * Hkv * D + (long long)h * D;
  rt::attend_tiles<D, kBK, kGMax, TKV>(
      sm, G, /*window=*/0, k + kv_off, v + kv_off, (long long)Hkv * D,
      kpos + (long long)b * L, L, 0, (L + kBK - 1) / kBK, scale, acc);

  const int d = tid % D, a0 = tid / D;
  TQ* ob = out + ((long long)b * Hq + (long long)h * G) * D;
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) {
    const int r = a0 + i * Rows::kStep;
    if (r < G) ob[r * D + d] = rt::from_f32<TQ>(acc[i] / fmaxf(sm.l[r], rt::kLFloor));
  }
}

template <int D, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* kpos,
           const void* pos, void* out, int B, int L, int Hq, int Hkv,
           cudaStream_t stream) {
  using Smem = rt::TileSmem<D, kBK, kGMax>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<D, TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(Hkv, B);
  decode_kernel<D, TQ, TKV><<<grid, rt::kThreads, Smem::kBytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(pos), static_cast<TQ*>(out), L, Hq, Hkv,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D, typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
              const void* kpos, const void* pos, void* out, int B, int L,
              int Hq, int Hkv, cudaStream_t s) {
  switch (kv_dtype) {
    case rt::kF32:
      return launch<D, TQ, float>(q, k, v, kpos, pos, out, B, L, Hq, Hkv, s);
    case rt::kBF16:
      return launch<D, TQ, __nv_bfloat16>(q, k, v, kpos, pos, out, B, L, Hq,
                                          Hkv, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_q(int q_dtype, int kv_dtype, const void* q, const void* k,
             const void* v, const void* kpos, const void* pos, void* out,
             int B, int L, int Hq, int Hkv, cudaStream_t s) {
  switch (q_dtype) {
    case rt::kF32:
      return launch_kv<D, float>(kv_dtype, q, k, v, kpos, pos, out, B, L, Hq,
                                 Hkv, s);
    case rt::kBF16:
      return launch_kv<D, __nv_bfloat16>(kv_dtype, q, k, v, kpos, pos, out, B,
                                         L, Hq, Hkv, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, D); k, v (B, L, Hkv, D); kpos (B, L) int32; pos (B,) int32;
// out (B, Hq, D) in q's dtype; all contiguous, q, k and v 16-byte
// aligned.  D in {64, 128},
// Hq % Hkv == 0, Hq / Hkv <= 16.  Returns the CUDA error code (0 = success).
extern "C" int rt_decode_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* kpos,
                                       const void* pos, void* out, int B,
                                       int L, int Hq, int Hkv, int D,
                                       int q_dtype, int kv_dtype,
                                       void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  if (L <= 0 || Hq % Hkv != 0 || Hq / Hkv > kGMax || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_q<64>(q_dtype, kv_dtype, q, k, v, kpos, pos, out, B, L, Hq,
                          Hkv, s);
    case 128:
      return launch_q<128>(q_dtype, kv_dtype, q, k, v, kpos, pos, out, B, L,
                           Hq, Hkv, s);
  }
  return (int)cudaErrorInvalidValue;
}
