// Per-slot decode attention for Hopper (sm_90a): one query token per batch
// row against its KV cache, normalised or as flash-decoding partials.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_fwd and
//   ::decode_attention_partials, which share the Pallas body `_kernel`
//   (via `_call`); so do they here: one kernel body with two compile-time
//   switches.
//   * PARTIALS: write the unnormalised online-softmax state (acc (B, Hkv,
//     G, D), m and l (B, Hkv, G), all f32) of this cache slice for the
//     context-parallel combine, o = sum(acc e^(m - max m)) /
//     sum(l e^(m - max m)) across slices; otherwise write acc / max(l,
//     1e-30) in q's dtype.
//   * int8 K/V (TKV = int8_t): per-(row, kv head) f32 scales (B, L, Hkv, 1)
//     ride beside the caches and each staged tile is dequantised right
//     after its 16-byte loads, so the device-memory stream stays int8.
//   Validity is per slot: 0 <= kpos[b, l] <= pos[b]; masked scores are the
//   finite NEG, so a slot (or a slice) with no valid key gets m = NEG,
//   l = its number of keys and acc = the sum of its v rows: the finite
//   mean of v once normalised, and a slice that vanishes in the combine
//   whenever another slice holds a valid key (e^(NEG - m) underflows to 0).
//   Key rows past L in the ragged last tile weigh exactly 0 (they are
//   absent, not masked).
//
// Bound on the H100: memory.  A slot needs K and V of its valid cache rows
// only, so the least time is (2 * valid rows * Hkv * D * kv_bytes [+ 2 *
// valid rows * Hkv * 4 bytes of int8 scales]) / 3.35 TB/s; the arithmetic
// (4 * Hq * D operations per valid row) is far below the bf16 ridge.  This
// kernel walks every cache row of its slice, valid or not.
//
// Design: the TPU grid (batch, kv head, key block) becomes one block per
// (kv head, batch row) that loops over key tiles itself.  The block loads
// the G = Hq / Hkv query heads that share its kv head once and scores all
// of them against each K tile staged in shared memory, so the cache is read
// once for all G heads, with no repeat of the kv heads.  Scores, m, l and
// acc stay in f32; q and the cache may each be f32 or bf16 (the engine's
// default cache is f32 while activations are bf16), and the cache int8.
// At B = 4 and Hkv = 4 this is 16 blocks on 132 SMs; splitting the key
// range of one device's slice across blocks (this kernel's PARTIALS output
// plus a combine pass) is the later speed-up.
#include <cmath>

#include "attention_tiles.cuh"

namespace {

constexpr int kBK = 64;     // keys per tile
constexpr int kGMax = 16;   // query heads per kv head one block can hold

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // int8 caches only: (B, L, Hkv, 1) scales
  const float* vs;
  const int* kpos;
  const int* pos;
  void* out;        // normalised output (B, Hq, D) in q's dtype
  float* acc;       // partials: (B, Hkv, G, D), m and l (B, Hkv, G)
  float* m;
  float* l;
  int B, L, Hq, Hkv;
  cudaStream_t stream;
};

template <int D, typename TQ, typename TKV, bool PARTIALS>
__global__ void __launch_bounds__(rt::kThreads)
    decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ kpos,
                  const int* __restrict__ pos, TQ* __restrict__ out,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int L, int Hq, int Hkv,
                  float scale) {
  using Smem = rt::TileSmem<D, kBK, kGMax>;
  using Rows = rt::AccRows<D, kGMax>;
  extern __shared__ float smem_raw[];
  const Smem sm(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  // the G query rows of this kv head are contiguous in q (B, Hq, D), and
  // so are their rows of the (B, Hkv, G, ...) partials
  const long long row0 = (long long)b * Hq + (long long)h * G;

  {
    float* const dst[1] = {sm.q};
    const TQ* const src[1] = {q + row0 * D};
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
  const long long sc_off = (long long)b * L * Hkv + h;
  rt::attend_tiles<D, kBK, kGMax, TKV>(
      sm, G, /*window=*/0, k + kv_off, v + kv_off, (long long)Hkv * D,
      kpos + (long long)b * L, L, 0, (L + kBK - 1) / kBK, scale, acc,
      /*causal=*/true, ks != nullptr ? ks + sc_off : nullptr,
      vs != nullptr ? vs + sc_off : nullptr, Hkv);

  const int d = tid % D, a0 = tid / D;
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) {
    const int r = a0 + i * Rows::kStep;
    if (r >= G) continue;
    if constexpr (PARTIALS)
      acc_out[(row0 + r) * D + d] = acc[i];
    else
      out[(row0 + r) * D + d] =
          rt::from_f32<TQ>(acc[i] / fmaxf(sm.l[r], rt::kLFloor));
  }
  if constexpr (PARTIALS) {
    for (int r = tid; r < G; r += rt::kThreads) {
      m_out[row0 + r] = sm.m[r];
      l_out[row0 + r] = sm.l[r];
    }
  }
}

template <int D, typename TQ, typename TKV, bool PARTIALS>
int launch(const Args& a) {
  using Smem = rt::TileSmem<D, kBK, kGMax>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<D, TQ, TKV, PARTIALS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(a.Hkv, a.B);
  decode_kernel<D, TQ, TKV, PARTIALS>
      <<<grid, rt::kThreads, Smem::kBytes, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
          static_cast<const TKV*>(a.v), a.ks, a.vs, a.kpos, a.pos,
          static_cast<TQ*>(a.out), a.acc, a.m, a.l, a.L, a.Hq, a.Hkv,
          (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D, typename TQ, bool PARTIALS>
int launch_kv(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case rt::kF32:
      return launch<D, TQ, float, PARTIALS>(a);
    case rt::kBF16:
      return launch<D, TQ, __nv_bfloat16, PARTIALS>(a);
    case rt::kInt8:
      return launch<D, TQ, int8_t, PARTIALS>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool PARTIALS>
int launch_all(int D, int q_dtype, int kv_dtype, const Args& a) {
  if (a.B <= 0 || a.Hkv <= 0) return 0;
  if (a.L <= 0 || a.Hq % a.Hkv != 0 || a.Hq / a.Hkv > kGMax || a.B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == rt::kInt8) != (a.ks != nullptr && a.vs != nullptr))
    return (int)cudaErrorInvalidValue;
  switch (D * 4 + q_dtype) {
    case 64 * 4 + rt::kF32:
      return launch_kv<64, float, PARTIALS>(kv_dtype, a);
    case 64 * 4 + rt::kBF16:
      return launch_kv<64, __nv_bfloat16, PARTIALS>(kv_dtype, a);
    case 128 * 4 + rt::kF32:
      return launch_kv<128, float, PARTIALS>(kv_dtype, a);
    case 128 * 4 + rt::kBF16:
      return launch_kv<128, __nv_bfloat16, PARTIALS>(kv_dtype, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, D); k, v (B, L, Hkv, D) f32, bf16 or int8, with ks, vs
// (B, L, Hkv, 1) f32 exactly when int8 (else null); kpos (B, L) int32; pos
// (B,) int32; out (B, Hq, D) in q's dtype; all contiguous, q, k and v
// 16-byte aligned.  D in {64, 128}, Hq % Hkv == 0, Hq / Hkv <= 16.  Returns
// the CUDA error code (0 = success).
extern "C" int rt_decode_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, const void* kpos,
                                       const void* pos, void* out, int B,
                                       int L, int Hq, int Hkv, int D,
                                       int q_dtype, int kv_dtype,
                                       void* stream) {
  const Args a{q, k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const int*>(kpos),
               static_cast<const int*>(pos), out, nullptr, nullptr, nullptr,
               B, L, Hq, Hkv, static_cast<cudaStream_t>(stream)};
  return launch_all<false>(D, q_dtype, kv_dtype, a);
}

// The same inputs; acc (B, Hkv, G, D), m and l (B, Hkv, G), all f32: the
// unnormalised partials of this cache slice.
extern "C" int rt_decode_attention_partials(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* kpos, const void* pos, void* acc, void* m,
    void* l, int B, int L, int Hq, int Hkv, int D, int q_dtype, int kv_dtype,
    void* stream) {
  const Args a{q, k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const int*>(kpos),
               static_cast<const int*>(pos), nullptr,
               static_cast<float*>(acc), static_cast<float*>(m),
               static_cast<float*>(l), B, L, Hq, Hkv,
               static_cast<cudaStream_t>(stream)};
  return launch_all<true>(D, q_dtype, kv_dtype, a);
}
