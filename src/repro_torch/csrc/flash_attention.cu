// Flash attention forward for training on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
//   (Pallas body `_kernel`).  q (B, S, Hq, D) against k, v (B, S, Hkv, D)
//   of the same sequence, query row i and key row j at positions i and j:
//   key j is valid for query i iff (causal: j <= i) and (window: j >
//   i - window).  Online softmax in f32 with the finite NEG mask; out in
//   q's dtype and lse = m + log(max(l, 1e-30)) per row in f32, (B, Hq, S)
//   (the TPU kernel's save_residuals, always on here: every caller trains),
//   from which the backward rebuilds the softmax.
//
// Bound on the H100: operations.  At the train shape (B = 4, S = 1024,
// 32 q heads, D = 128, causal) the products are 4 * D per live (query, key)
// pair over B * Hq * S * (S + 1) / 2 live pairs, 34.4 GFLOP, against
// 76 MB of q, k, v, out and lse in bf16; 0.035 ms at the 989 TFLOP/s bf16
// peak against 0.023 ms at 3.35 TB/s.
//
// Two arms, chosen by dtype (each counted on its own by the wrapper):
//
// bf16: FlashAttention-2's structure on the tensor cores, the tile loop
//   of flash_mma_fwd.cuh (fm::attend_block) under its training mask
//   (fm::TrainMask): one block of 4 warps per (q tile of 64 rows, q head,
//   batch row), 2048 blocks at the train shape; the q tiles are the grid's
//   slowest dimension and, when causal, run longest first (the last q tile
//   first), so the short blocks of the causal head of the sequence fill
//   the tail.  Key tiles of 64 rows, double-buffered by cp.async; S = Q K^T
//   and acc += P V on mma.sync m16n8k16, the online softmax in registers,
//   p rounded to bf16 before P V (flash_attention.py:117) while l sums the
//   f32 p; the mask per fragment element only where a tile crosses the
//   causal diagonal, the window floor or S.  lse is written in natural
//   log.
//
// f32: the first, SIMT body, exact to 1e-5: the append kernel's function
//   (flash_append.cu) with pos0 = 0 and the key positions taken from the
//   row index, through rt::attend_tiles: one block per (q tile of 64 rows,
//   q head, batch row) over key tiles of 32 rows, f32 FMAs from shared
//   memory, p unrounded.
//
// Both arms skip the key tiles past the causal bound or below the window
// floor by the append kernel's rule; causal = false visits every tile.
// A ragged S (not a multiple of the tiles) is masked here.
//
// The query-offset arm (sequence-parallel attention, where each model
// rank owns Sq = S / tp query rows of the sequence and attends them
// against all Sk = S keys): q, out (B, Sq, Hq, D) at positions q_off ..
// q_off + Sq - 1, k, v (B, Sk, Hkv, D) at 0 .. Sk - 1, lse (B, Hq, Sq).
// The masks, the live-tile bounds and the longest-first order compare
// absolute positions (a query row's index plus q_off); the grid covers
// the Sq rows.  With q_off = 0 and Sq = Sk it is the whole arm, tile for
// tile.
#include <cmath>

#include "attention_tiles.cuh"
#include "flash_mma_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 arm: SIMT body
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // keys per tile

template <int D>
__global__ void __launch_bounds__(rt::kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int q_off,
                     int Hq, int Hkv, int causal, int window, float scale) {
  using Smem = rt::TileSmem<D, kBK, kBQ>;
  using Rows = rt::AccRows<D, kBQ>;
  extern __shared__ float smem_raw[];
  const Smem sm(smem_raw);
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int i0 = iq * kBQ;
  const int tid = threadIdx.x;

  // query rows i0 .. i0 + kBQ of head h; rows past Sq are zero and unused
  {
    float* const dst[1] = {sm.q};
    const float* const src[1] = {q + (((long long)b * Sq + i0) * Hq + h) * D};
    rt::load_rows_f32<D, kBQ, 1, float>(dst, D, src, (long long)Hq * D,
                                        Sq - i0);
  }
  for (int r = tid; r < kBQ; r += rt::kThreads) {
    sm.m[r] = rt::kNeg;
    sm.l[r] = 0.f;
    sm.qpos[r] = q_off + i0 + r;
  }
  float acc[Rows::kCount];
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) acc[i] = 0.f;

  // live key tiles: none past the block's last query (causal), none whose
  // last key is at or below the block's first query's window floor
  const int p0 = q_off + i0;  // the block's first query position
  int kt_begin = 0, kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (p0 + kBQ - 1) / kBK + 1);
  if (window > 0) {
    const int t = p0 - window + 1;  // live iff (kt + 1) * kBK > t
    if (t > 0) kt_begin = t / kBK;
  }
  __syncthreads();

  const long long kv_off = (long long)b * Sk * Hkv * D + (long long)hk * D;
  rt::attend_tiles<D, kBK, kBQ, float>(
      sm, kBQ, window, k + kv_off, v + kv_off, (long long)Hkv * D, nullptr,
      Sk, kt_begin, kt_end, scale, acc, causal != 0);

  const int d = tid % D, a0 = tid / D;
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) {
    const int r = a0 + i * Rows::kStep, row = i0 + r;
    if (row < Sq)
      out[(((long long)b * Sq + row) * Hq + h) * D + d] =
          acc[i] / fmaxf(sm.l[r], rt::kLFloor);
  }
  for (int r = tid; r < kBQ; r += rt::kThreads) {
    const int row = i0 + r;
    if (row < Sq)
      lse[((long long)b * Hq + h) * Sq + row] =
          sm.m[r] + logf(fmaxf(sm.l[r], rt::kLFloor));
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Sk, int q_off, int Hq, int Hkv,
               int causal, int window, cudaStream_t stream) {
  using Smem = rt::TileSmem<D, kBK, kBQ>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Smem::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<D><<<grid, rt::kThreads, Smem::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Sk, q_off, Hq, Hkv, causal, window,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 arm: tensor cores, the tile loop of flash_mma_fwd.cuh
// ---------------------------------------------------------------------------

using mt::bf16;

template <int D>
__global__ void __launch_bounds__(fm::kThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int Sq, int Sk, int q_off,
                         int Hq, int Hkv, int causal, int window,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = causal ? (int)gridDim.z - 1 - (int)blockIdx.z
                        : (int)blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const long long q_at = (long long)b * Sq * q_stride + (long long)h * D;
  const long long kv_at = (long long)b * Sk * kv_stride + (long long)hk * D;
  fm::attend_block<D>(fm::TrainMask{Sk, causal, window, q_off}, smem_mma,
                      q + q_at, q_stride, Sq, k + kv_at, v + kv_at, kv_stride,
                      nullptr, iq * fm::kBQ, scale, out + q_at,
                      lse + ((long long)b * Hq + h) * Sq);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int Sq, int Sk, int q_off, int Hq, int Hkv,
                int causal, int window, cudaStream_t stream) {
  using Sm = fm::Smem<D, fm::TrainMask>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Sm::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(Hq, B, (Sq + fm::kBQ - 1) / fm::kBQ);
  flash_fwd_mma_kernel<D><<<grid, fm::kThreads, Sm::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), Sq, Sk, q_off, Hq, Hkv, causal, window,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_t(int dtype, const void* q, const void* k, const void* v,
             void* out, void* lse, int B, int Sq, int Sk, int q_off, int Hq,
             int Hkv, int causal, int window, cudaStream_t s) {
  switch (dtype) {
    case rt::kF32:
      return launch_f32<D>(q, k, v, out, lse, B, Sq, Sk, q_off, Hq, Hkv,
                           causal, window, s);
    case rt::kBF16:
      return launch_bf16<D>(q, k, v, out, lse, B, Sq, Sk, q_off, Hq, Hkv,
                            causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); one dtype (f32 or bf16)
// for all four; lse (B, Hq, Sq) f32.  Query row i sits at position
// q_off + i, key row j at j; q_off >= 0, Sq + q_off <= Sk (the whole
// arm: q_off = 0, Sq = Sk).  All contiguous, q, k and v 16-byte aligned.
// D in {64, 128}, Hq % Hkv == 0; causal 0 or 1; window <= 0 means none.
// Returns the CUDA error code of the launch.
extern "C" int rt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Sk, int q_off,
                                      int Hq, int Hkv, int D, int causal,
                                      int window, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 || q_off < 0 ||
      Sq > Sk - q_off || (Sq + fm::kBQ - 1) / fm::kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_t<64>(dtype, q, k, v, out, lse, B, Sq, Sk, q_off, Hq, Hkv,
                          causal, window, s);
    case 128:
      return launch_t<128>(dtype, q, k, v, out, lse, B, Sq, Sk, q_off, Hq,
                           Hkv, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
