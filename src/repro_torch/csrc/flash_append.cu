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
//   key stream carries per-(row, kv head) f32 scales (B, Sk, Hkv, 1); its
//   tiles are dequantised in shared memory, as the TPU body dequantises in
//   VMEM: the device-memory stream stays int8.
//
// Bound on the H100: operations.  At the serving shape (B = 4, C = 128
// rows at pos0 = 512 against a stream of 640 keys, 32 q heads over 4 kv
// heads, D = 128) the products are 4 * D per live (query, key) pair and
// head, 4.84 GFLOP over 32 x 295,168 live pairs: 0.0049 ms at the 989
// TFLOP/s bf16 peak against 0.0041 ms for the 13.6 MB of q, k, v, kpos and
// out at 3.35 TB/s (int8: one byte a K/V element plus 4 bytes of scale a
// row and kv head).
//
// Four arms, chosen by dtype (each counted on its own by the wrapper):
//
// bf16 q over a bf16 key stream: the training forward's tensor-core tile
// loop (flash_mma_fwd.cuh, fm::attend_block) under the append mask
// (fm::AppendMask).  One block of 4 warps per (q tile of 64 rows, q head,
// batch row), 256 blocks at the serving shape, the last q tile first; key
// tiles of 64 rows and their 64 key positions double-buffered by
// cp.async; S = Q K^T and acc += P V on mma.sync m16n8k16 with p rounded
// to bf16 before P V (flash_attention.py:248) and l summing the f32 p;
// each score element is tested against its key's position, except in a
// tile whose 64 positions the warp has read and found valid for all its
// rows (a linear stream may still hold unwritten rows, so the positions
// decide, never the layout).
//
// bf16 q over an int8 key stream: the same tile loop under the int8
// key-stream policy (fm::Int8Stream, flash_mma_fwd.cuh): the raw int8 K
// and V tiles and their scales double-buffered by cp.async and widened to
// bf16 in shared memory (exact), each score column times its key's k
// scale, and p times each key's v scale kept in f32 as a bf16 hi + lo
// pair, two products into acc: the reference's f32 semantics (K and V
// dequantised to f32, p unrounded, flash_attention.py:220-224, 248-251)
// to about 2**-18 a term, so the arm is held to the int8 tolerance with no
// rounding term.  84.5 KB of shared memory a block at D = 128.
//
// f32 q (over an f32, bf16 or int8 stream) or an f32 stream: the first,
// SIMT body, exact to 1e-5: one block per (q tile of 64 rows, q head,
// batch row) that loops over key tiles of 32 rows through
// rt::attend_tiles; the kv head is h / G, so the kv heads are never
// repeated in memory.  Q, K and V tiles are staged in
// shared memory as f32 (an int8 tile dequantised with its row scales as it
// is staged) and the products are f32 FMAs, p unrounded.
//
// Every arm masks its own ragged edges (C or Sk not a tile multiple), so
// no alignment rule pushes a call off the kernel.
#include <cmath>
#include <type_traits>

#include "attention_tiles.cuh"
#include "flash_mma_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 and int8 arms: SIMT body
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16 arm: tensor cores
// ---------------------------------------------------------------------------

using mt::bf16;

template <int D, class Stream>
__global__ void __launch_bounds__(fm::kThreads)
    append_mma_kernel(const bf16* __restrict__ q,
                      const typename Stream::T* __restrict__ k,
                      const typename Stream::T* __restrict__ v,
                      const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ kpos, bf16* __restrict__ out,
                      int C, int Sk, int Hq, int Hkv, int pos0, int window,
                      int kpos_linear, float scale) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = (int)gridDim.z - 1 - (int)blockIdx.z;  // longest first
  const int hk = h / (Hq / Hkv);
  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const long long q_off = (long long)b * C * q_stride + (long long)h * D;
  const long long kv_off = (long long)b * Sk * kv_stride + (long long)hk * D;
  const long long sc_off = (long long)b * Sk * Hkv + hk;  // int8 scales
  fm::attend_block<D, Stream>(
      fm::AppendMask{Sk, pos0, window, kpos_linear}, smem_mma, q + q_off,
      q_stride, C, k + kv_off, v + kv_off, kv_stride,
      kpos + (long long)b * Sk, iq * fm::kBQ, scale, out + q_off, nullptr,
      Stream::kQuant ? ks + sc_off : nullptr,
      Stream::kQuant ? vs + sc_off : nullptr, Hkv);
}

template <int D, class Stream>
int launch_mma(const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const void* kpos, void* out, int B, int C,
               int Sk, int Hq, int Hkv, int pos0, int window, int kpos_linear,
               cudaStream_t stream) {
  using Sm = fm::Smem<D, fm::AppendMask, Stream>;
  using T = typename Stream::T;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        append_mma_kernel<D, Stream>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sm::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(Hq, B, (C + fm::kBQ - 1) / fm::kBQ);
  append_mma_kernel<D, Stream><<<grid, fm::kThreads, Sm::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ks, vs, static_cast<const int*>(kpos),
      static_cast<bf16*>(out), C, Sk, Hq, Hkv, pos0, window, kpos_linear,
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
      if constexpr (std::is_same<TQ, bf16>::value)  // the tensor-core arm
        return launch_mma<D, fm::Bf16Stream>(q, k, v, nullptr, nullptr, kpos,
                                             out, B, C, Sk, Hq, Hkv, pos0,
                                             window, kpos_linear, s);
      else
        return launch<D, TQ, bf16>(q, k, v, ks, vs, kpos, out, B, C, Sk, Hq,
                                   Hkv, pos0, window, kpos_linear, s);
    case rt::kInt8:
      if constexpr (std::is_same<TQ, bf16>::value)  // tensor cores, int8
        return launch_mma<D, fm::Int8Stream>(q, k, v, ks, vs, kpos, out, B,
                                             C, Sk, Hq, Hkv, pos0, window,
                                             kpos_linear, s);
      else
        return launch<D, TQ, int8_t>(q, k, v, ks, vs, kpos, out, B, C, Sk,
                                     Hq, Hkv, pos0, window, kpos_linear, s);
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
      Hq > 65535 || (C + kBQ - 1) / kBQ > 65535)
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
