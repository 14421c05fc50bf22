// Flash attention backward (dq, dk, dv) for training on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention_bwd.py::flash_attention_bwd
//   (Pallas bodies `_dq_kernel` and `_dkv_kernel`).  FlashAttention-2's
//   backward from the forward's saved lse: per live (query i, key j) pair
//     p  = exp(q_i . k_j * scale - lse_i)
//     dp = do_i . v_j
//     ds = p * (dp - delta_i) * scale,   delta_i = rowsum(do_i * o_i)
//   dq_i = sum_j ds k_j;  dk_j = sum_i ds q_i;  dv_j = sum_i p do_i, with dk
//   and dv summed over the G query heads of each kv head.  Masks as the
//   forward (flash_attention.cu): causal j <= i, window j > i - window.
//
// Bound on the H100: operations.  The least work is five products of D
// terms per live pair (s, dp, dq, dk, dv), 10 * D operations per pair:
// 85.9 GFLOP at the train shape (B = 4, S = 1024, 32 q heads over 4 kv
// heads, D = 128, causal), 0.087 ms at the 989 TFLOP/s bf16 peak, against
// 0.045 ms for its 152 MB of q, k, v, o, do, lse, dq, dk and dv in bf16.
// The kernels below do 14 * D per pair: the dq kernel recomputes s and dp.
//
// Two arms, chosen by dtype (each counted on its own by the wrapper); both
// are two kernels on one stream with no atomics, so a result is the same
// from run to run.
//
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate; the building
// blocks of mma_tiles.cuh), tiles staged as bf16 by cp.async (rows padded
// to D + 8, zero-filled past S), double-buffered so that the next tile
// loads while this one is multiplied.  4 warps a block, 16 rows a warp.
// The rounding is the TPU kernel's: ds is rounded to bf16 before
// dq += ds K (flash_attention_bwd.py:86), p before dv += p^T do (:121), ds
// before dk += ds^T q (:127); s, dp, p, ds and every sum stay f32.
//   dq:  one block per (q tile of 64 rows, q head, batch row), the q tiles
//        the grid's slowest dimension and, when causal, longest first.  It
//        computes delta for its rows (writing it, (B, Hq, S) f32, for the
//        dkv kernel), keeps its Q fragments in registers and walks the
//        live key tiles of 64 rows: S = Q K^T and dP = dO V^T (dO by
//        ldmatrix from shared memory each tile, to keep registers for the
//        accumulators), p and ds in f32 registers, then dq += dS K with dS
//        the A operand straight from registers (ldmatrix.trans of K).
//   dkv: one block per (k tile of 64 keys, kv head, batch row, split of
//        the G q heads into n_split groups of G / n_split heads; the wrapper
//        takes 2 heads a group where G is even), k tiles the slowest
//        dimension, longest first when causal.  It computes the transposed
//        scores S^T = K Q^T and dP^T = V dO^T, so that p^T and ds^T come out
//        in the accumulator layout of the warp's 16 keys: dv += P^T dO and
//        dk += dS^T Q take them as A operands from registers, with no
//        shared-memory transpose.  Query tiles of 32 rows, with their lse
//        and delta, are double-buffered.  Each block writes f32 partial dk
//        and dv into a scratch (2, n_split, B, S, Hkv, D), and a third,
//        elementwise launch sums the n_split partials in a fixed order and
//        casts them.  At the train shape: 16 k tiles x 4 kv heads x 4 rows
//        x 4 splits = 1024 blocks, about 4 waves at 2 blocks an SM on 132 SMs
//        (the loop over all G heads gave 256 blocks, under 2 waves, the
//        diagonal's longest block setting the kernel's length), and a
//        67 MB scratch (2 x 4 x 4 x 1024 x 4 x 128 x 4 B), a quarter of
//        the TPU's per-q-head (B, Hq, S, D) buffers, which its sequential
//        grid needed because it could not revisit a block and which it
//        summed outside the kernel.
//
// f32: the first, SIMT bodies, exact to 1e-5 (the train check on the
// card against the CPU depends on them): dq blocks of 64 rows over key
// tiles of 32, dkv blocks of 64 keys looping over their G q heads and
// query tiles of 32 rows, tiles staged as f32 with rows padded to D + 1,
// p and ds unrounded, f32 FMAs from shared memory.
//
// Both arms skip dead tiles by the forward's rule (and its transpose in
// dkv).
//
// The query-offset arm (flash_attention.cu's): q, o, dout, dq (B, Sq, Hq,
// D) at positions q_off .. q_off + Sq - 1, k, v, dk, dv (B, Sk, Hkv, D),
// lse and delta (B, Hq, Sq).  The masks and live-tile bounds compare
// absolute positions; the dq grid covers the Sq rows, the dkv grid all Sk
// keys with the shard's query tiles, and a key tile that no query of the
// shard reaches writes zeros (its dk, dv are this shard's part: none).
// With Sk > Sq the key tiles alone fill the card, so the wrapper takes one
// split of the q heads, whose dkv block writes dk and dv itself (bf16;
// no partials, no sum launch); it does so wherever n_split is 1.
#include <cmath>

#include "attention_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = rt::kThreads;
constexpr int kBQ = 64;  // dq kernel: query rows per block
constexpr int kBK = 32;  // dq kernel: keys per tile
constexpr int kBN = 64;  // dkv kernel: keys per block
constexpr int kBM = 32;  // dkv kernel: query rows per tile

// query row qi (position q_off + qi) against key kp
__device__ __forceinline__ bool valid(int qi, int kp, int Sq, int Sk,
                                      int q_off, int causal, int window) {
  const int qp = q_off + qi;
  return qi < Sq && kp < Sk && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// The live query tiles [begin, end) of tile size BM for the keys [j0,
// k_hi] (the forward's rule, transposed): none whose last row is before
// the block's first key (causal); none whose first row is at or past the
// block's last key + window (window).  Empty where no query of the shard
// reaches the keys.
template <int BM>
__device__ __forceinline__ void live_q_tiles(int j0, int k_hi, int Sq,
                                             int q_off, int causal,
                                             int window, int& begin,
                                             int& end) {
  const int n_qt = (Sq + BM - 1) / BM;
  begin = causal ? max(j0 - q_off, 0) / BM : 0;
  end = n_qt;
  if (window > 0) {
    const int last = k_hi + window - 1 - q_off;  // the last live query row
    end = last < 0 ? 0 : min(n_qt, last / BM + 1);
  }
  if (end < begin) end = begin;
}

// ---------------------------------------------------------------------------
// f32 arm, dq (+ delta)
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kKS = D + 1;  // padded K / V row
  static constexpr int kFloats =
      2 * kBQ * D + 2 * kBK * kKS + kBQ * kBK + 2 * kBQ;
  static constexpr size_t kBytes = sizeof(float) * (size_t)kFloats;
  float* q;
  float* dout;
  float* k;
  float* v;
  float* ds;
  float* lse;
  float* delta;
  __device__ explicit DqSmem(float* base) {
    q = base;
    dout = q + kBQ * D;
    k = dout + kBQ * D;
    v = k + kBK * kKS;
    ds = v + kBK * kKS;
    lse = ds + kBQ * kBK;
    delta = lse + kBQ;
  }
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
              int q_off, int Hq, int Hkv, int causal, int window,
              float scale) {
  using Sm = DqSmem<D>;
  using Rows = rt::AccRows<D, kBQ>;
  constexpr int kKS = Sm::kKS;
  constexpr int kStepS = kThreads / kBK;  // query rows between a thread's
  constexpr int kRS = kBQ / kStepS;       // score rows
  extern __shared__ float smem_raw[];
  const Sm sm(smem_raw);
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int i0 = iq * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row_stride = (long long)Hq * D;
  const long long q_at = ((long long)b * Sq + i0) * row_stride +
                         (long long)h * D;
  const long long stat_off = ((long long)b * Hq + h) * Sq;

  // q and do rows -> shared (f32); rows past Sq are zero
  {
    float* const dst[2] = {sm.q, sm.dout};
    const T* const src[2] = {q + q_at, dout + q_at};
    rt::load_rows_f32<D, kBQ, 2, T>(dst, D, src, row_stride, Sq - i0);
  }
  __syncthreads();
  // delta = rowsum(do * o) in f32, one warp per row
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int row = i0 + r;
    float dsum = 0.f;
    if (row < Sq) {
      const T* orow = o + q_at + r * row_stride;
      for (int d = lane; d < D; d += 32)
        dsum += sm.dout[r * D + d] * rt::to_f32(orow[d]);
    }
    dsum = rt::warp_sum(dsum);
    if (lane == 0) {
      sm.delta[r] = dsum;
      sm.lse[r] = row < Sq ? lse[stat_off + row] : 0.f;
      if (row < Sq) delta[stat_off + row] = dsum;
    }
  }

  float acc[Rows::kCount];
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) acc[i] = 0.f;
  const int p0 = q_off + i0;  // the block's first query position
  int kt_begin = 0, kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (p0 + kBQ - 1) / kBK + 1);
  if (window > 0) {
    const int t = p0 - window + 1;  // live iff (kt + 1) * kBK > t
    if (t > 0) kt_begin = t / kBK;
  }
  const long long kv_stride = (long long)Hkv * D;
  const long long kv_off = (long long)b * Sk * kv_stride + (long long)hk * D;
  __syncthreads();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    {
      float* const dst[2] = {sm.k, sm.v};
      const T* const src[2] = {k + kv_off + k0 * kv_stride,
                               v + kv_off + k0 * kv_stride};
      rt::load_rows_f32<D, kBK, 2, T>(dst, kKS, src, kv_stride, Sk - k0);
    }
    __syncthreads();

    // ds for key j of the tile against query rows r0 + i * kStepS
    {
      const int j = tid % kBK, r0 = tid / kBK;
      float sc[kRS], dp[kRS];
#pragma unroll
      for (int i = 0; i < kRS; ++i) sc[i] = dp[i] = 0.f;
      const float* krow = sm.k + j * kKS;
      const float* vrow = sm.v + j * kKS;
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d], vd = vrow[d];
#pragma unroll
        for (int i = 0; i < kRS; ++i) {
          const int r = r0 + i * kStepS;
          sc[i] += sm.q[r * D + d] * kd;
          dp[i] += sm.dout[r * D + d] * vd;
        }
      }
#pragma unroll
      for (int i = 0; i < kRS; ++i) {
        const int r = r0 + i * kStepS;
        const float p = valid(i0 + r, k0 + j, Sq, Sk, q_off, causal, window)
                            ? expf(sc[i] * scale - sm.lse[r])
                            : 0.f;
        sm.ds[r * kBK + j] = p * (dp[i] - sm.delta[r]) * scale;
      }
    }
    __syncthreads();

    // dq += ds @ K: thread (d = tid % D) owns column d of its rows
    {
      const int d = tid % D, a0 = tid / D;
      for (int j = 0; j < kBK; ++j) {
        const float kd = sm.k[j * kKS + d];
#pragma unroll
        for (int i = 0; i < Rows::kCount; ++i)
          acc[i] += sm.ds[(a0 + i * Rows::kStep) * kBK + j] * kd;
      }
    }
    __syncthreads();
  }

  const int d = tid % D, a0 = tid / D;
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) {
    const int row = i0 + a0 + i * Rows::kStep;
    if (row < Sq)
      dq[q_at + (long long)(row - i0) * row_stride + d] =
          rt::from_f32<T>(acc[i]);
  }
}

// ---------------------------------------------------------------------------
// f32 arm, dk, dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int kKS = D + 1;  // padded K / V row
  static constexpr int kFloats =
      2 * kBN * kKS + 2 * kBM * D + 2 * kBM * kBN + 2 * kBM;
  static constexpr size_t kBytes = sizeof(float) * (size_t)kFloats;
  float* k;
  float* v;
  float* q;
  float* dout;
  float* p;
  float* ds;
  float* lse;
  float* delta;
  __device__ explicit DkvSmem(float* base) {
    k = base;
    v = k + kBN * kKS;
    q = v + kBN * kKS;
    dout = q + kBM * D;
    p = dout + kBM * D;
    ds = p + kBM * kBN;
    lse = ds + kBM * kBN;
    delta = lse + kBM;
  }
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
               int q_off, int Hq, int Hkv, int causal, int window,
               float scale) {
  using Sm = DkvSmem<D>;
  constexpr int kKS = Sm::kKS;
  constexpr int kStepS = kThreads / kBN;  // query rows between a thread's
  constexpr int kRS = kBM / kStepS;       // score rows
  constexpr int kStepA = kThreads / D;    // keys between a thread's
  constexpr int kCA = kBN / kStepA;       // accumulator rows
  extern __shared__ float smem_raw[];
  const Sm sm(smem_raw);
  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int j0 = ik * kBN;
  const int tid = threadIdx.x;
  const long long kv_stride = (long long)Hkv * D;
  const long long kv_off = ((long long)b * Sk + j0) * kv_stride +
                           (long long)hk * D;
  const long long row_stride = (long long)Hq * D;

  {
    float* const dst[2] = {sm.k, sm.v};
    const T* const src[2] = {k + kv_off, v + kv_off};
    rt::load_rows_f32<D, kBN, 2, T>(dst, kKS, src, kv_stride, Sk - j0);
  }
  float dk_acc[kCA], dv_acc[kCA];
#pragma unroll
  for (int i = 0; i < kCA; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  int qt_begin, qt_end;
  live_q_tiles<kBM>(j0, min(j0 + kBN, Sk) - 1, Sq, q_off, causal, window,
                    qt_begin, qt_end);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long stat_off = ((long long)b * Hq + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int m0 = qt * kBM;
      const long long q_at = ((long long)b * Sq + m0) * row_stride +
                             (long long)h * D;
      __syncthreads();  // the previous tile's readers are done
      {
        float* const dst[2] = {sm.q, sm.dout};
        const T* const src[2] = {q + q_at, dout + q_at};
        rt::load_rows_f32<D, kBM, 2, T>(dst, D, src, row_stride, Sq - m0);
      }
      if (tid < kBM) {
        const int row = m0 + tid;
        sm.lse[tid] = row < Sq ? lse[stat_off + row] : 0.f;
        sm.delta[tid] = row < Sq ? delta[stat_off + row] : 0.f;
      }
      __syncthreads();

      // p and ds for key j of the block against rows r0 + i * kStepS
      {
        const int j = tid % kBN, r0 = tid / kBN;
        float sc[kRS], dp[kRS];
#pragma unroll
        for (int i = 0; i < kRS; ++i) sc[i] = dp[i] = 0.f;
        const float* krow = sm.k + j * kKS;
        const float* vrow = sm.v + j * kKS;
        for (int d = 0; d < D; ++d) {
          const float kd = krow[d], vd = vrow[d];
#pragma unroll
          for (int i = 0; i < kRS; ++i) {
            const int r = r0 + i * kStepS;
            sc[i] += sm.q[r * D + d] * kd;
            dp[i] += sm.dout[r * D + d] * vd;
          }
        }
#pragma unroll
        for (int i = 0; i < kRS; ++i) {
          const int r = r0 + i * kStepS;
          const float p = valid(m0 + r, j0 + j, Sq, Sk, q_off, causal,
                                window)
                              ? expf(sc[i] * scale - sm.lse[r])
                              : 0.f;
          sm.p[r * kBN + j] = p;
          sm.ds[r * kBN + j] = p * (dp[i] - sm.delta[r]) * scale;
        }
      }
      __syncthreads();

      // dv += p^T do, dk += ds^T q: thread (d = tid % D) owns column d of
      // keys a0 + i * kStepA
      {
        const int d = tid % D, a0 = tid / D;
        for (int r = 0; r < kBM; ++r) {
          const float dod = sm.dout[r * D + d], qd = sm.q[r * D + d];
#pragma unroll
          for (int i = 0; i < kCA; ++i) {
            const int j = a0 + i * kStepA;
            dv_acc[i] += sm.p[r * kBN + j] * dod;
            dk_acc[i] += sm.ds[r * kBN + j] * qd;
          }
        }
      }
    }
  }

  const int d = tid % D, a0 = tid / D;
#pragma unroll
  for (int i = 0; i < kCA; ++i) {
    const int j = a0 + i * kStepA;
    if (j0 + j < Sk) {
      const long long at = kv_off + (long long)j * kv_stride + d;
      dk[at] = rt::from_f32<T>(dk_acc[i]);
      dv[at] = rt::from_f32<T>(dv_acc[i]);
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int Sq, int Sk, int q_off, int Hq,
               int Hkv, int causal, int window, cudaStream_t stream) {
  using T = float;
  static bool configured = false;
  if (!configured) {
    int err = set_smem(dq_kernel<D, T>, DqSmem<D>::kBytes);
    if (err == 0) err = set_smem(dkv_kernel<D, T>, DkvSmem<D>::kBytes);
    if (err != 0) return err;
    configured = true;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  dq_kernel<D, T><<<dim3((Sq + kBQ - 1) / kBQ, Hq, B), kThreads,
                    DqSmem<D>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), Sq, Sk, q_off, Hq, Hkv,
      causal, window, scale);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv_kernel<D, T><<<dim3((Sk + kBN - 1) / kBN, Hkv, B), kThreads,
                     DkvSmem<D>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, q_off, Hq, Hkv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 arm: tensor cores
// ---------------------------------------------------------------------------

using mt::bf16;
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows (dq) or keys (dkv) each
constexpr int kMBQ = 64;          // dq: query rows per block
constexpr int kMBK = 64;          // dq: keys per tile
constexpr int kMBN = 64;          // dkv: keys per block
constexpr int kMBM = 32;          // dkv: query rows per tile


template <int D>
struct DqMmaSmem {
  static constexpr int kRow = mt::row_stride<D>();
  static constexpr int kTile = kMBK * kRow;  // one K or V tile, elements
  // q tile, do tile, two buffers of (K tile, V tile); then f32 lse (log2
  // units) and delta of the block's rows
  static constexpr size_t kBytes =
      sizeof(bf16) * (2 * (size_t)kMBQ * kRow + 4 * (size_t)kTile) +
      sizeof(float) * 2 * kMBQ;
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  bf16* __restrict__ dq, int Sq, int Sk, int q_off, int Hq,
                  int Hkv, int causal, int window, float scale) {
  using Sm = DqMmaSmem<D>;
  constexpr int kRow = Sm::kRow;
  constexpr int kKD = D / 16;
  constexpr int kNK = kMBK / 8;
  constexpr int kND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sq = reinterpret_cast<bf16*>(smem_mma);
  bf16* sdo = sq + kMBQ * kRow;
  bf16* skv = sdo + kMBQ * kRow;  // [buffer][K, V][kMBK rows]
  float* slse = reinterpret_cast<float*>(skv + 4 * Sm::kTile);
  float* sdelta = slse + kMBQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = causal ? (int)gridDim.z - 1 - (int)blockIdx.z
                        : (int)blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int i0 = iq * kMBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const long long q_at = ((long long)b * Sq + i0) * q_stride +
                         (long long)h * D;
  const long long stat_off = ((long long)b * Hq + h) * Sq;
  const bf16* kg = k + (long long)b * Sk * kv_stride + (long long)hk * D;
  const bf16* vg = v + (long long)b * Sk * kv_stride + (long long)hk * D;

  const int p0 = q_off + i0;  // the block's first query position
  int kt_begin = 0, kt_end = (Sk + kMBK - 1) / kMBK;
  if (causal) kt_end = min(kt_end, (p0 + kMBQ - 1) / kMBK + 1);
  if (window > 0) {
    const int t = p0 - window + 1;  // live iff (kt + 1) * kMBK > t
    if (t > 0) kt_begin = t / kMBK;
  }

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kMBK;
    bf16* dst = skv + buf * 2 * Sm::kTile;
    mt::load_tile_async<kMBK, D, kMmaThreads>(dst, kg + k0 * kv_stride,
                                              kv_stride, Sk - k0);
    mt::load_tile_async<kMBK, D, kMmaThreads>(dst + Sm::kTile,
                                              vg + k0 * kv_stride, kv_stride,
                                              Sk - k0);
  };
  mt::load_tile_async<kMBQ, D, kMmaThreads>(sq, q + q_at, q_stride, Sq - i0);
  mt::load_tile_async<kMBQ, D, kMmaThreads>(sdo, dout + q_at, q_stride,
                                            Sq - i0);
  load_kv(kt_begin, 0);
  mt::cp_async_commit();
  mt::cp_async_wait<0>();
  __syncthreads();

  // delta = rowsum(do * o) in f32 over the warp's own 16 rows
  for (int r = 0; r < 16; ++r) {
    const int lr = warp * 16 + r, row = i0 + lr;
    float dsum = 0.f;
    if (row < Sq) {
      const bf16* orow = o + q_at + (long long)lr * q_stride;
      for (int d = lane; d < D; d += 32)
        dsum += __bfloat162float(sdo[lr * kRow + d]) *
                __bfloat162float(orow[d]);
    }
    dsum = rt::warp_sum(dsum);
    if (lane == 0) {
      sdelta[lr] = dsum;
      slse[lr] = row < Sq ? lse[stat_off + row] * mt::kLog2e : 0.f;
      if (row < Sq) delta[stat_off + row] = dsum;
    }
  }
  __syncwarp();
  const int lrow = warp * 16 + (lane >> 2);  // block rows lrow, lrow + 8
  const int row0 = i0 + lrow;
  const int col0 = 2 * (lane & 3);
  const float lse2[2] = {slse[lrow], slse[lrow + 8]};
  const float dlt[2] = {sdelta[lrow], sdelta[lrow + 8]};

  uint32_t qf[kKD][4];
  const uint32_t sq_u = mt::smem_u32(sq), sdo_u = mt::smem_u32(sdo);
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk)
    mt::ldsm_x4(qf[kk], mt::a_addr<D>(sq_u, warp * 16, kk * 16, lane));
  float acc[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  const float sl2 = scale * mt::kLog2e;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, buf ^ 1);
    mt::cp_async_commit();
    const uint32_t sk = mt::smem_u32(skv + buf * 2 * Sm::kTile);
    const uint32_t sv = sk + Sm::kTile * (uint32_t)sizeof(bf16);
    const int k0 = kt * kMBK;

    // S = Q K^T, dP = dO V^T
    float s[kNK][4], dp[kNK][4];
#pragma unroll
    for (int nt = 0; nt < kNK; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t da[4];
      mt::ldsm_x4(da, mt::a_addr<D>(sdo_u, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < kNK / 2; ++np) {
        uint32_t bk[4], bv[4];
        mt::ldsm_x4(bk, mt::b_addr<D>(sk, np * 16, kk * 16, lane));
        mt::mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mt::mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        mt::ldsm_x4(bv, mt::b_addr<D>(sv, np * 16, kk * 16, lane));
        mt::mma_bf16(dp[2 * np], da, bv[0], bv[1]);
        mt::mma_bf16(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }

    // p = exp(s * scale - lse), ds = p (dp - delta) scale, in f32
    const bool full = k0 + kMBK <= Sk && i0 + kMBQ <= Sq &&
                      (!causal || k0 + kMBK - 1 <= p0) &&
                      (window <= 0 || k0 > p0 + kMBQ - 1 - window);
#pragma unroll
    for (int nt = 0; nt < kNK; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        const bool ok =
            full || valid(row0 + rr * 8, k0 + nt * 8 + col0 + (c & 1), Sq,
                          Sk, q_off, causal, window);
        const float p = ok ? exp2f(s[nt][c] * sl2 - lse2[rr]) : 0.f;
        s[nt][c] = p * (dp[nt][c] - dlt[rr]) * scale;
      }
    }

    // dq += dS K, dS rounded to bf16 from registers
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      uint32_t da[4];
      mt::c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bk[4];
        mt::ldsm_x4_trans(bk, mt::bt_addr<D>(sk, kk * 16, dp2 * 16, lane));
        mt::mma_bf16(acc[2 * dp2], da, bk[0], bk[1]);
        mt::mma_bf16(acc[2 * dp2 + 1], da, bk[2], bk[3]);
      }
    }
    mt::cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + rr * 8;
    if (row >= Sq) continue;
    bf16* out = dq + q_at + (long long)(lrow + rr * 8) * q_stride;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd)
      *reinterpret_cast<uint32_t*>(out + nd * 8 + col0) =
          mt::pack_bf16(acc[nd][2 * rr], acc[nd][2 * rr + 1]);
  }
}

template <int D>
struct DkvMmaSmem {
  static constexpr int kRow = mt::row_stride<D>();
  static constexpr int kKV = kMBN * kRow;  // the block's K or V tile
  static constexpr int kQT = kMBM * kRow;  // one q or do tile
  // K, V; two buffers of (q tile, do tile); then two buffers of f32
  // (lse in log2 units, delta) of the query tile's rows
  static constexpr size_t kBytes =
      sizeof(bf16) * (2 * (size_t)kKV + 4 * (size_t)kQT) +
      sizeof(float) * 4 * kMBM;
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ part,
                   bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
                   int B, int Sq, int Sk, int q_off, int Hq, int Hkv,
                   int n_split, int causal, int window, float scale) {
  using Sm = DkvMmaSmem<D>;
  constexpr int kKD = D / 16;
  constexpr int kNM = kMBM / 8;  // n8 tiles of a transposed score row
  constexpr int kND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sk = reinterpret_cast<bf16*>(smem_mma);
  bf16* sv = sk + Sm::kKV;
  bf16* sqd = sv + Sm::kKV;  // [buffer][q, do][kMBM rows]
  float* sstat = reinterpret_cast<float*>(sqd + 4 * Sm::kQT);
  const int G = Hq / Hkv, gps = G / n_split;
  const int hk = blockIdx.x / n_split, sp = blockIdx.x % n_split;
  const int b = blockIdx.y, ik = blockIdx.z;
  const int j0 = ik * kMBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const long long kv_off = ((long long)b * Sk + j0) * kv_stride +
                           (long long)hk * D;

  int qt_begin, qt_end;
  live_q_tiles<kMBM>(j0, min(j0 + kMBN, Sk) - 1, Sq, q_off, causal, window,
                     qt_begin, qt_end);
  const int n_live = qt_end - qt_begin;
  const int n_items = gps * n_live;  // (q head of the split, q tile) pairs

  auto load_q = [&](int item, int buf) {
    const int h = hk * G + sp * gps + item / n_live;
    const int m0 = (qt_begin + item % n_live) * kMBM;
    const long long q_at = ((long long)b * Sq + m0) * q_stride +
                           (long long)h * D;
    bf16* dst = sqd + buf * 2 * Sm::kQT;
    mt::load_tile_async<kMBM, D, kMmaThreads>(dst, q + q_at, q_stride,
                                              Sq - m0);
    mt::load_tile_async<kMBM, D, kMmaThreads>(dst + Sm::kQT, dout + q_at,
                                              q_stride, Sq - m0);
    if (tid < kMBM) {
      const long long stat_off = ((long long)b * Hq + h) * Sq;
      const int row = m0 + tid;
      float* st = sstat + buf * 2 * kMBM;
      st[tid] = row < Sq ? lse[stat_off + row] * mt::kLog2e : 0.f;
      st[kMBM + tid] = row < Sq ? delta[stat_off + row] : 0.f;
    }
  };
  mt::load_tile_async<kMBN, D, kMmaThreads>(sk, k + kv_off, kv_stride,
                                            Sk - j0);
  mt::load_tile_async<kMBN, D, kMmaThreads>(sv, v + kv_off, kv_stride,
                                            Sk - j0);
  if (n_items > 0) load_q(0, 0);
  mt::cp_async_commit();
  mt::cp_async_wait<0>();
  __syncthreads();

  float dk[kND][4], dv[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[nd][c] = dv[nd][c] = 0.f;
  const uint32_t sk_u = mt::smem_u32(sk), sv_u = mt::smem_u32(sv);
  const int key0 = j0 + warp * 16 + (lane >> 2);  // keys key0, key0 + 8
  const int col0 = 2 * (lane & 3);
  const float sl2 = scale * mt::kLog2e;

  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_items) load_q(it + 1, buf ^ 1);
    mt::cp_async_commit();
    const int m0 = (qt_begin + it % n_live) * kMBM;
    const uint32_t sq_u = mt::smem_u32(sqd + buf * 2 * Sm::kQT);
    const uint32_t sdo_u = sq_u + Sm::kQT * (uint32_t)sizeof(bf16);
    const float* st = sstat + buf * 2 * kMBM;

    // S^T = K Q^T, dP^T = V dO^T: rows are the warp's keys
    float s[kNM][4], dp[kNM][4];
#pragma unroll
    for (int nt = 0; nt < kNM; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t ka[4], va[4];
      mt::ldsm_x4(ka, mt::a_addr<D>(sk_u, warp * 16, kk * 16, lane));
      mt::ldsm_x4(va, mt::a_addr<D>(sv_u, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < kNM / 2; ++np) {
        uint32_t bq[4], bd[4];
        mt::ldsm_x4(bq, mt::b_addr<D>(sq_u, np * 16, kk * 16, lane));
        mt::mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mt::mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        mt::ldsm_x4(bd, mt::b_addr<D>(sdo_u, np * 16, kk * 16, lane));
        mt::mma_bf16(dp[2 * np], va, bd[0], bd[1]);
        mt::mma_bf16(dp[2 * np + 1], va, bd[2], bd[3]);
      }
    }

    // p^T and ds^T in f32; queries past Sq get p = 0 (their rows of q and
    // do are zero, but lse is not theirs)
    const int p0 = q_off + m0;  // the tile's first query position
    const bool full = m0 + kMBM <= Sq && j0 + kMBN <= Sk &&
                      (!causal || j0 + kMBN - 1 <= p0) &&
                      (window <= 0 || j0 > p0 + kMBM - 1 - window);
#pragma unroll
    for (int nt = 0; nt < kNM; ++nt) {
      const int qc = nt * 8 + col0;
      const float2 ls = *reinterpret_cast<const float2*>(st + qc);
      const float2 dl = *reinterpret_cast<const float2*>(st + kMBM + qc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = full || valid(m0 + qc + (c & 1),
                                      key0 + (c >> 1) * 8, Sq, Sk, q_off,
                                      causal, window);
        const float l2 = (c & 1) ? ls.y : ls.x;
        const float d0 = (c & 1) ? dl.y : dl.x;
        const float p = ok ? exp2f(s[nt][c] * sl2 - l2) : 0.f;
        s[nt][c] = p;
        dp[nt][c] = p * (dp[nt][c] - d0) * scale;
      }
    }

    // dv += P^T dO, dk += dS^T Q, P^T and dS^T rounded to bf16 from
    // registers
#pragma unroll
    for (int kk = 0; kk < kMBM / 16; ++kk) {
      uint32_t pa[4], da[4];
      mt::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      mt::c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bd[4], bq[4];
        mt::ldsm_x4_trans(bd,
                          mt::bt_addr<D>(sdo_u, kk * 16, dp2 * 16, lane));
        mt::mma_bf16(dv[2 * dp2], pa, bd[0], bd[1]);
        mt::mma_bf16(dv[2 * dp2 + 1], pa, bd[2], bd[3]);
        mt::ldsm_x4_trans(bq, mt::bt_addr<D>(sq_u, kk * 16, dp2 * 16, lane));
        mt::mma_bf16(dk[2 * dp2], da, bq[0], bq[1]);
        mt::mma_bf16(dk[2 * dp2 + 1], da, bq[2], bq[3]);
      }
    }
    mt::cp_async_wait<0>();
    __syncthreads();
  }

  // f32 partials of this split: part[0][sp] is dk, part[1][sp] is dv;
  // with one split (part null) dk and dv themselves, rounded once to bf16
  // as the sum launch would round its one partial
  const long long n = (long long)B * Sk * Hkv * D;
  float* pk = part + (long long)sp * n;
  float* pv = part + (long long)(n_split + sp) * n;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key0 + rr * 8;
    if (key >= Sk) continue;
    const long long at = (((long long)b * Sk + key) * Hkv + hk) * D + col0;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      if (part == nullptr) {
        *reinterpret_cast<uint32_t*>(dk_out + at + nd * 8) =
            mt::pack_bf16(dk[nd][2 * rr], dk[nd][2 * rr + 1]);
        *reinterpret_cast<uint32_t*>(dv_out + at + nd * 8) =
            mt::pack_bf16(dv[nd][2 * rr], dv[nd][2 * rr + 1]);
        continue;
      }
      *reinterpret_cast<float2*>(pk + at + nd * 8) =
          make_float2(dk[nd][2 * rr], dk[nd][2 * rr + 1]);
      *reinterpret_cast<float2*>(pv + at + nd * 8) =
          make_float2(dv[nd][2 * rr], dv[nd][2 * rr + 1]);
    }
  }
}

// dk (blockIdx.y = 0) or dv (1) = the sum of its n_split f32 partials, in
// split order, cast to bf16; n elements, 4 a thread (n % 4 == 0)
__global__ void __launch_bounds__(256)
    dkv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, long long n, int n_split) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float* src = part + (long long)blockIdx.y * n_split * n + i;
  float4 a = *reinterpret_cast<const float4*>(src);
  for (int sp = 1; sp < n_split; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(src + sp * n);
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  uint2 w;
  w.x = mt::pack_bf16(a.x, a.y);
  w.y = mt::pack_bf16(a.z, a.w);
  *reinterpret_cast<uint2*>((blockIdx.y == 0 ? dk : dv) + i) = w;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, void* part, int n_split, int B, int Sq,
                int Sk, int q_off, int Hq, int Hkv, int causal, int window,
                cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    int err = set_smem(dq_mma_kernel<D>, DqMmaSmem<D>::kBytes);
    if (err == 0) err = set_smem(dkv_mma_kernel<D>, DkvMmaSmem<D>::kBytes);
    if (err != 0) return err;
    configured = true;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  dq_mma_kernel<D><<<dim3(Hq, B, (Sq + kMBQ - 1) / kMBQ), kMmaThreads,
                     DqMmaSmem<D>::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), Sq, Sk, q_off, Hq,
      Hkv, causal, window, scale);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv_mma_kernel<D><<<dim3(Hkv * n_split, B, (Sk + kMBN - 1) / kMBN),
                      kMmaThreads, DkvMmaSmem<D>::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(part), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, Sq, Sk, q_off, Hq, Hkv, n_split, causal,
      window, scale);
  err = (int)cudaGetLastError();
  if (err != 0 || part == nullptr) return err;
  const long long n = (long long)B * Sk * Hkv * D;
  dkv_sum_kernel<<<dim3((unsigned)((n / 4 + 255) / 256), 2), 256, 0,
                   stream>>>(static_cast<const float*>(part),
                             static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                             n, n_split);
  return (int)cudaGetLastError();
}

template <int D>
int launch_t(int dtype, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const void* lse, void* delta,
             void* dq, void* dk, void* dv, void* part, int n_split, int B,
             int Sq, int Sk, int q_off, int Hq, int Hkv, int causal,
             int window, cudaStream_t s) {
  switch (dtype) {
    case rt::kF32:
      return launch_f32<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                           Sk, q_off, Hq, Hkv, causal, window, s);
    case rt::kBF16:
      if ((part == nullptr) != (n_split == 1) || n_split <= 0 ||
          (Hq / Hkv) % n_split != 0 || Hkv * n_split > 65535)
        return (int)cudaErrorInvalidValue;
      return launch_bf16<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                            n_split, B, Sq, Sk, q_off, Hq, Hkv, causal,
                            window, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Sk, Hkv, D); one dtype
// (f32 or bf16) for all ten; lse and the scratch delta (B, Hq, Sq) f32.
// Query row i sits at position q_off + i, key row j at j; q_off >= 0,
// Sq + q_off <= Sk (the whole arm: q_off = 0, Sq = Sk).  The bf16 arm also
// takes n_split, dividing Hq / Hkv, and for n_split > 1 the f32 scratch
// `part` (2, n_split, B, Sk, Hkv, D) for the dkv kernel's partials (null
// for n_split = 1); the f32 arm ignores both.  All contiguous, q, k, v,
// dout 16-byte aligned.  D in {64, 128}, Hq % Hkv == 0; causal 0 or 1;
// window <= 0 means none.  Launches the dq kernel, then the dkv kernel
// (then, bf16 over several splits, the sum of the partials), on
// `stream`.  Returns the CUDA error code.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk,
                                      void* dv, void* part, int n_split,
                                      int B, int Sq, int Sk, int q_off,
                                      int Hq, int Hkv, int D, int causal,
                                      int window, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 || q_off < 0 ||
      Sq > Sk - q_off || (Sq + kMBQ - 1) / kMBQ > 65535 ||
      (Sk + kMBN - 1) / kMBN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_t<64>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv,
                          part, n_split, B, Sq, Sk, q_off, Hq, Hkv, causal,
                          window, s);
    case 128:
      return launch_t<128>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv,
                           part, n_split, B, Sq, Sk, q_off, Hq, Hkv, causal,
                           window, s);
  }
  return (int)cudaErrorInvalidValue;
}
