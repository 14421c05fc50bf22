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
// Rounding: p and ds stay in f32 and every product is an f32 FMA; the TPU
// kernel rounds p and ds to the input dtype before its products
// (flash_attention_bwd.py:86,121,127) because the MXU takes bf16 operands.
// The plain version (kernels/ref.py::flash_attention_bwd_ref) also keeps p
// and ds in f32, so on bf16 inputs kernel and plain version differ only by
// the order of f32 sums before the one rounding of each output.
//
// Bound on the H100: operations.  The least work is five products of D
// terms per live pair (s, dp, dq, dk, dv), 10 * D operations per pair:
// 85.9 GFLOP at the train shape (B = 4, S = 1024, 32 q heads over 4 kv
// heads, D = 128, causal), 0.087 ms at the 989 TFLOP/s bf16 peak, against
// 0.045 ms for its 152 MB of q, k, v, o, do, lse, dq, dk and dv in bf16.
//
// Design: two kernels on one stream.
//   dq:  one block per (q tile of 64 rows, q head, batch row).  It stages
//        its q and do rows in shared memory as f32, computes delta for its
//        rows (writing it, (B, Hq, S) f32, for the dkv kernel), then walks
//        the live key tiles of 32 rows: per tile it builds ds in shared
//        memory and accumulates ds @ K into registers.
//   dkv: one block per (k tile of 64 rows, kv head, batch row).  K and V
//        stay in shared memory while the block loops over the G q heads of
//        its group and, for each, over the live q tiles of 32 rows: per
//        tile it builds p and ds in shared memory and accumulates p^T do and
//        ds^T q for the kv head directly.  The TPU grid could not revisit a
//        block, so its kernel writes dk, dv per q head into (B, Hq, S, D)
//        buffers and sums the groups outside; a Hopper block loops instead,
//        so there is no such buffer and no second pass.
// Dead tiles are skipped by the forward's rule (and its transpose in dkv).
// Staging and products follow rt::attend_tiles: rows padded to D + 1
// floats, one thread per key of a tile for the scores, one thread per
// column for the accumulators.  f32 FMAs from shared memory, simple and
// right first; tensor cores, TMA and a split of the dkv loop are later
// work.
#include <cmath>

#include "attention_tiles.cuh"

namespace {

constexpr int kThreads = rt::kThreads;
constexpr int kBQ = 64;  // dq kernel: query rows per block
constexpr int kBK = 32;  // dq kernel: keys per tile
constexpr int kBN = 64;  // dkv kernel: keys per block
constexpr int kBM = 32;  // dkv kernel: query rows per tile

__device__ __forceinline__ bool valid(int qp, int kp, int S, int causal,
                                      int window) {
  return qp < S && kp < S && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// dq (+ delta)
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
              float* __restrict__ delta, T* __restrict__ dq, int S, int Hq,
              int Hkv, int causal, int window, float scale) {
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
  const long long q_off = ((long long)b * S + i0) * row_stride +
                          (long long)h * D;
  const long long stat_off = ((long long)b * Hq + h) * S;

  // q and do rows -> shared (f32); rows past S are zero
  {
    float* const dst[2] = {sm.q, sm.dout};
    const T* const src[2] = {q + q_off, dout + q_off};
    rt::load_rows_f32<D, kBQ, 2, T>(dst, D, src, row_stride, S - i0);
  }
  __syncthreads();
  // delta = rowsum(do * o) in f32, one warp per row
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int row = i0 + r;
    float dsum = 0.f;
    if (row < S) {
      const T* orow = o + q_off + r * row_stride;
      for (int d = lane; d < D; d += 32)
        dsum += sm.dout[r * D + d] * rt::to_f32(orow[d]);
    }
    dsum = rt::warp_sum(dsum);
    if (lane == 0) {
      sm.delta[r] = dsum;
      sm.lse[r] = row < S ? lse[stat_off + row] : 0.f;
      if (row < S) delta[stat_off + row] = dsum;
    }
  }

  float acc[Rows::kCount];
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) acc[i] = 0.f;
  int kt_begin = 0, kt_end = (S + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (i0 + kBQ - 1) / kBK + 1);
  if (window > 0) {
    const int t = i0 - window + 1;  // live iff (kt + 1) * kBK > t
    if (t > 0) kt_begin = t / kBK;
  }
  const long long kv_stride = (long long)Hkv * D;
  const long long kv_off = (long long)b * S * kv_stride + (long long)hk * D;
  __syncthreads();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    {
      float* const dst[2] = {sm.k, sm.v};
      const T* const src[2] = {k + kv_off + k0 * kv_stride,
                               v + kv_off + k0 * kv_stride};
      rt::load_rows_f32<D, kBK, 2, T>(dst, kKS, src, kv_stride, S - k0);
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
        const float p = valid(i0 + r, k0 + j, S, causal, window)
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
    if (row < S)
      dq[q_off + (long long)(row - i0) * row_stride + d] =
          rt::from_f32<T>(acc[i]);
  }
}

// ---------------------------------------------------------------------------
// dk, dv
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
               T* __restrict__ dk, T* __restrict__ dv, int S, int Hq, int Hkv,
               int causal, int window, float scale) {
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
  const long long kv_off = ((long long)b * S + j0) * kv_stride +
                           (long long)hk * D;
  const long long row_stride = (long long)Hq * D;

  {
    float* const dst[2] = {sm.k, sm.v};
    const T* const src[2] = {k + kv_off, v + kv_off};
    rt::load_rows_f32<D, kBN, 2, T>(dst, kKS, src, kv_stride, S - j0);
  }
  float dk_acc[kCA], dv_acc[kCA];
#pragma unroll
  for (int i = 0; i < kCA; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // live q tiles (the forward's rule, transposed): none whose last row is
  // before the block's first key (causal); none whose first row is at or
  // past the block's last key + window (window)
  const int n_qt = (S + kBM - 1) / kBM;
  const int qt_begin = causal ? j0 / kBM : 0;
  int qt_end = n_qt;
  if (window > 0) {
    const int k_hi = min(j0 + kBN, S) - 1;
    qt_end = min(n_qt, (k_hi + window - 1) / kBM + 1);
  }

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long stat_off = ((long long)b * Hq + h) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int m0 = qt * kBM;
      const long long q_off = ((long long)b * S + m0) * row_stride +
                              (long long)h * D;
      __syncthreads();  // the previous tile's readers are done
      {
        float* const dst[2] = {sm.q, sm.dout};
        const T* const src[2] = {q + q_off, dout + q_off};
        rt::load_rows_f32<D, kBM, 2, T>(dst, D, src, row_stride, S - m0);
      }
      if (tid < kBM) {
        const int row = m0 + tid;
        sm.lse[tid] = row < S ? lse[stat_off + row] : 0.f;
        sm.delta[tid] = row < S ? delta[stat_off + row] : 0.f;
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
          const float p = valid(m0 + r, j0 + j, S, causal, window)
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
    if (j0 + j < S) {
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

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int S, int Hq, int Hkv, int causal, int window,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    int err = set_smem(dq_kernel<D, T>, DqSmem<D>::kBytes);
    if (err == 0) err = set_smem(dkv_kernel<D, T>, DkvSmem<D>::kBytes);
    if (err != 0) return err;
    configured = true;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  dq_kernel<D, T><<<dim3((S + kBQ - 1) / kBQ, Hq, B), kThreads,
                    DqSmem<D>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), S, Hq, Hkv, causal,
      window, scale);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv_kernel<D, T><<<dim3((S + kBN - 1) / kBN, Hkv, B), kThreads,
                     DkvSmem<D>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, Hq, Hkv, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_t(int dtype, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const void* lse, void* delta,
             void* dq, void* dk, void* dv, int B, int S, int Hq, int Hkv,
             int causal, int window, cudaStream_t s) {
  switch (dtype) {
    case rt::kF32:
      return launch<D, float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                              Hq, Hkv, causal, window, s);
    case rt::kBF16:
      return launch<D, __nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, B, S, Hq, Hkv, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D); one dtype (f32
// or bf16) for all ten; lse and the scratch delta (B, Hq, S) f32.  All
// contiguous, q, k, v, dout 16-byte aligned.  D in {64, 128}, Hq % Hkv ==
// 0; causal 0 or 1; window <= 0 means none.  Launches the dq kernel, then
// the dkv kernel, on `stream`.  Returns the CUDA error code.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk,
                                      void* dv, int B, int S, int Hq, int Hkv,
                                      int D, int causal, int window,
                                      int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_t<64>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                          S, Hq, Hkv, causal, window, s);
    case 128:
      return launch_t<128>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                           S, Hq, Hkv, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
