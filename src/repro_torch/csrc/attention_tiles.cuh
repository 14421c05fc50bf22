// Block-level online-softmax attention over key tiles in f32 FMAs: the
// SIMT body of the append kernel's f32 and int8 arms (flash_append.cu: a
// tile of chunk rows of one query head) and of the training forward's f32
// arm (flash_attention.cu, key positions = row indices).  Scores in f32,
// validity from a per-key absolute position map `kpos` (-1 = invalid),
// masked scores set to the finite NEG, running (m, l, acc) in f32, p never
// rounded.
//
// One block of kThreads threads owns R query rows (already in shared memory
// as f32) and walks key tiles of BK rows.  Per tile:
//   1. K and V tiles are copied from device memory into shared memory as
//      f32 with 16-byte loads (int8 tiles dequantised with their row scales
//      on the way), rows padded to D + 1 floats so that the score loop,
//      where the 32 lanes of a warp read 32 different key rows, hits 32
//      banks;
//   2. scores: thread (j = tid % BK) computes row j of the tile against
//      rows tid / BK + k * (kThreads / BK) of Q, reusing each K element
//      for all its rows; the mask is applied on absolute positions;
//   3. online softmax: one warp per query row, lanes over the tile's keys;
//   4. acc: thread (d = tid % D) updates column d of its rows
//      tid / D + k * (kThreads / D), reading p as a warp-wide broadcast.
// Key rows at or past Sk (the ragged last tile) get weight exactly 0 and do
// not take part in the running max; they do not exist in the reference.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rt {

constexpr int kThreads = 256;
constexpr int kAbsent = -2147483647 - 1;  // key row past the end of the stream

// Shared-memory carve-up for R_MAX query rows, head dim D and key tile BK.
template <int D, int BK, int R_MAX>
struct TileSmem {
  static constexpr int kQ = R_MAX * D;           // f32 query rows
  static constexpr int kKV = BK * (D + 1);       // f32 K (and V) tile, padded
  static constexpr int kS = R_MAX * BK;          // f32 scores / probabilities
  static constexpr int kFloats = kQ + 2 * kKV + kS + 3 * R_MAX;
  static constexpr int kInts = BK + R_MAX;       // tile kpos, per-row qpos
  static constexpr size_t kBytes =
      sizeof(float) * (size_t)kFloats + sizeof(int) * (size_t)kInts;

  float* q;
  float* k;
  float* v;
  float* s;
  float* m;
  float* l;
  float* corr;
  int* kp;
  int* qpos;

  __device__ explicit TileSmem(float* base) {
    q = base;
    k = q + kQ;
    v = k + kKV;
    s = v + kKV;
    m = s + kS;
    l = m + R_MAX;
    corr = l + R_MAX;
    kp = reinterpret_cast<int*>(corr + R_MAX);
    qpos = kp + BK;
  }
};

// Copy rows [0, ROWS) of NSRC row-major sources (row r of source i at
// src[i] + r * stride, D elements, 16-byte aligned) into shared memory as
// f32 (row r of destination i at dst[i] + r * dst_stride); rows >=
// valid_rows are zero.  Each thread first issues all its 16-byte loads and
// only then converts and stores, so a block keeps kThreads * NSRC *
// iterations loads in flight instead of one per thread.  An int8 source
// is dequantised on the way: each element times its row's f32 scale
// (scl[i] + r * scale_stride, loaded beside the 16 bytes), so the
// device-memory stream stays int8; float sources ignore scl.
template <int D, int ROWS, int NSRC, typename T>
__device__ __forceinline__ void load_rows_f32(
    float* const (&dst)[NSRC], int dst_stride, const T* const (&src)[NSRC],
    long long stride, int valid_rows, const float* const* scl = nullptr,
    long long scale_stride = 0) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int kTotal = ROWS * kChunks;
  constexpr int kIters = (kTotal + kThreads - 1) / kThreads;
  static_assert(D % kVec == 0, "row must be whole 16-byte chunks");
  uint4 buf[NSRC][kIters];
  float sc[NSRC][kQuant ? kIters : 1];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = e / kChunks, c = e % kChunks;
    const bool live = e < kTotal && r < valid_rows;
#pragma unroll
    for (int i = 0; i < NSRC; ++i) {
      buf[i][it] = live ? *reinterpret_cast<const uint4*>(
                              src[i] + r * stride + c * kVec)
                        : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (kQuant) sc[i][it] = live ? scl[i][r * scale_stride] : 0.f;
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (e >= kTotal) continue;
    const int r = e / kChunks, c = e % kChunks;
#pragma unroll
    for (int i = 0; i < NSRC; ++i) {
      const T* el = reinterpret_cast<const T*>(&buf[i][it]);
      float* d = dst[i] + r * dst_stride + c * kVec;
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        if constexpr (kQuant)
          d[t] = to_f32(el[t]) * sc[i][it];
        else
          d[t] = to_f32(el[t]);
      }
    }
  }
}

// Rows of acc a thread owns: tid / D + k * (kThreads / D), k < RA.
template <int D, int R_MAX>
struct AccRows {
  static constexpr int kStep = kThreads / D;
  static constexpr int kCount = (R_MAX + kStep - 1) / kStep;
};

// Walk key tiles [kt_begin, kt_end) of a key stream of Sk rows.  kg/vg
// point at key row 0 of this (batch, kv head); consecutive key rows are
// row_stride elements apart.  kposg is this batch row's kpos (Sk,), or
// null when key row j sits at position j (the training forward).  An int8
// stream passes its f32 scales: ksg/vsg at key row 0 of this (batch, kv
// head), consecutive rows scale_stride apart (the (B, Sk, Hkv, 1) layout);
// each K/V tile is dequantised as it is staged.
// sm.m / sm.l / acc must hold (NEG, 0, 0) on entry; on return they hold the
// unnormalised online-softmax state, and every thread may read sm.l and
// sm.m.  window <= 0 means no sliding window; causal = false drops the
// kpos <= qpos bound (bidirectional attention).
template <int D, int BK, int R_MAX, typename TKV>
__device__ __forceinline__ void attend_tiles(
    const TileSmem<D, BK, R_MAX>& sm, int R, int window,
    const TKV* __restrict__ kg, const TKV* __restrict__ vg,
    long long row_stride, const int* __restrict__ kposg, int Sk,
    int kt_begin, int kt_end, float scale,
    float (&acc)[AccRows<D, R_MAX>::kCount], bool causal = true,
    const float* __restrict__ ksg = nullptr,
    const float* __restrict__ vsg = nullptr, long long scale_stride = 0) {
  static_assert(kThreads % BK == 0 && BK % 32 == 0, "BK: warp multiple");
  static_assert(kThreads % D == 0 && D % 32 == 0, "D: warp multiple");
  constexpr int kKS = D + 1;
  constexpr int kStepS = kThreads / BK;
  constexpr int kRS = (R_MAX + kStepS - 1) / kStepS;
  constexpr int kStepA = AccRows<D, R_MAX>::kStep;
  constexpr int kRA = AccRows<D, R_MAX>::kCount;
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;

    // 1. K, V tiles -> shared (f32), kpos tile
    {
      float* const dst[2] = {sm.k, sm.v};
      const TKV* const src[2] = {kg + k0 * row_stride, vg + k0 * row_stride};
      const float* const scl[2] = {
          ksg != nullptr ? ksg + k0 * scale_stride : nullptr,
          vsg != nullptr ? vsg + k0 * scale_stride : nullptr};
      load_rows_f32<D, BK, 2, TKV>(dst, kKS, src, row_stride, Sk - k0, scl,
                                   scale_stride);
    }
    if (tid < BK) {
      const int row = k0 + tid;
      sm.kp[tid] = row >= Sk ? kAbsent : kposg != nullptr ? kposg[row] : row;
    }
    __syncthreads();

    // 2. masked, scaled scores
    {
      const int j = tid % BK, r0 = tid / BK;
      float sc[kRS];
#pragma unroll
      for (int i = 0; i < kRS; ++i) sc[i] = 0.f;
      const float* krow = sm.k + j * kKS;
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d];
#pragma unroll
        for (int i = 0; i < kRS; ++i) {
          const int r = r0 + i * kStepS;
          if (r < R) sc[i] += sm.q[r * D + d] * kd;
        }
      }
      const int kp = sm.kp[j];
#pragma unroll
      for (int i = 0; i < kRS; ++i) {
        const int r = r0 + i * kStepS;
        if (r < R) {
          const int qp = sm.qpos[r];
          const bool ok = kp >= 0 && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          sm.s[r * BK + j] = ok ? sc[i] * scale : kNeg;
        }
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per query row
    for (int r = warp; r < R; r += kWarps) {
      float mx = kNeg;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, sm.s[r * BK + j]);
      mx = warp_max(mx);
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p =
            sm.kp[j] == kAbsent ? 0.f : expf(sm.s[r * BK + j] - m_new);
        sm.s[r * BK + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        sm.corr[r] = c;
        sm.l[r] = sm.l[r] * c + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + p @ V
    {
      const int d = tid % D, a0 = tid / D;
#pragma unroll
      for (int i = 0; i < kRA; ++i) {
        const int r = a0 + i * kStepA;
        if (r < R) acc[i] *= sm.corr[r];
      }
      for (int j = 0; j < BK; ++j) {
        const float vd = sm.v[j * kKS + d];
#pragma unroll
        for (int i = 0; i < kRA; ++i) {
          const int r = a0 + i * kStepA;
          if (r < R) acc[i] += sm.s[r * BK + j] * vd;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace rt
