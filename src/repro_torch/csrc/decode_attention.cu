// Per-slot decode attention for Hopper (sm_90a): one query token per batch
// row against its KV cache, normalised or as flash-decoding partials.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_fwd and
//   ::decode_attention_partials, which share the Pallas body `_kernel`
//   (via `_call`); so do they here: one kernel body (decode_split_kernel)
//   and one combine (decode_combine_kernel), each with the same two
//   compile-time switches.
//   * PARTIALS: write the unnormalised online-softmax state (acc (B, Hkv,
//     G, D), m and l (B, Hkv, G), all f32) of this cache slice for the
//     context-parallel combine, o = sum(acc e^(m - max m)) /
//     sum(l e^(m - max m)) across slices; otherwise write acc / max(l,
//     1e-30) in q's dtype.
//   * int8 K/V (TKV = int8_t): per-(row, kv head) f32 scales (B, L, Hkv, 1)
//     ride beside the caches; tiles travel as int8 with their scales and
//     each element is dequantised as it is read from shared memory, so the
//     device-memory stream stays int8.
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
// valid rows * Hkv * 4 bytes of int8 scales]) / 3.35 TB/s: 0.00137 ms for
// the 2204 valid rows of the serving shape (B = 4, L = 1024, 4 kv heads,
// D = 128, bf16).  The arithmetic, 4 * G * D operations a valid row and kv
// head, is 8 flop a byte of bf16 K/V at G = 8: below the f32 ridge of the
// SIMT units (67 TFLOP/s over 3.35 TB/s, 20 flop a byte), so f32 FMAs
// outside the tensor cores can keep up with the stream once enough blocks
// stream it.
//
// Design: split flash-decoding over live tiles.
//   1. decode_split_kernel, grid (split, kv head, batch row): the key range
//      [0, L) is cut into n_split runs of tiles_per_split key tiles of 64
//      rows (the last run may be shorter; split_plan in the wrapper picks
//      n_split from the shapes alone, about two blocks on each SM: 16
//      splits of one tile, 256 blocks at the serving shape, against the 16
//      blocks of one block per (kv head, batch row)).  The block loads the G = Hq / Hkv query
//      heads that share its kv head once and scores all of them against
//      each K tile, so the cache is read once for all G heads.
//   2. Live tiles only.  The block first reads its slot's kpos row (L
//      int32, the first 4 values a thread in flight while q is staged)
//      once, into "this row has a valid key" and one live flag a tile of
//      its split in shared memory (at most 1024 tiles a split).  If the row
//      has a valid key, a tile with none is never copied: exact, since
//      e^(NEG - m) is 0 in f32 once a valid key has set m, and a split
//      left with no live tile writes m = NEG, l = 0, acc = 0, which the
//      combine weighs 0.  A row with no valid key (an idle slot, a fully
//      masked context-parallel slice) visits every tile, which keeps the
//      TPU semantics above.  The test reads positions, so ring caches need
//      no linear layout.
//   3. cp.async 16-byte copies of the raw K and V rows (f32, bf16 or int8,
//      rows padded by 16 bytes so that the 16-byte reads of 8 neighbouring
//      key rows fall in 8 different bank groups) and 4-byte copies of the
//      tile's key positions and int8 scales, into two tile buffers: the
//      next live tile is in flight while the current one is multiplied.
//   4. Products in f32 FMAs from shared memory, p in f32 (no rounding):
//      thread (key j = tid % 64, row group tid / 64) scores its key against
//      its query rows, each sum in two chains; one warp a query row runs
//      the online softmax; thread (column pair tid % (D / 2), row group)
//      accumulates p V, reading p four keys at a time.
//   5. Each split writes its (acc, m, l) to an f32 workspace (B, Hkv,
//      n_split, G, D) and (B, Hkv, n_split, G); decode_combine_kernel, one
//      block of D threads a (query head, kv head, batch row), reduces over
//      the splits in split order (no atomics, so results repeat exactly)
//      into acc / max(l, 1e-30) in q's dtype, or into the slice's (acc, m,
//      l) relative to its own max m.
#include <cmath>

#include "attention_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;     // keys per tile
constexpr int kGMax = 16;   // query heads per kv head one block can hold
constexpr int kRowGroups = kThreads / kBK;  // query row groups of a score
constexpr int kMaxTiles = 1024;  // tiles a split (one live flag byte each)
constexpr int kKposRegs = 4;     // kpos values a thread loads ahead

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // int8 caches only: (B, L, Hkv, 1) scales
  const float* vs;
  const int* kpos;
  const int* pos;
  float* wacc;      // workspace: (B, Hkv, n_split, G, D), m and l
  float* wm;        // (B, Hkv, n_split, G), all f32
  float* wl;
  void* out;        // normalised output (B, Hq, D) in q's dtype
  float* acc;       // partials: (B, Hkv, G, D), m and l (B, Hkv, G)
  float* m;
  float* l;
  int B, L, Hq, Hkv, n_split, tiles_per_split;
  cudaStream_t stream;
};

// Shared-memory carve-up: f32 query rows, two buffers of raw (K, V) tiles
// with rows padded by 16 bytes, two buffers of int8 scales (K, V) and of
// key positions, the probabilities, the running m, l, corr and the split's
// live-tile flags.
template <int D, typename TKV>
struct DecSmem {
  static constexpr int kRowBytes = D * (int)sizeof(TKV) + 16;
  static constexpr int kTileBytes = kBK * kRowBytes;
  static constexpr int kQ = 0;                                 // f32
  static constexpr int kKV = kQ + kGMax * D * 4;               // raw tiles
  static constexpr int kScale = kKV + 4 * kTileBytes;          // f32
  static constexpr int kKp = kScale + 4 * kBK * 4;             // int
  static constexpr int kS = kKp + 2 * kBK * 4;                 // f32
  static constexpr int kM = kS + kGMax * kBK * 4;              // f32 x 3
  static constexpr int kFlags = kM + 3 * kGMax * 4;            // bytes
  static constexpr size_t kBytes = kFlags + kMaxTiles;
};

__device__ __forceinline__ bool key_valid(int kp, int p) {
  return kp >= 0 && kp <= p;
}

// Two neighbouring elements of a row as f32
template <typename TKV>
__device__ __forceinline__ float2 pair_f32(const unsigned char* src);
template <>
__device__ __forceinline__ float2 pair_f32<float>(const unsigned char* src) {
  return *reinterpret_cast<const float2*>(src);
}
template <>
__device__ __forceinline__ float2 pair_f32<__nv_bfloat16>(
    const unsigned char* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}
template <>
__device__ __forceinline__ float2 pair_f32<int8_t>(const unsigned char* src) {
  const char2 c = *reinterpret_cast<const char2*>(src);
  return make_float2((float)c.x, (float)c.y);
}

// The E = 16 / sizeof(TKV) elements of one 16-byte chunk as f32, each
// times sc (int8; float chunks ignore it)
template <typename TKV>
__device__ __forceinline__ void chunk_f32(const unsigned char* src, float sc,
                                          float* dst) {
  constexpr int kE = 16 / sizeof(TKV);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const TKV* el = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
  for (int t = 0; t < kE; ++t) {
    if constexpr (std::is_same<TKV, int8_t>::value)
      dst[t] = rt::to_f32(el[t]) * sc;
    else
      dst[t] = rt::to_f32(el[t]);
  }
}

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads, 1)
    decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ kpos,
                        const int* __restrict__ pos,
                        float* __restrict__ wacc, float* __restrict__ wm,
                        float* __restrict__ wl, int L, int Hq, int Hkv,
                        int tiles_per_split, float scale) {
  using Sm = DecSmem<D, TKV>;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kE = 16 / (int)sizeof(TKV);    // elements a 16-byte chunk
  constexpr int kChunks = D / kE;              // chunks a row
  constexpr int kCopies = kBK * kChunks / kThreads;
  constexpr int kRS = kGMax / kRowGroups;      // score rows a thread
  constexpr int kPairs = D / 2;                // column pairs of a row
  constexpr int kStepA = kThreads / kPairs;    // acc row groups
  constexpr int kRA = kGMax / kStepA;          // acc rows a thread
  static_assert(kBK * kChunks % kThreads == 0, "tile splits evenly");
  extern __shared__ __align__(16) unsigned char smem_dec[];
  float* sq = reinterpret_cast<float*>(smem_dec + Sm::kQ);
  unsigned char* skv = smem_dec + Sm::kKV;     // [buf][K, V][kBK rows]
  float* ssc = reinterpret_cast<float*>(smem_dec + Sm::kScale);  // [buf][K,V]
  int* skp = reinterpret_cast<int*>(smem_dec + Sm::kKp);         // [buf]
  float* ss = reinterpret_cast<float*>(smem_dec + Sm::kS);
  float* sm_m = reinterpret_cast<float*>(smem_dec + Sm::kM);
  float* sm_l = sm_m + kGMax;
  float* sm_corr = sm_l + kGMax;
  unsigned char* live = smem_dec + Sm::kFlags;  // [tile - t0]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the G query rows of this kv head are contiguous in q (B, Hq, D)
  const long long row0 = (long long)b * Hq + (long long)h * G;
  const long long kv_stride = (long long)Hkv * D;
  const TKV* kg = k + (long long)b * L * kv_stride + (long long)h * D;
  const TKV* vg = v + (long long)b * L * kv_stride + (long long)h * D;
  const float* ksg = kQuant ? ks + (long long)b * L * Hkv + h : nullptr;
  const float* vsg = kQuant ? vs + (long long)b * L * Hkv + h : nullptr;
  const int* kposg = kpos + (long long)b * L;
  const int p = pos[b];
  const int n_tiles = (L + kBK - 1) / kBK;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);

  // 1. the slot's key positions, first kKposRegs a thread in flight while
  //    q is staged; then "the row holds a valid key" and one live flag a
  //    tile of this split
  int kp_ahead[kKposRegs];
#pragma unroll
  for (int u = 0; u < kKposRegs; ++u) {
    const int j = tid + u * kThreads;
    kp_ahead[u] = j < L ? kposg[j] : -1;
  }
  for (int t = tid; t < t1 - t0; t += kThreads) live[t] = 0;
  {
    float* const dst[1] = {sq};
    const TQ* const src[1] = {q + row0 * D};
    rt::load_rows_f32<D, kGMax, 1, TQ>(dst, D, src, D, G);
  }
  for (int r = tid; r < kGMax; r += kThreads) {
    sm_m[r] = rt::kNeg;
    sm_l[r] = 0.f;
  }
  __syncthreads();
  int any = 0;
  auto mark = [&](int j, int kp) {
    if (!key_valid(kp, p)) return;
    any = 1;
    const int t = j / kBK;
    if (t >= t0 && t < t1) live[t - t0] = 1;  // same value from any thread
  };
#pragma unroll
  for (int u = 0; u < kKposRegs; ++u) mark(tid + u * kThreads, kp_ahead[u]);
  for (int j = tid + kKposRegs * kThreads; j < L; j += kThreads)
    mark(j, kposg[j]);
  const bool row_live = __syncthreads_or(any) != 0;

  // the first tile at or after t that holds a valid key (every tile when
  // the row holds none); block-uniform
  auto next_tile = [&](int t) {
    if (row_live)
      while (t < t1 && !live[t - t0]) ++t;
    return t;
  };
  auto copy_tile = [&](int t, int buf) {
    const int k0 = t * kBK;
    const uint32_t bk = mt::smem_u32(skv + buf * 2 * Sm::kTileBytes);
    const uint32_t bv = bk + Sm::kTileBytes;
#pragma unroll
    for (int it = 0; it < kCopies; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / kChunks, c = e % kChunks;
      const bool ok = k0 + r < L;
      const long long off = (ok ? (long long)(k0 + r) * kv_stride : 0LL) +
                            c * kE;
      const uint32_t so = (uint32_t)(r * Sm::kRowBytes + c * 16);
      mt::cp_async16(bk + so, kg + off, ok);
      mt::cp_async16(bv + so, vg + off, ok);
    }
    if (tid < kBK) {
      const bool ok = k0 + tid < L;
      mt::cp_async4(mt::smem_u32(skp + buf * kBK + tid),
                    kposg + (ok ? k0 + tid : 0), ok);
    }
    if constexpr (kQuant) {
      if (tid >= kBK && tid < 3 * kBK) {
        const int r = tid % kBK;
        const bool ok = k0 + r < L;
        const float* src = (tid < 2 * kBK ? ksg : vsg) +
                           (ok ? (long long)(k0 + r) * Hkv : 0LL);
        mt::cp_async4(
            mt::smem_u32(ssc + (buf * 2 + tid / kBK - 1) * kBK + r), src,
            ok);
      }
    }
  };

  float2 acc[kRA];
#pragma unroll
  for (int i = 0; i < kRA; ++i) acc[i] = make_float2(0.f, 0.f);

  int cur = next_tile(t0), buf = 0;
  if (cur < t1) copy_tile(cur, 0);
  mt::cp_async_commit();
  while (cur < t1) {
    const int nxt = next_tile(cur + 1);
    if (nxt < t1) copy_tile(nxt, buf ^ 1);
    mt::cp_async_commit();
    mt::cp_async_wait<1>();  // the current tile has landed
    __syncthreads();
    const unsigned char* tk = skv + buf * 2 * Sm::kTileBytes;
    const unsigned char* tv = tk + Sm::kTileBytes;
    const float* tks = ssc + buf * 2 * kBK;
    const float* tvs = tks + kBK;
    const int* kp = skp + buf * kBK;
    const int k0 = cur * kBK;

    // 2. masked, scaled scores: key j against rows rg + i * kRowGroups,
    //    each row's sum in two halves (even, odd elements) for two chains
    {
      const int j = tid % kBK, rg = tid / kBK;
      float sc[kRS][2];
#pragma unroll
      for (int i = 0; i < kRS; ++i) sc[i][0] = sc[i][1] = 0.f;
      const unsigned char* krow = tk + j * Sm::kRowBytes;
      const float kscale = kQuant ? tks[j] : 1.f;
#pragma unroll 4
      for (int c = 0; c < kChunks; ++c) {
        float kf[kE];
        chunk_f32<TKV>(krow + c * 16, kscale, kf);
#pragma unroll
        for (int i = 0; i < kRS; ++i) {
          const int r = rg + i * kRowGroups;
          if (r < G) {
            const float* qr = sq + r * D + c * kE;
#pragma unroll
            for (int t = 0; t < kE; ++t) sc[i][t & 1] += qr[t] * kf[t];
          }
        }
      }
      // keys past L are absent (weight exactly 0), masked ones score NEG
      const bool absent = k0 + j >= L;
      const bool ok = !absent && key_valid(kp[j], p);
#pragma unroll
      for (int i = 0; i < kRS; ++i) {
        const int r = rg + i * kRowGroups;
        if (r < G)
          ss[r * kBK + j] = absent ? -INFINITY
                            : ok   ? (sc[i][0] + sc[i][1]) * scale
                                   : rt::kNeg;
      }
    }
    __syncthreads();

    // 3. online softmax, one warp a query row
    for (int r = warp; r < G; r += kThreads / 32) {
      float mx = rt::kNeg;
      for (int j = lane; j < kBK; j += 32) mx = fmaxf(mx, ss[r * kBK + j]);
      mx = rt::warp_max(mx);
      const float m_prev = sm_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kBK; j += 32) {
        const float pj = expf(ss[r * kBK + j] - m_new);
        ss[r * kBK + j] = pj;
        sum += pj;
      }
      sum = rt::warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        sm_corr[r] = c;
        sm_l[r] = sm_l[r] * c + sum;
        sm_m[r] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + p @ V: columns 2 cp, 2 cp + 1 of rows a0 + i *
    //    kStepA, p read four keys at a time
    {
      const int cp = tid % kPairs, a0 = tid / kPairs;
#pragma unroll
      for (int i = 0; i < kRA; ++i) {
        const int r = a0 + i * kStepA;
        if (r < G) {
          const float c = sm_corr[r];
          acc[i].x *= c;
          acc[i].y *= c;
        }
      }
      const unsigned char* vcol = tv + cp * 2 * sizeof(TKV);
#pragma unroll 2
      for (int j4 = 0; j4 < kBK; j4 += 4) {
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          vv[u] = pair_f32<TKV>(vcol + (j4 + u) * Sm::kRowBytes);
          if constexpr (kQuant) {
            vv[u].x *= tvs[j4 + u];
            vv[u].y *= tvs[j4 + u];
          }
        }
#pragma unroll
        for (int i = 0; i < kRA; ++i) {
          const int r = a0 + i * kStepA;
          if (r < G) {
            const float4 p4 = *reinterpret_cast<const float4*>(ss + r * kBK +
                                                               j4);
            acc[i].x += p4.x * vv[0].x + p4.y * vv[1].x + p4.z * vv[2].x +
                        p4.w * vv[3].x;
            acc[i].y += p4.x * vv[0].y + p4.y * vv[1].y + p4.z * vv[2].y +
                        p4.w * vv[3].y;
          }
        }
      }
    }
    __syncthreads();  // the buffers and scores are free again
    cur = nxt;
    buf ^= 1;
  }

  // this split's state; a split with no live tile leaves (NEG, 0, 0)
  const long long w0 = (((long long)b * Hkv + h) * n_split + split) * G;
  {
    const int cp = tid % kPairs, a0 = tid / kPairs;
#pragma unroll
    for (int i = 0; i < kRA; ++i) {
      const int r = a0 + i * kStepA;
      if (r < G)
        *reinterpret_cast<float2*>(wacc + (w0 + r) * D + 2 * cp) = acc[i];
    }
  }
  for (int r = tid; r < G; r += kThreads) {
    wm[w0 + r] = sm_m[r];
    wl[w0 + r] = sm_l[r];
  }
}

// The splits of one (query head, kv head, batch row) reduced in split
// order, column d by thread d: M = max m, l = sum l e^(m - M), acc = sum
// acc e^(m - M); each loop's loads are independent of one another.
template <int D, typename TQ, bool PARTIALS>
__global__ void __launch_bounds__(D)
    decode_combine_kernel(const float* __restrict__ wacc,
                          const float* __restrict__ wm,
                          const float* __restrict__ wl, int n_split,
                          TQ* __restrict__ out, float* __restrict__ acc_out,
                          float* __restrict__ m_out,
                          float* __restrict__ l_out) {
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int G = gridDim.x, Hkv = gridDim.y;
  const long long base = ((long long)b * Hkv + h) * n_split * G + g;
  float mx = rt::kNeg;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, wm[base + s * G]);
  float lt = 0.f, at = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const long long w = base + (long long)s * G;
    const float c = expf(wm[w] - mx);
    lt += wl[w] * c;
    at += wacc[w * D + d] * c;
  }
  const long long o = ((long long)b * Hkv + h) * G + g;  // row of (B, Hq)
  if constexpr (PARTIALS) {
    acc_out[o * D + d] = at;
    if (d == 0) {
      m_out[o] = mx;
      l_out[o] = lt;
    }
  } else {
    out[o * D + d] = rt::from_f32<TQ>(at / fmaxf(lt, rt::kLFloor));
  }
}

template <int D, typename TQ, typename TKV, bool PARTIALS>
int launch(const Args& a) {
  using Sm = DecSmem<D, TKV>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<D, TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sm::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(a.n_split, a.Hkv, a.B);
  decode_split_kernel<D, TQ, TKV><<<grid, kThreads, Sm::kBytes, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.kpos, a.pos, a.wacc, a.wm,
      a.wl, a.L, a.Hq, a.Hkv, a.tiles_per_split,
      (float)(1.0 / sqrt((double)D)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<D, TQ, PARTIALS>
      <<<dim3(a.Hq / a.Hkv, a.Hkv, a.B), D, 0, a.stream>>>(
          a.wacc, a.wm, a.wl, a.n_split, static_cast<TQ*>(a.out), a.acc, a.m,
          a.l);
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
  const int n_tiles = (a.L + kBK - 1) / kBK;
  if (a.L <= 0 || a.Hq % a.Hkv != 0 || a.Hq / a.Hkv > kGMax ||
      a.B > 65535 || a.Hkv > 65535 || a.tiles_per_split <= 0 ||
      a.tiles_per_split > kMaxTiles ||
      a.n_split != (n_tiles + a.tiles_per_split - 1) / a.tiles_per_split)
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
// (B,) int32; out (B, Hq, D) in q's dtype; the f32 workspace wacc (B, Hkv,
// n_split, G, D), wm and wl (B, Hkv, n_split, G), n_split = ceil(ceil(L /
// 64) / tiles_per_split), tiles_per_split <= 1024; all contiguous, q, k and
// v 16-byte aligned.  D in {64, 128}, Hq % Hkv == 0, Hq / Hkv <= 16.
// Returns the CUDA error code (0 = success).
extern "C" int rt_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* kpos, const void* pos, void* out, void* wacc,
    void* wm, void* wl, int B, int L, int Hq, int Hkv, int D, int n_split,
    int tiles_per_split, int q_dtype, int kv_dtype, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const int*>(kpos),
               static_cast<const int*>(pos), static_cast<float*>(wacc),
               static_cast<float*>(wm), static_cast<float*>(wl), out,
               nullptr, nullptr, nullptr, B, L, Hq, Hkv, n_split,
               tiles_per_split, static_cast<cudaStream_t>(stream)};
  return launch_all<false>(D, q_dtype, kv_dtype, a);
}

// The same inputs and workspace; acc (B, Hkv, G, D), m and l (B, Hkv, G),
// all f32: the unnormalised partials of this cache slice.
extern "C" int rt_decode_attention_partials(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* kpos, const void* pos, void* acc, void* m,
    void* l, void* wacc, void* wm, void* wl, int B, int L, int Hq, int Hkv,
    int D, int n_split, int tiles_per_split, int q_dtype, int kv_dtype,
    void* stream) {
  const Args a{q, k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const int*>(kpos),
               static_cast<const int*>(pos), static_cast<float*>(wacc),
               static_cast<float*>(wm), static_cast<float*>(wl), nullptr,
               static_cast<float*>(acc), static_cast<float*>(m),
               static_cast<float*>(l), B, L, Hq, Hkv, n_split,
               tiles_per_split, static_cast<cudaStream_t>(stream)};
  return launch_all<true>(D, q_dtype, kv_dtype, a);
}
