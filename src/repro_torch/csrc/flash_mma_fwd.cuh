// The tensor-core tile loop of the bf16 flash forward, shared by the
// training forward (flash_attention.cu, flash_fwd_mma_kernel) and the
// append kernel (flash_append.cu, append_mma_kernel).  The two differ only
// in where a key's position comes from, which keys a query may see, which
// key tiles can hold a live key and whether lse is kept; a mask policy
// (TrainMask, AppendMask) says each, and attend_block does the rest.  A
// key-stream policy (Bf16Stream, Int8Stream) says what the K and V rows
// hold; the bf16 stream is the loop described here, the int8 stream's
// changes follow below.
//
// One block of 4 warps owns 64 query rows of one (batch row, q head); each
// warp a 16-row slab whose Q fragments are loaded once (ldmatrix) and kept
// in registers.  The block walks its live key tiles of 64 rows,
// double-buffered: cp.async copies tile t + 1 (bf16, rows padded to D + 8,
// zero-filled past the stream's end; with the append policy also the
// tile's 64 key positions, 4 bytes each) while tile t is multiplied.  Per
// tile and warp: S = Q K^T with mma.sync m16n8k16 into f32 registers;
// scale (log2 e folded in, exp2f); the policy's mask per fragment element
// (skipped on a tile the policy calls full for the warp's rows); the online
// softmax in registers (row max and row sum over the 4 lanes of a quad, l
// kept per lane and summed once at the end); then p is rounded to bf16 (the
// TPU kernels' p.astype(v.dtype), flash_attention.py:117 and :248) and
// acc += P V with P the A operand straight from the score registers
// (ldmatrix.trans of V).  m, l and acc stay f32 and l sums the f32 p,
// before its rounding, as the TPU kernels do.  Masked keys score the
// finite NEG (so a row with no valid key so far carries weight 1 per key
// until a valid key outweighs it, the TPU semantics); keys past the
// stream's end score -inf, get weight exactly 0 and never set the running
// max.  Registers per thread at D = 128: 64 f32 of acc, 32 of scores, 32
// of Q fragments.
//
// An int8 key stream (the append kernel's int8 arm; (B, Sk, Hkv, 1) f32
// scales a row and kv head) keeps the reference's f32 arithmetic
// (flash_attention.py:220-224, 248-251: K and V dequantised to f32, p
// unrounded).  cp.async double-buffers the raw int8 K and V tiles (64 x D
// bytes each) and their 64 k and v scales; after the wait one pass widens
// the int8 tiles into a single pair of bf16 tiles in the layout above
// (exact).  S = Q K^T is the same product, exact in f32 for integer K, and
// each score column is multiplied by its key's k scale before the scaling
// and the mask.  For P V, w = p * (the key's v scale) stays in f32 and is
// split into hi = bf16(w) and lo = bf16(w - hi): two products into acc
// with V's integers as bf16, so each term is off by at most 2**-18 of
// itself instead of 2**-9.  l sums the unscaled f32 p, as for bf16.
// Shared memory at D = 128: 84.5 KB a block (q, one bf16 K/V pair, two
// raw int8 pairs, scales, positions), two blocks an SM.
#pragma once

#include <cmath>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace fm {

using mt::bf16;
constexpr int kThreads = 128;  // 4 warps, one 16-row slab each
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile

// What the key stream's rows hold.  bf16: K and V tiles go straight to
// the products.  int8: each K and V row has an f32 scale, the raw tiles
// are widened to bf16 in shared memory and the scales applied in f32.
struct Bf16Stream {
  using T = bf16;
  static constexpr bool kQuant = false;
};
struct Int8Stream {
  using T = int8_t;
  static constexpr bool kQuant = true;
};

// Training: query row i of the block's q and key row j sit at positions
// q_off + i and j (q_off = 0 over one whole sequence; a sequence shard's
// first row otherwise); key j is valid for query i iff (causal: j <=
// q_off + i) and (window: j > q_off + i - window).  The live tiles end at
// the block's causal bound and start above its window floor; a tile
// wholly inside both is full.
struct TrainMask {
  static constexpr bool kKeyPos = false;  // positions are row indices
  static constexpr bool kLse = true;
  int Sk, causal, window, q_off;

  __device__ int keys() const { return Sk; }
  __device__ void tiles(int i0, int& begin, int& end) const {
    const int p0 = q_off + i0;
    begin = 0;
    end = (Sk + kBK - 1) / kBK;
    if (causal) end = min(end, (p0 + kBQ - 1) / kBK + 1);
    if (window > 0) {
      const int t = p0 - window + 1;  // live iff (kt + 1) * kBK > t
      if (t > 0) begin = t / kBK;
    }
  }
  // no element of tile k0 needs the mask for any row of the block
  __device__ bool full(int k0, int i0, const int*, int) const {
    const int p0 = q_off + i0;
    return k0 + kBK <= Sk && (!causal || k0 + kBK - 1 <= p0) &&
           (window <= 0 || k0 > p0 + kBQ - 1 - window);
  }
  // score x (log2 units) of key row `key` for query row `row`
  __device__ float mask(float x, int key, int, int row, const int*) const {
    const int qp = q_off + row;
    if (key >= Sk) return -INFINITY;
    if ((causal && key > qp) || (window > 0 && key <= qp - window))
      return rt::kNeg;
    return x;
  }
};

// Append: chunk row i sits at position pos0 + i; key row j at kpos[j]
// (-1 = unwritten), valid iff kpos >= 0, kpos <= qpos and, with a window,
// kpos > qpos - window.  With kpos_linear (row index == position wherever
// valid) the tiles past the block's last query or at or below its first
// query's window floor are dead, as the TPU kernel's tile_live; a ring
// layout visits every tile.  A linear stream may still hold unwritten
// rows, so a tile is full only where the warp has read all 64 of its
// positions and found each valid for all 16 of its rows.
struct AppendMask {
  static constexpr bool kKeyPos = true;
  static constexpr bool kLse = false;
  int Sk, pos0, window, linear;

  __device__ int keys() const { return Sk; }
  __device__ void tiles(int i0, int& begin, int& end) const {
    begin = 0;
    end = (Sk + kBK - 1) / kBK;
    if (linear) {
      const int q_lo = pos0 + i0, q_hi = pos0 + i0 + kBQ - 1;
      end = min(end, q_hi / kBK + 1);
      if (window > 0) {
        const int t = q_lo - window + 1;  // live iff (kt + 1) * kBK > t
        if (t > 0) begin = t / kBK;
      }
    }
  }
  // every key of the tile valid for every row of the warp whose first row
  // is w0 (a warp vote over the tile's positions in shared memory)
  __device__ bool full(int k0, int, const int* kp, int w0) const {
    if (k0 + kBK > Sk) return false;
    const int lane = threadIdx.x & 31;
    const int lo = pos0 + w0, hi = lo + 15;  // the warp's query positions
    bool ok = true;
#pragma unroll
    for (int u = 0; u < kBK / 32; ++u) {
      const int p = kp[lane + 32 * u];
      ok = ok && p >= 0 && p <= lo && (window <= 0 || p > hi - window);
    }
    return __all_sync(0xffffffffu, ok);
  }
  // kp: the tile's key positions in shared memory, jl the key's index there
  __device__ float mask(float x, int key, int jl, int row,
                        const int* kp) const {
    if (key >= Sk) return -INFINITY;
    const int p = kp[jl], qp = pos0 + row;
    if (p < 0 || p > qp || (window > 0 && p <= qp - window)) return rt::kNeg;
    return x;
  }
};

template <int D, class Mask, class Stream = Bf16Stream>
struct Smem {
  static constexpr int kRow = mt::row_stride<D>();
  static constexpr int kTile = kBK * kRow;  // one K or V tile, elements
  // bf16 (K tile, V tile) pairs: two buffers for a bf16 stream, one that
  // the int8 stream's raw tiles are widened into
  static constexpr int kPairs = Stream::kQuant ? 1 : 2;
  // int8: two buffers of raw (K tile, V tile), then two of their scales
  static constexpr size_t kRaw =
      Stream::kQuant ? 2 * 2 * (size_t)kBK * D : 0;
  static constexpr size_t kScales =
      Stream::kQuant ? 2 * 2 * kBK * sizeof(float) : 0;
  // q tile, the bf16 pairs, [raw tiles, scales], then (append) two
  // buffers of the tiles' key positions
  static constexpr size_t kBytes =
      sizeof(bf16) * ((size_t)kBQ * kRow + 2 * kPairs * (size_t)kTile) +
      kRaw + kScales + (Mask::kKeyPos ? 2 * kBK * sizeof(int) : 0);
};

// The block's 64 query rows from i0 against its live key tiles.  qg, og:
// row 0 of this (batch row, q head) in q and out, rows q_stride apart, n_q
// rows in all; kg, vg: key row 0 of this (batch row, kv head), rows
// kv_stride apart; kposg: this batch row's key positions (append) or
// null; lseg: row 0 of this (batch row, q head) in lse, or null; ksg, vsg
// (int8 stream): the scales of key row 0, rows sc_stride apart.
template <int D, class Stream = Bf16Stream, class Mask>
__device__ __forceinline__ void attend_block(
    const Mask& mk, unsigned char* smem, const bf16* __restrict__ qg,
    long long q_stride, int n_q, const typename Stream::T* __restrict__ kg,
    const typename Stream::T* __restrict__ vg, long long kv_stride,
    const int* __restrict__ kposg, int i0, float scale,
    bf16* __restrict__ og, float* __restrict__ lseg,
    const float* __restrict__ ksg = nullptr,
    const float* __restrict__ vsg = nullptr, long long sc_stride = 0) {
  using Sm = Smem<D, Mask, Stream>;
  constexpr bool kQuant = Stream::kQuant;
  constexpr int kKD = D / 16;   // k16 slices of a q / k row
  constexpr int kNK = kBK / 8;  // n8 tiles of a score row
  constexpr int kND = D / 8;    // n8 tiles of an output row
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* skv = sq + kBQ * Sm::kRow;  // [buffer][K, V][kBK rows]
  unsigned char* rest =
      reinterpret_cast<unsigned char*>(skv + 2 * Sm::kPairs * Sm::kTile);
  int8_t* sraw = reinterpret_cast<int8_t*>(rest);  // [buffer][K, V][kBK][D]
  float* ssc = reinterpret_cast<float*>(rest + Sm::kRaw);  // [buf][K, V][kBK]
  int* skp = reinterpret_cast<int*>(rest + Sm::kRaw + Sm::kScales);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_k = mk.keys();

  int kt_begin, kt_end;
  mk.tiles(i0, kt_begin, kt_end);

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    if constexpr (kQuant) {
      int8_t* dst = sraw + buf * 2 * kBK * D;
      mt::load_raw_async<kBK, D, kThreads>(dst, kg + k0 * kv_stride,
                                           kv_stride, n_k - k0);
      mt::load_raw_async<kBK, D, kThreads>(dst + kBK * D, vg + k0 * kv_stride,
                                           kv_stride, n_k - k0);
      // the k scales (threads 0..63) and v scales (64..127) of the tile
      static_assert(kThreads == 2 * kBK, "one scale a thread");
      const int j = tid % kBK;
      const bool ok = k0 + j < n_k;
      const float* src =
          (tid < kBK ? ksg : vsg) + (ok ? k0 + j : 0) * sc_stride;
      mt::cp_async4(mt::smem_u32(ssc + buf * 2 * kBK + tid), src, ok);
    } else {
      bf16* dst = skv + buf * 2 * Sm::kTile;
      mt::load_tile_async<kBK, D, kThreads>(dst, kg + k0 * kv_stride,
                                            kv_stride, n_k - k0);
      mt::load_tile_async<kBK, D, kThreads>(dst + Sm::kTile,
                                            vg + k0 * kv_stride, kv_stride,
                                            n_k - k0);
    }
    if constexpr (Mask::kKeyPos) {
      // a kpos row need not start on 16 bytes: 4-byte copies
      if (tid < kBK) {
        const bool ok = k0 + tid < n_k;
        mt::cp_async4(mt::smem_u32(skp + buf * kBK + tid),
                      kposg + (ok ? k0 + tid : 0), ok);
      }
    }
  };
  mt::load_tile_async<kBQ, D, kThreads>(sq, qg + i0 * q_stride, q_stride,
                                        n_q - i0);
  // a training block always has a live tile; an append block over a
  // stream that ends below its window floor may have none
  if (!Mask::kKeyPos || kt_begin < kt_end) load_kv(kt_begin, 0);
  mt::cp_async_commit();
  mt::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[kKD][4];
  {
    const uint32_t base = mt::smem_u32(sq);
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk)
      mt::ldsm_x4(qf[kk], mt::a_addr<D>(base, warp * 16, kk * 16, lane));
  }
  float acc[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {rt::kNeg, rt::kNeg};  // running max, log2 units
  float l[2] = {0.f, 0.f};            // this lane's share of the row sum
  const float sl2 = scale * mt::kLog2e;
  const int row0 = i0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const int col0 = 2 * (lane & 3);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, buf ^ 1);
    mt::cp_async_commit();
    const float* sks = ssc + buf * 2 * kBK;  // int8: k, then v scales
    if constexpr (kQuant) {
      // widen this tile's raw K and V into the one bf16 pair
      const int8_t* raw = sraw + buf * 2 * kBK * D;
      mt::widen_tile<kBK, D, kThreads>(skv, raw);
      mt::widen_tile<kBK, D, kThreads>(skv + Sm::kTile, raw + kBK * D);
      __syncthreads();
    }
    const uint32_t sk =
        mt::smem_u32(skv + (kQuant ? 0 : buf) * 2 * Sm::kTile);
    const uint32_t sv = sk + Sm::kTile * (uint32_t)sizeof(bf16);
    const int* kp = skp + buf * kBK;
    const int k0 = kt * kBK;

    // S = Q K^T
    float s[kNK][4];
#pragma unroll
    for (int nt = 0; nt < kNK; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
      for (int np = 0; np < kNK / 2; ++np) {
        uint32_t bfr[4];
        mt::ldsm_x4(bfr, mt::b_addr<D>(sk, np * 16, kk * 16, lane));
        mt::mma_bf16(s[2 * np], qf[kk], bfr[0], bfr[1]);
        mt::mma_bf16(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // scale to log2 units and mask
    const bool full = mk.full(k0, i0, kp, i0 + warp * 16);
#pragma unroll
    for (int nt = 0; nt < kNK; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = nt * 8 + col0 + (c & 1);
        float x = s[nt][c];
        if constexpr (kQuant) x *= sks[jl];
        x *= sl2;
        if (!full) x = mk.mask(x, k0 + jl, jl, row0 + (c >> 1) * 8, kp);
        s[nt][c] = x;
      }
    }

    // online softmax, rows row0 (c = 0, 1) and row0 + 8 (c = 2, 3)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int nt = 0; nt < kNK; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * rr], s[nt][2 * rr + 1]));
      mx = mt::quad_max(mx);
      const float corr = exp2f(m[rr] - mx);
      m[rr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNK; ++nt) {
        const float p0 = exp2f(s[nt][2 * rr] - mx);
        const float p1 = exp2f(s[nt][2 * rr + 1] - mx);
        s[nt][2 * rr] = p0;
        s[nt][2 * rr + 1] = p1;
        sum += p0 + p1;
      }
      l[rr] = l[rr] * corr + sum;
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        acc[nd][2 * rr] *= corr;
        acc[nd][2 * rr + 1] *= corr;
      }
    }

    // acc += P V, P rounded to bf16 from the score registers (int8: p
    // times the v scales, as hi + lo)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4], pl[4];
      if constexpr (kQuant) {
        const float* svs = sks + kBK + kk * 16 + col0;
        float w0[4], w1[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          w0[c] = s[2 * kk][c] * svs[c & 1];
          w1[c] = s[2 * kk + 1][c] * svs[8 + (c & 1)];
        }
        mt::c_to_a_split(pa, pl, w0, w1);
      } else {
        mt::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bfr[4];
        mt::ldsm_x4_trans(bfr, mt::bt_addr<D>(sv, kk * 16, dp * 16, lane));
        mt::mma_bf16(acc[2 * dp], pa, bfr[0], bfr[1]);
        mt::mma_bf16(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
        if constexpr (kQuant) {
          mt::mma_bf16(acc[2 * dp], pl, bfr[0], bfr[1]);
          mt::mma_bf16(acc[2 * dp + 1], pl, bfr[2], bfr[3]);
        }
      }
    }
    mt::cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float lt = fmaxf(mt::quad_sum(l[rr]), rt::kLFloor);
    const int row = row0 + rr * 8;
    if (row >= n_q) continue;
    const float inv = 1.f / lt;
    bf16* orow = og + row * q_stride;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + col0) = mt::pack_bf16(
          acc[nd][2 * rr] * inv, acc[nd][2 * rr + 1] * inv);
    if constexpr (Mask::kLse) {
      if ((lane & 3) == 0) lseg[row] = m[rr] * mt::kLn2 + logf(lt);
    }
  }
}

}  // namespace fm
