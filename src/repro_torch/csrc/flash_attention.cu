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
// bf16: FlashAttention-2's structure on the tensor cores.  One block of 4
//   warps per (q tile of 64 rows, q head, batch row), 2048 blocks at the
//   train shape; the q tiles are the grid's slowest dimension and, when
//   causal, run longest first (the last q tile first), so the short
//   blocks of the causal head of the sequence fill the tail.  Each warp
//   owns a 16-row slab; its Q fragments are loaded once (ldmatrix) and
//   kept in registers.  The block walks the live key tiles of 64 rows,
//   double-buffered: cp.async copies tile t + 1 (bf16, rows padded to
//   D + 8, zero-filled past S) while tile t is multiplied.  Per tile and
//   warp: S = Q K^T with mma.sync m16n8k16 (K by ldmatrix, no transpose)
//   into f32 registers; scale (log2 e folded in, exp2f), the mask per
//   fragment element where the tile crosses the causal diagonal, the
//   window floor or S; the online softmax in registers (row max and row
//   sum over the 4 lanes of a quad, l kept per lane and summed once at the
//   end); then p is rounded to bf16 (the TPU kernel's p.astype(v.dtype),
//   flash_attention.py:117) and acc += P V with P the A operand straight
//   from the score registers (ldmatrix.trans of V).  m, l and acc stay
//   f32 and l sums the f32 p, before its rounding, as the TPU kernel does.
//   lse is written in natural log.  Masked keys score the finite NEG (so
//   a row with no valid key so far carries weight 1 per key until a valid
//   key outweighs it, the TPU semantics); keys past S score -inf, get
//   weight exactly 0 and never set the running max.  Registers per thread
//   at D = 128: 64 f32 of acc, 32 of scores, 32 of Q fragments.
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
#include <cmath>

#include "attention_tiles.cuh"
#include "mma_tiles.cuh"

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
                     float* __restrict__ lse, int S, int Hq, int Hkv,
                     int causal, int window, float scale) {
  using Smem = rt::TileSmem<D, kBK, kBQ>;
  using Rows = rt::AccRows<D, kBQ>;
  extern __shared__ float smem_raw[];
  const Smem sm(smem_raw);
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int i0 = iq * kBQ;
  const int tid = threadIdx.x;

  // query rows i0 .. i0 + kBQ of head h; rows past S are zero and unused
  {
    float* const dst[1] = {sm.q};
    const float* const src[1] = {q + (((long long)b * S + i0) * Hq + h) * D};
    rt::load_rows_f32<D, kBQ, 1, float>(dst, D, src, (long long)Hq * D,
                                        S - i0);
  }
  for (int r = tid; r < kBQ; r += rt::kThreads) {
    sm.m[r] = rt::kNeg;
    sm.l[r] = 0.f;
    sm.qpos[r] = i0 + r;
  }
  float acc[Rows::kCount];
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) acc[i] = 0.f;

  // live key tiles: none past the block's last query (causal), none whose
  // last key is at or below the block's first query's window floor
  int kt_begin = 0, kt_end = (S + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (i0 + kBQ - 1) / kBK + 1);
  if (window > 0) {
    const int t = i0 - window + 1;  // live iff (kt + 1) * kBK > t
    if (t > 0) kt_begin = t / kBK;
  }
  __syncthreads();

  const long long kv_off = (long long)b * S * Hkv * D + (long long)hk * D;
  rt::attend_tiles<D, kBK, kBQ, float>(
      sm, kBQ, window, k + kv_off, v + kv_off, (long long)Hkv * D, nullptr, S,
      kt_begin, kt_end, scale, acc, causal != 0);

  const int d = tid % D, a0 = tid / D;
#pragma unroll
  for (int i = 0; i < Rows::kCount; ++i) {
    const int r = a0 + i * Rows::kStep, row = i0 + r;
    if (row < S)
      out[(((long long)b * S + row) * Hq + h) * D + d] =
          acc[i] / fmaxf(sm.l[r], rt::kLFloor);
  }
  for (int r = tid; r < kBQ; r += rt::kThreads) {
    const int row = i0 + r;
    if (row < S)
      lse[((long long)b * Hq + h) * S + row] =
          sm.m[r] + logf(fmaxf(sm.l[r], rt::kLFloor));
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int S, int Hq, int Hkv, int causal,
               int window, cudaStream_t stream) {
  using Smem = rt::TileSmem<D, kBK, kBQ>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Smem::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<D><<<grid, rt::kThreads, Smem::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), S, Hq, Hkv, causal, window,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 arm: tensor cores
// ---------------------------------------------------------------------------

using mt::bf16;
constexpr int kMmaThreads = 128;  // 4 warps, one 16-row slab each
constexpr int kMBQ = 64;          // query rows per block
constexpr int kMBK = 64;          // keys per tile

template <int D>
struct FwdMmaSmem {
  static constexpr int kRow = mt::row_stride<D>();
  static constexpr int kTile = kMBK * kRow;  // one K or V tile, elements
  // q tile, then two buffers of (K tile, V tile)
  static constexpr size_t kBytes =
      sizeof(bf16) * ((size_t)kMBQ * kRow + 4 * (size_t)kTile);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int S, int Hq, int Hkv,
                         int causal, int window, float scale) {
  using Sm = FwdMmaSmem<D>;
  constexpr int kKD = D / 16;    // k16 slices of a q / k row
  constexpr int kNK = kMBK / 8;  // n8 tiles of a score row
  constexpr int kND = D / 8;     // n8 tiles of an output row
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sq = reinterpret_cast<bf16*>(smem_mma);
  bf16* skv = sq + kMBQ * Sm::kRow;  // [buffer][K, V][kMBK rows]
  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = causal ? (int)gridDim.z - 1 - (int)blockIdx.z
                        : (int)blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int i0 = iq * kMBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const bf16* kg = k + (long long)b * S * kv_stride + (long long)hk * D;
  const bf16* vg = v + (long long)b * S * kv_stride + (long long)hk * D;

  int kt_begin = 0, kt_end = (S + kMBK - 1) / kMBK;
  if (causal) kt_end = min(kt_end, (i0 + kMBQ - 1) / kMBK + 1);
  if (window > 0) {
    const int t = i0 - window + 1;  // live iff (kt + 1) * kMBK > t
    if (t > 0) kt_begin = t / kMBK;
  }

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kMBK;
    bf16* dst = skv + buf * 2 * Sm::kTile;
    mt::load_tile_async<kMBK, D, kMmaThreads>(dst, kg + k0 * kv_stride,
                                              kv_stride, S - k0);
    mt::load_tile_async<kMBK, D, kMmaThreads>(dst + Sm::kTile,
                                              vg + k0 * kv_stride, kv_stride,
                                              S - k0);
  };
  mt::load_tile_async<kMBQ, D, kMmaThreads>(
      sq, q + ((long long)b * S + i0) * q_stride + (long long)h * D,
      q_stride, S - i0);
  load_kv(kt_begin, 0);
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
    const uint32_t sk = mt::smem_u32(skv + buf * 2 * Sm::kTile);
    const uint32_t sv = sk + Sm::kTile * (uint32_t)sizeof(bf16);
    const int k0 = kt * kMBK;

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
    const bool full = k0 + kMBK <= S &&
                      (!causal || k0 + kMBK - 1 <= i0) &&
                      (window <= 0 || k0 > i0 + kMBQ - 1 - window);
#pragma unroll
    for (int nt = 0; nt < kNK; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[nt][c] * sl2;
        if (!full) {
          const int key = k0 + nt * 8 + col0 + (c & 1);
          const int row = row0 + (c >> 1) * 8;
          if (key >= S)
            x = -INFINITY;
          else if ((causal && key > row) ||
                   (window > 0 && key <= row - window))
            x = rt::kNeg;
        }
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

    // acc += P V, P rounded to bf16 from the score registers
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      uint32_t pa[4];
      mt::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bfr[4];
        mt::ldsm_x4_trans(bfr, mt::bt_addr<D>(sv, kk * 16, dp * 16, lane));
        mt::mma_bf16(acc[2 * dp], pa, bfr[0], bfr[1]);
        mt::mma_bf16(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
      }
    }
    mt::cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float lt = fmaxf(mt::quad_sum(l[rr]), rt::kLFloor);
    const int row = row0 + rr * 8;
    if (row >= S) continue;
    const float inv = 1.f / lt;
    bf16* orow = out + ((long long)b * S + row) * q_stride + (long long)h * D;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + col0) = mt::pack_bf16(
          acc[nd][2 * rr] * inv, acc[nd][2 * rr + 1] * inv);
    if ((lane & 3) == 0)
      lse[((long long)b * Hq + h) * S + row] = m[rr] * mt::kLn2 + logf(lt);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int S, int Hq, int Hkv, int causal,
                int window, cudaStream_t stream) {
  using Sm = FwdMmaSmem<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Sm::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(Hq, B, (S + kMBQ - 1) / kMBQ);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, Sm::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, Hq, Hkv, causal, window,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_t(int dtype, const void* q, const void* k, const void* v,
             void* out, void* lse, int B, int S, int Hq, int Hkv, int causal,
             int window, cudaStream_t s) {
  switch (dtype) {
    case rt::kF32:
      return launch_f32<D>(q, k, v, out, lse, B, S, Hq, Hkv, causal, window,
                           s);
    case rt::kBF16:
      return launch_bf16<D>(q, k, v, out, lse, B, S, Hq, Hkv, causal, window,
                            s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out (B, S, Hq, D); k, v (B, S, Hkv, D); one dtype (f32 or bf16) for
// all four; lse (B, Hq, S) f32.  All contiguous, q, k and v 16-byte
// aligned.  D in {64, 128}, Hq % Hkv == 0; causal 0 or 1;
// window <= 0 means none.  Returns the CUDA error code of the launch.
extern "C" int rt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int S, int Hq, int Hkv, int D,
                                      int causal, int window, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 ||
      (S + kMBQ - 1) / kMBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_t<64>(dtype, q, k, v, out, lse, B, S, Hq, Hkv, causal,
                          window, s);
    case 128:
      return launch_t<128>(dtype, q, k, v, out, lse, B, S, Hq, Hkv, causal,
                           window, s);
  }
  return (int)cudaErrorInvalidValue;
}
