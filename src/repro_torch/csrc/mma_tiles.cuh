// Hopper tensor-core building blocks for the bf16 attention kernels
// (flash_attention.cu, flash_attention_bwd.cu), in inline PTX:
//
//   - cp.async.cg 16-byte copies of bf16 rows from device into shared
//     memory, zero-filled (src-size 0) for rows past the end of the
//     sequence, with the commit / wait-group helpers;
//   - a shared-memory tile layout of R rows of D bf16 with rows padded to
//     D + 8 elements (D * 2 + 16 bytes): the 8 rows that one ldmatrix
//     phase reads then start 4 banks apart, so ldmatrix is free of bank
//     conflicts without a swizzle, and every row stays 16-byte aligned;
//   - ldmatrix.x4 and ldmatrix.x4.trans fragment loads, with the lane
//     addresses of an A operand (row-major 16 x 16), of a B operand stored
//     with n as its row ([n][k], e.g. K for S = Q K^T) and of a B operand
//     stored with k as its row ([k][n], e.g. V for O = P V);
//   - mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32;
//   - the packing of two f32 accumulator fragments (a 16 x 16 block of C)
//     into one bf16 A fragment: the one place where the kernels round p
//     and ds to bf16, as the TPU kernels' p.astype(v.dtype) and
//     ds.astype(k.dtype) do before the MXU products.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9)
//   B (16 x 8):  b0 (k rows 2t, 2t+1, col g), b1 (k rows 2t+8, 2t+9, col g)
//   C (16 x 8):  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// so the C fragments of two neighbouring n8 tiles are, packed to bf16, the
// A fragment of a k16 slice: a product's output feeds the next product
// from registers, with no shared-memory round trip.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace mt {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// padded row stride, in bf16 elements, of a shared tile of D-wide rows
template <int D>
__host__ __device__ constexpr int row_stride() {
  return D + 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared memory at dst; zeros when !valid (nothing
// is read then, but src must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of rows [0, ROWS) of a bf16 source (row r at src + r *
// stride, D elements) into a padded shared tile; rows >= valid_rows are
// zero.  valid_rows >= 1 (row 0 of src is mapped).  NT threads share the
// ROWS * D / 8 chunks.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long stride,
                                                int valid_rows) {
  constexpr int kChunks = D / 8;
  constexpr int kTotal = ROWS * kChunks;
  static_assert(kTotal % NT == 0, "tile must split evenly over the block");
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int it = 0; it < kTotal / NT; ++it) {
    const int e = threadIdx.x + it * NT;
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r < valid_rows;
    const bf16* s = src + (ok ? (long long)r * stride : 0LL) + c * 8;
    cp_async16(base + (uint32_t)((r * row_stride<D>() + c * 8) * 2), s, ok);
  }
}

// lane addresses for ldmatrix.x4 on a padded tile of D-wide rows at `base`
// (a shared address):
//   A operand, 16 x 16 block at (row r0, col c0): regs = a0..a3
template <int D>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int r0, int c0,
                                           int lane) {
  return base + (uint32_t)(((r0 + (lane & 15)) * row_stride<D>() + c0 +
                            (lane >> 4) * 8) *
                           2);
}
//   B operand stored [n][k], 16 n x 16 k block at (n0, k0), no transpose:
//   regs = (b0, b1) of n tile n0, then (b0, b1) of n tile n0 + 8
template <int D>
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int n0, int k0,
                                           int lane) {
  return base + (uint32_t)(((n0 + (lane & 7) + ((lane >> 4) << 3)) *
                                row_stride<D>() +
                            k0 + ((lane >> 3) & 1) * 8) *
                           2);
}
//   B operand stored [k][n], 16 k x 16 n block at (k0, n0), with .trans:
//   regs = (b0, b1) of n tile n0, then (b0, b1) of n tile n0 + 8
template <int D>
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int k0, int n0,
                                            int lane) {
  return base + (uint32_t)(((k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                row_stride<D>() +
                            n0 + (lane >> 4) * 8) *
                           2);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, bf16) * b (16 x 8, bf16), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to nearest-even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (16 x 16, bf16) of the k16 slice made of the C fragments
// of n tiles 2j and 2j + 1: the rounding of p / ds to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// max / sum over the 4 lanes of a quad (the lanes holding one C row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace mt
