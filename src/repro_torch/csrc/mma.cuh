// Tensor-core helpers of the port's kernels: bf16 mma.sync m16n8k16 with
// fp32 accumulators, ldmatrix fragment loads, cp.async tile staging and the
// hi/lo split of an fp32 operand into two bf16 operands.
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with g = lane / 4 and
// t = lane % 4:
//   A (16 x 16, row):  a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//                      a[2] = A[g][2t+8..2t+9], a[3] = A[g+8][2t+8..2t+9];
//   B (16 x 8, col):   b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..2t+9][g];
//   C (16 x 8, fp32):  c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1].
// Each 32-bit register holds two bf16, the lower column (or row) in the low
// half.  So the accumulators of two neighbouring 8-column C tiles are, as
// they stand, the A fragment of the next product over those 16 columns:
// that is how the softmax probabilities feed P V without shared memory.
//
// Shared tiles are bf16, row-major, with a row stride of a multiple of 8
// elements plus 8 (16 bytes of padding): the 8 rows an ldmatrix reads then
// start on distinct 4-bank groups and the load is free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lln {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives row lane / 4, columns 2 (lane % 4) + {0, 1}.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed: r[i] receives rows
// 2 (lane % 4) + {0, 1} of column lane / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += A B on the tensor cores (bf16 products, exact; fp32 sums).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy from device to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (about 2 ulp; 0 below 2^-126).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) rounded to bf16 (nearest even), x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// x = hi + lo + O(2^-17 |x|), hi = bf16(x), lo = bf16(x - hi), for the
// pair (x0, x1) packed as one fragment register each.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
}

// Stage rows [0, total) of a bf16 tile into shared memory (row stride ld
// elements, DP columns): row i < valid reads src[i * width + c] for
// c < width; every other element is zero.  With vec (width % 8 == 0 and
// src 16-byte aligned) whole 16-byte chunks go by cp.async; the caller
// commits and waits.  Threads of the block share the work.
template <int DP>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src, int width,
                                           int valid, int total, bool vec) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < total * CH; i += blockDim.x) {
    const int row = i / CH, c = (i - row * CH) * 8;
    __nv_bfloat16* d = dst + row * ld + c;
    if (vec && row < valid && c + 8 <= width) {
      cp_async16(d, src + static_cast<size_t>(row) * width + c);
    } else {
      for (int e = 0; e < 8; ++e)
        d[e] = row < valid && c + e < width
                   ? src[static_cast<size_t>(row) * width + c + e]
                   : __float2bfloat16(0.f);
    }
  }
}

// acc (16 x 8 NT) += A B^T with A the 16 rows at a (stride lda) and B the
// 8 NT rows at b (stride ldb), both over the first 16 ks columns: the
// score form q k^T.  NT is even.
template <int NT, int KMAX>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const __nv_bfloat16* a, int lda,
                                        const __nv_bfloat16* b, int ldb,
                                        int ks, int lane) {
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk >= ks) break;
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * lda + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (j * 8 + (lane & 7) + (lane >> 4) * 8) * ldb +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[j], af, bf[0], bf[1]);
      mma_bf16(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x 8 NT) += P B with P (16 x 16 KT) fp32 in accumulator layout
// (p[j] the C tile of columns 8j..8j+7) and B the 16 KT rows at b (stride
// ldb), first 8 NT columns: the value form p v.  P goes in as hi + lo, two
// products per tile.  Only the first nt (even, <= NT) output tiles are
// computed.
template <int NT, int KT>
__device__ __forceinline__ void mma_pb(float (&acc)[NT][4],
                                       const float (&p)[2 * KT][4],
                                       const __nv_bfloat16* b, int ldb,
                                       int nt, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) break;
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kk * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * ldb +
                                j * 8 + (lane >> 4) * 8);
      mma_bf16(acc[j], hi, bf[0], bf[1]);
      mma_bf16(acc[j], lo, bf[0], bf[1]);
      mma_bf16(acc[j + 1], hi, bf[2], bf[3]);
      mma_bf16(acc[j + 1], lo, bf[2], bf[3]);
    }
  }
}

}  // namespace lln
