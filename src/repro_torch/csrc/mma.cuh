// Tensor-core helpers of the port's kernels: bf16 mma.sync m16n8k16 with
// fp32 accumulators, ldmatrix fragment loads, cp.async tile staging and the
// split of an fp32 operand into two or three bf16 planes (hi + lo, or hi +
// mid + lo), with products over the planes of either side.
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
// that is how the softmax probabilities feed P V without shared memory
// (mma_pb_p, after split_acc rounds them to bf16 planes).
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

// Stage rows [0, total) of a bf16 tile into shared memory (row stride ld
// elements, DP columns): row i < valid reads src[i * stride + c] for
// c < width; every other element is zero.  With vec (width and stride
// multiples of 8, src 16-byte aligned) whole 16-byte chunks go by
// cp.async; the caller commits and waits.  Threads of the block share the
// work.
template <int DP>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           size_t stride, int width,
                                           int valid, int total, bool vec) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < total * CH; i += blockDim.x) {
    const int row = i / CH, c = (i - row * CH) * 8;
    __nv_bfloat16* d = dst + row * ld + c;
    if (vec && row < valid && c + 8 <= width) {
      cp_async16(d, src + row * stride + c);
    } else {
      for (int e = 0; e < 8; ++e)
        d[e] = row < valid && c + e < width ? src[row * stride + c + e]
                                            : __float2bfloat16(0.f);
    }
  }
}

// stage_rows of a tile whose source rows are width elements apart.
template <int DP>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src, int width,
                                           int valid, int total, bool vec) {
  stage_rows<DP>(dst, ld, src, static_cast<size_t>(width), width, valid,
                 total, vec);
}

// Fragment loads of one 16 x 16 A tile or two 8-column B tiles (16 n x 16
// k) from a shared tile at p with row stride ld, stored either way round:
// frag_a reads A stored [m][k], frag_a_trans A stored [k][m]; frag_b reads
// B stored [n][k] (the rows of k in q k^T), frag_b_trans B stored [k][n]
// (the rows of v in p v).  b[0..1] are the first tile's, b[2..3] the
// second's.
__device__ __forceinline__ void frag_a(uint32_t (&r)[4],
                                       const __nv_bfloat16* p, int ld,
                                       int lane) {
  ldmatrix_x4(r, p + (lane & 15) * ld + (lane >> 4) * 8);
}
__device__ __forceinline__ void frag_a_trans(uint32_t (&r)[4],
                                             const __nv_bfloat16* p, int ld,
                                             int lane) {
  ldmatrix_x4_trans(r, p + ((lane >> 4) * 8 + (lane & 7)) * ld +
                           ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void frag_b(uint32_t (&r)[4],
                                       const __nv_bfloat16* p, int ld,
                                       int lane) {
  ldmatrix_x4(r, p + ((lane & 7) + (lane >> 4) * 8) * ld +
                     ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void frag_b_trans(uint32_t (&r)[4],
                                             const __nv_bfloat16* p, int ld,
                                             int lane) {
  ldmatrix_x4_trans(r, p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           (lane >> 4) * 8);
}

// An fp32 pair (x0, x1) as NP bf16 planes, packed as fragment registers:
// p[0] = bf16(x), p[i] = bf16(x - p[0] - ... - p[i-1]) (each difference
// exact).  Two planes (hi + lo) keep x to 2^-16 relative, three to 2^-24
// (exact for normal x).
template <int NP>
__device__ __forceinline__ void split_planes(float x0, float x1,
                                             uint32_t (&p)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    p[i] = pack_bf16(x0, x1);
    x0 -= bf16_lo(p[i]);
    x1 -= bf16_hi(p[i]);
  }
}

// Two neighbouring outputs, columns col and col + 1 of a row of width w at
// p (the row's element col): one 8- or 4-byte store where both exist and
// the pair is aligned (w even), else element by element.
__device__ __forceinline__ void store_pair(float* p, float x0, float x1,
                                           int col, int w) {
  if (col + 1 < w && (w & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    if (col < w) p[0] = x0;
    if (col + 1 < w) p[1] = x1;
  }
}

// (x0, x1) split into NP bf16 planes (split_planes), stored as pairs at p
// + i * plane for plane i.
template <int NP>
__device__ __forceinline__ void store_planes(__nv_bfloat16* p, size_t plane,
                                             float x0, float x1, int col,
                                             int w) {
  uint32_t pl[NP];
  split_planes<NP>(x0, x1, pl);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    __nv_bfloat16* ph = p + i * plane;
    if (col + 1 < w && (w & 1) == 0) {
      *reinterpret_cast<uint32_t*>(ph) = pl[i];
    } else {
      if (col < w) ph[0] = __ushort_as_bfloat16(pl[i] & 0xffffu);
      if (col + 1 < w) ph[1] = __ushort_as_bfloat16(pl[i] >> 16);
    }
  }
}

// The NP-plane A fragments of the fp32 16 x 16 tile held as two
// neighbouring C tiles (columns 0..7 in c0, 8..15 in c1).
template <int NP>
__device__ __forceinline__ void split_acc(const float (&c0)[4],
                                          const float (&c1)[4],
                                          uint32_t (&a)[NP][4]) {
  uint32_t t[NP];
  split_planes<NP>(c0[0], c0[1], t);
#pragma unroll
  for (int i = 0; i < NP; ++i) a[i][0] = t[i];
  split_planes<NP>(c0[2], c0[3], t);
#pragma unroll
  for (int i = 0; i < NP; ++i) a[i][1] = t[i];
  split_planes<NP>(c1[0], c1[1], t);
#pragma unroll
  for (int i = 0; i < NP; ++i) a[i][2] = t[i];
  split_planes<NP>(c1[2], c1[3], t);
#pragma unroll
  for (int i = 0; i < NP; ++i) a[i][3] = t[i];
}

// c += a b with a in NA bf16 planes and b in NB (a bf16 operand is one
// plane): the products of planes i and j with i + j < max(NA, NB), the
// largest first.  (1, 1) is one exact MMA (q k^T), (2, 1) two (p V, the
// fp32 p as hi + lo: about 2^-16 of |a b| left), (2, 2) three (hi hi + hi
// lo + lo hi, the two-sided split), (3, 1) three and (3, 3) six (about
// 2^-24 left).  b[j] holds plane j's two B registers.
template <int NA, int NB>
__device__ __forceinline__ void mma_planes(float (&c)[4],
                                           const uint32_t (&a)[NA][4],
                                           const uint32_t (&b)[NB][2]) {
  constexpr int K = (NA > NB ? NA : NB) - 1;
#pragma unroll
  for (int s = 0; s <= K; ++s) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int j = s - i;
      if (j >= 0 && j < NB) mma_bf16(c, a[i], b[j][0], b[j][1]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// The products of planed operands.  A tile in planes lies at p + i * ps
// for plane i (shared memory); a bf16 operand is one plane.
//
// acc (16 x 8 NT) += A B^T, A the 16 rows at a, B the 8 NT rows at b, over
// the first 16 ks columns: the score form q k^T or Phi(q) Phi(k)^T.
template <int NT, int KMAX, int NA, int NB>
__device__ __forceinline__ void mma_abt_p(float (&acc)[NT][4],
                                          const __nv_bfloat16* a, int pa,
                                          int lda, const __nv_bfloat16* b,
                                          int pb, int ldb, int ks, int lane) {
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk >= ks) break;
    uint32_t af[NA][4];
#pragma unroll
    for (int i = 0; i < NA; ++i) frag_a(af[i], a + i * pa + kk * 16, lda, lane);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b0[NB][2], b1[NB][2];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        uint32_t r[4];
        frag_b(r, b + i * pb + j * 8 * ldb + kk * 16, ldb, lane);
        b0[i][0] = r[0]; b0[i][1] = r[1]; b1[i][0] = r[2]; b1[i][1] = r[3];
      }
      mma_planes<NA, NB>(acc[j], af, b0);
      mma_planes<NA, NB>(acc[j + 1], af, b1);
    }
  }
}

// acc (16 x 8 NT) += P B with P (16 x 16 KT) fp32 in accumulator layout,
// split into NA planes, and B the 16 KT rows at b (row-major, k by n): the
// value form p v.  Only the first nt (even) output tiles are computed.
template <int NT, int KT, int NA, int NB>
__device__ __forceinline__ void mma_pb_p(float (&acc)[NT][4],
                                         const float (&p)[2 * KT][4],
                                         const __nv_bfloat16* b, int pb,
                                         int ldb, int nt, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t af[NA][4];
    split_acc<NA>(p[2 * kk], p[2 * kk + 1], af);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) break;
      uint32_t b0[NB][2], b1[NB][2];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        uint32_t r[4];
        frag_b_trans(r, b + i * pb + kk * 16 * ldb + j * 8, ldb, lane);
        b0[i][0] = r[0]; b0[i][1] = r[1]; b1[i][0] = r[2]; b1[i][1] = r[3];
      }
      mma_planes<NA, NB>(acc[j], af, b0);
      mma_planes<NA, NB>(acc[j + 1], af, b1);
    }
  }
}

// acc (16 x 8 NT) += A B with A the 16 rows at a and B the rows of k at b
// (row-major, k by n), over the first 16 ks rows of B: a state product
// such as Phi(q) S.  Only the first nt (even) output tiles are computed.
template <int NT, int KMAX, int NA, int NB>
__device__ __forceinline__ void mma_ab_p(float (&acc)[NT][4],
                                         const __nv_bfloat16* a, int pa,
                                         int lda, const __nv_bfloat16* b,
                                         int pb, int ldb, int ks, int nt,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk >= ks) break;
    uint32_t af[NA][4];
#pragma unroll
    for (int i = 0; i < NA; ++i) frag_a(af[i], a + i * pa + kk * 16, lda, lane);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) break;
      uint32_t b0[NB][2], b1[NB][2];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        uint32_t r[4];
        frag_b_trans(r, b + i * pb + kk * 16 * ldb + j * 8, ldb, lane);
        b0[i][0] = r[0]; b0[i][1] = r[1]; b1[i][0] = r[2]; b1[i][1] = r[3];
      }
      mma_planes<NA, NB>(acc[j], af, b0);
      mma_planes<NA, NB>(acc[j + 1], af, b1);
    }
  }
}

}  // namespace lln
