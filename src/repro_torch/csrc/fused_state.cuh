// Shared pieces of the LLN tensor-core kernels (lln_causal.cu,
// lln_causal_bwd.cu, lln_diag_fused.cu, lln_diag_fused_bwd.cu,
// lln_bidir.cu, lln_bidir_bwd.cu): the feature map split into bf16
// planes, the per-block LLN states of a kv group, and the products of a
// tile with a planed state.
//
// phi_split writes Phi(x) = exp(x) of an fp32 tensor as NP bf16 planes
// (mma.cuh:split_planes; two keep Phi(x) to 2^-16 relative, three to
// 2^-24), so that every later tile of Phi(q) or Phi(k) is staged by
// cp.async and fed to ldmatrix.  The forwards take two planes, the
// backwards three (their fp32 gradients are held to 1e-5).
//
// state_kernel writes, for every blk block c of a kv group (the last one
// may be short: N need not be a multiple of blk), the exclusive state S_c
// (D x Dv fp32, stored as NST bf16 planes) and z_c (D fp32):
//   forward (kRev false): the sums over the blocks before c of Phi(k)^T v
//     and Phi(k), rows x = ks, y = v;
//   reverse (kRev true): the sums over the blocks after c, and over the r
//     query heads of the group, of (cot Phi(q) / den)^T g = Phi(q)^T u and
//     Phi(q) w, rows x = qs, y = g (cot = 1/2 for the fused pair's halved
//     cotangent, 1 for lln_causal_bwd).
// With s_fin it goes on past the last block (reverse: past the first) and
// writes the inclusive total, S in fp32 and z, reps times each: forward,
// the final state in the r query-head rows of the group (the layout a
// decode state takes); reverse, (dS, dz) over every block and every head
// of the group (the bidirectional backward, one block of N rows).  With
// so null no block state is stored (the bidirectional kernels want only
// the total).
// One CTA owns a 32 x 64 slice of S (and, in its first column slice, 32
// entries of z) and walks the blocks in order (forward) or backwards
// (reverse), heads then rows inside a block: every sum has a fixed order
// and there are no atomics.  The 64-row steps run as a software pipeline:
// the next step's y (cp.async, double-buffered) and x, den, w (registers)
// are in flight during this step's products.  Phi(x) (times cot / den) is
// split into NP planes as it is staged and meets y on the tensor cores in
// NP MMAs; each step's partial sum is added to the fp32 total in
// registers, so the long sums round as fp32 adds.  z is an fp32 sum on the
// CUDA cores.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace lln {

template <int NP>
__global__ void phi_split_kernel(const float* __restrict__ x,
                                 __nv_bfloat16* __restrict__ out,
                                 size_t count) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    float f = expf(x[i]);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const __nv_bfloat16 h = __float2bfloat16(f);
      out[p * count + i] = h;
      f -= __bfloat162float(h);
    }
  }
}

// out (NP, count): plane p at out[p count, (p + 1) count).
template <int NP>
inline cudaError_t phi_split(const float* x, __nv_bfloat16* out, size_t count,
                             cudaStream_t stream) {
  const size_t want = (count + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  if (blocks > 0)
    phi_split_kernel<NP><<<blocks, 256, 0, stream>>>(x, out, count);
  return cudaGetLastError();
}

constexpr int SD = 32;   // state rows (of D) per CTA
constexpr int SE = 64;   // state columns (of Dv) per CTA
constexpr int SR = 64;   // sequence rows per step

// so (NST, BG, nb, D, Dv): plane p at so + p s_count; z (BG, nb, D), nb =
// ceil(N / blk); both null, or neither.  den and w (BH, N) are read by the
// reverse state only; s_fin (BG reps, D, Dv) and z_fin (BG reps, D), fp32,
// may be null.
template <bool kRev, int NP, int NST>
__global__ void __launch_bounds__(128)
state_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ y,
             const float* __restrict__ den, const float* __restrict__ w,
             float cot, __nv_bfloat16* __restrict__ so,
             float* __restrict__ zo, float* __restrict__ s_fin,
             float* __restrict__ z_fin, size_t s_count, int n, int d,
             int dv, int heads, int blk, int reps, int vec) {
  constexpr int LA = SD + 8, LB = SE + 8;
  __shared__ __align__(16) __nv_bfloat16 sa[NP][SR * LA];
  __shared__ __align__(16) __nv_bfloat16 sb[2][SR * LB];
  __shared__ float zred[4][SD];

  const int gi = blockIdx.x;
  const int d0 = blockIdx.y * SD, e0 = blockIdx.z * SE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;   // rows 16 wm, columns 32 wn
  const int dd = threadIdx.x & 31, rq = threadIdx.x >> 5;  // staging slot
  const int nb = (n + blk - 1) / blk;
  const bool vz = vec != 0;
  const bool with_z = blockIdx.z == 0;
  const int ew = min(SE, dv - e0);
  const bool fin = s_fin != nullptr;

  float tot[4][4];
  zero_acc(tot);
  float zp = 0.f;   // this thread's part of z: column dd, rows rq + 4 u
  // Write the exclusive state of the i-th block of the walk (tot, zp).
  const auto store_slot = [&](int i) {
    if (so == nullptr) return;
    const int c = kRev ? nb - 1 - i : i;
    const size_t slot = (static_cast<size_t>(gi) * nb + c) * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = d0 + wm * 16 + gq + hh * 8;
        const int col = e0 + wn * 32 + j * 8 + 2 * t4;
        if (row >= d) continue;
        store_planes<NST>(so + (slot + row) * dv + col, s_count,
                          tot[j][2 * hh], tot[j][2 * hh + 1], col, dv);
      }
    }
    if (with_z) {
      zred[rq][dd] = zp;
      __syncthreads();
      if (threadIdx.x < SD && d0 + threadIdx.x < d) {
        const int t = threadIdx.x;
        zo[slot + d0 + t] =
            ((zred[0][t] + zred[1][t]) + zred[2][t]) + zred[3][t];
      }
    }
  };

  // The walk sums blocks 0 .. nb - 2 in order (reverse: nb - 1 .. 1), and
  // the last one too with the final state; a step is SR rows of one head
  // of one block.  The steps run as one software pipeline: the next step's
  // y (cp.async, double-buffered) and x, den, w (registers) are in flight
  // while the tensor cores work on this one.
  const int walk = fin ? nb : nb - 1;
  struct Cursor { int i, hh, off; };
  const auto rows_of = [&](int i) {
    const int c = kRev ? nb - 1 - i : i;
    return min(blk, n - c * blk);
  };
  const auto advance = [&](Cursor cu) {
    cu.off += SR;
    if (cu.off >= rows_of(cu.i)) {
      cu.off = 0;
      if (++cu.hh == heads) {
        cu.hh = 0;
        ++cu.i;
      }
    }
    return cu;
  };
  float xv[SR / 4], sc[SR / 4], wv[SR / 4];
  const auto fetch = [&](Cursor cu, int buf) {
    const int c = kRev ? nb - 1 - cu.i : cu.i;
    const int valid = min(SR, rows_of(cu.i) - cu.off);
    const size_t r0 = (static_cast<size_t>(gi) * heads + cu.hh) * n +
                      static_cast<size_t>(c) * blk + cu.off;
    stage_rows<SE>(sb[buf], LB, y + r0 * dv + e0, dv, ew, valid, SR, vz);
#pragma unroll
    for (int u = 0; u < SR / 4; ++u) {
      const int rr = rq + 4 * u;
      const bool ok = rr < valid && d0 + dd < d;
      xv[u] = ok ? x[(r0 + rr) * d + d0 + dd] : 0.f;
      sc[u] = kRev && rr < valid ? den[r0 + rr] : 1.f;
      wv[u] = kRev && rr < valid ? w[r0 + rr] : 1.f;
    }
  };

  store_slot(0);
  Cursor cur{0, 0, 0};
  if (walk > 0) {
    fetch(cur, 0);
    cp_async_commit();
  }
  for (int k = 0; cur.i < walk; ++k) {
    const int valid = min(SR, rows_of(cur.i) - cur.off);
    __syncthreads();                 // the last step's tiles are read
#pragma unroll
    for (int u = 0; u < SR / 4; ++u) {
      const int rr = rq + 4 * u;
      const bool ok = rr < valid && d0 + dd < d;
      const float f = ok ? expf(xv[u]) : 0.f;
      zp = fmaf(f, wv[u], zp);
      float a = kRev ? f * (cot / sc[u]) : f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const __nv_bfloat16 h = __float2bfloat16(a);
        sa[p][rr * LA + dd] = h;
        a -= __bfloat162float(h);
      }
    }
    const Cursor next = advance(cur);
    if (next.i < walk) fetch(next, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* sbk = sb[k & 1];
    float part[4][4];
    zero_acc(part);
#pragma unroll
    for (int kk = 0; kk < SR / 16; ++kk) {
      uint32_t af[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        frag_a_trans(af[p], sa[p] + kk * 16 * LA + wm * 16, LA, lane);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        frag_b_trans(b, sbk + kk * 16 * LB + wn * 32 + j * 8, LB, lane);
        const uint32_t b0[1][2] = {{b[0], b[1]}}, b1[1][2] = {{b[2], b[3]}};
        mma_planes<NP, 1>(part[j], af, b0);
        mma_planes<NP, 1>(part[j + 1], af, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[j][e] += part[j][e];
    if (next.i != cur.i && next.i < nb) store_slot(next.i);
    cur = next;
  }
  cp_async_wait<0>();
  if (!fin) return;
  // The inclusive final state, reps copies.
  for (int rep = 0; rep < reps; ++rep) {
    float* sf = s_fin + (static_cast<size_t>(gi) * reps + rep) * d * dv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = d0 + wm * 16 + gq + hh * 8;
        const int col = e0 + wn * 32 + j * 8 + 2 * t4;
        if (row < d && col < dv)
          store_pair(sf + static_cast<size_t>(row) * dv + col, tot[j][2 * hh],
                     tot[j][2 * hh + 1], col, dv);
      }
    }
  }
  if (with_z) {
    __syncthreads();                 // the last step's zred reads are done
    zred[rq][dd] = zp;
    __syncthreads();
    if (threadIdx.x < SD && d0 + threadIdx.x < d) {
      const int t = threadIdx.x;
      const float zt = ((zred[0][t] + zred[1][t]) + zred[2][t]) + zred[3][t];
      for (int rep = 0; rep < reps; ++rep)
        z_fin[(static_cast<size_t>(gi) * reps + rep) * d + d0 + t] = zt;
    }
  }
}

// The exclusive block states of every kv group (see state_kernel), NP
// planes of Phi(x) in the products, NST planes of S_c stored; with s_fin,
// also the final state, reps copies.
template <bool kRev, int NP, int NST = NP>
inline cudaError_t block_states(const float* x, const __nv_bfloat16* y,
                                const float* den, const float* w, float cot,
                                __nv_bfloat16* so, float* z, float* s_fin,
                                float* z_fin, int reps, int bg, int n, int d,
                                int dv, int heads, int blk,
                                cudaStream_t stream) {
  const int nb = (n + blk - 1) / blk;
  const size_t s_count = static_cast<size_t>(bg) * nb * d * dv;
  const int vec = dv % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const dim3 grid(bg, (d + SD - 1) / SD, (dv + SE - 1) / SE);
  state_kernel<kRev, NP, NST><<<grid, 128, 0, stream>>>(
      x, y, den, w, cot, so, z, s_fin, z_fin, s_count, n, d, dv, heads, blk,
      reps, vec);
  return cudaGetLastError();
}

// Stage rows [d0, d0 + 32) of a D x Dv state (plane p at sp + p scount)
// into stg (plane p at rows 32 p .. 32 p + 31).
template <int DP, int NP>
__device__ __forceinline__ void stage_state(__nv_bfloat16* stg,
                                            const __nv_bfloat16* sp,
                                            size_t scount, int d0, int d,
                                            int dv, bool vz) {
  constexpr int LD = DP + 8;
  const int dr = min(32, d - d0);
#pragma unroll
  for (int p = 0; p < NP; ++p)
    stage_tile<DP>(stg + p * 32 * LD, LD,
                   sp + p * scount + static_cast<size_t>(d0) * dv, dv, dr, 32,
                   vz);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Rows [d0, d0 + R) of an fp32 matrix of width dv at sp (row-major) as
// NP bf16 planes (split_planes) at stg + p ps, row stride DP + 8, every
// column up to DP; rows past d and columns past dv are zero.  For blocks
// of 128 threads: each thread issues up to 8 loads of 16 bytes (dv % 4 ==
// 0 and sp 16-byte aligned; else element by element) before it splits
// and stores them, so that they are in flight together (no more than the
// tile needs: each one costs registers).
template <int DP, int NP, int R>
__device__ __forceinline__ void stage_f32(__nv_bfloat16* stg, int ps,
                                          const float* sp, int d0, int d,
                                          int dv) {
  constexpr int LD = DP + 8, QC = DP / 4, TOTAL = R * QC, NT = 128;
  constexpr int B = TOTAL / NT < 8 ? TOTAL / NT : 8;
  static_assert(TOTAL % (B * NT) == 0, "whole rounds of the block's threads");
  const bool v4 = dv % 4 == 0 && (reinterpret_cast<uintptr_t>(sp) & 15) == 0;
  for (int i0 = 0; i0 < TOTAL; i0 += B * NT) {
    float4 x[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = i0 + u * NT + threadIdx.x;
      const int row = i / QC, c = (i - row * QC) * 4;
      const float* src = sp + static_cast<size_t>(d0 + row) * dv + c;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d0 + row < d) {
        if (v4 && c < dv) {
          x[u] = *reinterpret_cast<const float4*>(src);
        } else {
          if (c < dv) x[u].x = src[0];
          if (c + 1 < dv) x[u].y = src[1];
          if (c + 2 < dv) x[u].z = src[2];
          if (c + 3 < dv) x[u].w = src[3];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = i0 + u * NT + threadIdx.x;
      const int row = i / QC, c = (i - row * QC) * 4;
      uint32_t a[NP], b[NP];
      split_planes<NP>(x[u].x, x[u].y, a);
      split_planes<NP>(x[u].z, x[u].w, b);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        *reinterpret_cast<uint2*>(stg + p * ps + row * LD + c) =
            make_uint2(a[p], b[p]);
    }
  }
}

// As above from an fp32 state at sp (D x Dv, row-major), split into NP
// bf16 planes as it is staged (stage_f32).  The bidirectional kernels
// read their fp32 residuals s and dS this way.
template <int DP, int NP>
__device__ __forceinline__ void stage_state(__nv_bfloat16* stg,
                                            const float* sp, size_t,
                                            int d0, int d, int dv, bool) {
  stage_f32<DP, NP, 32>(stg, 32 * (DP + 8), sp, d0, d, dv);
  __syncthreads();
}

// acc (16 x 8 NO) += a S^T over kvs 16-column steps for the 32 rows of the
// state S staged at stg: output tiles 4 CH .. 4 CH + 3 (rows below w).
template <int DP, int NP, int CH, int NO>
__device__ __forceinline__ void mma_state_t(float (&acc)[NO][4],
                                            const __nv_bfloat16* a,
                                            const __nv_bfloat16* stg, int kvs,
                                            int w, int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk >= kvs) break;
    uint32_t af[1][4];
    frag_a(af[0], a + kk * 16, LD, lane);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      if (CH * 32 + j * 8 >= w) break;
      uint32_t b0[NP][2], b1[NP][2];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t r[4];
        frag_b(r, stg + (p * 32 + j * 8) * LD + kk * 16, LD, lane);
        b0[p][0] = r[0]; b0[p][1] = r[1]; b1[p][0] = r[2]; b1[p][1] = r[3];
      }
      mma_planes<1, NP>(acc[CH * 4 + j], af, b0);
      mma_planes<1, NP>(acc[CH * 4 + j + 1], af, b1);
    }
  }
}

// acc += a S^T for the state rows [r0, r0 + 8 NO) (D rows at sp, NP bf16
// planes scount apart, or fp32 split as it is staged), 32 rows at a time
// through stg: the product u S^T (with a = g) or V dS^T (a = V), output
// column c of acc being row r0 + c of S.  With NO = DP / 8 and r0 = 0,
// every row.
template <int DP, int NP, int CH = 0, int NO, typename ST>
__device__ __forceinline__ void state_t_all(float (&acc)[NO][4],
                                            const __nv_bfloat16* a,
                                            __nv_bfloat16* stg, const ST* sp,
                                            size_t scount, int d, int dv,
                                            int kvs, bool vz, int lane,
                                            int r0 = 0) {
  if constexpr (CH * 32 < NO * 8) {
    if (r0 + CH * 32 < d) {
      __syncthreads();
      stage_state<DP, NP>(stg, sp, scount, r0 + CH * 32, d, dv, vz);
      mma_state_t<DP, NP, CH>(acc, a, stg, kvs, d - r0, lane);
      state_t_all<DP, NP, CH + 1>(acc, a, stg, sp, scount, d, dv, kvs, vz,
                                  lane, r0);
    }
  }
}

// Phi(x) = exp(x) of a 64-row fp32 tile (row a at x + a d) as NP bf16
// planes at dst + p ps (row stride DP + 8): warp w stages rows 16 w ..
// 16 w + 15, a warp per row with 8 rows of loads in flight.  Rows at or
// past `rows` and columns at or past d are zero Phi rows and columns (a
// pad row never enters a sum; the tile itself is never zero-padded, since
// exp(0) = 1).  With kDot, pz[a] = Phi(x_a) . z in fp32 with the exact
// Phi, zv holding this lane's entries of z (columns lane + 32 u).
template <int DP, int NP, bool kDot>
__device__ __forceinline__ void phi_rows(__nv_bfloat16* dst, int ps,
                                         const float* x, int rows, int d,
                                         const float (&zv)[DP / 32],
                                         float* pz, int warp, int lane) {
  constexpr int LD = DP + 8, RB = 8, NU = DP / 32;
  for (int i0 = 0; i0 < 16; i0 += RB) {
    float xv[RB][NU];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int a = warp * 16 + i0 + i;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int e = lane + 32 * u;
        xv[i][u] = a < rows && e < d ? x[static_cast<size_t>(a) * d + e] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int a = warp * 16 + i0 + i;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int e = lane + 32 * u;
        float f = a < rows && e < d ? expf(xv[i][u]) : 0.f;
        if (kDot) sum = fmaf(f, zv[u], sum);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const __nv_bfloat16 h = __float2bfloat16(f);
          dst[p * ps + a * LD + e] = h;
          f -= __bfloat162float(h);
        }
      }
      if (kDot) {
        sum = warp_sum(sum);
        if (lane == 0) pz[a] = sum;
      }
    }
  }
}

}  // namespace lln
