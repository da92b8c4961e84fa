// The output kernel of the chunk-parallel causal LLN forwards on the
// tensor cores (lln_causal.cu, loglin_causal.cu), bf16 v with D, Dv <= DP.
//
// Granule (or block) j of blk rows reads, beside its own keys, only a
// state A_j fixed before the launch: the exclusive prefix S_j of the plain
// LLN scan, or the weighted pyramid read of the log-linear form.  One CTA
// of 4 warps per (query head, granule, 64-row tile), the tiles that walk
// the most keys first; N need not be a multiple of blk (a short last
// granule, its pad rows not written).  Phi(q) = exp(qs) is split into
// bf16 hi + lo as it is loaded, 8 rows of loads in flight per warp (each
// query tile has one reader), and Phi(q) . zA_j is taken in fp32 with the
// exact Phi(q).  The granule's keys up to the tile's last row come in 16-
// or 32-key tiles of v and Phi(k) hi / lo, staged by cp.async
// (double-buffered): Phi(q) Phi(k)^T (three MMAs), masked on the diagonal
// tiles, its row sums for den, scores V (two MMAs).  Then Phi(q) A_j
// (three MMAs), den = row sums + Phi(q) . zA_j + EPS, and out rounded
// once.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace lln {

constexpr int kOutRows = 64;   // query rows per output CTA (4 warps x 16)

// Key rows per staged tile: 16 at DP = 128; the stage area also holds 64
// rows of A_j hi and lo.
template <int DP>
__host__ __device__ constexpr int out_key_tile() { return DP > 64 ? 16 : 32; }

template <int DP>
__host__ __device__ constexpr int out_stage_rows() {
  return 6 * out_key_tile<DP>() > 2 * kOutRows ? 6 * out_key_tile<DP>()
                                              : 2 * kOutRows;
}

template <int DP>
constexpr size_t out_smem_bytes() {
  return (2 * kOutRows + out_stage_rows<DP>()) * (DP + 8) *
             sizeof(__nv_bfloat16) +
         kOutRows * sizeof(float);
}

// phk (2,BG,N,D): Phi(k) hi, then lo at + kcount; aw (2,BG,nc,D,Dv): A_j
// hi, then lo at + a_count; za (BG,nc,D); den_out (BH,N) may be null.
template <int DP>
__global__ void __launch_bounds__(128, 2)
causal_out_kernel(const float* __restrict__ qs,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ phk,
                  const __nv_bfloat16* __restrict__ aw,
                  const float* __restrict__ za,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ den_out, int n, int d, int dv, int r,
                  int blk, size_t kcount, size_t a_count, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 8;
  constexpr int KT = out_key_tile<DP>();
  constexpr int NS = KT / 8;           // score tiles of 8 keys per warp
  constexpr int NO = DP / 8;           // output tiles of 8 columns per warp
  constexpr int TS = kOutRows * LD;
  constexpr int KS = KT * LD;
  __nv_bfloat16* sfh = reinterpret_cast<__nv_bfloat16*>(smem);  // Phi(q) hi
  __nv_bfloat16* sfl = sfh + TS;       // Phi(q) lo (planes TS apart)
  __nv_bfloat16* stg = sfl + TS;       // 2 stages of v, Phi(k) hi, lo
  float* pz = reinterpret_cast<float*>(stg + out_stage_rows<DP>() * LD);

  const int h = blockIdx.x;
  const int kvh = h / r;
  const int j = blockIdx.y;
  const int nc = gridDim.y;
  const int g0 = j * blk;
  const int gend = min(g0 + blk, n);
  const int r0 = g0 + (gridDim.z - 1 - blockIdx.z) * kOutRows;
  if (r0 >= gend) return;              // blk < 64 or a short last granule
  const int rows = min(kOutRows, gend - r0);
  const int nk = r0 + rows - g0;       // the granule's keys up to the last row
  const int ntiles = (nk + KT - 1) / KT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ks = (d + 15) / 16;
  const int no = min(NO, ((dv + 15) / 16) * 2);
  const bool vz = vec != 0;
  const size_t hq = static_cast<size_t>(h) * n;
  const size_t hk = static_cast<size_t>(kvh) * n + g0;
  const __nv_bfloat16* vh = v + hk * dv;
  const __nv_bfloat16* fkh = phk + hk * d;

  const auto stage_keys = [&](int t, int sb) {
    const int k0 = t * KT, kr = min(KT, nk - k0);
    __nv_bfloat16* s = stg + sb * 3 * KS;
    const size_t o = static_cast<size_t>(k0) * d;
    stage_tile<DP>(s, LD, vh + static_cast<size_t>(k0) * dv, dv, kr, KT, vz);
    stage_tile<DP>(s + KS, LD, fkh + o, d, kr, KT, vz);
    stage_tile<DP>(s + 2 * KS, LD, fkh + kcount + o, d, kr, KT, vz);
  };
  stage_keys(0, 0);
  cp_async_commit();

  // Phi(q) = exp(qs) as hi + lo, split as it is loaded, and Phi(q) . zA_j
  // in fp32 with the exact Phi(q): a warp per row, 8 rows of loads in
  // flight at a time.
  {
    constexpr int RB = 8, NU = DP / 32;
    const float* zj = za + (static_cast<size_t>(kvh) * nc + j) * d;
    float zv[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u)
      zv[u] = j > 0 && lane + 32 * u < d ? zj[lane + 32 * u] : 0.f;
    for (int i0 = 0; i0 < 16; i0 += RB) {
      float x[RB][NU];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int a = warp * 16 + i0 + i;
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int e = lane + 32 * u;
          x[i][u] = a < rows && e < d ? qs[(hq + r0 + a) * d + e] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int a = warp * 16 + i0 + i;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int e = lane + 32 * u;
          const float f = a < rows && e < d ? expf(x[i][u]) : 0.f;
          sum = fmaf(f, zv[u], sum);
          const __nv_bfloat16 hb = __float2bfloat16(f);
          sfh[a * LD + e] = hb;
          sfl[a * LD + e] = __float2bfloat16(f - __bfloat162float(hb));
        }
        sum = warp_sum(sum);
        if (lane == 0) pz[a] = sum;
      }
    }
  }

  float ol[NO][4];
  zero_acc(ol);
  float rs[2] = {0.f, 0.f};          // this thread's part of the row sums
  const int qw = r0 - g0 + warp * 16;        // the warp's first query
  const int qrow = qw + gq;
  const __nv_bfloat16* afh = sfh + warp * 16 * LD;

  for (int t = 0; t < ntiles; ++t) {
    const int sb = t & 1;
    if (t + 1 < ntiles) stage_keys(t + 1, sb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* s_v = stg + sb * 3 * KS;
    float a[NS][4];
    zero_acc(a);
    mma_abt_p<NS, DP / 16, 2, 2>(a, afh, TS, LD, s_v + KS, KS, LD, ks, lane);
    // Mask above the diagonal (only tiles reaching past the warp's first
    // query need it; keys past the last row lie above every row's).
    const int kb = t * KT;
    const bool edge = kb + KT > qw + 1;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kb + jj * 8 + 2 * t4 + (e & 1);
        const int row = qrow + (e >> 1) * 8;
        if (edge && col > row) a[jj][e] = 0.f;
        rs[e >> 1] += a[jj][e];
      }
    }
    mma_pb_p<NO, NS / 2, 2, 1>(ol, a, s_v, 0, LD, no, lane);
    __syncthreads();                 // this stage is free for the prefetch
  }
  cp_async_wait<0>();

  // Phi(q) A_j, 64 rows of A (hi, then lo) at a time through the stages.
  if (j > 0) {
    const __nv_bfloat16* ah =
        aw + (static_cast<size_t>(kvh) * nc + j) * d * dv;
    for (int d0 = 0; d0 < d; d0 += 64) {
      const int dr = min(64, d - d0);
      __syncthreads();
      stage_tile<DP>(stg, LD, ah + static_cast<size_t>(d0) * dv, dv, dr, 64,
                     vz);
      stage_tile<DP>(stg + 64 * LD, LD,
                     ah + a_count + static_cast<size_t>(d0) * dv, dv, dr, 64,
                     vz);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mma_ab_p<NO, 4, 2, 2>(ol, afh + d0, TS, LD, stg, 64 * LD, LD,
                            (dr + 15) / 16, no, lane);
    }
  }
  __syncthreads();                   // pz

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    if (a >= rows) continue;
    const float dn = rs[hh] + pz[a] + kEps;
    if (den_out != nullptr && t4 == 0) den_out[hq + r0 + a] = dn;
    __nv_bfloat16* orow = out + (hq + r0 + a) * dv;
#pragma unroll
    for (int jj = 0; jj < NO; ++jj) {
      const int cc = jj * 8 + 2 * t4;
      const uint32_t x = pack_bf16(ol[jj][2 * hh] / dn, ol[jj][2 * hh + 1] / dn);
      if (vz && cc + 1 < dv) {
        *reinterpret_cast<uint32_t*>(orow + cc) = x;
      } else {
        if (cc < dv) orow[cc] = __ushort_as_bfloat16(x & 0xffffu);
        if (cc + 1 < dv) orow[cc + 1] = __ushort_as_bfloat16(x >> 16);
      }
    }
  }
}

// Launch causal_out_kernel: (BH, nc, blk / 64) CTAs, nc = ceil(N / blk).
template <int DP>
inline cudaError_t causal_out(const float* qs, const __nv_bfloat16* v,
                              const __nv_bfloat16* phk,
                              const __nv_bfloat16* aw, const float* za,
                              __nv_bfloat16* out, float* den, int bh, int bg,
                              int n, int d, int dv, int blk, size_t kcount,
                              size_t a_count, int vec, cudaStream_t stream) {
  const size_t bytes = out_smem_bytes<DP>();
  cudaError_t err = allow_smem(causal_out_kernel<DP>, bytes);
  if (err != cudaSuccess) return err;
  const int nc = (n + blk - 1) / blk;
  const dim3 grid(bh, nc, (blk + kOutRows - 1) / kOutRows);
  causal_out_kernel<DP><<<grid, 128, bytes, stream>>>(
      qs, v, phk, aw, za, out, den, n, d, dv, bh / bg, blk, kcount, a_count,
      vec);
  return cudaGetLastError();
}

}  // namespace lln
