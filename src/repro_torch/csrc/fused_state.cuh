// Shared pieces of the fused LLN + diag tensor-core kernels
// (lln_diag_fused.cu, lln_diag_fused_bwd.cu): the feature map split into
// bf16 hi + lo, and the per-block LLN states of a kv group.
//
// phi_split writes Phi(x) = exp(x) of an fp32 tensor as NP bf16 planes
// (mma.cuh:split_planes; two keep Phi(x) to 2^-16 relative, three to
// 2^-24), so that every later tile of Phi(q) or Phi(k) is staged by
// cp.async and fed to ldmatrix.  The forward takes two planes, the
// backward three (its fp32 gradients are held to 1e-5).
//
// state_kernel writes, for every blk block c of a kv group, the exclusive
// state S_c (D x Dv fp32, stored as NP bf16 planes) and z_c (D fp32):
//   forward (kRev false): the sums over the blocks before c of Phi(k)^T v
//     and Phi(k), rows x = ks, y = v;
//   reverse (kRev true): the sums over the blocks after c, and over the r
//     query heads of the group, of (Phi(q) / (2 den))^T g = Phi(q)^T u and
//     Phi(q) w, rows x = qs, y = g.
// One CTA owns a 32 x 64 slice of S (and, in its first column slice, 32
// entries of z) and walks the blocks in order (forward) or backwards
// (reverse), heads then rows inside a block: every sum has a fixed order
// and there are no atomics.  Phi(x) (times 1 / (2 den)) is split into NP
// planes as it is staged and meets y on the tensor cores in NP MMAs; each
// 64-row step's partial sum is added to the fp32 total in registers, so
// the long sums round as fp32 adds.  z is an fp32 sum on the CUDA cores.
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

// so (NP, BG, nb, D, Dv): plane p at so + p s_count; z (BG, nb, D).
// den and w (BH, N) are read by the reverse state only.
template <bool kRev, int NP>
__global__ void __launch_bounds__(128)
state_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ y,
             const float* __restrict__ den, const float* __restrict__ w,
             __nv_bfloat16* __restrict__ so, float* __restrict__ zo,
             size_t s_count, int n, int d, int dv, int heads, int blk,
             int vec) {
  constexpr int LA = SD + 8, LB = SE + 8;
  __shared__ __align__(16) __nv_bfloat16 sa[NP][SR * LA];
  __shared__ __align__(16) __nv_bfloat16 sb[SR * LB];
  __shared__ float zred[4][SD];

  const int gi = blockIdx.x;
  const int d0 = blockIdx.y * SD, e0 = blockIdx.z * SE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;   // rows 16 wm, columns 32 wn
  const int dd = threadIdx.x & 31, rq = threadIdx.x >> 5;  // staging slot
  const int nb = n / blk;
  const bool vz = vec != 0;
  const bool with_z = blockIdx.z == 0;
  const int ew = min(SE, dv - e0);

  float tot[4][4];
  zero_acc(tot);
  float zp = 0.f;   // this thread's part of z: column dd, rows rq + 4 u
  for (int step = 0; step < nb; ++step) {
    const int c = kRev ? nb - 1 - step : step;
    const size_t slot = (static_cast<size_t>(gi) * nb + c) * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = d0 + wm * 16 + gq + hh * 8;
        const int col = e0 + wn * 32 + j * 8 + 2 * t4;
        if (row >= d) continue;
        store_planes<NP>(so + (slot + row) * dv + col, s_count,
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
    if (kRev ? c == 0 : c == nb - 1) break;
    for (int hh = 0; hh < heads; ++hh) {
      const size_t row0 = (static_cast<size_t>(gi) * heads + hh) * n +
                          static_cast<size_t>(c) * blk;
      for (int off = 0; off < blk; off += SR) {
        const int valid = min(SR, blk - off);
        const size_t r0 = row0 + off;
        __syncthreads();               // the last step's tiles are read
        stage_rows<SE>(sb, LB, y + r0 * dv + e0, dv, ew, valid, SR, vz);
        cp_async_commit();
        float xv[SR / 4], sc[SR / 4], wv[SR / 4];
#pragma unroll
        for (int u = 0; u < SR / 4; ++u) {   // loads first, all in flight
          const int rr = rq + 4 * u;
          const bool ok = rr < valid && d0 + dd < d;
          xv[u] = ok ? x[(r0 + rr) * d + d0 + dd] : 0.f;
          sc[u] = kRev && rr < valid ? den[r0 + rr] : 1.f;
          wv[u] = kRev && rr < valid ? w[r0 + rr] : 1.f;
        }
#pragma unroll
        for (int u = 0; u < SR / 4; ++u) {
          const int rr = rq + 4 * u;
          const bool ok = rr < valid && d0 + dd < d;
          const float f = ok ? expf(xv[u]) : 0.f;
          zp = fmaf(f, wv[u], zp);
          float a = kRev ? f * (0.5f / sc[u]) : f;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const __nv_bfloat16 h = __float2bfloat16(a);
            sa[p][rr * LA + dd] = h;
            a -= __bfloat162float(h);
          }
        }
        cp_async_wait<0>();
        __syncthreads();
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
            frag_b_trans(b, sb + kk * 16 * LB + wn * 32 + j * 8, LB, lane);
            const uint32_t b0[1][2] = {{b[0], b[1]}}, b1[1][2] = {{b[2], b[3]}};
            mma_planes<NP, 1>(part[j], af, b0);
            mma_planes<NP, 1>(part[j + 1], af, b1);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[j][e] += part[j][e];
      }
    }
  }
}

// The exclusive block states of every kv group (see state_kernel).
template <bool kRev, int NP>
inline cudaError_t block_states(const float* x, const __nv_bfloat16* y,
                                const float* den, const float* w,
                                __nv_bfloat16* so, float* z, int bg, int n,
                                int d, int dv, int heads, int blk,
                                cudaStream_t stream) {
  const int nb = n / blk;
  const size_t s_count = static_cast<size_t>(bg) * nb * d * dv;
  const int vec = dv % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const dim3 grid(bg, (d + SD - 1) / SD, (dv + SE - 1) / SE);
  state_kernel<kRev, NP><<<grid, 128, 0, stream>>>(x, y, den, w, so, z,
                                               s_count, n, d, dv, heads, blk,
                                               vec);
  return cudaGetLastError();
}

}  // namespace lln
