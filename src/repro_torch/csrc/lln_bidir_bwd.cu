// Backward of the bidirectional LLN forward (the encoder).
//
// Replaces src/repro/kernels/lln_backward.py:lln_bidir_bwd_pallas.
// Inputs: qs (BH,N,D), ks (BG,N,D) fp32; v (BG,N,Dv), the cotangent g
// (BH,N,Dv) and the saved output o (BH,N,Dv) in one type (fp32 or bf16);
// den (BH,N), s (BG,D,Dv) and z (BG,1,D) fp32, the forward's residuals.
// Outputs, fp32: dqs (BH,N,D), dks
// (BG,N,D), dv (BG,N,Dv), dks and dv summed over the r query heads of a kv
// head.  Scratch, fp32: w (BH,N), ds (BG,D,Dv), dz (BG,D).
//
// Math (the reference's): u = g / den, w = (g . o) / den;
//   dqs = Phi(q) * (u s^T - w z);
//   dS = sum_{h in group, i} Phi(q_i)^T u_i,  dz = sum w_i Phi(q_i);
//   dv = Phi(k) dS,  dks = Phi(k) * (v dS^T - dz).
// The kernel takes g as given: the hybrid passes g / 2.
//
// Two paths, chosen by the caller (kernels/lln_backward.py, by
// lln_attention._tc_path) by type and width, each with its own entry point:
//
// bf16 with D, Dv <= 128 (the encoder on the card): lln_bidir_bwd_tc_launch,
// on the tensor cores, three launches:
//   1. bidir_dq_tc_kernel, one CTA of 4 warps per (query head, 64-row
//      tile): w = (g . o) / den per row in fp32 on the CUDA cores
//      (written for 2), g s^T with g bf16 (one exact plane) against the
//      fp32 s split into three bf16 planes as it is staged (three MMAs,
//      fused_state.cuh:state_t_all), then dqs = Phi(q) (g s^T / den - w z)
//      in fp32 with the exact Phi(q) = exp(qs).
//   2. state_kernel (fused_state.cuh), reverse, with one block of N rows
//      and the final total: (dS, dz) per kv group over the r query heads
//      and the sequence, heads then rows in a fixed order, Phi(q) / den in
//      three bf16 planes against bf16 g (three MMAs), each 64-row step's
//      partial added to the fp32 total; no block state stored.
//   3. bidir_dkv_tc_kernel, two CTAs per (kv group, 64-key tile), by
//      blockIdx.z: dks = Phi(k) (V dS^T - dz) (bf16 V against dS in three
//      planes, three MMAs; the exact Phi(k) = exp(ks)), and dv = Phi(k) dS
//      (Phi(k) and dS in three planes each, six MMAs).  dS is split as it
//      is staged, 32 rows at a time.
//   No atomics: two runs give the same gradients bit for bit.  Any N: pad
//   rows and pad keys are staged as zero rows (zero Phi, zero g) and not
//   written; qs and ks are never zero-padded (exp(0) = 1).  Every fp32
//   operand goes in as three bf16 planes (2^-24 relative: the gradients
//   are held to 1e-5 of the largest entry).
//   Bound on the H100 (chip_smoke.py:_bidir_counts): the bytes, mostly the
//   fp32 qs, ks and gradients, about 4x the products at the bf16 rate.
//
// fp32, or a width above 128: lln_bidir_bwd_launch, the CUDA-core kernels
// below, IEEE fp32, the reference's three kernels.  dq: one CTA per (query
// head, TILE-row tile) with the kv head's s in shared memory, rows padded
// to Dv + 1 so that a warp's 32 consecutive rows of s fall in 32 banks; it
// writes each row's w for the reduce.  Reduce: the TPU revisited one
// output block per kv head in grid order (r, then N); GPU programs run in
// no order, so one CTA per (kv head, COLS columns of dS) loops over the r
// query heads and the sequence in that order, each entry of dS summed by
// one thread: a fixed order and no atomics, so gradients are the same bit
// for bit from run to run.  dk/dv: one CTA per (kv head, TILE-row tile)
// with dS (rows padded) and dz in shared memory.  Any N.  All products are
// fp32 FMAs on the CUDA cores; bound: fp32 operations.
#include "fused_state.cuh"
#include "train_common.cuh"

namespace {

constexpr int TILE = 64;
constexpr int COLS = 32;

template <typename T>
__global__ void bidir_dq_kernel(const float* __restrict__ qs,
                                const T* __restrict__ g,
                                const T* __restrict__ o,
                                const float* __restrict__ den_in,
                                const float* __restrict__ s,
                                const float* __restrict__ z,
                                float* __restrict__ dqs,
                                float* __restrict__ w_out, int n, int d, int dv,
                                int r) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  const int sp = dv + 1;
  float* S = smem;                  // d x sp      forward s
  float* zs = S + d * sp;           // d           forward z
  float* gu = zs + d;               // TILE x dv   g, then u = g / den
  float* fq = gu + TILE * dv;       // TILE x dp   Phi(q)
  float* den = fq + TILE * dp;      // TILE
  float* w = den + TILE;            // TILE

  const int h = blockIdx.x;
  const int kv = h / r;
  const int t0 = blockIdx.y * TILE;
  const int rows = min(TILE, n - t0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const size_t row0 = static_cast<size_t>(h) * n + t0;

  lln::load_tile(S, sp, s + static_cast<size_t>(kv) * d * dv, dv, d, 0, dv,
                 lln::Ident{});
  lln::load_tile(zs, d, z + static_cast<size_t>(kv) * d, d, 1, 0, d,
                 lln::Ident{});
  lln::load_tile(gu, dv, g + row0 * dv, dv, rows, 0, dv, lln::Ident{});
  lln::load_tile(fq, dp, qs + row0 * d, d, rows, 0, d, lln::Exp{});
  for (int a = tid; a < rows; a += nt) den[a] = den_in[row0 + a];
  __syncthreads();
  for (int a = warp; a < rows; a += nw) {
    float acc = 0.f;
    for (int c = lane; c < dv; c += 32)
      acc = fmaf(gu[a * dv + c], lln::to_f32(o[(row0 + a) * dv + c]), acc);
    acc = lln::warp_sum(acc);
    if (lane == 0) {
      w[a] = acc / den[a];
      w_out[row0 + a] = w[a];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * dv; i += nt) gu[i] = gu[i] / den[i / dv];
  __syncthreads();
  for (int i = tid; i < rows * d; i += nt) {
    const int a = i / d, e = i - a * d;
    const float acc = lln::dot(gu + a * dv, S + e * sp, dv);
    dqs[(row0 + a) * d + e] = fq[a * dp + e] * (acc - w[a] * zs[e]);
  }
}

template <typename T>
__global__ void bidir_dsdz_kernel(const float* __restrict__ qs,
                                  const T* __restrict__ g,
                                  const float* __restrict__ den_in,
                                  const float* __restrict__ w_in,
                                  float* __restrict__ ds,
                                  float* __restrict__ dz, int n, int d, int dv,
                                  int r) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* fq = smem;                 // TILE x dp   Phi(q)
  float* ut = fq + TILE * dp;       // TILE x COLS u (this CTA's columns)
  float* dS = ut + TILE * COLS;     // d x COLS
  float* dzs = dS + d * COLS;       // d
  float* den = dzs + d;             // TILE
  float* w = den + TILE;            // TILE

  const int kv = blockIdx.x;
  const int c0 = blockIdx.y * COLS;
  const int cw = min(COLS, dv - c0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = tid; i < d * COLS; i += nt) dS[i] = 0.f;
  for (int i = tid; i < d; i += nt) dzs[i] = 0.f;
  for (int hh = 0; hh < r; ++hh) {
    const size_t hq = (static_cast<size_t>(kv) * r + hh) * n;
    for (int t0 = 0; t0 < n; t0 += TILE) {
      const int rows = min(TILE, n - t0);
      __syncthreads();              // previous tile's readers are done
      for (int a = tid; a < rows; a += nt) {
        den[a] = den_in[hq + t0 + a];
        w[a] = w_in[hq + t0 + a];
      }
      lln::load_tile(fq, dp, qs + (hq + t0) * d, d, rows, 0, d, lln::Exp{});
      __syncthreads();
      for (int i = tid; i < rows * COLS; i += nt) {
        const int a = i / COLS, c = i - a * COLS;
        ut[i] = c < cw ? lln::DivRow{den}(
                             lln::to_f32(g[(hq + t0 + a) * dv + c0 + c]), a)
                       : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < d * COLS; i += nt) {
        const int e = i / COLS, c = i - e * COLS;
        float acc = dS[i];
        for (int a = 0; a < rows; ++a)
          acc = fmaf(fq[a * dp + e], ut[a * COLS + c], acc);
        dS[i] = acc;
      }
      if (blockIdx.y == 0)
        for (int e = tid; e < d; e += nt) {
          float acc = dzs[e];
          for (int a = 0; a < rows; ++a) acc = fmaf(w[a], fq[a * dp + e], acc);
          dzs[e] = acc;
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < d * cw; i += nt) {
    const int e = i / cw, c = i - e * cw;
    ds[(static_cast<size_t>(kv) * d + e) * dv + c0 + c] = dS[e * COLS + c];
  }
  if (blockIdx.y == 0)
    for (int e = tid; e < d; e += nt) dz[static_cast<size_t>(kv) * d + e] = dzs[e];
}

template <typename T>
__global__ void bidir_dkv_kernel(const float* __restrict__ ks,
                                 const T* __restrict__ v,
                                 const float* __restrict__ ds,
                                 const float* __restrict__ dz,
                                 float* __restrict__ dks,
                                 float* __restrict__ dvo, int n, int d,
                                 int dv) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  const int sp = dv + 1;
  float* dS = smem;                 // d x sp
  float* dzs = dS + d * sp;         // d
  float* fk = dzs + d;              // TILE x dp   Phi(k)
  float* vt = fk + TILE * dp;       // TILE x dv

  const int kv = blockIdx.x;
  const int t0 = blockIdx.y * TILE;
  const int rows = min(TILE, n - t0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t row0 = static_cast<size_t>(kv) * n + t0;

  lln::load_tile(dS, sp, ds + static_cast<size_t>(kv) * d * dv, dv, d, 0, dv,
                 lln::Ident{});
  lln::load_tile(dzs, d, dz + static_cast<size_t>(kv) * d, d, 1, 0, d,
                 lln::Ident{});
  lln::load_tile(fk, dp, ks + row0 * d, d, rows, 0, d, lln::Exp{});
  lln::load_tile(vt, dv, v + row0 * dv, dv, rows, 0, dv, lln::Ident{});
  __syncthreads();
  for (int i = tid; i < rows * dv; i += nt) {
    const int j = i / dv, c = i - j * dv;
    const float* fj = fk + j * dp;
    float acc = 0.f;
    for (int e = 0; e < d; ++e) acc = fmaf(fj[e], dS[e * sp + c], acc);
    dvo[(row0 + j) * dv + c] = acc;
  }
  for (int i = tid; i < rows * d; i += nt) {
    const int j = i / d, e = i - j * d;
    const float acc = lln::dot(vt + j * dv, dS + e * sp, dv);
    dks[(row0 + j) * d + e] = fk[j * dp + e] * (acc - dzs[e]);
  }
}

template <typename T>
int launch(const float* qs, const float* ks, const void* v, const void* g,
           const void* o, const float* den, const float* s, const float* z,
           float* dqs, float* dks, float* dv_, float* w, float* ds, float* dz,
           int bh, int bg, int n, int d, int dv, cudaStream_t stream) {
  if (bh % bg != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t tf = TILE;
  const size_t sp = static_cast<size_t>(dv) + 1;
  const size_t dq_bytes = (static_cast<size_t>(d) * sp + d + tf * dv +
                           tf * (d + 1) + 2 * tf) * sizeof(float);
  const size_t red_bytes = (tf * (d + 1) + tf * COLS +
                            static_cast<size_t>(d) * COLS + d + 2 * tf) *
                           sizeof(float);
  const size_t dkv_bytes = (static_cast<size_t>(d) * sp + d + tf * (d + 1) +
                            tf * dv) * sizeof(float);
  cudaError_t err = lln::allow_smem(bidir_dq_kernel<T>, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lln::allow_smem(bidir_dsdz_kernel<T>, red_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lln::allow_smem(bidir_dkv_kernel<T>, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int r = bh / bg;
  const int nb = (n + TILE - 1) / TILE;
  const auto gp = static_cast<const T*>(g);
  bidir_dq_kernel<T><<<dim3(bh, nb), 256, dq_bytes, stream>>>(
      qs, gp, static_cast<const T*>(o), den, s, z, dqs, w, n, d, dv, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 red_grid(bg, (dv + COLS - 1) / COLS);
  bidir_dsdz_kernel<T><<<red_grid, 256, red_bytes, stream>>>(
      qs, gp, den, w, ds, dz, n, d, dv, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bidir_dkv_kernel<T><<<dim3(bg, nb), 256, dkv_bytes, stream>>>(
      ks, static_cast<const T*>(v), ds, dz, dks, dv_, n, d, dv);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.
// ---------------------------------------------------------------------------

using namespace lln;

constexpr int TC_ROWS = 64;   // query rows (dq) or keys (dk/dv) per CTA
// bf16 planes of every fp32 operand: three keep it to 2^-24 relative, so
// the fp32 gradients stay within 1e-5 of the largest entry.
constexpr int NP = 3;

template <int DP>
constexpr size_t dq_smem_bytes() {
  return (2 * TC_ROWS + NP * 32) * (DP + 8) * sizeof(__nv_bfloat16);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return (NP * TC_ROWS + NP * 32) * (DP + 8) * sizeof(__nv_bfloat16);
}

// One CTA per (query head, 64-row tile): w = (g . o) / den per row
// (written to w_out), then dqs = Phi(q) (g s^T / den - w z).  s (BG,D,Dv)
// and z (BG,D): the forward's fp32 totals.
template <int DP>
__global__ void __launch_bounds__(128, 2)
bidir_dq_tc_kernel(const float* __restrict__ qs,
                   const __nv_bfloat16* __restrict__ g,
                   const __nv_bfloat16* __restrict__ o,
                   const float* __restrict__ den_in,
                   const float* __restrict__ s, const float* __restrict__ z,
                   float* __restrict__ dqs, float* __restrict__ w_out, int n,
                   int d, int dv, int r, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 8;
  constexpr int NO = DP / 8;
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* so = sg + TC_ROWS * LD;    // the saved output o
  __nv_bfloat16* stg = so + TC_ROWS * LD;   // NP planes of 32 rows of s

  const int h = blockIdx.x;
  const int kvh = h / r;
  const int r0 = blockIdx.y * TC_ROWS;
  const int rows = min(TC_ROWS, n - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const bool vz = vec != 0;
  const size_t hq = static_cast<size_t>(h) * n + r0;

  stage_tile<DP>(sg, LD, g + hq * dv, dv, rows, TC_ROWS, vz);
  stage_tile<DP>(so, LD, o + hq * dv, dv, rows, TC_ROWS, vz);
  cp_async_commit();
  float dn[2];                       // den of rows gq, gq + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    dn[hh] = a < rows ? den_in[hq + a] : 1.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // w = (g . o) / den per row in fp32 from the staged tiles: the four
  // lanes of a row take every fourth pair of columns, then add.
  float w[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    const __nv_bfloat16* ga = sg + a * LD;
    const __nv_bfloat16* oa = so + a * LD;
    float sum = 0.f;
    for (int e = 2 * t4; e < dv; e += 8) {
      const float2 gf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ga + e));
      const float2 of = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(oa + e));
      sum = fmaf(gf.y, of.y, fmaf(gf.x, of.x, sum));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    w[hh] = a < rows ? sum / dn[hh] : 0.f;
    if (a < rows && t4 == 0) w_out[hq + a] = w[hh];
  }

  float acc[NO][4];                  // g s^T
  zero_acc(acc);
  state_t_all<DP, NP>(acc, sg + warp * 16 * LD, stg,
                      s + static_cast<size_t>(kvh) * d * dv, 0, d, dv,
                      (dv + 15) / 16, vz, lane);

  const float* zg = z + static_cast<size_t>(kvh) * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    if (a >= rows) continue;
    const size_t at = (hq + a) * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int cc = j * 8 + 2 * t4;
      if (cc >= d) break;
      float x0 = (acc[j][2 * hh] / dn[hh] - w[hh] * zg[cc]) *
                 expf(qs[at + cc]);
      if (cc + 1 < d) {
        const float x1 = (acc[j][2 * hh + 1] / dn[hh] - w[hh] * zg[cc + 1]) *
                         expf(qs[at + cc + 1]);
        store_pair(dqs + at + cc, x0, x1, cc, d);
      } else {
        dqs[at + cc] = x0;
      }
    }
  }
}

// Two CTAs per (kv group, 64-key tile), by blockIdx.z: dks = Phi(k) (V
// dS^T - dz) with the exact Phi(k) = exp(ks) (role 0), dv = Phi(k) dS
// (role 1).  ds (BG,D,Dv) and dz (BG,D): the reverse totals, fp32.
template <int DP>
__global__ void __launch_bounds__(128, 2)
bidir_dkv_tc_kernel(const float* __restrict__ ks,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ ds,
                    const float* __restrict__ dz, float* __restrict__ dks,
                    float* __restrict__ dvo, int n, int d, int dv, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 8;
  constexpr int NO = DP / 8;
  constexpr int TS = TC_ROWS * LD;
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);  // V or Phi(k)
  __nv_bfloat16* stg = sx + NP * TS;   // NP planes of 32 rows of dS

  const int kv = blockIdx.x;
  const int k0 = blockIdx.y * TC_ROWS;
  const int role = blockIdx.z;         // 0 dks, 1 dv
  const int kr = min(TC_ROWS, n - k0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int kvs = (dv + 15) / 16;
  const bool vz = vec != 0;
  const size_t row0 = static_cast<size_t>(kv) * n + k0;
  const float* dsg = ds + static_cast<size_t>(kv) * d * dv;
  const __nv_bfloat16* wx = sx + warp * 16 * LD;

  float acc[NO][4];
  zero_acc(acc);
  if (role == 0) {
    stage_tile<DP>(sx, LD, v + row0 * dv, dv, kr, TC_ROWS, vz);
    cp_async_commit();
    cp_async_wait<0>();
    state_t_all<DP, NP>(acc, wx, stg, dsg, 0, d, dv, kvs, vz, lane);
  } else {
    const float none[DP / 32] = {};
    phi_rows<DP, NP, false>(sx, TS, ks + row0 * d, kr, d, none, nullptr,
                            warp, lane);
    for (int d0 = 0; d0 < d; d0 += 32) {
      __syncthreads();
      stage_state<DP, NP>(stg, dsg, 0, d0, d, dv, vz);
      mma_ab_p<NO, 2, NP, NP>(acc, wx + d0, TS, LD, stg, 32 * LD, LD,
                              (min(32, d - d0) + 15) / 16,
                              min(NO, kvs * 2), lane);
    }
  }

  const float* dzg = dz + static_cast<size_t>(kv) * d;
  const int wd = role == 1 ? dv : d;
  float* out = role == 0 ? dks : dvo;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j0 = warp * 16 + gq + hh * 8;
    if (j0 >= kr) continue;
    const size_t row = row0 + j0;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int cc = j * 8 + 2 * t4;
      if (cc >= wd) break;
      float x0 = acc[j][2 * hh], x1 = acc[j][2 * hh + 1];
      if (role == 0) {                 // dks = Phi(k) (V dS^T - dz)
        x0 = (x0 - dzg[cc]) * expf(ks[row * d + cc]);
        if (cc + 1 < d) x1 = (x1 - dzg[cc + 1]) * expf(ks[row * d + cc + 1]);
      }
      store_pair(out + row * wd + cc, x0, x1, cc, wd);
    }
  }
}

template <int DP>
int launch_tc(const float* qs, const float* ks, const void* v, const void* g,
              const void* o, const float* den, const float* s, const float* z,
              float* dqs, float* dks, float* dv_, float* w, float* ds,
              float* dz, int bh, int bg, int n, int d, int dv,
              cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const auto vp = static_cast<const bf*>(v);
  const auto gp = static_cast<const bf*>(g);
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = d % 8 == 0 && dv % 8 == 0 && al(v) && al(g) && al(dqs) &&
                  al(dks) && al(dv_);
  const size_t dq_bytes = dq_smem_bytes<DP>();
  const size_t dkv_bytes = dkv_smem_bytes<DP>();
  cudaError_t err = allow_smem(bidir_dq_tc_kernel<DP>, dq_bytes);
  if (err == cudaSuccess)
    err = allow_smem(bidir_dkv_tc_kernel<DP>, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (n + TC_ROWS - 1) / TC_ROWS;
  bidir_dq_tc_kernel<DP><<<dim3(bh, nt), 128, dq_bytes, stream>>>(
      qs, gp, static_cast<const bf*>(o), den, s, z, dqs, w, n, d, dv,
      bh / bg, vec);
  err = cudaGetLastError();
  // (dS, dz): one block of all N rows over the r heads, no block state
  // stored, the total once per kv group.
  if (err == cudaSuccess)
    err = block_states<true, NP>(qs, gp, den, w, 1.f, nullptr, nullptr, ds,
                                 dz, 1, bg, n, d, dv, bh / bg, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  bidir_dkv_tc_kernel<DP><<<dim3(bg, nt, 2), 128, dkv_bytes, stream>>>(
      ks, vp, ds, dz, dks, dv_, n, d, dv, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (v, g, o): 0 = float32, 1 = bfloat16.  w, ds and dz are fp32
// scratch of (BH,N), (BG,D,Dv) and (BG,D).  Returns cudaGetLastError().
extern "C" int lln_bidir_bwd_launch(
    const void* qs, const void* ks, const void* v, const void* g,
    const void* o, const void* den, const void* s, const void* z, void* dqs,
    void* dks, void* dv, void* w, void* ds, void* dz, int bh, int bg, int n,
    int d, int dvd, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 1)
    return launch<__nv_bfloat16>(c(qs), c(ks), v, g, o, c(den), c(s), c(z),
                                 f(dqs), f(dks), f(dv), f(w), f(ds), f(dz), bh,
                                 bg, n, d, dvd, st);
  if (dtype == 0)
    return launch<float>(c(qs), c(ks), v, g, o, c(den), c(s), c(z), f(dqs),
                         f(dks), f(dv), f(w), f(ds), f(dz), bh, bg, n, d, dvd,
                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 tensor-core path (v, g, o bf16; D, Dv <= 128), any N; w, ds and
// dz are fp32 scratch of (BH,N), (BG,D,Dv) and (BG,D).  Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
extern "C" int lln_bidir_bwd_tc_launch(
    const void* qs, const void* ks, const void* v, const void* g,
    const void* o, const void* den, const void* s, const void* z, void* dqs,
    void* dks, void* dv, void* w, void* ds, void* dz, int bh, int bg, int n,
    int d, int dvd, void* stream) {
  if (bg < 1 || n < 1 || bh % bg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (d <= 64 && dvd <= 64)
    return launch_tc<64>(c(qs), c(ks), v, g, o, c(den), c(s), c(z), f(dqs),
                         f(dks), f(dv), f(w), f(ds), f(dz), bh, bg, n, d, dvd,
                         st);
  if (d <= 128 && dvd <= 128)
    return launch_tc<128>(c(qs), c(ks), v, g, o, c(den), c(s), c(z), f(dqs),
                          f(dks), f(dv), f(w), f(ds), f(dz), bh, bg, n, d,
                          dvd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
