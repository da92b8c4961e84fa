// Bidirectional LLN forward (paper eq. 8, the encoder).
//
// Replaces src/repro/kernels/lln_attention.py:lln_bidir_pallas (with
// return_res).  Inputs qs (BH,N,D) and ks (BG,N,D) are fp32, pre-scaled and
// stabilized (<= 0); v (BG,N,Dv) is fp32 or bf16; query row h reads kv row
// h / r.  Outputs: s (BG,D,Dv) = sum_j Phi(k_j) v_j^T and z (BG,1,D) =
// sum_j Phi(k_j) over the whole sequence, fp32; out (BH,N,Dv) in v's type,
// Phi(q) s / (Phi(q).z + EPS); optional (null deselects it) den (BH,N) fp32,
// the row normalizer the backward reads.
//
// Two paths, chosen by the caller (kernels/lln_attention.py:_tc_path) by
// type and width, each with its own entry point:
//
// bf16 v with D, Dv <= 128 (the encoder on the card): lln_bidir_tc_launch,
// on the tensor cores, two launches:
//   1. state_kernel (csrc/fused_state.cuh) with one block of N rows and
//      the final state: (s, z) per kv group in fp32, each CTA owning a
//      32 x 64 slice of s (768 CTAs at the encoder shape) and walking the
//      sequence in 64-row steps in order, Phi(k) in three bf16 planes
//      against bf16 v (three MMAs; s is a residual the backward reads,
//      held to 1e-5), each step's partial added to the fp32 total; no
//      block state stored.  A fixed order and no atomics.  (N cut into
//      chunks summed in parallel, then added in order, was measured
//      slower on the card: the walk gained less than the adding pass
//      cost.)
//   2. bidir_apply_tc_kernel: one CTA of 4 warps per (query head, 64-row
//      tile).  Phi(q) = exp(qs) is split into bf16 hi + lo as it is
//      loaded and Phi(q) . z taken in fp32 with the exact Phi(q); the kv
//      group's fp32 s is split into hi + lo as it is staged (8 loads of 16
//      bytes in flight per thread); Phi(q) s in three MMAs (hi hi, hi lo,
//      lo hi), den = Phi(q) . z + EPS, out rounded once.
//   Any N: pad keys and pad query rows are staged as zero Phi rows and pad
//   rows are not written; qs and ks are never zero-padded (exp(0) = 1).
//   Bound on the H100 (chip_smoke.py:_bidir_counts): the bytes, mostly the
//   fp32 qs and ks, about 5x the products at the bf16 rate.
//
// fp32 v, or a width above 128: lln_bidir_launch, the CUDA-core kernels
// below, IEEE fp32, the reference's two kernels.  The TPU's reduce walked
// the sequence on the grid's ordered minor axis and accumulated into a
// revisited output block; GPU blocks run in no order, so here one CTA per
// (kv head, COLS value columns) loops over the sequence in TILE-row tiles
// and owns its slice of s (D x COLS) in shared memory, each entry summed by
// one thread in sequence order: a fixed order, no atomics.  The column-0
// CTA also sums z.  The apply gives each CTA one query head's TILE-row
// tile and the whole of its kv head's s and z in shared memory; a warp
// reads one row of Phi(q) (broadcast) against consecutive columns of s.
// Any N: the ragged last tile loads pad keys as Phi(k) = 0 and writes no
// pad rows.  All products are fp32 FMAs on the CUDA cores; bound: fp32
// operations.
#include "fused_state.cuh"
#include "train_common.cuh"

namespace {

constexpr int TILE = 64;
constexpr int COLS = 32;

template <typename VT>
__global__ void bidir_reduce_kernel(const float* __restrict__ ks,
                                    const VT* __restrict__ v,
                                    float* __restrict__ s,
                                    float* __restrict__ z, int n, int d,
                                    int dv) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* fk = smem;                 // TILE x dp   Phi(k)
  float* vt = fk + TILE * dp;       // TILE x COLS V (this CTA's columns)
  float* S = vt + TILE * COLS;      // d x COLS    running sum of Phi(k) v^T
  float* zs = S + d * COLS;         // d           running sum of Phi(k)

  const int g = blockIdx.x;
  const int c0 = blockIdx.y * COLS;
  const int cw = min(COLS, dv - c0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* kg = ks + static_cast<size_t>(g) * n * d;
  const VT* vg = v + static_cast<size_t>(g) * n * dv;

  for (int i = tid; i < d * COLS; i += nt) S[i] = 0.f;
  for (int i = tid; i < d; i += nt) zs[i] = 0.f;

  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int rows = min(TILE, n - t0);
    __syncthreads();                // previous tile's readers are done
    for (int i = tid; i < TILE * d; i += nt) {
      const int a = i / d, e = i - a * d;
      fk[a * dp + e] =
          a < rows ? expf(kg[static_cast<size_t>(t0 + a) * d + e]) : 0.f;
    }
    for (int i = tid; i < TILE * COLS; i += nt) {
      const int a = i / COLS, c = i - a * COLS;
      vt[i] = (a < rows && c < cw)
                  ? lln::to_f32(vg[static_cast<size_t>(t0 + a) * dv + c0 + c])
                  : 0.f;
    }
    __syncthreads();
    // Entry (e, c) of s: one thread, keys in sequence order.
    for (int i = tid; i < d * COLS; i += nt) {
      const int e = i / COLS, c = i - e * COLS;
      float acc = S[i];
      for (int a = 0; a < rows; ++a)
        acc = fmaf(fk[a * dp + e], vt[a * COLS + c], acc);
      S[i] = acc;
    }
    if (blockIdx.y == 0)
      for (int e = tid; e < d; e += nt) {
        float acc = zs[e];
        for (int a = 0; a < rows; ++a) acc += fk[a * dp + e];
        zs[e] = acc;
      }
  }
  __syncthreads();
  for (int i = tid; i < d * cw; i += nt) {
    const int e = i / cw, c = i - e * cw;
    s[(static_cast<size_t>(g) * d + e) * dv + c0 + c] = S[e * COLS + c];
  }
  if (blockIdx.y == 0)
    for (int e = tid; e < d; e += nt) z[static_cast<size_t>(g) * d + e] = zs[e];
}

template <typename VT>
__global__ void bidir_apply_kernel(const float* __restrict__ qs,
                                   const float* __restrict__ s,
                                   const float* __restrict__ z,
                                   VT* __restrict__ out,
                                   float* __restrict__ den_out, int n, int d,
                                   int dv, int r) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* fq = smem;                 // TILE x dp   Phi(q)
  float* S = fq + TILE * dp;        // d x dv      the kv head's s
  float* zs = S + d * dv;           // d
  float* den = zs + d;              // TILE

  const int h = blockIdx.x;
  const int g = h / r;
  const int t0 = blockIdx.y * TILE;
  const int rows = min(TILE, n - t0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;

  lln::load_tile(S, dv, s + static_cast<size_t>(g) * d * dv, dv, d, 0, dv,
                 lln::Ident{});
  lln::load_tile(zs, d, z + static_cast<size_t>(g) * d, d, 1, 0, d,
                 lln::Ident{});
  lln::load_tile(fq, dp, qs + (static_cast<size_t>(h) * n + t0) * d, d, rows,
                 0, d, lln::Exp{});
  __syncthreads();
  for (int a = warp; a < rows; a += nw) {
    float acc = 0.f;
    for (int e = lane; e < d; e += 32) acc = fmaf(fq[a * dp + e], zs[e], acc);
    acc = lln::warp_sum(acc) + lln::kEps;
    if (lane == 0) {
      den[a] = acc;
      if (den_out != nullptr) den_out[static_cast<size_t>(h) * n + t0 + a] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * dv; i += nt) {
    const int a = i / dv, c = i - a * dv;
    const float* qa = fq + a * dp;
    float acc = 0.f;
    for (int e = 0; e < d; ++e) acc = fmaf(qa[e], S[e * dv + c], acc);
    out[(static_cast<size_t>(h) * n + t0 + a) * dv + c] =
        lln::from_f32<VT>(acc / den[a]);
  }
}

template <typename VT>
int launch(const float* qs, const float* ks, const void* v, void* out,
           float* den, float* s, float* z, int bh, int bg, int n, int d,
           int dv, cudaStream_t stream) {
  if (bh % bg != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t red_bytes =
      (static_cast<size_t>(TILE) * (d + 1) + TILE * COLS +
       static_cast<size_t>(d) * COLS + d) * sizeof(float);
  const size_t app_bytes =
      (static_cast<size_t>(TILE) * (d + 1) + static_cast<size_t>(d) * dv + d +
       TILE) * sizeof(float);
  cudaError_t err = lln::allow_smem(bidir_reduce_kernel<VT>, red_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lln::allow_smem(bidir_apply_kernel<VT>, app_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 red_grid(bg, (dv + COLS - 1) / COLS);
  bidir_reduce_kernel<VT><<<red_grid, 256, red_bytes, stream>>>(
      ks, static_cast<const VT*>(v), s, z, n, d, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 app_grid(bh, (n + TILE - 1) / TILE);
  bidir_apply_kernel<VT><<<app_grid, 256, app_bytes, stream>>>(
      qs, s, z, static_cast<VT*>(out), den, n, d, dv, bh / bg);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 v on the tensor cores.
// ---------------------------------------------------------------------------

using namespace lln;

constexpr int TC_ROWS = 64;   // query rows per apply CTA (4 warps x 16)

template <int DP>
constexpr size_t apply_smem_bytes() {
  return (2 * TC_ROWS + 2 * DP) * (DP + 8) * sizeof(__nv_bfloat16) +
         TC_ROWS * sizeof(float);
}

// One CTA per (query head, 64-row tile): out = Phi(q) s / den and den =
// Phi(q) . z + EPS, with s (BG,D,Dv) and z (BG,D) the kv group's fp32
// totals.  den_out may be null.
template <int DP>
__global__ void __launch_bounds__(128, 2)
bidir_apply_tc_kernel(const float* __restrict__ qs,
                      const float* __restrict__ s,
                      const float* __restrict__ z,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ den_out, int n, int d, int dv,
                      int r, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 8;
  constexpr int NO = DP / 8;            // output tiles of 8 columns per warp
  constexpr int TS = TC_ROWS * LD;
  constexpr int SS = DP * LD;
  __nv_bfloat16* sfq = reinterpret_cast<__nv_bfloat16*>(smem);  // hi, lo
  __nv_bfloat16* ss = sfq + 2 * TS;     // s hi, lo (planes SS apart)
  float* pz = reinterpret_cast<float*>(ss + 2 * SS);

  const int h = blockIdx.x;
  const int g = h / r;
  const int r0 = blockIdx.y * TC_ROWS;
  const int rows = min(TC_ROWS, n - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int no = min(NO, ((dv + 15) / 16) * 2);
  const size_t hq = static_cast<size_t>(h) * n + r0;

  // The kv group's s as hi + lo, every row and column up to DP (zero past
  // d and dv).
  stage_f32<DP, 2, DP>(ss, SS, s + static_cast<size_t>(g) * d * dv, 0, d,
                       dv);
  float zv[DP / 32];
#pragma unroll
  for (int u = 0; u < DP / 32; ++u)
    zv[u] = lane + 32 * u < d ? z[static_cast<size_t>(g) * d + lane + 32 * u]
                              : 0.f;
  phi_rows<DP, 2, true>(sfq, TS, qs + hq * d, rows, d, zv, pz, warp, lane);
  __syncthreads();

  float acc[NO][4];
  zero_acc(acc);
  mma_ab_p<NO, DP / 16, 2, 2>(acc, sfq + warp * 16 * LD, TS, LD, ss, SS, LD,
                              (d + 15) / 16, no, lane);

  const bool vz = vec != 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    if (a >= rows) continue;
    const float dn = pz[a] + kEps;
    if (den_out != nullptr && t4 == 0) den_out[hq + a] = dn;
    __nv_bfloat16* orow = out + (hq + a) * dv;
#pragma unroll
    for (int jj = 0; jj < NO; ++jj) {
      const int cc = jj * 8 + 2 * t4;
      const uint32_t x = pack_bf16(acc[jj][2 * hh] / dn,
                                   acc[jj][2 * hh + 1] / dn);
      if (vz && cc + 1 < dv) {
        *reinterpret_cast<uint32_t*>(orow + cc) = x;
      } else {
        if (cc < dv) orow[cc] = __ushort_as_bfloat16(x & 0xffffu);
        if (cc + 1 < dv) orow[cc + 1] = __ushort_as_bfloat16(x >> 16);
      }
    }
  }
}

template <int DP>
int launch_tc(const float* qs, const float* ks, const void* v, void* out,
              float* den, float* s, float* z, int bh, int bg, int n, int d,
              int dv, cudaStream_t stream) {
  // (s, z): one block of all N rows, no block state stored, the total once
  // per kv group (reps 1); Phi(k) in three planes.
  cudaError_t err = block_states<false, 3>(
      ks, static_cast<const __nv_bfloat16*>(v), nullptr, nullptr, 1.f,
      nullptr, nullptr, s, z, 1, bg, n, d, dv, 1, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = apply_smem_bytes<DP>();
  err = allow_smem(bidir_apply_tc_kernel<DP>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = dv % 2 == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const dim3 grid(bh, (n + TC_ROWS - 1) / TC_ROWS);
  bidir_apply_tc_kernel<DP><<<grid, 128, bytes, stream>>>(
      qs, s, z, static_cast<__nv_bfloat16*>(out), den, n, d, dv, bh / bg,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vdtype: 0 = float32, 1 = bfloat16; den may be null.  Returns
// cudaGetLastError().
extern "C" int lln_bidir_launch(const void* qs, const void* ks, const void* v,
                                void* out, void* den, void* s, void* z, int bh,
                                int bg, int n, int d, int dv, int vdtype,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto qsp = static_cast<const float*>(qs);
  auto ksp = static_cast<const float*>(ks);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (vdtype == 1)
    return launch<__nv_bfloat16>(qsp, ksp, v, out, f(den), f(s), f(z), bh, bg,
                                 n, d, dv, st);
  if (vdtype == 0)
    return launch<float>(qsp, ksp, v, out, f(den), f(s), f(z), bh, bg, n, d,
                         dv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 tensor-core path (v and out bf16; D, Dv <= 128), any N; den may
// be null.  Returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int lln_bidir_tc_launch(const void* qs, const void* ks,
                                   const void* v, void* out, void* den,
                                   void* s, void* z, int bh, int bg, int n,
                                   int d, int dv, void* stream) {
  if (bg < 1 || n < 1 || bh % bg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qs);
  auto k = static_cast<const float*>(ks);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (d <= 64 && dv <= 64)
    return launch_tc<64>(q, k, v, out, f(den), f(s), f(z), bh, bg, n, d, dv,
                         st);
  if (d <= 128 && dv <= 128)
    return launch_tc<128>(q, k, v, out, f(den), f(s), f(z), bh, bg, n, d, dv,
                          st);
  return static_cast<int>(cudaErrorInvalidValue);
}
