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
// Design: the reference's two kernels.  The TPU's reduce walked the
// sequence on the grid's ordered minor axis and accumulated into a revisited
// output block; GPU blocks run in no order, so here one CTA per (kv head,
// COLS value columns) loops over the sequence in TILE-row tiles and owns its
// slice of s (D x COLS) in shared memory, each entry summed by one thread in
// sequence order: a fixed order, no atomics.  The column-0 CTA also sums z.
// The apply gives each CTA one query head's TILE-row tile and the whole of
// its kv head's s and z in shared memory; a warp reads one row of Phi(q)
// (broadcast) against consecutive columns of s.  Any N: the ragged last
// tile loads pad keys as Phi(k) = 0 and writes no pad rows.  All products
// are fp32 on the CUDA cores.
//
// Bound on the H100: fp32 operations at the encoder shapes (see
// kernels/lln_attention.py).
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
