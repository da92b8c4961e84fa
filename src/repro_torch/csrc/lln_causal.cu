// Causal LLN prefill with the final decode state (paper eq. 8).
//
// Replaces src/repro/kernels/lln_attention.py:lln_causal_pallas
// (return_state=True).  Inputs qs (BH,N,D) and ks (BG,N,D) are fp32,
// pre-scaled and stabilized (<= 0); v (BG,N,Dv) is fp32 or bf16; query row h
// reads kv row h / r.  Outputs: out (BH,N,Dv) in v's type, s (BH,D,Dv) and
// z (BH,1,D) fp32, the state after the last token.
//
// Design: the TPU kernel walked the sequence on the grid's ordered minor
// axis with (S, z) in VMEM.  GPU blocks run in no order, so one CTA per
// (query head, COLS value columns) loops over the sequence in TILE-row tiles
// and keeps its columns of S (D x COLS) and all of z in shared memory.  Per
// tile:  scores = tril(Phi(q) Phi(k)^T);  den = rowsum(scores) + Phi(q).z
// + EPS;  out = (scores V + Phi(q) S) / den;  then S += Phi(k)^T V and
// z += colsum Phi(k).  The ragged last tile loads pad keys as Phi(k) = 0
// and writes no pad rows.  All products are fp32 on the CUDA cores.
//
// Bound on the H100: fp32 operations at the serve shapes (see
// kernels/lln_attention.py); the column split multiplies the CTAs by Dv/COLS
// and recomputes each tile's scores once per column group.
#include "common.cuh"

namespace {

template <typename VT>
__global__ void lln_causal_kernel(const float* __restrict__ qs,
                                  const float* __restrict__ ks,
                                  const VT* __restrict__ v,
                                  VT* __restrict__ out,
                                  float* __restrict__ s_out,
                                  float* __restrict__ z_out,
                                  int n, int d, int dv, int r, int tile,
                                  int cols) {
  extern __shared__ float smem[];
  const int dp = d + 1;             // padded row: conflict-free column reads
  const int tp = tile + 1;
  float* fq = smem;                 // tile x dp   Phi(q)
  float* fk = fq + tile * dp;       // tile x dp   Phi(k)
  float* vt = fk + tile * dp;       // tile x cols V (this CTA's columns)
  float* sc = vt + tile * cols;     // tile x tp   causal scores
  float* S = sc + tile * tp;        // d x cols    running state columns
  float* z = S + d * cols;          // d           running normalizer
  float* den = z + d;               // tile        row normalizers

  const int h = blockIdx.x;
  const int kv = h / r;
  const int c0 = blockIdx.y * cols;
  const int cw = min(cols, dv - c0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const float* qh = qs + static_cast<size_t>(h) * n * d;
  const float* kh = ks + static_cast<size_t>(kv) * n * d;
  const VT* vh = v + static_cast<size_t>(kv) * n * dv;

  for (int i = tid; i < d * cols; i += nt) S[i] = 0.f;
  for (int i = tid; i < d; i += nt) z[i] = 0.f;

  for (int t0 = 0; t0 < n; t0 += tile) {
    const int rows = min(tile, n - t0);
    for (int i = tid; i < tile * d; i += nt) {
      const int a = i / d, e = i - a * d;
      const bool ok = a < rows;
      const size_t g = static_cast<size_t>(t0 + a) * d + e;
      fq[a * dp + e] = ok ? expf(qh[g]) : 0.f;
      fk[a * dp + e] = ok ? expf(kh[g]) : 0.f;     // pad keys: Phi(k) = 0
    }
    for (int i = tid; i < tile * cols; i += nt) {
      const int a = i / cols, c = i - a * cols;
      vt[i] = (a < rows && c < cw)
                  ? lln::to_f32(vh[static_cast<size_t>(t0 + a) * dv + c0 + c])
                  : 0.f;
    }
    __syncthreads();

    // Intra-tile causal scores.
    for (int i = tid; i < tile * tile; i += nt) {
      const int a = i / tile, b = i - a * tile;
      float acc = 0.f;
      if (b <= a) {
        const float* qa = fq + a * dp;
        const float* kb = fk + b * dp;
        for (int e = 0; e < d; ++e) acc = fmaf(qa[e], kb[e], acc);
      }
      sc[a * tp + b] = acc;
    }
    __syncthreads();

    // Row normalizers: intra row sum + Phi(q).z + EPS (one warp per row).
    for (int a = warp; a < rows; a += nw) {
      float acc = 0.f;
      for (int b = lane; b <= a; b += 32) acc += sc[a * tp + b];
      for (int e = lane; e < d; e += 32) acc = fmaf(fq[a * dp + e], z[e], acc);
      acc = lln::warp_sum(acc);
      if (lane == 0) den[a] = acc + lln::kEps;
    }
    __syncthreads();

    // Outputs: (intra + inter) / den.
    for (int i = tid; i < tile * cols; i += nt) {
      const int a = i / cols, c = i - a * cols;
      if (a >= rows || c >= cw) continue;
      float intra = 0.f, inter = 0.f;
      for (int b = 0; b <= a; ++b) intra = fmaf(sc[a * tp + b], vt[b * cols + c], intra);
      const float* qa = fq + a * dp;
      for (int e = 0; e < d; ++e) inter = fmaf(qa[e], S[e * cols + c], inter);
      out[(static_cast<size_t>(h) * n + t0 + a) * dv + c0 + c] =
          lln::from_f32<VT>((intra + inter) / den[a]);
    }
    __syncthreads();

    // State update: S += Phi(k)^T V, z += colsum Phi(k).
    for (int i = tid; i < d * cols; i += nt) {
      const int e = i / cols, c = i - e * cols;
      float acc = 0.f;
      for (int b = 0; b < rows; ++b) acc = fmaf(fk[b * dp + e], vt[b * cols + c], acc);
      S[i] += acc;
    }
    for (int e = tid; e < d; e += nt) {
      float acc = 0.f;
      for (int b = 0; b < rows; ++b) acc += fk[b * dp + e];
      z[e] += acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < d * cols; i += nt) {
    const int e = i / cols, c = i - e * cols;
    if (c < cw) s_out[(static_cast<size_t>(h) * d + e) * dv + c0 + c] = S[i];
  }
  if (blockIdx.y == 0)
    for (int e = tid; e < d; e += nt) z_out[static_cast<size_t>(h) * d + e] = z[e];
}

template <typename VT>
int launch(const float* qs, const float* ks, const void* v, void* out,
           float* s, float* z, int bh, int bg, int n, int d, int dv, int tile,
           int cols, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(tile) * (d + 1) * 2 +
                        static_cast<size_t>(tile) * cols +
                        static_cast<size_t>(tile) * (tile + 1) +
                        static_cast<size_t>(d) * cols + d + tile;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = lln::allow_smem(lln_causal_kernel<VT>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (dv + cols - 1) / cols);
  lln_causal_kernel<VT><<<grid, 256, bytes, stream>>>(
      qs, ks, static_cast<const VT*>(v), static_cast<VT*>(out), s, z, n, d,
      dv, bh / bg, tile, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v_dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int lln_causal_launch(const void* qs, const void* ks, const void* v,
                                 void* out, void* s, void* z, int bh, int bg,
                                 int n, int d, int dv, int v_dtype, int tile,
                                 int cols, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qs);
  auto k = static_cast<const float*>(ks);
  auto sp = static_cast<float*>(s);
  auto zp = static_cast<float*>(z);
  if (v_dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, sp, zp, bh, bg, n, d, dv, tile,
                                 cols, st);
  if (v_dtype == 0)
    return launch<float>(q, k, v, out, sp, zp, bh, bg, n, d, dv, tile, cols, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
