// Fused causal LLN + block-diagonal softmax forward (paper §4.2 hybrid).
//
// Replaces src/repro/kernels/lln_attention.py:lln_diag_fused_pallas
// (causal, return_res).  Inputs: qs (BH,N,D) and ks (BG,N,D) fp32,
// pre-scaled and stabilized for the LLN part; q (BH,N,D), k (BG,N,D) and
// v (BG,N,Dv) raw, in one type (fp32 or bf16); query row h reads kv row
// h / r.  out (BH,N,Dv) = 0.5 * (lln + diag) in that type, rounded once;
// optional den (BH,N) fp32, the LLN row normalizer (null deselects it).
// N % blk == 0: blk is both the diag block and the reference's LLN chunk.
//
// Design: one CTA per (query head, COLS value columns) walks the sequence in
// TILE-row tiles (TILE divides blk, so a tile never straddles a diag block)
// and keeps its columns of the LLN state S and all of z in shared memory, as
// csrc/lln_causal.cu does.  Per tile it computes the LLN rows (intra-tile
// scores, den, (scores V + Phi(q) S) / den), advances (S, z), then the diag
// rows: the scores of q*D^-1/2 against the block's keys up to the tile's
// last row (streamed in TILE-row chunks, masked -1e30 above the diagonal),
// the reference's softmax (subtract the row max, exponentiate, divide by
// the sum) and P V for its columns; it writes 0.5 * (lln + diag) once.
// Each column group recomputes the tile's scores and probabilities; the
// first one writes den.  Value columns past Dv (when COLS does not divide
// it) hold stale values that reach only columns that are never written.
// All products are fp32 on the CUDA cores.
//
// Bound on the H100: fp32 operations at the training shapes (see
// kernels/lln_attention.py).
#include "train_common.cuh"

namespace {

template <typename T>
__global__ void lln_diag_fused_kernel(
    const float* __restrict__ qs, const float* __restrict__ ks,
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ den_out, int n, int d, int dv,
    int r, int blk, int tile, int cols, float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  const int kp = max(d, cols) + 1;
  const int tp = tile + 1;
  const int pp = blk + 1;
  float* fq = smem;                 // tile x dp   Phi(q), then q * scale
  float* kb = fq + tile * dp;       // tile x kp   Phi(k), raw k, V chunks
  float* vt = kb + tile * kp;       // tile x cols V of the tile (LLN)
  float* sc = vt + tile * cols;     // tile x tp   LLN intra scores
  float* P = sc + tile * tp;        // tile x pp   diag scores -> probs
  float* S = P + tile * pp;         // d x cols    LLN state columns
  float* z = S + d * cols;          // d           LLN normalizer state
  float* den = z + d;               // tile        LLN row normalizers
  float* ob = den + tile;           // tile x cols LLN output rows
  float* dg = ob + tile * cols;     // tile x cols diag output rows

  const int h = blockIdx.x;
  const int kv = h / r;
  const int c0 = blockIdx.y * cols;
  const int cw = min(cols, dv - c0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const float* qsh = qs + static_cast<size_t>(h) * n * d;
  const float* ksh = ks + static_cast<size_t>(kv) * n * d;
  const T* qh = q + static_cast<size_t>(h) * n * d;
  const T* kh = k + static_cast<size_t>(kv) * n * d;
  const T* vh = v + static_cast<size_t>(kv) * n * dv;

  for (int i = tid; i < d * cols; i += nt) S[i] = 0.f;
  for (int i = tid; i < d; i += nt) z[i] = 0.f;

  for (int t0 = 0; t0 < n; t0 += tile) {
    const int b0 = (t0 / blk) * blk;
    const int nk = t0 + tile - b0;            // diag keys this tile sees
    // ---- LLN rows -------------------------------------------------------
    lln::load_tile(fq, dp, qsh + static_cast<size_t>(t0) * d, d, tile, 0, d,
                   lln::Exp{});
    lln::load_tile(kb, kp, ksh + static_cast<size_t>(t0) * d, d, tile, 0, d,
                   lln::Exp{});
    lln::load_tile(vt, cols, vh + static_cast<size_t>(t0) * dv, dv, tile, c0,
                   cw, lln::Ident{});
    __syncthreads();
    for (int i = tid; i < tile * tile; i += nt) {
      const int a = i / tile, b = i - a * tile;
      sc[a * tp + b] = b <= a ? lln::dot(fq + a * dp, kb + b * kp, d) : 0.f;
    }
    __syncthreads();
    for (int a = warp; a < tile; a += nw) {
      float acc = 0.f;
      for (int b = lane; b <= a; b += 32) acc += sc[a * tp + b];
      for (int e = lane; e < d; e += 32) acc = fmaf(fq[a * dp + e], z[e], acc);
      acc = lln::warp_sum(acc);
      if (lane == 0) {
        den[a] = acc + lln::kEps;
        if (den_out != nullptr && blockIdx.y == 0)
          den_out[static_cast<size_t>(h) * n + t0 + a] = den[a];
      }
    }
    __syncthreads();
    for (int i = tid; i < tile * cols; i += nt) {
      const int a = i / cols, c = i - a * cols;
      float intra = 0.f, inter = 0.f;
      for (int b = 0; b <= a; ++b) intra = fmaf(sc[a * tp + b], vt[b * cols + c], intra);
      for (int e = 0; e < d; ++e) inter = fmaf(fq[a * dp + e], S[e * cols + c], inter);
      ob[i] = (intra + inter) / den[a];
      dg[i] = 0.f;
    }
    __syncthreads();
    for (int i = tid; i < d * cols; i += nt) {
      const int e = i / cols, c = i - e * cols;
      float acc = 0.f;
      for (int b = 0; b < tile; ++b) acc = fmaf(kb[b * kp + e], vt[b * cols + c], acc);
      S[i] += acc;
    }
    for (int e = tid; e < d; e += nt) {
      float acc = 0.f;
      for (int b = 0; b < tile; ++b) acc += kb[b * kp + e];
      z[e] += acc;
    }
    __syncthreads();

    // ---- diag rows: softmax over the block's keys up to each row ---------
    lln::load_tile(fq, dp, qh + static_cast<size_t>(t0) * d, d, tile, 0, d,
                   lln::Scale{scale});
    for (int k0 = b0; k0 <= t0; k0 += tile) {
      lln::load_tile(kb, kp, kh + static_cast<size_t>(k0) * d, d, tile, 0, d,
                     lln::Ident{});
      __syncthreads();
      for (int i = tid; i < tile * tile; i += nt) {
        const int a = i / tile, j = i - a * tile;
        P[a * pp + k0 - b0 + j] = k0 + j <= t0 + a
                                      ? lln::dot(fq + a * dp, kb + j * kp, d)
                                      : lln::kNegInf;
      }
      __syncthreads();
    }
    for (int a = warp; a < tile; a += nw) {
      float* pa = P + a * pp;
      float m = lln::kNegInf;
      for (int j = lane; j < nk; j += 32) m = fmaxf(m, pa[j]);
      m = lln::warp_max(m);
      float l = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float e = expf(pa[j] - m);
        pa[j] = e;
        l += e;
      }
      l = lln::warp_sum(l);
      for (int j = lane; j < nk; j += 32) pa[j] = pa[j] / l;
    }
    for (int k0 = b0; k0 <= t0; k0 += tile) {
      __syncthreads();                         // P final / kb free
      lln::load_tile(kb, kp, vh + static_cast<size_t>(k0) * dv, dv, tile, c0,
                     cw, lln::Ident{});
      __syncthreads();
      for (int i = tid; i < tile * cols; i += nt) {
        const int a = i / cols, c = i - a * cols;
        const float* pa = P + a * pp + k0 - b0;
        float acc = dg[i];
        for (int j = 0; j < tile; ++j) acc = fmaf(pa[j], kb[j * kp + c], acc);
        dg[i] = acc;
      }
    }
    for (int i = tid; i < tile * cols; i += nt) {
      const int a = i / cols, c = i - a * cols;
      if (c < cw)
        out[(static_cast<size_t>(h) * n + t0 + a) * dv + c0 + c] =
            lln::from_f32<T>(0.5f * (ob[i] + dg[i]));
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const float* qs, const float* ks, const void* q, const void* k,
           const void* v, void* out, float* den, int bh, int bg, int n, int d,
           int dv, int blk, int cols, float scale, cudaStream_t stream) {
  if (n % blk != 0 || bh % bg != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = lln::tile_for(blk, 64);
  const size_t floats = static_cast<size_t>(tile) * (d + 1) +
                        static_cast<size_t>(tile) * ((d > cols ? d : cols) + 1) +
                        static_cast<size_t>(tile) * cols * 3 +
                        static_cast<size_t>(tile) * (tile + 1) +
                        static_cast<size_t>(tile) * (blk + 1) +
                        static_cast<size_t>(d) * cols + d + tile;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = lln::allow_smem(lln_diag_fused_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (dv + cols - 1) / cols);
  lln_diag_fused_kernel<T><<<grid, 256, bytes, stream>>>(
      qs, ks, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), den, n, d, dv, bh / bg,
      blk, tile, cols, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (q, k, v, out): 0 = float32, 1 = bfloat16; den may be null.
// Returns cudaGetLastError() (cudaErrorInvalidValue for N % blk != 0).
extern "C" int lln_diag_fused_launch(const void* qs, const void* ks,
                                     const void* q, const void* k,
                                     const void* v, void* out, void* den,
                                     int bh, int bg, int n, int d, int dv,
                                     int blk, int dtype, int cols,
                                     float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto qsp = static_cast<const float*>(qs);
  auto ksp = static_cast<const float*>(ks);
  auto dp = static_cast<float*>(den);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qsp, ksp, q, k, v, out, dp, bh, bg, n, d, dv,
                                 blk, cols, scale, st);
  if (dtype == 0)
    return launch<float>(qsp, ksp, q, k, v, out, dp, bh, bg, n, d, dv, blk,
                         cols, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
