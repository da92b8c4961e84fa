// Block-diagonal softmax attention (paper §4.2).
//
// Replaces src/repro/kernels/block_diag.py:block_diag_pallas.  q (BH,N,D),
// k/v (BG,N,D[v]) share one type (fp32 or bf16); query row h reads kv row
// h / r; out (BH,N,Dv) in the same type.  Each blk-sized block attends only
// within itself, optionally causal; the ragged last block holds N-(nb-1)*blk
// keys.  fp32 math throughout.
//
// Design: one CTA per (query head, block, qtile-row query tile).  It keeps
// the scaled query tile, the tile's full score rows over the block's keys
// (only the keys a causal tile can see: up to its last row), and its fp32
// output rows in shared memory; keys, then values, stream through a KTILE-row
// buffer.  The softmax is the reference's exact form: subtract the row max,
// exponentiate, divide by the row sum, then multiply by V.  Masked scores are
// -1e30, as in the reference.
//
// Bound on the H100: fp32 operations at the serve shapes (see
// kernels/block_diag.py).
#include "common.cuh"

namespace {

constexpr int KTILE = 64;

template <typename T>
__global__ void block_diag_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  T* __restrict__ out, int n, int d, int dv,
                                  int r, int blk, int causal, int qtile,
                                  float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  const int wp = max(d, dv) + 1;
  const int pp = blk + 1;
  float* qt = smem;                  // qtile x dp   scaled queries
  float* kvb = qt + qtile * dp;      // KTILE x wp   key or value tile
  float* P = kvb + KTILE * wp;       // qtile x pp   scores -> probabilities
  float* acc = P + qtile * pp;       // qtile x dv   output rows

  const int h = blockIdx.x;
  const int kvh = h / r;
  const int b0 = blockIdx.y * blk;
  const int bend = min(b0 + blk, n);
  const int r0 = b0 + blockIdx.z * qtile;
  if (r0 >= bend) return;            // ragged last block: no rows here
  const int rows = min(qtile, bend - r0);
  const int kend = causal ? min(bend, r0 + rows) : bend;
  const int nk = kend - b0;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const T* kh = k + static_cast<size_t>(kvh) * n * d;
  const T* vh = v + static_cast<size_t>(kvh) * n * dv;

  for (int i = tid; i < qtile * d; i += nt) {
    const int a = i / d, e = i - a * d;
    qt[a * dp + e] =
        a < rows
            ? lln::to_f32(q[(static_cast<size_t>(h) * n + r0 + a) * d + e]) * scale
            : 0.f;
  }
  for (int i = tid; i < qtile * dv; i += nt) acc[i] = 0.f;

  // Scores, key tile by key tile.
  for (int k0 = 0; k0 < nk; k0 += KTILE) {
    const int kr = min(KTILE, nk - k0);
    __syncthreads();                 // previous users of kvb are done
    for (int i = tid; i < KTILE * d; i += nt) {
      const int j = i / d, e = i - j * d;
      kvb[j * wp + e] =
          j < kr ? lln::to_f32(kh[static_cast<size_t>(b0 + k0 + j) * d + e]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < qtile * KTILE; i += nt) {
      const int a = i / KTILE, j = i - a * KTILE;
      if (a >= rows || j >= kr) continue;
      float s;
      if (causal && k0 + j > r0 - b0 + a) {
        s = lln::kNegInf;
      } else {
        s = 0.f;
        const float* qa = qt + a * dp;
        const float* kj = kvb + j * wp;
        for (int e = 0; e < d; ++e) s = fmaf(qa[e], kj[e], s);
      }
      P[a * pp + k0 + j] = s;
    }
  }
  __syncthreads();

  // Softmax rows (one warp per row): p = exp(s - max) / sum.
  for (int a = warp; a < rows; a += nw) {
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

  // Output rows: P V, value tile by value tile.
  for (int k0 = 0; k0 < nk; k0 += KTILE) {
    const int kr = min(KTILE, nk - k0);
    __syncthreads();
    for (int i = tid; i < KTILE * dv; i += nt) {
      const int j = i / dv, c = i - j * dv;
      kvb[j * wp + c] =
          j < kr ? lln::to_f32(vh[static_cast<size_t>(b0 + k0 + j) * dv + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < qtile * dv; i += nt) {
      const int a = i / dv, c = i - a * dv;
      if (a >= rows) continue;
      const float* pa = P + a * pp + k0;
      float s = acc[i];
      for (int j = 0; j < kr; ++j) s = fmaf(pa[j], kvb[j * wp + c], s);
      acc[i] = s;
    }
  }
  __syncthreads();

  for (int i = tid; i < qtile * dv; i += nt) {
    const int a = i / dv, c = i - a * dv;
    if (a < rows)
      out[(static_cast<size_t>(h) * n + r0 + a) * dv + c] = lln::from_f32<T>(acc[i]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int bg, int n, int d, int dv, int blk, int causal, int qtile,
           float scale, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(qtile) * (d + 1) +
                        static_cast<size_t>(KTILE) * ((d > dv ? d : dv) + 1) +
                        static_cast<size_t>(qtile) * (blk + 1) +
                        static_cast<size_t>(qtile) * dv;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = lln::allow_smem(block_diag_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + blk - 1) / blk;
  const dim3 grid(bh, nb, (blk + qtile - 1) / qtile);
  block_diag_kernel<T><<<grid, 256, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, d, dv, bh / bg, blk,
      causal, qtile, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int block_diag_launch(const void* q, const void* k, const void* v,
                                 void* out, int bh, int bg, int n, int d,
                                 int dv, int blk, int causal, int dtype,
                                 int qtile, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, bh, bg, n, d, dv, blk, causal,
                                 qtile, scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, out, bh, bg, n, d, dv, blk, causal, qtile,
                         scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
