// Backward of the block-diagonal softmax attention (paper §4.2).
//
// Replaces src/repro/kernels/block_diag.py:block_diag_bwd_pallas.  q
// (BH,N,D), k (BG,N,D), v (BG,N,Dv) and the cotangent g (BH,N,Dv) share one
// type (fp32 or bf16); query row h reads kv row h / r.  Outputs, fp32: dq
// (BH,N,D), dk (BG,N,D), dv (BG,N,Dv), dk and dv summed over the r query
// heads of a kv head.  stats (3,BH,N) is scratch: each query row's softmax
// max m, sum l and delta = sum_j p_j (g . v_j), written by the first
// kernel, read by the second.
// Each blk-sized block attends only within itself, optionally causal; the
// ragged last block holds N-(nb-1)*blk keys.
//
// Math (the reference's): p = softmax(q k^T D^-1/2) within the block,
// recomputed (no saved probabilities); dsm = p (g . v - delta);
// dq = dsm k D^-1/2, dk = dsm^T q D^-1/2, dv = p^T g.
//
// Design: as the softmax part of csrc/lln_diag_fused_bwd.cu.  A 256 x 256
// fp32 block of p is 256 KB and does not fit in shared memory, so it is
// never whole.  The dq kernel gives each CTA one query head's TILE-row tile
// of one block with its score rows against the block's keys (TILE x blk):
// softmax, g . v, delta, dsm and dq, and it saves m, l and delta.  The
// dk/dv kernel gives each CTA one kv head's TILE-key tile of one block and
// walks the r query heads and the block's query tiles in that fixed order,
// recomputing each p from the saved m and l with the same products as the
// first kernel: no atomics, so gradients are the same bit for bit from run
// to run.  Rows of shared tiles are padded to an odd stride.  All products
// are fp32 on the CUDA cores.
//
// Bound on the H100: fp32 operations at the encoder shapes (see
// kernels/block_diag.py).
#include "train_common.cuh"

namespace {

constexpr int TILE = 32;

template <typename T>
__global__ void block_diag_dq_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const T* __restrict__ g,
                                     float* __restrict__ dq,
                                     float* __restrict__ stats, int n, int d,
                                     int dv, int r, int blk, int causal,
                                     float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  const int wv = dv + 1;
  const int kp = max(d, dv) + 1;
  const int pp = blk + 1;
  float* qd = smem;                 // TILE x dp   q * scale
  float* gt = qd + TILE * dp;       // TILE x wv   g
  float* kb = gt + TILE * wv;       // TILE x kp   key or value tile
  float* P = kb + TILE * kp;        // TILE x pp   scores -> p -> dsm
  float* DP = P + TILE * pp;        // TILE x pp   g . v
  float* acc = DP + TILE * pp;      // TILE x dp   dq rows
  float* dl = acc + TILE * dp;      // TILE        delta

  const int h = blockIdx.x;
  const int kv = h / r;
  const int b0 = blockIdx.y * blk;
  const int bend = min(b0 + blk, n);
  const int r0 = b0 + blockIdx.z * TILE;
  if (r0 >= bend) return;           // ragged last block: no rows here
  const int rows = min(TILE, bend - r0);
  const int nk = (causal ? min(bend, r0 + rows) : bend) - b0;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const size_t hq = static_cast<size_t>(h) * n;
  const size_t hk = static_cast<size_t>(kv) * n;
  const size_t bhn = static_cast<size_t>(gridDim.x) * n;

  lln::load_tile(qd, dp, q + (hq + r0) * d, d, rows, 0, d, lln::Scale{scale});
  lln::load_tile(gt, wv, g + (hq + r0) * dv, dv, rows, 0, dv, lln::Ident{});
  // Scores against the block's keys (up to the tile's last row if causal).
  for (int k0 = 0; k0 < nk; k0 += TILE) {
    const int kr = min(TILE, nk - k0);
    __syncthreads();                // previous users of kb are done
    lln::load_tile(kb, kp, k + (hk + b0 + k0) * d, d, kr, 0, d, lln::Ident{});
    __syncthreads();
    for (int i = tid; i < rows * kr; i += nt) {
      const int a = i / kr, j = i - a * kr;
      P[a * pp + k0 + j] = causal && k0 + j > r0 - b0 + a
                               ? lln::kNegInf
                               : lln::dot(qd + a * dp, kb + j * kp, d);
    }
  }
  __syncthreads();
  // Softmax rows (one warp per row): p = exp(s - m) / l; save m and l.
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
    if (lane == 0) {
      stats[hq + r0 + a] = m;
      stats[bhn + hq + r0 + a] = l;
    }
  }
  // g . v against the block's values.
  for (int k0 = 0; k0 < nk; k0 += TILE) {
    const int kr = min(TILE, nk - k0);
    __syncthreads();
    lln::load_tile(kb, kp, v + (hk + b0 + k0) * dv, dv, kr, 0, dv,
                   lln::Ident{});
    __syncthreads();
    for (int i = tid; i < rows * kr; i += nt) {
      const int a = i / kr, j = i - a * kr;
      DP[a * pp + k0 + j] = causal && k0 + j > r0 - b0 + a
                                ? 0.f
                                : lln::dot(gt + a * wv, kb + j * kp, dv);
    }
  }
  __syncthreads();
  for (int a = warp; a < rows; a += nw) {
    float s = 0.f;
    for (int j = lane; j < nk; j += 32) s = fmaf(P[a * pp + j], DP[a * pp + j], s);
    s = lln::warp_sum(s);
    if (lane == 0) {
      dl[a] = s;
      stats[2 * bhn + hq + r0 + a] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * nk; i += nt) {
    const int a = i / nk, j = i - a * nk;
    P[a * pp + j] *= DP[a * pp + j] - dl[a];
  }
  for (int i = tid; i < TILE * d; i += nt) acc[(i / d) * dp + i % d] = 0.f;
  // dq = dsm k, key tile by key tile.
  for (int k0 = 0; k0 < nk; k0 += TILE) {
    const int kr = min(TILE, nk - k0);
    __syncthreads();
    lln::load_tile(kb, kp, k + (hk + b0 + k0) * d, d, kr, 0, d, lln::Ident{});
    __syncthreads();
    for (int i = tid; i < rows * d; i += nt) {
      const int a = i / d, e = i - a * d;
      const float* pa = P + a * pp + k0;
      float s = acc[a * dp + e];
      for (int j = 0; j < kr; ++j) s = fmaf(pa[j], kb[j * kp + e], s);
      acc[a * dp + e] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * d; i += nt) {
    const int a = i / d, e = i - a * d;
    dq[(hq + r0 + a) * d + e] = acc[a * dp + e] * scale;
  }
}

template <typename T>
__global__ void block_diag_dkv_kernel(const T* __restrict__ q,
                                      const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const T* __restrict__ g,
                                      const float* __restrict__ stats,
                                      float* __restrict__ dk,
                                      float* __restrict__ dvo, int n, int d,
                                      int dv, int r, int blk, int causal,
                                      float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  const int wv = dv + 1;
  const int tp = TILE + 1;
  float* kt = smem;                 // TILE x dp   this CTA's keys
  float* vt = kt + TILE * dp;       // TILE x wv   this CTA's values
  float* qd = vt + TILE * wv;       // TILE x dp   q * scale, one query tile
  float* gt = qd + TILE * dp;       // TILE x wv   g, same rows
  float* pm = gt + TILE * wv;       // TILE x tp   p (query a, key j)
  float* dm = pm + TILE * tp;       // TILE x tp   dsm
  float* adk = dm + TILE * tp;      // TILE x dp   dk rows
  float* adv = adk + TILE * dp;     // TILE x wv   dv rows
  float* mx = adv + TILE * wv;      // TILE
  float* sm = mx + TILE;            // TILE
  float* dl = sm + TILE;            // TILE

  const int kv = blockIdx.x;
  const int b0 = blockIdx.y * blk;
  const int bend = min(b0 + blk, n);
  const int kb0 = b0 + blockIdx.z * TILE;
  if (kb0 >= bend) return;          // ragged last block: no keys here
  const int kr = min(TILE, bend - kb0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t hk = static_cast<size_t>(kv) * n;
  const size_t bhn = static_cast<size_t>(gridDim.x) * r * n;

  lln::load_tile(kt, dp, k + (hk + kb0) * d, d, kr, 0, d, lln::Ident{});
  lln::load_tile(vt, wv, v + (hk + kb0) * dv, dv, kr, 0, dv, lln::Ident{});
  for (int i = tid; i < TILE * dp; i += nt) adk[i] = 0.f;
  for (int i = tid; i < TILE * wv; i += nt) adv[i] = 0.f;
  // Under the causal mask only the queries at or after this key tile see
  // it (tiles are TILE-aligned from the block's start).
  const int q_first = causal ? kb0 : b0;
  for (int hh = 0; hh < r; ++hh) {
    const size_t hq = (static_cast<size_t>(kv) * r + hh) * n;
    for (int i0 = q_first; i0 < bend; i0 += TILE) {
      const int rows = min(TILE, bend - i0);
      __syncthreads();              // previous tile's readers are done
      for (int a = tid; a < rows; a += nt) {
        mx[a] = stats[hq + i0 + a];
        sm[a] = stats[bhn + hq + i0 + a];
        dl[a] = stats[2 * bhn + hq + i0 + a];
      }
      lln::load_tile(qd, dp, q + (hq + i0) * d, d, rows, 0, d,
                     lln::Scale{scale});
      lln::load_tile(gt, wv, g + (hq + i0) * dv, dv, rows, 0, dv,
                     lln::Ident{});
      __syncthreads();
      for (int i = tid; i < TILE * TILE; i += nt) {
        const int a = i / TILE, j = i - a * TILE;
        float p = 0.f, ds = 0.f;
        if (a < rows && j < kr && !(causal && kb0 + j > i0 + a)) {
          p = expf(lln::dot(qd + a * dp, kt + j * dp, d) - mx[a]) / sm[a];
          ds = p * (lln::dot(gt + a * wv, vt + j * wv, dv) - dl[a]);
        }
        pm[a * tp + j] = p;
        dm[a * tp + j] = ds;
      }
      __syncthreads();
      for (int i = tid; i < kr * d; i += nt) {
        const int j = i / d, e = i - j * d;
        float s = adk[j * dp + e];
        for (int a = 0; a < rows; ++a) s = fmaf(dm[a * tp + j], qd[a * dp + e], s);
        adk[j * dp + e] = s;
      }
      for (int i = tid; i < kr * dv; i += nt) {
        const int j = i / dv, c = i - j * dv;
        float s = adv[j * wv + c];
        for (int a = 0; a < rows; ++a)
          s = fmaf(pm[a * tp + j], gt[a * wv + c], s);
        adv[j * wv + c] = s;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kr * d; i += nt) {
    const int j = i / d, e = i - j * d;
    dk[(hk + kb0 + j) * d + e] = adk[j * dp + e];
  }
  for (int i = tid; i < kr * dv; i += nt) {
    const int j = i / dv, c = i - j * dv;
    dvo[(hk + kb0 + j) * dv + c] = adv[j * wv + c];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g,
           float* dq, float* dk, float* dv_, float* stats, int bh, int bg,
           int n, int d, int dv, int blk, int causal, float scale,
           cudaStream_t stream) {
  if (bh % bg != 0 || blk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t tf = TILE;
  const size_t kp = static_cast<size_t>(d > dv ? d : dv) + 1;
  const size_t dq_bytes = (2 * tf * (d + 1) + tf * (dv + 1) + tf * kp +
                           2 * tf * (blk + 1) + tf) * sizeof(float);
  const size_t dkv_bytes = (3 * tf * (d + 1) + 3 * tf * (dv + 1) +
                            2 * tf * (tf + 1) + 3 * tf) * sizeof(float);
  cudaError_t err = lln::allow_smem(block_diag_dq_kernel<T>, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lln::allow_smem(block_diag_dkv_kernel<T>, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int r = bh / bg;
  const int nb = (n + blk - 1) / blk;
  const int nt = (blk + TILE - 1) / TILE;
  const auto qp = static_cast<const T*>(q);
  const auto kp_ = static_cast<const T*>(k);
  const auto vp = static_cast<const T*>(v);
  const auto gp = static_cast<const T*>(g);
  block_diag_dq_kernel<T><<<dim3(bh, nb, nt), 256, dq_bytes, stream>>>(
      qp, kp_, vp, gp, dq, stats, n, d, dv, r, blk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block_diag_dkv_kernel<T><<<dim3(bg, nb, nt), 256, dkv_bytes, stream>>>(
      qp, kp_, vp, gp, stats, dk, dv_, n, d, dv, r, blk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (q, k, v, g): 0 = float32, 1 = bfloat16; stats is (3, BH, N) fp32
// scratch.  Returns cudaGetLastError().
extern "C" int block_diag_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* g, void* dq,
                                     void* dk, void* dv, void* stats, int bh,
                                     int bg, int n, int d, int dvd, int blk,
                                     int causal, int dtype, float scale,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, f(dq), f(dk), f(dv), f(stats), bh,
                                 bg, n, d, dvd, blk, causal, scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, g, f(dq), f(dk), f(dv), f(stats), bh, bg, n,
                         d, dvd, blk, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
