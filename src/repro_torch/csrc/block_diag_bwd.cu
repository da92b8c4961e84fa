// Backward of the block-diagonal softmax attention (paper §4.2).
//
// Replaces src/repro/kernels/block_diag.py:block_diag_bwd_pallas.  q
// (BH,N,D), k (BG,N,D), v (BG,N,Dv) and the cotangent g (BH,N,Dv) share one
// type (fp32 or bf16); query row h reads kv row h / r.  Outputs, fp32: dq
// (BH,N,D), dk (BG,N,D), dv (BG,N,Dv), dk and dv summed over the r query
// heads of a kv head.  stats (3,BH,N) is scratch, written by the first
// kernel, read by the second: each query row's softmax max m, sum l and
// delta = sum_j p_j (g . v_j) (fp32 kernels), or lse = m + log2 l in log2
// units, unused and delta (bf16 kernels).
// Each blk-sized block attends only within itself, optionally causal; the
// ragged last block holds N-(nb-1)*blk keys.
//
// Math (the reference's): p = softmax(q k^T D^-1/2) within the block,
// recomputed (no saved probabilities); dsm = p (g . v - delta);
// dq = dsm k D^-1/2, dk = dsm^T q D^-1/2, dv = p^T g.
//
// A blk x blk fp32 block of p (256 KB at blk 256) does not fit in shared
// memory, so it is never whole: two kernels, the dq kernel per query tile
// and the dk/dv kernel per key tile, each recomputing p.  The dk/dv kernel
// walks the r query heads and the block's query tiles in a fixed order and
// uses no atomics, so gradients are the same bit for bit from run to run.
//
// bf16 with D, Dv <= 128 (every model path on the card): the tensor-core
// kernels.  CTAs of 4 warps, 16 rows per warp, bf16 tiles of 64 rows in
// shared memory staged by cp.async (double-buffered), products by mma.sync
// (csrc/mma.cuh).  The dq kernel, per (query head, block, 64-row tile),
// streams the block's key and value tiles twice: first the row max, sum and
// delta = sum_j p_j (g . v_j) together (online, in log2 units: p =
// exp2(s - lse) on the special-function unit), then dsm and dq += dsm k;
// it saves (lse, delta).  The dk/dv kernel, per (kv head, block, 64-key tile),
// recomputes p from lse and dsm from delta for each 32-query slice and
// accumulates dk += dsm^T q and dv += p^T g, each 32-query slice's products
// in a fresh MMA accumulator added to the total in fp32.  q k^T and g v^T
// take the raw bf16 operands (exact products, fp32 sums); the fp32 left
// operands p and dsm go in as three bf16 planes (three MMAs, about 2^-24
// relative), as the fused pair's backward takes them: with hi + lo alone
// the sums over r = 16 query heads missed the 1e-5 gradient gate.  The
// dq kernel sums over one block's keys only and keeps hi + lo.  Bound on the H100: bytes at the encoder shapes (the fp32
// gradients are most of them; see chip_smoke.py).
//
// fp32 (the card tests and the SMOKE parity runs), and bf16 with D or Dv
// above 128 (MLA's D = 192, paligemma's 256; the tiles are loaded to fp32):
// the CUDA-core kernels, IEEE fp32.  Their shared memory grows with D and
// blk: at D = Dv = 256, blk 256 the dq kernel takes 197,504 bytes and the
// dk/dv kernel 206,208, under the 232,448 a block may opt into, so each
// runs one CTA per SM.  The dq kernel gives each CTA one query head's TILE-row tile
// of one block with its score rows against the block's keys (TILE x blk):
// softmax, g . v, delta, dsm and dq.  The dk/dv kernel gives each CTA one
// kv head's TILE-key tile and recomputes each p from the saved m and l
// with the same products as the first kernel.  Rows of shared tiles are
// padded to an odd stride.
#include "mma.cuh"
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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores.
// ---------------------------------------------------------------------------

using namespace lln;

constexpr int TC_ROWS = 64;   // rows of a staged tile, 4 warps x 16

// Scores of a warp's 16 rows against a 64-row key tile in log2 units,
// s = q k^T D^-1/2 log2(e) (sl2 the factor); on an edge tile -1e30 past the
// block's nk keys or above the diagonal.
template <int DP>
__device__ __forceinline__ void tile_scores(float (&s)[8][4],
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b, int ks,
                                           int kb, int nk, int qrow,
                                           int causal, bool edge, float sl2,
                                           int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  mma_abt_p<8, DP / 16, 1, 1>(s, a, 0, LD, b, 0, LD, ks, lane);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kb + j * 8 + 2 * t4 + (e & 1);
      const int row = qrow + g + (e >> 1) * 8;
      float x = s[j][e] * sl2;
      if (edge && (col >= nk || (causal && col > row))) x = kNegInf;
      s[j][e] = x;
    }
  }
}

// At most 128 registers at DP = 64, so that four CTAs share an SM.
template <int DP>
__global__ void __launch_bounds__(128, DP > 64 ? 2 : 4)
block_diag_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ g,
                        float* __restrict__ dq, float* __restrict__ stats,
                        int n, int d, int dv, int r, int blk, int causal,
                        float scale, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 8;
  constexpr int NO = DP / 8;
  constexpr int TS = TC_ROWS * LD;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sg = sq + TS;
  __nv_bfloat16* sk = sg + TS;     // 2 stages
  __nv_bfloat16* sv = sk + 2 * TS; // 2 stages

  const int h = blockIdx.x;
  const int kv = h / r;
  const int b0 = blockIdx.y * blk;
  const int bend = min(b0 + blk, n);
  const int r0 = b0 + blockIdx.z * TC_ROWS;
  if (r0 >= bend) return;            // ragged last block: no rows here
  const int rows = min(TC_ROWS, bend - r0);
  const int nk = (causal ? min(bend, r0 + rows) : bend) - b0;
  const int ntiles = (nk + TC_ROWS - 1) / TC_ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ks = (d + 15) / 16, kvs = (dv + 15) / 16;
  const int no = min(NO, ks * 2);    // dq tiles in use
  const bool vz = vec != 0;
  const size_t hq = static_cast<size_t>(h) * n;
  const size_t bhn = static_cast<size_t>(gridDim.x) * n;
  const __nv_bfloat16* kh = k + (static_cast<size_t>(kv) * n + b0) * d;
  const __nv_bfloat16* vh = v + (static_cast<size_t>(kv) * n + b0) * dv;
  const int qrow = r0 - b0 + warp * 16;   // the warp's first query in the block
  const __nv_bfloat16* aq = sq + warp * 16 * LD;
  const __nv_bfloat16* ag = sg + warp * 16 * LD;

  stage_tile<DP>(sq, LD, q + (hq + r0) * d, d, rows, TC_ROWS, vz);
  stage_tile<DP>(sg, LD, g + (hq + r0) * dv, dv, rows, TC_ROWS, vz);
  stage_tile<DP>(sk, LD, kh, d, min(TC_ROWS, nk), TC_ROWS, vz);
  stage_tile<DP>(sv, LD, vh, dv, min(TC_ROWS, nk), TC_ROWS, vz);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // Pass 0 keeps, per row and online in log2 units, the max m, the sum
  // l = sum_j exp2(s_j - m) and dl = sum_j exp2(s_j - m) (g . v_j); then
  // lse = m + log2 l, so that p = exp2(s - lse), and delta = dl / l.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float lse[2];
  const float sl2 = scale * kLog2e;

  // Two passes over the block's key tiles, one pipeline: step st is pass
  // st / ntiles (0: max, sum and delta; 1: dq) and tile st % ntiles.
  const int steps = 2 * ntiles;
  for (int st = 0; st < steps; ++st) {
    const int pass = st / ntiles, t = st - pass * ntiles, sb = st & 1;
    if (st + 1 < steps) {
      const int k0 = ((st + 1) % ntiles) * TC_ROWS;
      const int kr = min(TC_ROWS, nk - k0);
      stage_tile<DP>(sk + (sb ^ 1) * TS, LD, kh + static_cast<size_t>(k0) * d,
                     d, kr, TC_ROWS, vz);
      stage_tile<DP>(sv + (sb ^ 1) * TS, LD, vh + static_cast<size_t>(k0) * dv,
                     dv, kr, TC_ROWS, vz);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // Only the last tile holds keys past the block's end or above the
    // diagonal: query and key tiles are 64-aligned from the block's start.
    float s[8][4], dp[8][4];
    tile_scores<DP>(s, aq, sk + sb * TS, ks, t * TC_ROWS, nk, qrow, causal,
                    t == ntiles - 1, sl2, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    mma_abt_p<8, DP / 16, 1, 1>(dp, ag, 0, LD, sv + sb * TS, 0, LD, kvs,
                                lane);                            // g v^T
    if (pass == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[hh], mx);
        const float a = fast_exp2(m[hh] - mn);
        float sum = l[hh] * a, dsum = dl[hh] * a;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
            const float pe = fast_exp2(s[j][e] - mn);
            sum += pe;
            dsum = fmaf(pe, dp[j][e], dsum);
          }
        }
        m[hh] = mn;
        l[hh] = sum;
        dl[hh] = dsum;
      }
      if (t == ntiles - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
          dl[hh] += __shfl_xor_sync(0xffffffffu, dl[hh], 1);
          dl[hh] += __shfl_xor_sync(0xffffffffu, dl[hh], 2);
          lse[hh] = m[hh] + log2f(l[hh]);
          dl[hh] /= l[hh];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          s[j][e] = fast_exp2(s[j][e] - lse[hh]) * (dp[j][e] - dl[hh]);
        }
      }
      mma_pb_p<NO, 4, 2, 1>(acc, s, sk + sb * TS, 0, LD, no,
                            lane);                       // dq += dsm k
    }
    __syncthreads();                 // this stage is free for the prefetch
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    if (a >= rows) continue;
    float* drow = dq + (hq + r0 + a) * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + 2 * t4;
      const float x0 = acc[j][2 * hh] * scale, x1 = acc[j][2 * hh + 1] * scale;
      if (vz && c + 1 < d) {
        *reinterpret_cast<float2*>(drow + c) = make_float2(x0, x1);
      } else {
        if (c < d) drow[c] = x0;
        if (c + 1 < d) drow[c + 1] = x1;
      }
    }
    if (t4 == 0) {
      stats[hq + r0 + a] = lse[hh];
      stats[2 * bhn + hq + r0 + a] = dl[hh];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(128)
block_diag_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ stats,
                         float* __restrict__ dk, float* __restrict__ dvo,
                         int n, int d, int dv, int r, int blk, int causal,
                         float scale, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 8;
  constexpr int NO = DP / 8;
  constexpr int TS = TC_ROWS * LD;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sv = sk + TS;
  __nv_bfloat16* sq = sv + TS;     // 2 stages
  __nv_bfloat16* sg = sq + 2 * TS; // 2 stages
  float* sst = reinterpret_cast<float*>(sg + 2 * TS);  // 2 x (lse, delta)

  const int kv = blockIdx.x;
  const int b0 = blockIdx.y * blk;
  const int bend = min(b0 + blk, n);
  const int kb0 = b0 + blockIdx.z * TC_ROWS;
  if (kb0 >= bend) return;           // ragged last block: no keys here
  const int kr = min(TC_ROWS, bend - kb0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ks = (d + 15) / 16, kvs = (dv + 15) / 16;
  const int nok = min(NO, ks * 2), nov = min(NO, kvs * 2);
  const bool vz = vec != 0;
  const size_t hk = static_cast<size_t>(kv) * n;
  const size_t bhn = static_cast<size_t>(gridDim.x) * r * n;
  // Under the causal mask only the queries at or after this key tile see
  // it; query tiles are 64-aligned from the block's start, as key tiles.
  const int q_first = causal ? kb0 : b0;
  const int nqt = (bend - q_first + TC_ROWS - 1) / TC_ROWS;
  const int steps = r * nqt;
  const int key = kb0 + warp * 16 + gq;   // this thread's first key
  const float sl2 = scale * kLog2e;

  const auto stage_q = [&](int step, int sb) {
    const int hh = step / nqt, i0 = q_first + (step - hh * nqt) * TC_ROWS;
    const int rows = min(TC_ROWS, bend - i0);
    const size_t hq = (hk * r) + static_cast<size_t>(hh) * n;  // (kv r + hh) n
    stage_tile<DP>(sq + sb * TS, LD, q + (hq + i0) * d, d, rows, TC_ROWS, vz);
    stage_tile<DP>(sg + sb * TS, LD, g + (hq + i0) * dv, dv, rows, TC_ROWS,
                   vz);
    float* ss = sst + sb * 2 * TC_ROWS;
    for (int i = threadIdx.x; i < TC_ROWS; i += blockDim.x) {
      const bool ok = i < rows;
      ss[i] = ok ? stats[hq + i0 + i] : 0.f;
      ss[TC_ROWS + i] = ok ? stats[2 * bhn + hq + i0 + i] : 0.f;
    }
  };

  stage_tile<DP>(sk, LD, k + (hk + kb0) * d, d, kr, TC_ROWS, vz);
  stage_tile<DP>(sv, LD, v + (hk + kb0) * dv, dv, kr, TC_ROWS, vz);
  stage_q(0, 0);
  cp_async_commit();

  float ak[NO][4], av[NO][4], part[NO][4];
  zero_acc(ak);
  zero_acc(av);
  const __nv_bfloat16* ak_s = sk + warp * 16 * LD;
  const __nv_bfloat16* av_s = sv + warp * 16 * LD;

  for (int st = 0; st < steps; ++st) {
    const int sb = st & 1;
    if (st + 1 < steps) stage_q(st + 1, sb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int i0 = q_first + (st % nqt) * TC_ROWS;
    const int rows = min(TC_ROWS, bend - i0);
    const __nv_bfloat16* tq = sq + sb * TS;
    const __nv_bfloat16* tg = sg + sb * TS;
    const float* ss = sst + sb * 2 * TC_ROWS;
    // Masks only where a query or key is past the block's end, or on the
    // causal diagonal tile.
    const bool edge = (causal && i0 == kb0) || rows < TC_ROWS || kr < TC_ROWS;
    for (int qa = 0; qa < rows; qa += 32) {   // 32-query slices
      float pt[4][4], dt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pt[j][0] = pt[j][1] = pt[j][2] = pt[j][3] = 0.f;
        dt[j][0] = dt[j][1] = dt[j][2] = dt[j][3] = 0.f;
      }
      mma_abt_p<4, DP / 16, 1, 1>(pt, ak_s, 0, LD, tq + qa * LD, 0, LD, ks,
                                  lane);                          // k q^T
      mma_abt_p<4, DP / 16, 1, 1>(dt, av_s, 0, LD, tg + qa * LD, 0, LD, kvs,
                                  lane);                          // v g^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = qa + j * 8 + 2 * t4;             // query in the tile
        const float2 lse = *reinterpret_cast<const float2*>(ss + c0);
        const float2 dl = *reinterpret_cast<const float2*>(ss + TC_ROWS + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + (e & 1);
          const int kj = key + (e >> 1) * 8;
          float p = fast_exp2(fmaf(pt[j][e], sl2, -((e & 1) ? lse.y : lse.x)));
          if (edge && !(c < rows && kj < kb0 + kr && !(causal && i0 + c < kj)))
            p = 0.f;
          pt[j][e] = p;
          dt[j][e] = p * (dt[j][e] - ((e & 1) ? dl.y : dl.x));
        }
      }
      // Each slice's products go into a fresh accumulator that is added
      // to the total in fp32: the tensor cores' own accumulation does not
      // round to nearest, and its error would grow with the r x blk query
      // rows summed.
      zero_acc(part);
      mma_pb_p<NO, 2, 3, 1>(part, pt, tg + qa * LD, 0, LD, nov,
                            lane);                      // p^T g
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) av[j][e] += part[j][e];
      zero_acc(part);
      mma_pb_p<NO, 2, 3, 1>(part, dt, tq + qa * LD, 0, LD, nok,
                            lane);                      // dsm^T q
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[j][e] += part[j][e];
    }
    __syncthreads();                 // this stage is free for the prefetch
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j0 = warp * 16 + gq + hh * 8;
    if (j0 >= kr) continue;
    float* krow = dk + (hk + kb0 + j0) * d;
    float* vrow = dvo + (hk + kb0 + j0) * dv;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + 2 * t4;
      const float k0 = ak[j][2 * hh] * scale, k1 = ak[j][2 * hh + 1] * scale;
      const float v0 = av[j][2 * hh], v1 = av[j][2 * hh + 1];
      if (vz && c + 1 < d) {
        *reinterpret_cast<float2*>(krow + c) = make_float2(k0, k1);
      } else {
        if (c < d) krow[c] = k0;
        if (c + 1 < d) krow[c + 1] = k1;
      }
      if (vz && c + 1 < dv) {
        *reinterpret_cast<float2*>(vrow + c) = make_float2(v0, v1);
      } else {
        if (c < dv) vrow[c] = v0;
        if (c + 1 < dv) vrow[c + 1] = v1;
      }
    }
  }
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, const void* g,
              float* dq, float* dk, float* dv_, float* stats, int bh, int bg,
              int n, int d, int dv, int blk, int causal, float scale,
              cudaStream_t stream) {
  const size_t tile = static_cast<size_t>(TC_ROWS) * (DP + 8) *
                      sizeof(__nv_bfloat16);
  const size_t dq_bytes = 6 * tile;
  const size_t dkv_bytes = 6 * tile + 2 * 2 * TC_ROWS * sizeof(float);
  cudaError_t err = lln::allow_smem(block_diag_dq_tc_kernel<DP>, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lln::allow_smem(block_diag_dkv_tc_kernel<DP>, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = d % 8 == 0 && dv % 8 == 0 && al(q) && al(k) && al(v) &&
                  al(g) && al(dq) && al(dk) && al(dv_);
  const int r = bh / bg;
  const int nb = (n + blk - 1) / blk;
  const int nt = (blk + TC_ROWS - 1) / TC_ROWS;
  const auto qp = static_cast<const __nv_bfloat16*>(q);
  const auto kp = static_cast<const __nv_bfloat16*>(k);
  const auto vp = static_cast<const __nv_bfloat16*>(v);
  const auto gp = static_cast<const __nv_bfloat16*>(g);
  block_diag_dq_tc_kernel<DP><<<dim3(bh, nb, nt), 128, dq_bytes, stream>>>(
      qp, kp, vp, gp, dq, stats, n, d, dv, r, blk, causal, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block_diag_dkv_tc_kernel<DP><<<dim3(bg, nb, nt), 128, dkv_bytes, stream>>>(
      qp, kp, vp, gp, stats, dk, dv_, n, d, dv, r, blk, causal, scale, vec);
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
  if (bh % bg != 0 || blk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && d <= 64 && dvd <= 64)
    return launch_tc<64>(q, k, v, g, f(dq), f(dk), f(dv), f(stats), bh, bg, n,
                         d, dvd, blk, causal, scale, st);
  if (dtype == 1 && d <= 128 && dvd <= 128)
    return launch_tc<128>(q, k, v, g, f(dq), f(dk), f(dv), f(stats), bh, bg, n,
                          d, dvd, blk, causal, scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, g, f(dq), f(dk), f(dv), f(stats), bh, bg, n,
                         d, dvd, blk, causal, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, f(dq), f(dk), f(dv), f(stats), bh,
                                 bg, n, d, dvd, blk, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
