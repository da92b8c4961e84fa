// Mamba2 SSD chunked scan (arXiv:2405.21060), the training forward.
//
// Replaces src/repro/kernels/ssd.py:ssd_pallas (_ssd_kernel).  Inputs:
// log_a (BH,N) fp32 per-step log decay (<= 0), xbar (BH,N,P) fp32, b_in and
// c_in (BG,N,S) fp32 or bf16; head h reads group row h / r.  Output y
// (BH,N,P) fp32.  Per chunk of blk steps, with e(x) = exp(clip(x, -60, 0)):
//   lcum_i = cumsum(log a)_i within the chunk;
//   y_i    = sum_{j<=i} (C_i.B_j) e(lcum_i - lcum_j) xbar_j + e(lcum_i) C_i.state;
//   state <- e(lcum_last) state + sum_j e(lcum_last - lcum_j) B_j xbar_j^T.
// Each factor is clipped on its own, as the reference clips them; the
// cumulative sum is one warp's in-order scan of 32-step segments
// (chunk_cumsum) on both paths; expf (not __expf) throughout.
//
// Two paths, chosen by the caller (kernels/ssd.py:_tc_path) by type and
// width, each with its own entry point:
//
// bf16 B/C with S, P <= 128 (mamba2-130m and zamba2-7b training):
// ssd_tc_launch, on the tensor cores, chunk-parallel (Mamba2's own
// chunked algorithm).  Four launches:
//   1. lcum_kernel: lcum of every (head, chunk), once, into scratch; every
//      later kernel reads that copy, so they agree bitwise.
//   2. chunk_state_kernel: G_c = sum_j B_j (e(l_last - lcum_j) xbar_j)^T
//      of every chunk but the last, one CTA per (head, chunk, 32 x 64
//      slice), all in parallel: B exact (bf16, cp.async), the decayed
//      xbar in three bf16 planes (three MMAs); each 64-row step's product
//      in a fresh accumulator added to the fp32 sum.
//   3. state_pass_kernel: state_c, the state before chunk c, by state <-
//      e(l_last) state + G_c in chunk order, fp32, one thread per (head,
//      entry), stored as bf16 hi + lo.
//   4. ssd_out_kernel: one CTA of 4 warps per (head, chunk, 64-row tile),
//      the tiles of one (head, chunk) side by side in the grid (they share
//      xbar and state_c in L2), the tile with the most keys first.  C,
//      state_c and the first key tile are staged together; the inter term
//      C state_c (C exact, state_c hi + lo: two MMAs) is scaled by
//      e(lcum_i); then the chunk's keys up to the tile's last row come in
//      32- or 64-key tiles, double-buffered (B by cp.async; xbar loaded
//      into registers a tile ahead and split into hi + lo as it is
//      stored): C B^T in one exact MMA per 16 of S, times e(lcum_i -
//      lcum_j) on and below the diagonal, and those fp32 scores as hi + lo
//      against xbar's hi + lo (three MMAs).  Each head recomputes its
//      group's C B^T: on the tensor cores that costs less than reading a
//      stored copy.
//   Bound on the H100: the bytes (xbar and y dominate), a little above
//   the tensor-core products (chip_smoke.py:_ssd_counts).
//
// fp32 B/C, or a width above 128: ssd_launch, the CUDA-core kernel below,
// IEEE fp32.  One CTA per (head, kCols columns of P) loops over the chunks
// and keeps its columns of the state in shared memory.  A chunk is cut
// into kTile-row tiles (the last may be short when blk is not a multiple
// of kTile).  Per query tile: C transposed into shared memory, the
// inter-chunk term against the state, then for each key tile up to the
// query tile the masked decayed scores (C B^T) and their product with
// xbar.  After the last query tile the key tiles come again for the state
// update.  Every product gives each of the 256 threads a 4 x 4 block of
// its output in registers (rows ty + 16 i, columns tx + 16 j), so one pair
// of shared-memory reads feeds 16 FMAs.  A CTA recomputes its group's
// C B^T for each of the r heads that share it.
#include "fused_state.cuh"

namespace {

constexpr int kTile = 64;        // sequence rows per tile
constexpr int kCols = 64;        // P columns per CTA
constexpr int kTp = kTile + 1;   // padded row of a transposed tile
constexpr int kThreads = 256;    // 16 x 16 threads, a 4 x 4 block each
constexpr int kMaxState = 128;   // S rows: ty + 16 i for i < 8

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -60.f), 0.f));
}

// lcum[j] = log_a[0] + ... + log_a[j] for j < blk, by one warp (lane =
// lane index): an in-order scan of 32-step segments, the same order on
// both paths.
__device__ __forceinline__ void chunk_cumsum(const float* log_a, float* lcum,
                                             int blk, int lane) {
  float carry = 0.f;
  for (int j0 = 0; j0 < blk; j0 += 32) {
    const int j = j0 + lane;
    float v = j < blk ? log_a[j] : 0.f;
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    if (j < blk) lcum[j] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// dst[e * kTp + a] = src[a * s + e] for a < rows, 0 for the pad rows.
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                int rows, int s) {
  for (int i = threadIdx.x; i < kTile * s; i += kThreads) {
    const int a = i / s, e = i - a * s;
    dst[e * kTp + a] = a < rows ? lln::to_f32(src[i]) : 0.f;
  }
}

// dst[b * kCols + c] = src[b * p + c] for b < rows and c < cw, else 0.
__device__ __forceinline__ void load_cols(float* dst, const float* src,
                                          int rows, int cw, int p) {
  for (int i = threadIdx.x; i < kTile * kCols; i += kThreads) {
    const int b = i / kCols, c = i - b * kCols;
    dst[i] = (b < rows && c < cw) ? src[static_cast<size_t>(b) * p + c] : 0.f;
  }
}

template <typename BT>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ log_a, const float* __restrict__ xbar,
           const BT* __restrict__ b_in, const BT* __restrict__ c_in,
           float* __restrict__ out, int n, int p, int s, int r, int blk) {
  extern __shared__ float smem[];
  float* lc = smem;                  // blk            cumsum of log a (chunk)
  float* ct = lc + blk;              // s x kTp        C of the query tile^T
  float* bt = ct + s * kTp;          // s x kTp        B of the key tile^T
  float* xt = bt + s * kTp;          // kTile x kCols  xbar of the key tile
  float* sc = xt + kTile * kCols;    // kTile x kTp    masked decayed scores
  float* st = sc + kTile * kTp;      // s x kCols      state columns

  const int h = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int cw = min(kCols, p - c0);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* lah = log_a + static_cast<size_t>(h) * n;
  const float* xh = xbar + static_cast<size_t>(h) * n * p + c0;
  const BT* bg = b_in + static_cast<size_t>(h / r) * n * s;
  const BT* cg = c_in + static_cast<size_t>(h / r) * n * s;
  float* oh = out + static_cast<size_t>(h) * n * p + c0;

  for (int i = tid; i < s * kCols; i += kThreads) st[i] = 0.f;

  for (int n0 = 0; n0 < n; n0 += blk) {
    if (tid < 32) chunk_cumsum(lah + n0, lc, blk, tid);
    __syncthreads();

    for (int q0 = 0; q0 < blk; q0 += kTile) {
      const int qrows = min(kTile, blk - q0);
      load_transposed(ct, cg + static_cast<size_t>(n0 + q0) * s, qrows, s);
      __syncthreads();

      // Inter-chunk term: e(lcum_a) C_a . state.
      float acc[4][4] = {};
      for (int e = 0; e < s; ++e) {
        float ca[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = ct[e * kTp + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = st[e * kCols + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ca[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = ty + 16 * i;
        const float w = a < qrows ? clip_exp(lc[q0 + a]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= w;
      }

      // Intra-chunk term against each key tile up to the query tile.
      for (int k0 = 0; k0 <= q0; k0 += kTile) {
        const int krows = min(kTile, blk - k0);
        __syncthreads();               // the last tile's bt, xt, sc are read
        load_transposed(bt, bg + static_cast<size_t>(n0 + k0) * s, krows, s);
        load_cols(xt, xh + static_cast<size_t>(n0 + k0) * p, krows, cw, p);
        __syncthreads();
        float dot[4][4] = {};
        for (int e = 0; e < s; ++e) {
          float ca[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ca[i] = ct[e * kTp + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = bt[e * kTp + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dot[i][j] = fmaf(ca[i], bb[j], dot[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int a = ty + 16 * i, b = tx + 16 * j;
            const int qi = q0 + a, kj = k0 + b;
            sc[a * kTp + b] = (kj <= qi && a < qrows && b < krows)
                                  ? dot[i][j] * clip_exp(lc[qi] - lc[kj])
                                  : 0.f;
          }
        __syncthreads();
        for (int b = 0; b < krows; ++b) {
          float sa[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sa[i] = sc[(ty + 16 * i) * kTp + b];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xt[b * kCols + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sa[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = ty + 16 * i;
        if (a >= qrows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c < cw) oh[static_cast<size_t>(n0 + q0 + a) * p + c] = acc[i][j];
        }
      }
      __syncthreads();                 // ct is reloaded by the next tile
    }

    // State update: state * e(l_last) + sum_b e(l_last - lcum_b) B_b xbar_b^T.
    const float l_last = lc[blk - 1];
    float up[kMaxState / 16][4] = {};
    for (int k0 = 0; k0 < blk; k0 += kTile) {
      const int krows = min(kTile, blk - k0);
      __syncthreads();
      load_transposed(bt, bg + static_cast<size_t>(n0 + k0) * s, krows, s);
      load_cols(xt, xh + static_cast<size_t>(n0 + k0) * p, krows, cw, p);
      for (int b = tid; b < krows; b += kThreads)
        sc[b] = clip_exp(l_last - lc[k0 + b]);
      __syncthreads();
      for (int b = 0; b < krows; ++b) {
        const float w = sc[b];
        float xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xt[b * kCols + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kMaxState / 16; ++i) {
          const int e = ty + 16 * i;
          if (e >= s) continue;
          const float bw = bt[e * kTp + b] * w;
#pragma unroll
          for (int j = 0; j < 4; ++j) up[i][j] = fmaf(bw, xv[j], up[i][j]);
        }
      }
    }
    const float dl = clip_exp(l_last);
#pragma unroll
    for (int i = 0; i < kMaxState / 16; ++i) {
      const int e = ty + 16 * i;
      if (e >= s) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* x = st + e * kCols + tx + 16 * j;
        *x = *x * dl + up[i][j];
      }
    }
    __syncthreads();                   // lc and st are rewritten next chunk
  }
}

template <typename BT>
int launch(const float* log_a, const float* xbar, const void* b_in,
           const void* c_in, float* out, int bh, int bg, int n, int p, int s,
           int blk, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(blk) + 2 * static_cast<size_t>(s) * kTp +
                        static_cast<size_t>(kTile) * kCols +
                        static_cast<size_t>(kTile) * kTp +
                        static_cast<size_t>(s) * kCols;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = lln::allow_smem(ssd_kernel<BT>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (p + kCols - 1) / kCols);
  ssd_kernel<BT><<<grid, kThreads, bytes, stream>>>(
      log_a, xbar, static_cast<const BT*>(b_in), static_cast<const BT*>(c_in),
      out, n, p, s, bh / bg, blk);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16 B/C on the tensor cores.
// ---------------------------------------------------------------------------

using namespace lln;

constexpr int TC_ROWS = 64;      // query rows per output CTA (4 warps x 16)

// Keys per staged tile of the output kernel: 64 where the wider C B^T
// leaves two CTAs per SM anyway, 32 at S <= 64 (three CTAs per SM).
template <int DS>
__host__ __device__ constexpr int key_tile() { return DS > 64 ? 64 : 32; }
constexpr int kStatePlanes = 3;  // e(.) xbar in the state kernel

// One warp per (head, chunk): lcum (BH,N) of every chunk, in chunk_cumsum's
// order (N % blk == 0, so chunk w of the flat index starts at w blk).
__global__ void lcum_kernel(const float* __restrict__ log_a,
                            float* __restrict__ lcum, int blk, int chunks) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= chunks) return;
  const size_t base = static_cast<size_t>(w) * blk;
  chunk_cumsum(log_a + base, lcum + base, blk, threadIdx.x & 31);
}

// gs (BH,nc-1,S,P) fp32: G_c = sum_j B_j (e(l_last - lcum_j) xbar_j)^T of
// every chunk but the last, one CTA per (head, chunk, 32 x 64 slice), all
// in parallel.  B is bf16, exact on the tensor cores, staged by cp.async;
// the decay goes onto xbar, whose fp32 product is split into NP bf16
// planes (NP MMAs).  Each 64-row step's product goes into a fresh
// accumulator added to the fp32 sum in step order.
template <int NP>
__global__ void __launch_bounds__(128)
chunk_state_kernel(const float* __restrict__ lcum,
                   const float* __restrict__ xbar,
                   const __nv_bfloat16* __restrict__ b_in,
                   float* __restrict__ gs, int n, int p, int s, int r,
                   int blk, int vec) {
  constexpr int LA = SD + 8, LB = SE + 8;
  constexpr int XU = SR * SE / 128;   // xbar entries per thread and step
  __shared__ __align__(16) __nv_bfloat16 sa[SR * LA];
  __shared__ __align__(16) __nv_bfloat16 sb[NP][SR * LB];
  __shared__ float wr[SR];

  // The slices of one (head, chunk) are neighbours in the grid, so the
  // S slices read its xbar rows from L2.
  const int nc = n / blk;
  const int ns = (s + SD - 1) / SD, np = (p + SE - 1) / SE;
  const int hc = blockIdx.x / (ns * np);
  const int h = hc / (nc - 1), c = hc % (nc - 1);
  const int s0 = (blockIdx.x % ns) * SD;
  const int p0 = (blockIdx.x / ns) % np * SE;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;   // rows 16 wm, columns 32 wn
  const float* lc = lcum + static_cast<size_t>(h) * n;
  const float* xh = xbar + static_cast<size_t>(h) * n * p;
  const __nv_bfloat16* bg = b_in + static_cast<size_t>(h / r) * n * s;
  const int n0 = c * blk;
  const float l_last = lc[n0 + blk - 1];

  float g[4][4];
  zero_acc(g);
  for (int off = 0; off < blk; off += SR) {
    const int valid = min(SR, blk - off);
    const int row0 = n0 + off;
    __syncthreads();                   // the last step's tiles are read
    stage_rows<SD>(sa, LA, bg + static_cast<size_t>(row0) * s + s0, s,
                   min(SD, s - s0), valid, SR, vec != 0);
    cp_async_commit();
    float xv[XU];
#pragma unroll
    for (int u = 0; u < XU; ++u) {     // loads first, all in flight
      const int i = tid + 128 * u, rr = i / SE, cc = i - rr * SE;
      xv[u] = rr < valid && p0 + cc < p
                  ? xh[static_cast<size_t>(row0 + rr) * p + p0 + cc]
                  : 0.f;
    }
    if (tid < SR)
      wr[tid] = tid < valid ? clip_exp(l_last - lc[row0 + tid]) : 0.f;
    __syncthreads();                   // wr
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int i = tid + 128 * u, rr = i / SE, cc = i - rr * SE;
      float f = xv[u] * wr[rr];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const __nv_bfloat16 hb = __float2bfloat16(f);
        sb[q][rr * LB + cc] = hb;
        f -= __bfloat162float(hb);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    float part[4][4];
    zero_acc(part);
#pragma unroll
    for (int kk = 0; kk < SR / 16; ++kk) {
      uint32_t af[1][4];
      frag_a_trans(af[0], sa + kk * 16 * LA + wm * 16, LA, lane);
#pragma unroll
      for (int jj = 0; jj < 4; jj += 2) {
        uint32_t b0[NP][2], b1[NP][2];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          uint32_t b[4];
          frag_b_trans(b, sb[q] + kk * 16 * LB + wn * 32 + jj * 8, LB, lane);
          b0[q][0] = b[0]; b0[q][1] = b[1]; b1[q][0] = b[2]; b1[q][1] = b[3];
        }
        mma_planes<1, NP>(part[jj], af, b0);
        mma_planes<1, NP>(part[jj + 1], af, b1);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[jj][e] += part[jj][e];
  }
  float* gc = gs + static_cast<size_t>(hc) * s * p;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = s0 + wm * 16 + gq + hh * 8;
      const int col = p0 + wn * 32 + jj * 8 + 2 * t4;
      if (row < s)
        store_pair(gc + static_cast<size_t>(row) * p + col, g[jj][2 * hh],
                   g[jj][2 * hh + 1], col, p);
    }
  }
}

// st (2,BH,nc,S,P): state_c, the state before chunk c, as bf16 hi, then lo
// at + st_count: state <- e(l_last) state + G_c in chunk order, in fp32,
// one thread per (head, state entry).  Slot c = 0 (the zero state) is
// never written.
__global__ void state_pass_kernel(const float* __restrict__ lcum,
                                  const float* __restrict__ gs,
                                  __nv_bfloat16* __restrict__ st,
                                  size_t st_count, int n, int blk,
                                  int entries, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int nc = n / blk;
  const size_t h = i / entries, e = i - h * entries;
  const float* lc = lcum + h * n;
  const float* g = gs + h * (nc - 1) * entries + e;
  __nv_bfloat16* o = st + (h * nc) * entries + e;
  float state = 0.f;
#pragma unroll 4
  for (int c = 0; c + 1 < nc; ++c) {
    state = state * clip_exp(lc[c * blk + blk - 1]) +
            g[static_cast<size_t>(c) * entries];
    const __nv_bfloat16 hb = __float2bfloat16(state);
    o[static_cast<size_t>(c + 1) * entries] = hb;
    o[st_count + static_cast<size_t>(c + 1) * entries] =
        __float2bfloat16(state - __bfloat162float(hb));
  }
}

// C (64 rows), state_c hi and lo (64 rows of S at a time), two stages of
// B, xbar hi and lo, then the key and query lcum.
template <int DS, int DPW>
constexpr size_t out_smem_bytes() {
  constexpr int KT = key_tile<DS>();
  return (static_cast<size_t>(TC_ROWS) * (DS + 8) + 2 * 64 * (DPW + 8) +
          2 * (KT * (DS + 8) + 2 * KT * (DPW + 8))) *
             sizeof(__nv_bfloat16) +
         (2 * KT + TC_ROWS) * sizeof(float);
}

// DS and DPW: S and P rounded up to 64 or 128.  Three CTAs per SM at S <=
// 64; two at 128, where the wider C B^T needs the registers.
template <int DS, int DPW>
__global__ void __launch_bounds__(128, DS > 64 ? 2 : 3)
ssd_out_kernel(const float* __restrict__ lcum, const float* __restrict__ xbar,
               const __nv_bfloat16* __restrict__ b_in,
               const __nv_bfloat16* __restrict__ c_in,
               const __nv_bfloat16* __restrict__ st, float* __restrict__ out,
               int n, int p, int s, int r, int blk, size_t st_count,
               int vec) {
  extern __shared__ float smem[];
  constexpr int KT = key_tile<DS>();
  constexpr int LS = DS + 8, LP = DPW + 8;
  constexpr int NS = KT / 8;           // score tiles of 8 keys per warp
  constexpr int NO = DPW / 8;          // output tiles of 8 columns per warp
  constexpr int XU = KT * DPW / 128;   // xbar entries per thread and tile
  constexpr int SZ = KT * LS + 2 * KT * LP;   // one stage
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(smem);  // C tile
  __nv_bfloat16* ss = sc + TC_ROWS * LS;   // state_c hi, lo: 64 rows each
  __nv_bfloat16* stg = ss + 2 * 64 * LP;   // 2 stages of B, xbar hi, lo
  float* lk = reinterpret_cast<float*>(stg + 2 * SZ);  // 2 x KT key lcum
  float* lq = lk + 2 * KT;                              // query lcum

  // The tiles of one (head, chunk) are neighbours in the grid, the tile
  // with the most keys first, so they share xbar and state_c in L2.
  const int nt = (blk + TC_ROWS - 1) / TC_ROWS;
  const int nc = n / blk;
  const int h = blockIdx.x / (nc * nt);
  const int c = (blockIdx.x / nt) % nc;
  const int q0 = (nt - 1 - blockIdx.x % nt) * TC_ROWS;  // in the chunk
  if (q0 >= blk) return;               // blk < 64: no rows here
  const int rows = min(TC_ROWS, blk - q0);
  const int nk = q0 + rows;            // the chunk's keys up to the last row
  const int ntiles = (nk + KT - 1) / KT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ks = (s + 15) / 16;
  const int no = min(NO, ((p + 15) / 16) * 2);
  const bool vz = vec != 0;
  const size_t hn = static_cast<size_t>(h) * n + static_cast<size_t>(c) * blk;
  const size_t gn =
      static_cast<size_t>(h / r) * n + static_cast<size_t>(c) * blk;
  const float* lc = lcum + hn;
  const float* xh = xbar + hn * p;
  const __nv_bfloat16* bg = b_in + gn * s;

  // Key tile t: B by cp.async into stage sb; xbar and lcum into registers
  // (fetch), split into hi + lo and stored into stage sb later (store), so
  // that their loads are in flight while the tensor cores work.
  float xv[XU], lkv = 0.f;
  const auto fetch_keys = [&](int t, int sb) {
    const int k0 = t * KT, kr = min(KT, nk - k0);
    stage_tile<DS>(stg + sb * SZ, LS, bg + static_cast<size_t>(k0) * s, s,
                   kr, KT, vz);
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int i = tid + 128 * u, rr = i / DPW, cc = i - rr * DPW;
      xv[u] = rr < kr && cc < p ? xh[static_cast<size_t>(k0 + rr) * p + cc]
                                : 0.f;
    }
    lkv = tid < kr ? lc[k0 + tid] : 0.f;
  };
  const auto store_keys = [&](int sb) {
    __nv_bfloat16* sk = stg + sb * SZ + KT * LS;
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int i = tid + 128 * u, rr = i / DPW, cc = i - rr * DPW;
      const __nv_bfloat16 hb = __float2bfloat16(xv[u]);
      sk[rr * LP + cc] = hb;
      sk[KT * LP + rr * LP + cc] =
          __float2bfloat16(xv[u] - __bfloat162float(hb));
    }
    if (tid < KT) lk[sb * KT + tid] = lkv;
  };

  // C, the first 64 rows of state_c and the first key tile are in flight
  // together.
  const __nv_bfloat16* sh = st + (static_cast<size_t>(h) * nc + c) * s * p;
  const auto stage_state = [&](int e0) {
    const int er = min(64, s - e0);
    stage_tile<DPW>(ss, LP, sh + static_cast<size_t>(e0) * p, p, er, 64, vz);
    stage_tile<DPW>(ss + 64 * LP, LP,
                    sh + st_count + static_cast<size_t>(e0) * p, p, er, 64,
                    vz);
  };
  stage_tile<DS>(sc, LS, c_in + (gn + q0) * s, s, rows, TC_ROWS, vz);
  if (c > 0) stage_state(0);
  cp_async_commit();
  fetch_keys(0, 0);
  cp_async_commit();
  if (tid < TC_ROWS) lq[tid] = tid < rows ? lc[q0 + tid] : 0.f;

  float acc[NO][4];
  zero_acc(acc);
  const __nv_bfloat16* aq = sc + warp * 16 * LS;

  // Inter-chunk term e(lcum_i) C_i state_c, 64 rows of state_c at a time.
  if (c > 0) {
    for (int e0 = 0; e0 < s; e0 += 64) {
      if (e0 > 0) {
        __syncthreads();               // the last rows are read
        stage_state(e0);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();            // C and state rows 0..63
      }
      __syncthreads();
      mma_ab_p<NO, 4, 1, 2>(acc, aq + e0, 0, LS, ss, 64 * LP, LP,
                            (min(64, s - e0) + 15) / 16, no, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // lq, C and key tile 0
  float lqr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lqr[hh] = lq[warp * 16 + gq + hh * 8];
    const float e = clip_exp(lqr[hh]);
#pragma unroll
    for (int jj = 0; jj < NO; ++jj) {
      acc[jj][2 * hh] *= e;
      acc[jj][2 * hh + 1] *= e;
    }
  }

  // Intra-chunk term: the masked decayed scores against xbar.
  store_keys(0);
  const int qrow = q0 + warp * 16 + gq;
  for (int t = 0; t < ntiles; ++t) {
    const int sb = t & 1;
    if (t + 1 < ntiles) fetch_keys(t + 1, sb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* s_b = stg + sb * SZ;
    const float* lkt = lk + sb * KT;
    // C B^T, one exact MMA per 16 of S (mma_abt_p's products, unrolled
    // by two to spare registers).
    float sco[NS][4];
    zero_acc(sco);
#pragma unroll 2
    for (int kk = 0; kk < ks; ++kk) {
      uint32_t af[4];
      frag_a(af, aq + kk * 16, LS, lane);
#pragma unroll
      for (int jj = 0; jj < NS; jj += 2) {
        uint32_t bf[4];
        frag_b(bf, s_b + jj * 8 * LS + kk * 16, LS, lane);
        mma_bf16(sco[jj], af, bf[0], bf[1]);
        mma_bf16(sco[jj + 1], af, bf[2], bf[3]);
      }
    }
    const int kb = t * KT;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = jj * 8 + 2 * t4 + (e & 1);
        const int row = qrow + (e >> 1) * 8;
        sco[jj][e] = kb + kc <= row
                         ? sco[jj][e] * clip_exp(lqr[e >> 1] - lkt[kc])
                         : 0.f;
      }
    }
    mma_pb_p<NO, NS / 2, 2, 2>(acc, sco, s_b + KT * LS, KT * LP, LP, no,
                               lane);
    if (t + 1 < ntiles) store_keys(sb ^ 1);
    __syncthreads();                 // this stage is free for the prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    if (a >= rows) continue;
    float* orow = out + (hn + q0 + a) * p;
#pragma unroll
    for (int jj = 0; jj < NO; ++jj) {
      const int cc = jj * 8 + 2 * t4;
      store_pair(orow + cc, acc[jj][2 * hh], acc[jj][2 * hh + 1], cc, p);
    }
  }
}

template <int DS, int DPW>
int launch_tc(const float* log_a, const float* xbar,
              const __nv_bfloat16* b_in, const __nv_bfloat16* c_in,
              float* out, float* lcum, float* gs, __nv_bfloat16* st, int bh,
              int bg, int n, int p, int s, int blk, cudaStream_t stream) {
  const int nc = n / blk;
  const int chunks = bh * nc;
  const size_t st_count = static_cast<size_t>(bh) * nc * s * p;
  lcum_kernel<<<(chunks + 3) / 4, 128, 0, stream>>>(log_a, lcum, blk, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nc > 1) {
    const int slices = ((s + SD - 1) / SD) * ((p + SE - 1) / SE);
    const int bvec = s % 8 == 0 && (reinterpret_cast<uintptr_t>(b_in) & 15) == 0;
    chunk_state_kernel<kStatePlanes><<<bh * (nc - 1) * slices, 128, 0,
                                       stream>>>(
        lcum, xbar, b_in, gs, n, p, s, bh / bg, blk, bvec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t total = static_cast<size_t>(bh) * s * p;
    state_pass_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                        stream>>>(lcum, gs, st, st_count, n, blk, s * p,
                                  total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t bytes = out_smem_bytes<DS, DPW>();
  err = lln::allow_smem(ssd_out_kernel<DS, DPW>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto al = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  const int vec = s % 8 == 0 && p % 8 == 0 && al(b_in) && al(c_in) && al(st);
  const int tiles = (blk + TC_ROWS - 1) / TC_ROWS;
  ssd_out_kernel<DS, DPW><<<bh * nc * tiles, 128, bytes, stream>>>(
      lcum, xbar, b_in, c_in, st, out, n, p, s, bh / bg, blk, st_count, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// b_dtype: 0 = float32, 1 = bfloat16 (b_in and c_in).  Needs 1 <= s <= 128,
// bh % bg == 0 and n % blk == 0.  Returns cudaGetLastError().
extern "C" int ssd_launch(const void* log_a, const void* xbar, const void* b_in,
                          const void* c_in, void* out, int bh, int bg, int n,
                          int p, int s, int blk, int b_dtype, void* stream) {
  if (s < 1 || s > kMaxState || bg < 1 || bh % bg || blk < 1 || n % blk)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto la = static_cast<const float*>(log_a);
  auto xb = static_cast<const float*>(xbar);
  auto o = static_cast<float*>(out);
  if (b_dtype == 1)
    return launch<__nv_bfloat16>(la, xb, b_in, c_in, o, bh, bg, n, p, s, blk, st);
  if (b_dtype == 0)
    return launch<float>(la, xb, b_in, c_in, o, bh, bg, n, p, s, blk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 tensor-core path (b_in and c_in bf16; 1 <= s, p <= 128).  lcum
// (BH,N) fp32, gs (BH,N/blk-1,S,P) fp32 and st (2,BH,N/blk,S,P) bf16 are
// scratch.  Needs bh % bg == 0 and n % blk == 0.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
extern "C" int ssd_tc_launch(const void* log_a, const void* xbar,
                             const void* b_in, const void* c_in, void* out,
                             void* lcum, void* gs, void* st, int bh, int bg,
                             int n, int p, int s, int blk, void* stream) {
  if (s < 1 || s > kMaxState || p < 1 || p > 128 || bg < 1 || bh % bg ||
      blk < 1 || n % blk)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  auto str = static_cast<cudaStream_t>(stream);
  auto la = static_cast<const float*>(log_a);
  auto xb = static_cast<const float*>(xbar);
  auto b = static_cast<const bf*>(b_in);
  auto c = static_cast<const bf*>(c_in);
  auto o = static_cast<float*>(out);
  auto lc = static_cast<float*>(lcum);
  auto g = static_cast<float*>(gs);
  auto sp = static_cast<bf*>(st);
  if (s <= 64 && p <= 64)
    return launch_tc<64, 64>(la, xb, b, c, o, lc, g, sp, bh, bg, n, p, s, blk,
                             str);
  if (s <= 64)
    return launch_tc<64, 128>(la, xb, b, c, o, lc, g, sp, bh, bg, n, p, s,
                              blk, str);
  if (p <= 64)
    return launch_tc<128, 64>(la, xb, b, c, o, lc, g, sp, bh, bg, n, p, s,
                              blk, str);
  return launch_tc<128, 128>(la, xb, b, c, o, lc, g, sp, bh, bg, n, p, s,
                             blk, str);
}
