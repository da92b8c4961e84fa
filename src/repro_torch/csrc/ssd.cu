// Mamba2 SSD chunked scan (arXiv:2405.21060), the training forward.
//
// Replaces src/repro/kernels/ssd.py:ssd_pallas (_ssd_kernel).  Inputs:
// log_a (BH,N) fp32 per-step log decay (<= 0), xbar (BH,N,P) fp32, b_in and
// c_in (BG,N,S) fp32 or bf16; head h reads group row h / r.  Output y
// (BH,N,P) fp32.  Per chunk of blk steps, with e(x) = exp(clip(x, -60, 0)):
//   lcum_i = cumsum(log a)_i within the chunk;
//   y_i    = sum_{j<=i} (C_i.B_j) e(lcum_i - lcum_j) xbar_j + e(lcum_i) C_i.state;
//   state <- e(lcum_last) state + sum_j e(lcum_last - lcum_j) B_j xbar_j^T.
//
// Design: the TPU kernel walked the chunks on the grid's ordered minor axis
// with the (S, P) state in VMEM.  Here one CTA per (head, kCols columns of
// P) loops over the chunks and keeps its columns of the state in shared
// memory.  A chunk is cut into kTile-row tiles (the last may be short when
// blk is not a multiple of kTile).  Per query tile: C transposed into shared
// memory, the inter-chunk term against the state, then for each key tile up
// to the query tile the masked decayed scores (C B^T) and their product with
// xbar.  After the last query tile the key tiles come again for the state
// update.  Every product gives each of the 256 threads a 4 x 4 block of its
// output in registers (rows ty + 16 i, columns tx + 16 j), so one pair of
// shared-memory reads feeds 16 FMAs.  The cumulative sum is one warp's
// in-order scan of 32-step segments; expf (not __expf) throughout.  All
// math is fp32 on the CUDA cores.
//
// Bound on the H100: fp32 operations.  The recurrent form needs about
// 4 S P FLOPs per head and step; this chunked form does more (C B^T per
// tile pair, and per head: the r heads of a group each recompute their
// group's C B^T, as the TPU kernel did).
#include "common.cuh"

namespace {

constexpr int kTile = 64;        // sequence rows per tile
constexpr int kCols = 64;        // P columns per CTA
constexpr int kTp = kTile + 1;   // padded row of a transposed tile
constexpr int kThreads = 256;    // 16 x 16 threads, a 4 x 4 block each
constexpr int kMaxState = 128;   // S rows: ty + 16 i for i < 8

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -60.f), 0.f));
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
    // lcum: warp 0 scans the chunk in 32-step segments, in order.
    if (tid < 32) {
      float carry = 0.f;
      for (int j0 = 0; j0 < blk; j0 += 32) {
        const int j = j0 + tid;
        float v = j < blk ? lah[n0 + j] : 0.f;
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (j < blk) lc[j] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
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
