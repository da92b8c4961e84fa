// Block-diagonal softmax attention (paper §4.2).
//
// Replaces src/repro/kernels/block_diag.py:block_diag_pallas.  q (BH,N,D),
// k/v (BG,N,D[v]) share one type (fp32 or bf16); query row h reads kv row
// h / r; out (BH,N,Dv) in the same type.  Each blk-sized block attends only
// within itself, optionally causal; the ragged last block holds N-(nb-1)*blk
// keys.  The math is the reference's: p = softmax(q k^T D^-1/2) with masked
// scores at -1e30, out = p v, every sum in fp32.
//
// Two kernels, chosen by the input type:
//
// bf16 (every model path on the card; D, Dv <= 256): block_diag_tc_kernel,
// on the tensor cores.  One CTA of 4 warps per (query head, block, 64-row
// query tile, chunk of up to 128 value columns); each warp owns 16 query
// rows.  Key and value tiles of 32 rows stream through a double-buffered
// bf16 ring in shared memory by cp.async.  q k^T is one mma.sync per 16 x
// 8 x 16 piece on the raw bf16 operands (exact products, fp32 sums) over
// all of D in 16-deep steps, scaled by D^-1/2 in fp32; the scores stay in
// the MMA accumulators, never in shared memory.  The softmax is online in
// log2 units (exp2 on the special-function unit; the row max moves once
// per key tile and rescales the output accumulator), divided by the row
// sum at the end.  p v takes the fp32 p as hi + lo bf16 (two MMAs, about
// 2^-17 relative), so the result keeps the fp32 p the reference
// multiplies by, which SDPA does not.  Causal tiles stop at the diagonal.
// The kernel is templated on the padded q/k width DK and the value chunk
// DV.  At D, Dv <= 128 one chunk holds every value column (DK = DV = 64
// or 128).  Wider heads (MLA's D = 192 with Dv = 128, paligemma's D = Dv
// = 256) take DK = 192 or 256 and 128-column value chunks, a CTA per
// chunk, each recomputing the scores: 128 output columns are 64 fp32
// accumulators a thread, as at D = 128, where all 256 would be 128.
// Shared memory at DK = 256: a 64 x 264 q tile, 2 x 32 x 264 keys and 2 x
// 32 x 136 values, bf16, 85.0 KB, two CTAs per SM.  Bound on the H100:
// bytes at the encoder and serve shapes (q, k, v read once, out written
// once; the products at the tensor cores' rate take less, see
// chip_smoke.py).
//
// fp32 (the card tests and the SMOKE parity runs), and bf16 with a head
// wider than 256: block_diag_kernel,
// IEEE fp32 on the CUDA cores (bf16 inputs widened as they are staged, the
// output rounded once).  One CTA per (query head, block, qtile-row query
// tile) keeps the scaled query tile, its score rows over the block's keys
// (up to its last row if causal) and its output rows in shared memory;
// keys, then values, stream through a KTILE-row buffer; the softmax is the
// reference's exact form (max, exponentiate, divide, then multiply by V).
#include "common.cuh"
#include "mma.cuh"

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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores.
// ---------------------------------------------------------------------------

using namespace lln;

constexpr int TC_ROWS = 64;   // query rows per CTA (4 warps x 16)
// Key rows per staged tile: short tiles leave shared memory for more CTAs
// per SM (27.6 KB each at DK = DV = 64).
constexpr int TC_KEYS = 32;

// DK: the padded q/k width, a multiple of 16 >= d; DV: the value columns
// of one CTA, a multiple of 16 (all of dv when dv <= DV, else chunks of
// DV, blockIdx.z = tile * chunks + chunk).
template <int DK, int DV>
__global__ void __launch_bounds__(128)
block_diag_tc_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int n, int d, int dv,
                     int r, int blk, int causal, float scale, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DK + 8;         // padded row: ldmatrix without conflicts
  constexpr int LV = DV + 8;
  constexpr int NS = TC_KEYS / 8;    // score tiles of 8 keys per warp
  constexpr int NO = DV / 8;         // output tiles of 8 columns per warp
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + TC_ROWS * LD;      // 2 stages
  __nv_bfloat16* sv = sk + 2 * TC_KEYS * LD;  // 2 stages

  const int h = blockIdx.x;
  const int kvh = h / r;
  const int b0 = blockIdx.y * blk;
  const int bend = min(b0 + blk, n);
  const int nch = (dv + DV - 1) / DV;          // value chunks
  const int c0 = static_cast<int>(blockIdx.z % nch) * DV;
  const int r0 = b0 + static_cast<int>(blockIdx.z / nch) * TC_ROWS;
  if (r0 >= bend) return;            // ragged last block: no rows here
  const int rows = min(TC_ROWS, bend - r0);
  const int nk = (causal ? min(bend, r0 + rows) : bend) - b0;
  const int ntiles = (nk + TC_KEYS - 1) / TC_KEYS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int ks = (d + 15) / 16;                 // 16-deep steps of q k^T
  const int vw = min(DV, dv - c0);              // this chunk's columns
  const int no = min(NO, ((vw + 15) / 16) * 2); // output tiles in use
  const bool vz = vec != 0;
  const __nv_bfloat16* kh = k + (static_cast<size_t>(kvh) * n + b0) * d;
  const __nv_bfloat16* vh =
      v + (static_cast<size_t>(kvh) * n + b0) * dv + c0;

  stage_tile<DK>(sq, LD, q + (static_cast<size_t>(h) * n + r0) * d, d, rows,
                 TC_ROWS, vz);
  stage_tile<DK>(sk, LD, kh, d, min(TC_KEYS, nk), TC_KEYS, vz);
  stage_rows<DV>(sv, LV, vh, dv, vw, min(TC_KEYS, nk), TC_KEYS, vz);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // row max of rows g and g + 8
  float l[2] = {0.f, 0.f};           // this thread's part of the row sums
  const int qrow = r0 - b0 + warp * 16 + g;   // query index in the block
  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2 = exp

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {            // prefetch the next key/value tile
      const int k0 = (t + 1) * TC_KEYS;
      const int kr = min(TC_KEYS, nk - k0);
      stage_tile<DK>(sk + (st ^ 1) * TC_KEYS * LD, LD,
                     kh + static_cast<size_t>(k0) * d, d, kr, TC_KEYS, vz);
      stage_rows<DV>(sv + (st ^ 1) * TC_KEYS * LV, LV,
                     vh + static_cast<size_t>(k0) * dv, dv, vw, kr, TC_KEYS,
                     vz);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt_p<NS, DK / 16, 1, 1>(s, sq + warp * 16 * LD, 0, LD,
                                 sk + st * TC_KEYS * LD, 0, LD, ks, lane);

    // Scale and mask (only tiles that reach past the block's end or past
    // the tile's first query need it); the row max, then the online rescale.
    const int kb = t * TC_KEYS;
    const bool edge = kb + TC_KEYS > nk || (causal && kb + TC_KEYS > r0 - b0 + 1);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kb + j * 8 + 2 * t4 + (e & 1);
        const int row = qrow + (e >> 1) * 8;
        float x = s[j][e] * sl2;
        if (edge && (col >= nk || (causal && col > row))) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(m[hh], mx[hh]);
      const float a = fast_exp2(m[hh] - mn);
      m[hh] = mn;
      l[hh] *= a;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * hh] *= a;
        o[j][2 * hh + 1] *= a;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
    mma_pb_p<NO, NS / 2, 2, 1>(o, s, sv + st * TC_KEYS * LV, 0, LV, no,
                               lane);
    __syncthreads();                 // this stage is free for the prefetch
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + g + hh * 8;
    if (a >= rows) continue;
    __nv_bfloat16* orow =
        out + (static_cast<size_t>(h) * n + r0 + a) * dv + c0;
    const float inv = 1.f / l[hh];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + 2 * t4;
      const uint32_t x = pack_bf16(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
      if (vz && c + 1 < vw) {
        *reinterpret_cast<uint32_t*>(orow + c) = x;
      } else {
        if (c < vw) orow[c] = __ushort_as_bfloat16(x & 0xffffu);
        if (c + 1 < vw) orow[c + 1] = __ushort_as_bfloat16(x >> 16);
      }
    }
  }
}

template <int DK, int DV>
constexpr size_t tc_smem_bytes() {
  return (static_cast<size_t>(TC_ROWS + 2 * TC_KEYS) * (DK + 8) +
          static_cast<size_t>(2 * TC_KEYS) * (DV + 8)) *
         sizeof(__nv_bfloat16);
}

template <int DK, int DV>
int launch_tc(const void* q, const void* k, const void* v, void* out, int bh,
              int bg, int n, int d, int dv, int blk, int causal, float scale,
              cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes<DK, DV>();
  cudaError_t err = lln::allow_smem(block_diag_tc_kernel<DK, DV>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = d % 8 == 0 && dv % 8 == 0 && al(q) && al(k) && al(v) &&
                  al(out);
  const int nb = (n + blk - 1) / blk;
  const int nch = (dv + DV - 1) / DV;
  const dim3 grid(bh, nb, (blk + TC_ROWS - 1) / TC_ROWS * nch);
  block_diag_tc_kernel<DK, DV><<<grid, 128, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      n, d, dv, bh / bg, blk, causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int tc_attrs(int* out) {
  return static_cast<int>(kernel_attrs(block_diag_tc_kernel<DK, DV>, 128,
                                       tc_smem_bytes<DK, DV>(), out));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qtile is the fp32 kernel's query tile.
// bf16 with D, Dv <= 256 takes the tensor cores, the rest the CUDA cores.
// Returns cudaGetLastError().
extern "C" int block_diag_launch(const void* q, const void* k, const void* v,
                                 void* out, int bh, int bg, int n, int d,
                                 int dv, int blk, int causal, int dtype,
                                 int qtile, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d <= 64 && dv <= 64)
    return launch_tc<64, 64>(q, k, v, out, bh, bg, n, d, dv, blk, causal,
                             scale, st);
  if (dtype == 1 && d <= 128 && dv <= 128)
    return launch_tc<128, 128>(q, k, v, out, bh, bg, n, d, dv, blk, causal,
                               scale, st);
  if (dtype == 1 && d <= 192 && dv <= 256)
    return launch_tc<192, 128>(q, k, v, out, bh, bg, n, d, dv, blk, causal,
                               scale, st);
  if (dtype == 1 && d <= 256 && dv <= 256)
    return launch_tc<256, 128>(q, k, v, out, bh, bg, n, d, dv, blk, causal,
                               scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, out, bh, bg, n, d, dv, blk, causal, qtile,
                         scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, bh, bg, n, d, dv, blk, causal,
                                 qtile, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel bf16 (d, dv) takes: out[0..3] = registers a
// thread, local (spill) bytes a thread, CTAs per SM, dynamic shared bytes
// (lln::kernel_attrs).
extern "C" int block_diag_tc_attrs(int d, int dv, void* out) {
  int* o = static_cast<int*>(out);
  if (d <= 64 && dv <= 64) return tc_attrs<64, 64>(o);
  if (d <= 128 && dv <= 128) return tc_attrs<128, 128>(o);
  if (d <= 192 && dv <= 256) return tc_attrs<192, 128>(o);
  if (d <= 256 && dv <= 256) return tc_attrs<256, 128>(o);
  return static_cast<int>(cudaErrorInvalidValue);
}
