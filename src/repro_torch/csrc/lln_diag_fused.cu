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
// Two paths, chosen by the caller (kernels/lln_attention.py) by type and
// width, each with its own entry point:
//
// bf16 with D, Dv <= 256 (every model path on the card):
// lln_diag_fused_tc_launch, on the tensor cores, chunk-parallel over the
// blk blocks, as the reference's s_acc / z_acc chunks.  Four launches:
//   1. phi_split (csrc/fused_state.cuh), twice: Phi(q) and Phi(k) as two
//      bf16 planes, hi + lo.
//   2. state_kernel: the exclusive block states (S_c, z_c) of every kv
//      group, once per group (not per query head), in a fixed order.
//   3. fused_tc_kernel: one CTA of 4 warps per (query head, block, 64-row
//      tile), the r heads of a group side by side in the grid (L2 reuse),
//      the tiles that walk the most keys first.  It walks the block's keys
//      from b0 up to its diagonal once, in 16- or 32-key tiles of k, v and
//      Phi(k) hi / lo staged by cp.async (double-buffered), and on those
//      shared loads computes both halves of the reference: the diag
//      softmax (q k^T, one exact bf16 MMA; online in log2 units in the
//      accumulators, masked on the diagonal tiles only; p V with p as hi +
//      lo, two MMAs) and the LLN intra-block part (Phi(q) Phi(k)^T, both
//      sides hi + lo, three MMAs; its row sums for den; scores V, two
//      MMAs).  Then Phi(q) S_c (three MMAs) and Phi(q) . z_c (fp32, with
//      Phi(q) = exp(qs) exact), den, and 0.5 (lln + diag) rounded once.
//   Bound on the H100: the products at the bf16 tensor-core rate, an fp32
//   operand counted once per MMA it takes, with the softmax steps and the
//   exps as fp32 work (chip_smoke.py:_fused_counts); at the training shape
//   the operations and the bytes are about equal.
//   Widths: fused_tc_kernel<DK, DV> takes the padded q/k width DK (64,
//   128, 192, 256) apart from DV, the value columns of one CTA (DK up to
//   128, else 128), so that the od / ol accumulators stay at 2 x DV / 8
//   tiles a warp.  q k^T and Phi(q) Phi(k)^T run over all of D in 16-deep
//   steps; above Dv = 128 (paligemma's D = Dv = 256) a CTA per 128-column
//   chunk of Dv recomputes its tile's scores and reads its columns of v
//   and S_c, and chunk 0 writes den.  MLA (D = 192, Dv = 128) takes one
//   chunk.  Shared memory 87 KB at DK = 128 (two CTAs per SM), 124 KB at
//   192 and 161 KB at 256 (one).
//
// fp32, or a width above 256: lln_diag_fused_launch, the CUDA-core kernel
// below, IEEE fp32.  One CTA per (query head, COLS value columns) walks the
// sequence in TILE-row tiles (TILE divides blk, so a tile never straddles
// a diag block; at most 64 rows, fewer where the shared memory would pass
// the block's limit, as at D = 256) and keeps its columns of the LLN state S and all of z in
// shared memory, as csrc/lln_causal.cu does.  Per tile it computes the
// LLN rows (intra-tile scores, den, (scores V + Phi(q) S) / den), advances
// (S, z), then the diag rows: the scores of q*D^-1/2 against the block's
// keys up to the tile's last row (streamed in TILE-row chunks, masked
// -1e30 above the diagonal), the reference's softmax (subtract the row
// max, exponentiate, divide by the sum) and P V for its columns; it writes
// 0.5 * (lln + diag) once.  Each column group recomputes the tile's scores
// and probabilities; the first one writes den.  Value columns past Dv
// (when COLS does not divide it) hold stale values that reach only columns
// that are never written.
#include "fused_state.cuh"
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
  const auto smem_bytes = [&](int tile) {
    const size_t t = static_cast<size_t>(tile);
    return (t * (d + 1) + t * ((d > cols ? d : cols) + 1) + t * cols * 3 +
            t * (tile + 1) + t * (blk + 1) + static_cast<size_t>(d) * cols +
            d + t) * sizeof(float);
  };
  // The largest tile (a power of two that divides blk, at most 64) whose
  // shared memory fits the block's opt-in limit: at D = Dv = 256 and blk
  // 256 (paligemma) 64 rows take 272,640 bytes and 32 rows 149,120.  Any
  // width that fit before keeps its tile, and so its results bit for bit.
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int tile = lln::tile_for(blk, 64);
  while (tile > 1 && smem_bytes(tile) > static_cast<size_t>(limit)) tile /= 2;
  const size_t bytes = smem_bytes(tile);
  err = lln::allow_smem(lln_diag_fused_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (dv + cols - 1) / cols);
  lln_diag_fused_kernel<T><<<grid, 256, bytes, stream>>>(
      qs, ks, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), den, n, d, dv, bh / bg,
      blk, tile, cols, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.
// ---------------------------------------------------------------------------

using namespace lln;

constexpr int TC_ROWS = 64;   // query rows per CTA (4 warps x 16)

// Key rows per staged tile: 16 at DK = 128 leaves room for two CTAs per SM.
template <int DK>
__host__ __device__ constexpr int key_tile() { return DK > 64 ? 16 : 32; }

// The stages: two of k and the Phi(k) planes (at DK) and v (at DV), which
// also take the 2 x 64 rows of S_c (hi, lo; at DV) for Phi(q) S_c.
template <int DK, int DV>
__host__ __device__ constexpr size_t stage_elems() {
  constexpr size_t keys =
      2 * key_tile<DK>() * (3 * (DK + 8) + static_cast<size_t>(DV + 8));
  constexpr size_t state = 2 * 64 * static_cast<size_t>(DV + 8);
  return keys > state ? keys : state;
}

// q and the Phi(q) planes (64 rows at DK), the stages, Phi(q) . z_c.
template <int DK, int DV>
constexpr size_t tc_smem_bytes() {
  return (3 * TC_ROWS * static_cast<size_t>(DK + 8) + stage_elems<DK, DV>()) *
             sizeof(__nv_bfloat16) +
         TC_ROWS * sizeof(float);
}

// phq (2,BH,N,D) and phk (2,BG,N,D): Phi(q) and Phi(k) hi, then lo at
// + qcount / + kcount; sst (2,BG,nb,D,Dv) and zst (BG,nb,D): the
// exclusive block states, lo at + scount.  DK: the padded q/k width, a
// multiple of 16 >= d; DV: the value columns of one CTA (all of dv when dv
// <= DV, else chunks of DV, blockIdx.z = tile * chunks + chunk; each
// chunk recomputes the tile's scores, and chunk 0 writes den).
template <int DK, int DV>
__global__ void __launch_bounds__(128, 2)
fused_tc_kernel(const float* __restrict__ qs,
                const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ phq,
                const __nv_bfloat16* __restrict__ phk,
                const __nv_bfloat16* __restrict__ sst,
                const float* __restrict__ zst, __nv_bfloat16* __restrict__ out,
                float* __restrict__ den_out, int n, int d, int dv, int r,
                int blk, size_t qcount, size_t kcount, size_t scount,
                float scale, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DK + 8;
  constexpr int LV = DV + 8;
  constexpr int KT = key_tile<DK>();
  constexpr int NS = KT / 8;           // score tiles of 8 keys per warp
  constexpr int NO = DV / 8;           // output tiles of 8 columns per warp
  constexpr int TS = TC_ROWS * LD;
  constexpr int KS = KT * LD;
  constexpr int SS = 3 * KS + KT * LV;   // one stage: k, Phi(k) hi, lo, v
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sfh = sq + TS;        // Phi(q) hi
  __nv_bfloat16* sfl = sfh + TS;       // Phi(q) lo (planes TS apart)
  __nv_bfloat16* stg = sfl + TS;       // 2 stages, then S_c
  float* pz = reinterpret_cast<float*>(stg + stage_elems<DK, DV>());

  const int h = blockIdx.x;
  const int kvh = h / r;
  const int c = blockIdx.y;
  const int nb = gridDim.y;
  const int b0 = c * blk;
  const int bend = b0 + blk;
  const int nch = (dv + DV - 1) / DV;  // value chunks
  const int c0 = static_cast<int>(blockIdx.z) % nch * DV;
  const int nt = static_cast<int>(gridDim.z) / nch;
  const int r0 = b0 + (nt - 1 - static_cast<int>(blockIdx.z) / nch) * TC_ROWS;
  if (r0 >= bend) return;              // blk < 64: no rows here
  const int rows = min(TC_ROWS, bend - r0);
  const int nk = r0 + rows - b0;       // the block's keys up to the last row
  const int ntiles = (nk + KT - 1) / KT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ks = (d + 15) / 16;
  const int vw = min(DV, dv - c0);     // this chunk's columns
  const int no = min(NO, ((vw + 15) / 16) * 2);
  const bool vz = vec != 0;
  const size_t hq = static_cast<size_t>(h) * n;
  const size_t hk = static_cast<size_t>(kvh) * n + b0;
  const __nv_bfloat16* kh = k + hk * d;
  const __nv_bfloat16* vh = v + hk * dv + c0;
  const __nv_bfloat16* fkh = phk + hk * d;

  const auto stage_keys = [&](int t, int sb) {
    const int k0 = t * KT, kr = min(KT, nk - k0);
    __nv_bfloat16* s = stg + sb * SS;
    const size_t o = static_cast<size_t>(k0) * d;
    stage_tile<DK>(s, LD, kh + o, d, kr, KT, vz);
    stage_tile<DK>(s + KS, LD, fkh + o, d, kr, KT, vz);
    stage_tile<DK>(s + 2 * KS, LD, fkh + kcount + o, d, kr, KT, vz);
    stage_rows<DV>(s + 3 * KS, LV, vh + static_cast<size_t>(k0) * dv, dv,
                   vw, kr, KT, vz);
  };
  stage_tile<DK>(sq, LD, q + (hq + r0) * d, d, rows, TC_ROWS, vz);
  stage_tile<DK>(sfh, LD, phq + (hq + r0) * d, d, rows, TC_ROWS, vz);
  stage_tile<DK>(sfl, LD, phq + qcount + (hq + r0) * d, d, rows, TC_ROWS, vz);
  stage_keys(0, 0);
  cp_async_commit();

  // Phi(q) . z_c in fp32 with the exact Phi(q) = exp(qs): a warp per row.
  {
    const float* zc = zst + (static_cast<size_t>(kvh) * nb + c) * d;
    for (int i = 0; i < 16; ++i) {
      const int a = warp * 16 + i;
      float s = 0.f;
      if (a < rows && c > 0)
        for (int e = lane; e < d; e += 32)
          s = fmaf(expf(qs[(hq + r0 + a) * d + e]), zc[e], s);
      s = warp_sum(s);
      if (lane == 0) pz[a] = s;
    }
  }

  float od[NO][4], ol[NO][4];
  zero_acc(od);
  zero_acc(ol);
  float m[2] = {kNegInf, kNegInf};   // row max of rows g and g + 8
  float l[2] = {0.f, 0.f};           // this thread's part of the row sums
  float rs[2] = {0.f, 0.f};          // ... and of the LLN score row sums
  const int qw = r0 - b0 + warp * 16;        // the warp's first query
  const int qrow = qw + gq;
  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2 = exp
  const __nv_bfloat16* aq = sq + warp * 16 * LD;
  const __nv_bfloat16* afh = sfh + warp * 16 * LD;

  for (int t = 0; t < ntiles; ++t) {
    const int sb = t & 1;
    if (t + 1 < ntiles) stage_keys(t + 1, sb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* s_k = stg + sb * SS;
    const __nv_bfloat16* s_v = s_k + 3 * KS;

    float s[NS][4], a[NS][4];
    zero_acc(s);
    zero_acc(a);
    mma_abt_p<NS, DK / 16, 1, 1>(s, aq, 0, LD, s_k, 0, LD, ks, lane);
    mma_abt_p<NS, DK / 16, 2, 2>(a, afh, TS, LD, s_k + KS, KS, LD, ks,
                                 lane);
    // Mask above the diagonal (only tiles reaching past the warp's first
    // query need it; keys past the last row lie above every row's).
    const int kb = t * KT;
    const bool edge = kb + KT > qw + 1;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kb + j * 8 + 2 * t4 + (e & 1);
        const int row = qrow + (e >> 1) * 8;
        float x = s[j][e] * sl2, y = a[j][e];
        if (edge && col > row) {
          x = kNegInf;
          y = 0.f;
        }
        s[j][e] = x;
        a[j][e] = y;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
        rs[e >> 1] += y;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(m[hh], mx[hh]);
      const float al = fast_exp2(m[hh] - mn);
      m[hh] = mn;
      l[hh] *= al;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        od[j][2 * hh] *= al;
        od[j][2 * hh + 1] *= al;
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
    mma_pb_p<NO, NS / 2, 2, 1>(od, s, s_v, 0, LV, no, lane);
    mma_pb_p<NO, NS / 2, 2, 1>(ol, a, s_v, 0, LV, no, lane);
    __syncthreads();                 // this stage is free for the prefetch
  }
  cp_async_wait<0>();

  // Phi(q) S_c, 64 rows of S (hi, then lo; this chunk's columns) at a time
  // through the stages.
  if (c > 0) {
    const __nv_bfloat16* sh =
        sst + (static_cast<size_t>(kvh) * nb + c) * d * dv + c0;
    for (int d0 = 0; d0 < d; d0 += 64) {
      const int dr = min(64, d - d0);
      __syncthreads();
      stage_rows<DV>(stg, LV, sh + static_cast<size_t>(d0) * dv, dv, vw, dr,
                     64, vz);
      stage_rows<DV>(stg + 64 * LV, LV,
                     sh + scount + static_cast<size_t>(d0) * dv, dv, vw, dr,
                     64, vz);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mma_ab_p<NO, 4, 2, 2>(ol, afh + d0, TS, LD, stg, 64 * LV, LV,
                            (dr + 15) / 16, no, lane);
    }
  }
  __syncthreads();                   // pz

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    if (a >= rows) continue;
    const float dn = rs[hh] + pz[a] + kEps;
    if (den_out != nullptr && c0 == 0 && t4 == 0) den_out[hq + r0 + a] = dn;
    const float il = 1.f / l[hh];
    __nv_bfloat16* orow = out + (hq + r0 + a) * dv + c0;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int cc = j * 8 + 2 * t4;
      const float x0 = 0.5f * (ol[j][2 * hh] / dn + od[j][2 * hh] * il);
      const float x1 =
          0.5f * (ol[j][2 * hh + 1] / dn + od[j][2 * hh + 1] * il);
      const uint32_t x = pack_bf16(x0, x1);
      if (vz && cc + 1 < vw) {
        *reinterpret_cast<uint32_t*>(orow + cc) = x;
      } else {
        if (cc < vw) orow[cc] = __ushort_as_bfloat16(x & 0xffffu);
        if (cc + 1 < vw) orow[cc + 1] = __ushort_as_bfloat16(x >> 16);
      }
    }
  }
}

template <int DK, int DV>
int launch_tc(const float* qs, const float* ks, const void* q, const void* k,
              const void* v, void* out, float* den, void* phq, void* phk,
              void* sst, float* zst, int bh, int bg, int n, int d, int dv,
              int blk, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t qcount = static_cast<size_t>(bh) * n * d;
  const size_t kcount = static_cast<size_t>(bg) * n * d;
  const int nb = n / blk;
  const size_t scount = static_cast<size_t>(bg) * nb * d * dv;
  const auto fq = static_cast<bf*>(phq);
  const auto fk = static_cast<bf*>(phk);
  const auto sp = static_cast<bf*>(sst);
  cudaError_t err = phi_split<2>(qs, fq, qcount, stream);
  if (err == cudaSuccess) err = phi_split<2>(ks, fk, kcount, stream);
  if (err == cudaSuccess)
    err = block_states<false, 2>(ks, static_cast<const bf*>(v), nullptr,
                                 nullptr, 1.f, sp, zst, nullptr, nullptr, 0,
                                 bg, n, d, dv, 1, blk, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = tc_smem_bytes<DK, DV>();
  err = lln::allow_smem(fused_tc_kernel<DK, DV>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = d % 8 == 0 && dv % 8 == 0 && al(q) && al(k) && al(v) &&
                  al(out) && al(phq) && al(phk) && al(sst);
  const int nch = (dv + DV - 1) / DV;
  const dim3 grid(bh, nb, (blk + TC_ROWS - 1) / TC_ROWS * nch);
  fused_tc_kernel<DK, DV><<<grid, 128, bytes, stream>>>(
      qs, static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), fq, fk, sp, zst, static_cast<bf*>(out), den,
      n, d, dv, bh / bg, blk, qcount, kcount, scount, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int tc_attrs(int* out) {
  return static_cast<int>(kernel_attrs(fused_tc_kernel<DK, DV>, 128,
                                       tc_smem_bytes<DK, DV>(), out));
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

// The bf16 tensor-core path (q, k, v, out bf16; D, Dv <= 256).  phq
// (2,BH,N,D), phk (2,BG,N,D) and sst (2,BG,N/blk,D,Dv) are bf16 scratch,
// zst (BG,N/blk,D) fp32 scratch; den may be null.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
extern "C" int lln_diag_fused_tc_launch(
    const void* qs, const void* ks, const void* q, const void* k,
    const void* v, void* out, void* den, void* phq, void* phk, void* sst,
    void* zst, int bh, int bg, int n, int d, int dv, int blk, float scale,
    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto qsp = static_cast<const float*>(qs);
  auto ksp = static_cast<const float*>(ks);
  auto dp = static_cast<float*>(den);
  auto zp = static_cast<float*>(zst);
  if (blk < 1 || n % blk != 0 || bh % bg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define LLN_FUSED_TC(DK, DV)                                                  \
  return launch_tc<DK, DV>(qsp, ksp, q, k, v, out, dp, phq, phk, sst, zp, bh, \
                           bg, n, d, dv, blk, scale, st)
  if (d <= 64 && dv <= 64) LLN_FUSED_TC(64, 64);
  if (d <= 128 && dv <= 128) LLN_FUSED_TC(128, 128);
  if (d <= 192 && dv <= 256) LLN_FUSED_TC(192, 128);
  if (d <= 256 && dv <= 256) LLN_FUSED_TC(256, 128);
#undef LLN_FUSED_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel bf16 (d, dv) takes: out[0..3] = registers a
// thread, local (spill) bytes a thread, CTAs per SM, dynamic shared bytes
// (lln::kernel_attrs).
extern "C" int lln_diag_fused_tc_attrs(int d, int dv, void* out) {
  int* o = static_cast<int*>(out);
  if (d <= 64 && dv <= 64) return tc_attrs<64, 64>(o);
  if (d <= 128 && dv <= 128) return tc_attrs<128, 128>(o);
  if (d <= 192 && dv <= 256) return tc_attrs<192, 128>(o);
  if (d <= 256 && dv <= 256) return tc_attrs<256, 128>(o);
  return static_cast<int>(cudaErrorInvalidValue);
}
