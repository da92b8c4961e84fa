// Backward of the causal LLN forward (paper eq. 8), from saved residuals.
//
// Replaces src/repro/kernels/lln_backward.py:lln_causal_bwd_pallas.
// Inputs: qs (BH,N,D) and ks (BG,N,D) fp32 (pre-scaled, stabilized);
// v (BG,N,Dv), the cotangent g (BH,N,Dv) and the forward output o (BH,N,Dv)
// in one type (fp32 or bf16); den (BH,N) fp32, the forward's normalizer.
// Outputs, fp32: dqs (BH,N,D), dks (BG,N,D), dv (BG,N,Dv), dks and dv summed
// over the r = BH/BG query heads that share a kv head; w (BH,N) is scratch
// the first kernel writes for the second.
//
// With u = g/den and w = (g.o)/den (lln_backward.py's module docstring):
//   dqs_i = Phi(q)_i * (sum_{j<=i} (u_i.v_j - w_i) Phi(k)_j)
//   dks_j = Phi(k)_j * (sum_{i>=j} (u_i.v_j - w_i) Phi(q)_i)
//   dv_j  = sum_{i>=j} (Phi(q)_i.Phi(k)_j) u_i
// Within a TILE-row tile these sums are the masked tile products; across
// tiles they go through the forward state (S, z) (dq, forward order) and the
// reverse state dS = sum Phi(q) u^T, dz = sum w Phi(q) (dk and dv, last tile
// first).
//
// Two paths, chosen by the caller (kernels/lln_backward.py, by
// lln_attention._tc_path) by type and width, each with its own entry point:
//
// bf16 with D, Dv <= 256 (every model path on the card):
// lln_causal_bwd_tc_launch, on the tensor cores, chunk-parallel over blocks
// of blk rows (lln_attention.TC_BLOCK = 64, the kernels' own choice; any
// N, a short last block masked).  lln_diag_fused_bwd.cu's design without
// its softmax half.  Six launches:
//   1. phi_split (csrc/fused_state.cuh), twice: Phi(q), Phi(k) as three
//      bf16 planes each.
//   2. state_kernel, forward: the exclusive block states (S_c, z_c), once
//      per kv group, recomputed as the forward made them.
//   3. dq_tc_kernel, one CTA per (query head, block, 64-row tile): w =
//      (g . o) / den per row (written for 4 and 5), then over the block's
//      keys up to the diagonal gmat = tril(g v^T / den - w) (g v^T one
//      exact bf16 MMA) and gmat Phi(k) (six MMAs); u S_c^T and w z_c; dqs
//      = Phi(q) (gmat Phi(k) + u S_c^T - w z_c) with the exact exp(qs).
//   4. state_kernel, reverse (cotangent factor 1): the exclusive suffix
//      (dS_c, dz_c) = sums over the later blocks and the r heads of
//      Phi(q)^T u and Phi(q) w, heads then blocks in a fixed order.
//   5. dkv_tc_kernel, two CTAs per (kv group, block, 64-key tile): dks =
//      Phi(k) (gmat^T Phi(q) over the r heads + V dS_c^T - dz_c); dv =
//      scores^T u over the r heads + Phi(k) dS_c.  Each walks the r heads
//      and its block's query tiles in a fixed order; each query tile's
//      products go into a fresh accumulator added to the total in fp32.
//   No atomics: two runs give the same gradients bit for bit.  Every fp32
//   operand goes in as three bf16 planes (2^-24 relative; the gradients
//   are held to 1e-5): against a bf16 operand three MMAs, against another
//   fp32 operand six.
//   Bound on the H100 (chip_smoke.py:_lln_counts): the bytes (qs, ks, the
//   fp32 gradients) over the products at the bf16 rate with the three-plane
//   count.  What holds it back: the reverse state walk (128 CTAs, r x N
//   rows each, in order) and the fragment reloads of the dq and dk/dv
//   kernels.
//   Widths: dq_tc_kernel<DP, OC> and dkv_tc_kernel<DP, OC> take the padded
//   width DP of D and Dv (64, 128, 192, 256) and OC, the output columns of
//   one CTA (DP up to 128, else 128), as lln_diag_fused_bwd.cu's pair does:
//   above 128 a dq CTA writes a 128-column chunk of dqs and each dk/dv
//   role a chunk of its output, each recomputing its tile's scores (g v^T,
//   Phi(k) Phi(q)^T over all of Dv or D in 16-deep steps); the dq stage
//   keeps the Phi(k) planes at the chunk's columns only.  Shared memory at
//   DP = 256: dq 84 KB, dk/dv 169 KB (one CTA per SM); at 192: 65 KB and
//   128 KB.  At paligemma (B 2, G 1, N 512, r 8) the dk/dv grid is 2 x 8
//   blocks x 2 roles x 2 chunks = 64 CTAs, each walking the r heads.
//
// fp32, or a width above 256: lln_causal_bwd_launch, the CUDA-core kernels
// below, IEEE fp32.  dq: the products u S^T and (u.v - w) contract over
// Dv, so a column split of S (as in lln_causal.cu) would not serve; one
// CTA per (query head, ROWS rows of D) keeps those rows of S and z and
// recomputes the tile's (u.v - w) matrix.  dk/dv: dk's dS v contracts over
// Dv and dv's Phi(k) dS over D, so one launch holds two kinds of CTA per
// kv head: dk CTAs keep ROWS rows of dS (all columns), dv CTAs COLS
// columns (all rows).  Pallas kept (dS, dz) per repeated head, (r, D, Dv)
// fp32, more than a block's shared memory at r=8, D=Dv=128; the inter-tile
// terms are linear in (dS, dz), so each CTA keeps their sum over the r
// heads and loops over the heads, in order, only for the intra-tile terms.
// No atomics.  Bound: fp32 operations.
#include "fused_state.cuh"
#include "train_common.cuh"

namespace {

template <typename VT>
__global__ void dq_kernel(const float* __restrict__ qs,
                          const float* __restrict__ ks,
                          const VT* __restrict__ v, const VT* __restrict__ g,
                          const VT* __restrict__ o,
                          const float* __restrict__ den_in,
                          float* __restrict__ dqs, float* __restrict__ w_out,
                          int n, int d, int dv, int r, int tile, int rows) {
  extern __shared__ float smem[];
  const int wv = dv + 1;            // padded rows: conflict-free reads of
  const int rp = rows + 1;          // a column across a warp
  const int tp = tile + 1;
  float* u = smem;                  // tile x wv   g / den
  float* vt = u + tile * wv;        // tile x wv   V of the tile
  float* fk = vt + tile * wv;       // tile x rp   Phi(k), this CTA's D rows
  float* fq = fk + tile * rp;       // tile x rp   Phi(q), this CTA's D rows
  float* gm = fq + tile * rp;       // tile x tp   (u.v - w), masked
  float* S = gm + tile * tp;        // rows x wv   forward state rows
  float* z = S + rows * wv;         // rows
  float* w = z + rows;              // tile
  float* den = w + tile;            // tile

  const int h = blockIdx.x;
  const int kv = h / r;
  const int d0 = blockIdx.y * rows;
  const int rw = min(rows, d - d0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const size_t hq = static_cast<size_t>(h) * n;
  const size_t hk = static_cast<size_t>(kv) * n;

  for (int i = tid; i < rows * wv; i += nt) S[i] = 0.f;
  for (int i = tid; i < rows; i += nt) z[i] = 0.f;

  for (int t0 = 0; t0 < n; t0 += tile) {
    for (int a = tid; a < tile; a += nt) den[a] = den_in[hq + t0 + a];
    __syncthreads();
    lln::load_tile(u, wv, g + (hq + t0) * dv, dv, tile, 0, dv,
                   lln::DivRow{den});
    lln::load_tile(vt, wv, v + (hk + t0) * dv, dv, tile, 0, dv, lln::Ident{});
    lln::load_tile(fk, rp, ks + (hk + t0) * d, d, tile, d0, rw, lln::Exp{});
    lln::load_tile(fq, rp, qs + (hq + t0) * d, d, tile, d0, rw, lln::Exp{});
    for (int a = warp; a < tile; a += nw) {
      float acc = 0.f;
      for (int e = lane; e < dv; e += 32) {
        const size_t at = (hq + t0 + a) * dv + e;
        acc = fmaf(lln::to_f32(g[at]), lln::to_f32(o[at]), acc);
      }
      acc = lln::warp_sum(acc);
      if (lane == 0) {
        w[a] = acc / den[a];
        if (blockIdx.y == 0) w_out[hq + t0 + a] = w[a];
      }
    }
    __syncthreads();
    for (int i = tid; i < tile * tile; i += nt) {
      const int a = i / tile, b = i - a * tile;
      gm[a * tp + b] = b <= a ? lln::dot(u + a * wv, vt + b * wv, dv) - w[a]
                              : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < tile * rw; i += nt) {
      const int a = i / rw, e = i - a * rw;
      float acc = 0.f;
      for (int b = 0; b <= a; ++b) acc = fmaf(gm[a * tp + b], fk[b * rp + e], acc);
      acc += lln::dot(u + a * wv, S + e * wv, dv);
      acc -= w[a] * z[e];
      dqs[(hq + t0 + a) * d + d0 + e] = fq[a * rp + e] * acc;
    }
    __syncthreads();
    for (int i = tid; i < rw * dv; i += nt) {
      const int e = i / dv, c = i - e * dv;
      float acc = 0.f;
      for (int b = 0; b < tile; ++b) acc = fmaf(fk[b * rp + e], vt[b * wv + c], acc);
      S[e * wv + c] += acc;
    }
    for (int e = tid; e < rw; e += nt) {
      float acc = 0.f;
      for (int b = 0; b < tile; ++b) acc += fk[b * rp + e];
      z[e] += acc;
    }
    __syncthreads();
  }
}

// blockIdx.y < ndk: a dk CTA over D rows [y*rows, +rows); otherwise a dv CTA
// over Dv columns [(y-ndk)*cols, +cols).
template <typename VT>
__global__ void dkv_kernel(const float* __restrict__ qs,
                           const float* __restrict__ ks,
                           const VT* __restrict__ v, const VT* __restrict__ g,
                           const float* __restrict__ den_in,
                           const float* __restrict__ w_in,
                           float* __restrict__ dks, float* __restrict__ dvo,
                           int n, int d, int dv, int r, int tile, int rows,
                           int cols, int ndk) {
  extern __shared__ float smem[];
  const int gi = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int tp = tile + 1;
  const size_t hk = static_cast<size_t>(gi) * n;

  if (static_cast<int>(blockIdx.y) < ndk) {
    // ---- dk: rows [d0, d0+rw) of dS, all Dv columns ----------------------
    const int wv = dv + 1;
    const int rp = rows + 1;
    float* vt = smem;               // tile x wv   V of the key tile
    float* fk = vt + tile * wv;     // tile x rp   Phi(k) rows of D
    float* u = fk + tile * rp;      // tile x wv   g / den of one head
    float* fq = u + tile * wv;      // tile x rp   Phi(q) rows of D
    float* gm = fq + tile * rp;     // tile x tp   (u.v - w), masked i >= j
    float* dS = gm + tile * tp;     // rows x wv
    float* dz = dS + rows * wv;     // rows
    float* acc = dz + rows;         // tile x rp   dPhi(k) rows of D
    float* w = acc + tile * rp;     // tile
    float* den = w + tile;          // tile
    const int d0 = blockIdx.y * rows;
    const int rw = min(rows, d - d0);
    for (int i = tid; i < rows * wv; i += nt) dS[i] = 0.f;
    for (int i = tid; i < rows; i += nt) dz[i] = 0.f;
    for (int t0 = n - tile; t0 >= 0; t0 -= tile) {
      __syncthreads();
      lln::load_tile(vt, wv, v + (hk + t0) * dv, dv, tile, 0, dv, lln::Ident{});
      lln::load_tile(fk, rp, ks + (hk + t0) * d, d, tile, d0, rw, lln::Exp{});
      __syncthreads();
      // Inter-tile term from the later tiles' (dS, dz), all r heads.
      for (int i = tid; i < tile * rw; i += nt) {
        const int j = i / rw, e = i - j * rw;
        acc[j * rp + e] = lln::dot(dS + e * wv, vt + j * wv, dv) - dz[e];
      }
      for (int hh = 0; hh < r; ++hh) {
        const size_t hq = (static_cast<size_t>(gi) * r + hh) * n;
        __syncthreads();
        for (int a = tid; a < tile; a += nt) {
          den[a] = den_in[hq + t0 + a];
          w[a] = w_in[hq + t0 + a];
        }
        __syncthreads();
        lln::load_tile(u, wv, g + (hq + t0) * dv, dv, tile, 0, dv,
                       lln::DivRow{den});
        lln::load_tile(fq, rp, qs + (hq + t0) * d, d, tile, d0, rw, lln::Exp{});
        __syncthreads();
        for (int i = tid; i < tile * tile; i += nt) {
          const int a = i / tile, j = i - a * tile;
          gm[a * tp + j] = a >= j ? lln::dot(u + a * wv, vt + j * wv, dv) - w[a]
                                  : 0.f;
        }
        __syncthreads();
        for (int i = tid; i < tile * rw; i += nt) {
          const int j = i / rw, e = i - j * rw;
          float s = acc[j * rp + e];
          for (int a = j; a < tile; ++a) s = fmaf(gm[a * tp + j], fq[a * rp + e], s);
          acc[j * rp + e] = s;
        }
        for (int i = tid; i < rw * dv; i += nt) {
          const int e = i / dv, c = i - e * dv;
          float s = 0.f;
          for (int a = 0; a < tile; ++a) s = fmaf(fq[a * rp + e], u[a * wv + c], s);
          dS[e * wv + c] += s;
        }
        for (int e = tid; e < rw; e += nt) {
          float s = 0.f;
          for (int a = 0; a < tile; ++a) s = fmaf(w[a], fq[a * rp + e], s);
          dz[e] += s;
        }
      }
      __syncthreads();
      for (int i = tid; i < tile * rw; i += nt) {
        const int j = i / rw, e = i - j * rw;
        dks[(hk + t0 + j) * d + d0 + e] = fk[j * rp + e] * acc[j * rp + e];
      }
    }
    return;
  }

  // ---- dv: columns [c0, c0+cw) of dS, all D rows -------------------------
  const int dp = d + 1;
  const int cp = cols + 1;
  float* fk = smem;                 // tile x dp   Phi(k) of the key tile
  float* fq = fk + tile * dp;       // tile x dp   Phi(q) of one head
  float* u = fq + tile * dp;        // tile x cp   g / den, this CTA's columns
  float* sc = u + tile * cp;        // tile x tp   Phi(q).Phi(k), masked i >= j
  float* dS = sc + tile * tp;       // d x cols
  float* acc = dS + d * cols;       // tile x cp   dv columns
  float* den = acc + tile * cp;     // tile
  const int c0 = (blockIdx.y - ndk) * cols;
  const int cw = min(cols, dv - c0);
  for (int i = tid; i < d * cols; i += nt) dS[i] = 0.f;
  for (int t0 = n - tile; t0 >= 0; t0 -= tile) {
    __syncthreads();
    lln::load_tile(fk, dp, ks + (hk + t0) * d, d, tile, 0, d, lln::Exp{});
    __syncthreads();
    for (int i = tid; i < tile * cw; i += nt) {
      const int j = i / cw, c = i - j * cw;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(fk[j * dp + e], dS[e * cols + c], s);
      acc[j * cp + c] = s;
    }
    for (int hh = 0; hh < r; ++hh) {
      const size_t hq = (static_cast<size_t>(gi) * r + hh) * n;
      __syncthreads();
      for (int a = tid; a < tile; a += nt) den[a] = den_in[hq + t0 + a];
      lln::load_tile(fq, dp, qs + (hq + t0) * d, d, tile, 0, d, lln::Exp{});
      __syncthreads();
      lln::load_tile(u, cp, g + (hq + t0) * dv, dv, tile, c0, cw,
                     lln::DivRow{den});
      for (int i = tid; i < tile * tile; i += nt) {
        const int a = i / tile, j = i - a * tile;
        sc[a * tp + j] = a >= j ? lln::dot(fq + a * dp, fk + j * dp, d) : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < tile * cw; i += nt) {
        const int j = i / cw, c = i - j * cw;
        float s = acc[j * cp + c];
        for (int a = j; a < tile; ++a) s = fmaf(sc[a * tp + j], u[a * cp + c], s);
        acc[j * cp + c] = s;
      }
      for (int i = tid; i < d * cw; i += nt) {
        const int e = i / cw, c = i - e * cw;
        float s = 0.f;
        for (int a = 0; a < tile; ++a) s = fmaf(fq[a * dp + e], u[a * cp + c], s);
        dS[e * cols + c] += s;
      }
    }
    __syncthreads();
    for (int i = tid; i < tile * cw; i += nt) {
      const int j = i / cw, c = i - j * cw;
      dvo[(hk + t0 + j) * dv + c0 + c] = acc[j * cp + c];
    }
  }
}

template <typename VT>
int launch(const float* qs, const float* ks, const void* v, const void* g,
           const void* o, const float* den, float* dqs, float* dks, float* dv_,
           float* w, int bh, int bg, int n, int d, int dv, int blk, int rows,
           int cols, cudaStream_t stream) {
  if (n % blk != 0 || bh % bg != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = lln::tile_for(blk, 64);
  const int r = bh / bg;
  const size_t tf = static_cast<size_t>(tile);
  const size_t dq_floats = tf * (dv + 1) * 2 + tf * (rows + 1) * 2 +
                           tf * (tile + 1) +
                           static_cast<size_t>(rows) * (dv + 1) + rows + 2 * tf;
  const size_t dk_floats = tf * (dv + 1) * 2 + tf * (rows + 1) * 3 +
                           tf * (tile + 1) +
                           static_cast<size_t>(rows) * (dv + 1) + rows + 2 * tf;
  const size_t dvk_floats = tf * (d + 1) * 2 + tf * (cols + 1) * 2 +
                            tf * (tile + 1) + static_cast<size_t>(d) * cols +
                            tf;
  const size_t dq_bytes = dq_floats * sizeof(float);
  const size_t dkv_bytes = (dk_floats > dvk_floats ? dk_floats : dvk_floats) *
                           sizeof(float);
  cudaError_t err = lln::allow_smem(dq_kernel<VT>, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lln::allow_smem(dkv_kernel<VT>, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto vp = static_cast<const VT*>(v);
  const auto gp = static_cast<const VT*>(g);
  dq_kernel<VT><<<dim3(bh, (d + rows - 1) / rows), 256, dq_bytes, stream>>>(
      qs, ks, vp, gp, static_cast<const VT*>(o), den, dqs, w, n, d, dv, r,
      tile, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ndk = (d + rows - 1) / rows;
  const int ndv = (dv + cols - 1) / cols;
  dkv_kernel<VT><<<dim3(bg, ndk + ndv), 256, dkv_bytes, stream>>>(
      qs, ks, vp, gp, den, w, dks, dv_, n, d, dv, r, tile, rows, cols, ndk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.
// ---------------------------------------------------------------------------

using namespace lln;

constexpr int TC_ROWS = 64;   // query rows (dq) or keys (dk/dv) per CTA
// bf16 planes of every fp32 operand: three keep it to 2^-24 relative, so
// the fp32 gradients stay within 1e-5 of the largest entry.
constexpr int NP = 3;

// Rows of a staged key tile (dq) or query tile (dk/dv).
template <int DP>
__host__ __device__ constexpr int step_rows() { return DP > 64 ? 16 : 32; }

// The dq kernel: the g tile, then two stages of v (at DP) and the Phi(k)
// planes (at the CTA's OC output columns), which also take the NP x 32 rows
// of S_c that state_t_all stages.
template <int DP, int OC>
constexpr size_t dq_smem_bytes() {
  constexpr size_t keys =
      2 * step_rows<DP>() * ((DP + 8) + NP * static_cast<size_t>(OC + 8));
  constexpr size_t state = NP * 32 * static_cast<size_t>(DP + 8);
  return (TC_ROWS * static_cast<size_t>(DP + 8) +
          (keys > state ? keys : state)) *
         sizeof(__nv_bfloat16);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return (NP * TC_ROWS + 2 * (1 + NP) * step_rows<DP>()) * (DP + 8) *
             sizeof(__nv_bfloat16) +
         2 * 2 * step_rows<DP>() * sizeof(float);
}

// One CTA per (query head, block, 64-row tile), the tiles that walk the
// most keys first: w = (g . o) / den per row (written to w_out), then
// gmat = tril(g v^T / den - w) per key tile against v and the Phi(k)
// planes (cp.async, double-buffered), dqs += gmat Phi(k); then u S_c^T,
// - w z_c, and dqs = Phi(q) (...) with the exact Phi(q) = exp(qs).  phk
// (NP,BG,N,D): Phi(k) planes kcount apart; sst (NP,BG,nb,D,Dv) and zst
// (BG,nb,D): the forward's exclusive block states.  DP: the padded width
// of D and Dv; OC: the columns of dqs one CTA writes (all of D when D <=
// OC, else chunks of OC, blockIdx.z = tile * chunks + chunk; chunk 0
// writes w).
template <int DP, int OC>
__global__ void __launch_bounds__(128, 2)
dq_tc_kernel(const float* __restrict__ qs,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ g,
             const __nv_bfloat16* __restrict__ o,
             const float* __restrict__ den_in,
             const __nv_bfloat16* __restrict__ phk,
             const __nv_bfloat16* __restrict__ sst,
             const float* __restrict__ zst, float* __restrict__ dqs,
             float* __restrict__ w_out, int n, int d, int dv, int r, int blk,
             size_t kcount, size_t scount, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 8;
  constexpr int LF = OC + 8;           // the Phi(k) planes' row
  constexpr int KT = step_rows<DP>();
  constexpr int NS = KT / 8;
  constexpr int NO = OC / 8;
  constexpr int KS = KT * LD;
  constexpr int KF = KT * LF;
  constexpr int SS = KS + NP * KF;     // one stage: v, Phi(k) planes
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stg = sg + TC_ROWS * LD;   // 2 stages

  const int h = blockIdx.x;
  const int kvh = h / r;
  const int c = blockIdx.y;
  const int nb = gridDim.y;
  const int b0 = c * blk;
  const int bend = min(b0 + blk, n);
  const int nch = (d + OC - 1) / OC;   // column chunks of dqs
  const int ch = static_cast<int>(blockIdx.z) % nch;
  const int c0 = ch * OC;
  const int cw = min(OC, d - c0);
  const int nt = static_cast<int>(gridDim.z) / nch;
  const int r0 =
      b0 + (nt - 1 - static_cast<int>(blockIdx.z) / nch) * TC_ROWS;
  if (r0 >= bend) return;
  const int rows = min(TC_ROWS, bend - r0);
  const int nk = r0 + rows - b0;
  const int ntiles = (nk + KT - 1) / KT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int kvs = (dv + 15) / 16;
  const int nod = min(NO, ((cw + 15) / 16) * 2);
  const bool vz = vec != 0;
  const size_t hq = static_cast<size_t>(h) * n;
  const size_t hk = static_cast<size_t>(kvh) * n + b0;
  const __nv_bfloat16* vh = v + hk * dv;
  const __nv_bfloat16* fkh = phk + hk * d;

  const auto stage_keys = [&](int t, int sb) {
    const int k0 = t * KT, kr = min(KT, nk - k0);
    __nv_bfloat16* s = stg + sb * SS;
    const size_t off = static_cast<size_t>(k0) * d;
    stage_tile<DP>(s, LD, vh + static_cast<size_t>(k0) * dv, dv, kr, KT, vz);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      stage_rows<OC>(s + KS + p * KF, LF, fkh + p * kcount + off + c0, d, cw,
                     kr, KT, vz);
  };
  stage_tile<DP>(sg, LD, g + (hq + r0) * dv, dv, rows, TC_ROWS, vz);
  stage_keys(0, 0);
  cp_async_commit();

  // g . o per row in fp32 (a warp per row); every lane gets the sum, and
  // the lanes that own rows gq and gq + 8 of the warp keep it.
  float go[2] = {0.f, 0.f};
  for (int i = 0; i < 16; ++i) {
    const int a = warp * 16 + i;
    float sum = 0.f;
    if (a < rows) {
      const size_t at = (hq + r0 + a) * dv;
      for (int e = lane; e < dv; e += 32)
        sum = fmaf(__bfloat162float(g[at + e]), __bfloat162float(o[at + e]),
                   sum);
    }
    sum = warp_sum(sum);
    if (i == gq) go[0] = sum;
    if (i == gq + 8) go[1] = sum;
  }
  float w[2], hd[2];                 // w and 1 / den of rows gq, gq + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    const float dn = a < rows ? den_in[hq + r0 + a] : 1.f;
    hd[hh] = a < rows ? 1.f / dn : 0.f;
    w[hh] = a < rows ? go[hh] / dn : 0.f;
    if (ch == 0 && a < rows && t4 == 0) w_out[hq + r0 + a] = w[hh];
  }

  float as[NO][4];                   // gmat Phi(k), then + u S_c^T
  zero_acc(as);
  const int qw = r0 - b0 + warp * 16;
  const int qrow = qw + gq;
  const __nv_bfloat16* wg = sg + warp * 16 * LD;

  for (int t = 0; t < ntiles; ++t) {
    const int sb = t & 1;
    if (t + 1 < ntiles) stage_keys(t + 1, sb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* s_v = stg + sb * SS;
    float dp[NS][4];
    zero_acc(dp);
    mma_abt_p<NS, DP / 16, 1, 1>(dp, wg, 0, LD, s_v, 0, LD, kvs,
                                 lane);                             // g v^T
    // Mask above the diagonal (keys past the last row lie above every
    // row's, so a short last tile is masked too).
    const int kb = t * KT;
    const bool edge = kb + KT > qw + 1;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int col = kb + j * 8 + 2 * t4 + (e & 1);
        dp[j][e] = edge && col > qrow + hh * 8 ? 0.f
                                                : dp[j][e] * hd[hh] - w[hh];
      }
    }
    mma_pb_p<NO, NS / 2, NP, NP>(as, dp, s_v + KS, KF, LF, nod,
                                 lane);                    // gmat Phi(k)
    __syncthreads();                 // this stage is free for the prefetch
  }
  cp_async_wait<0>();

  // u S_c^T = (g S_c^T) / den: the accumulator is scaled by den, g S_c^T
  // added 32 rows of S (this CTA's columns of dqs) at a time, and scaled
  // back.
  const float* zc = zst + (static_cast<size_t>(kvh) * nb + c) * d;
  if (c > 0) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (hd[e >> 1] > 0.f) as[j][e] /= hd[e >> 1];
    }
    state_t_all<DP, NP>(as, wg, stg,
                        sst + (static_cast<size_t>(kvh) * nb + c) * d * dv,
                        scount, d, dv, kvs, vz, lane, c0);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) as[j][e] *= hd[e >> 1];
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    if (a >= rows) continue;
    const size_t at = (hq + r0 + a) * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int cc = c0 + j * 8 + 2 * t4;
      if (cc >= d) break;
      float s0 = as[j][2 * hh], s1 = as[j][2 * hh + 1];
      if (c > 0) {
        s0 -= w[hh] * zc[cc];
        if (cc + 1 < d) s1 -= w[hh] * zc[cc + 1];
      }
      s0 *= expf(qs[at + cc]);
      if (cc + 1 < d) s1 *= expf(qs[at + cc + 1]);
      if (vz) {
        *reinterpret_cast<float2*>(dqs + at + cc) = make_float2(s0, s1);
      } else {
        dqs[at + cc] = s0;
        if (cc + 1 < d) dqs[at + cc + 1] = s1;
      }
    }
  }
}

// Two CTAs per key tile z / 2, by z % 2: the dks role (gmat^T Phi(q) over
// the r heads, V dS_c^T, - dz_c, times the exact Phi(k) = exp(ks)) and the
// dv role ((scores / den)^T g over the r heads, Phi(k) dS_c).  Each walks
// the r heads and its block's query tiles from its own rows to the block's
// end in a fixed order; each query tile's products go into a fresh
// accumulator that is then added to the total in fp32 (the tensor cores'
// own accumulation does not round to nearest).  phq (NP,BH,N,D), phk
// (NP,BG,N,D); w (BH,N) from dq_tc_kernel; dsst (NP,BG,nb,D,Dv) and dzst
// (BG,nb,D): the reverse exclusive block states.  Each CTA writes OC
// columns of its output (all of them when its width is at most OC; z / 2
// = tile * chunks + chunk), and recomputes its query tiles' scores.
template <int DP, int OC>
__global__ void __launch_bounds__(128, 2)
dkv_tc_kernel(const float* __restrict__ ks_in,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ g,
              const float* __restrict__ den_in,
              const float* __restrict__ w_in,
              const __nv_bfloat16* __restrict__ phq,
              const __nv_bfloat16* __restrict__ phk,
              const __nv_bfloat16* __restrict__ dsst,
              const float* __restrict__ dzst, float* __restrict__ dks,
              float* __restrict__ dvo, int n, int d, int dv, int r, int blk,
              size_t qcount, size_t kcount, size_t scount, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 8;
  constexpr int QT = step_rows<DP>();
  constexpr int NQ = QT / 8;           // score tiles of 8 queries per warp
  constexpr int NO = OC / 8;
  constexpr int TS = TC_ROWS * LD;
  constexpr int QS = QT * LD;
  constexpr int SS = (1 + NP) * QS;    // one stage: Phi(q) planes, g
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);  // V or Phi(k)
  __nv_bfloat16* stg = sx + NP * TS;   // 2 stages
  float* sst_ = reinterpret_cast<float*>(stg + 2 * SS);  // 2 x 2 x QT

  const int kv = blockIdx.x;
  const int c = blockIdx.y;
  const int nb = gridDim.y;
  const int role = blockIdx.z & 1;     // 0 dks, 1 dv
  const int nch = ((d > dv ? d : dv) + OC - 1) / OC;
  const int zc = static_cast<int>(blockIdx.z >> 1);
  const int c0 = zc % nch * OC;        // this CTA's first output column
  const int w = role == 1 ? dv : d;    // its output's width
  const int b0 = c * blk;
  const int bend = min(b0 + blk, n);
  const int kb0 = b0 + zc / nch * TC_ROWS;
  if (kb0 >= bend || c0 >= w) return;
  const int kr = min(TC_ROWS, bend - kb0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ks = (d + 15) / 16, kvs = (dv + 15) / 16;
  const int nout = min(NO, ((min(OC, w - c0) + 15) / 16) * 2);
  const bool vz = vec != 0;
  const size_t hk = static_cast<size_t>(kv) * n;
  const int nqt = (bend - kb0 + QT - 1) / QT;
  const int steps = r * nqt;
  const int key = kb0 + warp * 16 + gq;   // this thread's first key

  const auto stage_q = [&](int step, int sb) {
    const int hh = step / nqt, i0 = kb0 + (step - hh * nqt) * QT;
    const int rows = min(QT, bend - i0);
    const size_t hq = (static_cast<size_t>(kv) * r + hh) * n + i0;
    __nv_bfloat16* s = stg + sb * SS;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      stage_tile<DP>(s + p * QS, LD, phq + p * qcount + hq * d, d, rows, QT,
                     vz);
    stage_tile<DP>(s + NP * QS, LD, g + hq * dv, dv, rows, QT, vz);
    float* ss = sst_ + sb * 2 * QT;
    for (int i = threadIdx.x; i < QT; i += blockDim.x) {
      const bool ok = i < rows;
      ss[i] = ok ? w_in[hq + i] : 0.f;
      ss[QT + i] = ok ? 1.f / den_in[hq + i] : 0.f;
    }
  };

  if (role == 0) {
    stage_tile<DP>(sx, LD, v + (hk + kb0) * dv, dv, kr, TC_ROWS, vz);
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      stage_tile<DP>(sx + p * TS, LD, phk + p * kcount + (hk + kb0) * d, d,
                     kr, TC_ROWS, vz);
  }
  stage_q(0, 0);
  cp_async_commit();

  float acc[NO][4], part[NO][4];
  zero_acc(acc);
  const __nv_bfloat16* wx = sx + warp * 16 * LD;

  for (int st = 0; st < steps; ++st) {
    const int sb = st & 1;
    if (st + 1 < steps) stage_q(st + 1, sb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int i0 = kb0 + (st % nqt) * QT;
    const int rows = min(QT, bend - i0);
    const __nv_bfloat16* tf = stg + sb * SS;
    const __nv_bfloat16* tg = tf + NP * QS;
    const float* ss = sst_ + sb * 2 * QT;
    // Masks where a query lies before one of the warp's keys or past the
    // block's end.
    const bool edge = i0 < kb0 + warp * 16 + 16 || rows < QT;
    float xt[NQ][4];
    zero_acc(xt);
    if (role == 0)
      mma_abt_p<NQ, DP / 16, 1, 1>(xt, wx, 0, LD, tg, 0, LD, kvs,
                                   lane);                          // v g^T
    else
      mma_abt_p<NQ, DP / 16, NP, NP>(xt, wx, TS, LD, tf, QS, LD, ks,
                                     lane);       // Phi(k) Phi(q)^T
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cq = j * 8 + 2 * t4 + (e & 1);     // query in the tile
        const int kj = key + (e >> 1) * 8;
        const bool ok = !edge || (cq < rows && i0 + cq >= kj);
        const float x = xt[j][e] * ss[QT + cq];
        // gmat^T = v g^T / den - w (dks), scores / den (dv).
        xt[j][e] = !ok ? 0.f : role == 0 ? x - ss[cq] : x;
      }
    }
    zero_acc(part);
    if (role == 0)
      mma_pb_p<NO, NQ / 2, NP, NP>(part, xt, tf + c0, QS, LD, nout,
                                   lane);                        // Phi(q)
    else
      mma_pb_p<NO, NQ / 2, NP, 1>(part, xt, tg + c0, 0, LD, nout,
                                  lane);                              // g
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    __syncthreads();                 // this stage is free for the prefetch
  }
  cp_async_wait<0>();

  // The later blocks' reverse state: V dS_c^T (dks) or Phi(k) dS_c (dv).
  if (c < nb - 1) {
    const __nv_bfloat16* sp =
        dsst + (static_cast<size_t>(kv) * nb + c) * d * dv;
    zero_acc(part);
    if (role == 0) {
      state_t_all<DP, NP>(part, wx, stg, sp, scount, d, dv, kvs, vz, lane,
                          c0);
    } else {
      for (int d0 = 0; d0 < d; d0 += 32) {
        __syncthreads();
        stage_state<DP, NP>(stg, sp, scount, d0, d, dv, vz);
        mma_ab_p<NO, 2, NP, NP>(part, wx + d0, TS, LD, stg + c0, 32 * LD,
                                LD, (min(32, d - d0) + 15) / 16, nout, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }

  const float* dzc = dzst + (static_cast<size_t>(kv) * nb + c) * d;
  float* out = role == 0 ? dks : dvo;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j0 = warp * 16 + gq + hh * 8;
    if (j0 >= kr) continue;
    const size_t row = hk + kb0 + j0;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int cc = c0 + j * 8 + 2 * t4;
      if (cc >= w) break;
      float x0 = acc[j][2 * hh], x1 = acc[j][2 * hh + 1];
      if (role == 0) {           // dks = Phi(k) (... - dz_c)
        if (c < nb - 1) {
          x0 -= dzc[cc];
          if (cc + 1 < d) x1 -= dzc[cc + 1];
        }
        x0 *= expf(ks_in[row * d + cc]);
        if (cc + 1 < d) x1 *= expf(ks_in[row * d + cc + 1]);
      }
      if (vz) {
        *reinterpret_cast<float2*>(out + row * w + cc) = make_float2(x0, x1);
      } else {
        out[row * w + cc] = x0;
        if (cc + 1 < w) out[row * w + cc + 1] = x1;
      }
    }
  }
}

template <int DP, int OC>
int launch_tc(const float* qs, const float* ks, const void* v, const void* g,
              const void* o, const float* den, float* dqs, float* dks,
              float* dv_, float* w, void* phq, void* phk, void* sst,
              float* zst, void* dsst, float* dzst, int bh, int bg, int n,
              int d, int dv, int blk, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int r = bh / bg;
  const int nb = (n + blk - 1) / blk;
  const size_t qcount = static_cast<size_t>(bh) * n * d;
  const size_t kcount = static_cast<size_t>(bg) * n * d;
  const size_t scount = static_cast<size_t>(bg) * nb * d * dv;
  const auto vp = static_cast<const bf*>(v);
  const auto gp = static_cast<const bf*>(g);
  const auto fq = static_cast<bf*>(phq);
  const auto fk = static_cast<bf*>(phk);
  const auto sp = static_cast<bf*>(sst);
  const auto dsp = static_cast<bf*>(dsst);
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = d % 8 == 0 && dv % 8 == 0 && al(v) && al(g) && al(phq) &&
                  al(phk) && al(sst) && al(dsst) && al(dqs) && al(dks) &&
                  al(dv_);
  cudaError_t err = phi_split<NP>(qs, fq, qcount, stream);
  if (err == cudaSuccess) err = phi_split<NP>(ks, fk, kcount, stream);
  if (err == cudaSuccess)
    err = block_states<false, NP>(ks, vp, nullptr, nullptr, 1.f, sp, zst,
                                  nullptr, nullptr, 0, bg, n, d, dv, 1, blk,
                                  stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dq_bytes = dq_smem_bytes<DP, OC>();
  const size_t dkv_bytes = dkv_smem_bytes<DP>();
  err = lln::allow_smem(dq_tc_kernel<DP, OC>, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lln::allow_smem(dkv_tc_kernel<DP, OC>, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (blk + TC_ROWS - 1) / TC_ROWS;
  const int dq_chunks = (d + OC - 1) / OC;
  const int dkv_chunks = ((d > dv ? d : dv) + OC - 1) / OC;
  dq_tc_kernel<DP, OC><<<dim3(bh, nb, nt * dq_chunks), 128, dq_bytes,
                         stream>>>(
      qs, vp, gp, static_cast<const bf*>(o), den, fk, sp, zst, dqs, w, n, d,
      dv, r, blk, kcount, scount, vec);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = block_states<true, NP>(qs, gp, den, w, 1.f, dsp, dzst, nullptr,
                                 nullptr, 0, bg, n, d, dv, r, blk, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_tc_kernel<DP, OC><<<dim3(bg, nb, 2 * nt * dkv_chunks), 128, dkv_bytes,
                          stream>>>(
      ks, vp, gp, den, w, fq, fk, dsp, dzst, dks, dv_, n, d, dv, r, blk,
      qcount, kcount, scount, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int OC>
int tc_attrs(int* out) {
  cudaError_t err =
      kernel_attrs(dq_tc_kernel<DP, OC>, 128, dq_smem_bytes<DP, OC>(), out);
  if (err == cudaSuccess)
    err = kernel_attrs(dkv_tc_kernel<DP, OC>, 128, dkv_smem_bytes<DP>(),
                       out + 4);
  return static_cast<int>(err);
}

}  // namespace

// dtype (v, g, o): 0 = float32, 1 = bfloat16; w is (BH, N) fp32 scratch.
// Returns cudaGetLastError() (cudaErrorInvalidValue for N % blk != 0).
extern "C" int lln_causal_bwd_launch(const void* qs, const void* ks,
                                     const void* v, const void* g,
                                     const void* o, const void* den,
                                     void* dqs, void* dks, void* dv, void* w,
                                     int bh, int bg, int n, int d, int dvd,
                                     int blk, int dtype, int rows, int cols,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto qsp = static_cast<const float*>(qs);
  auto ksp = static_cast<const float*>(ks);
  auto dnp = static_cast<const float*>(den);
  auto dqp = static_cast<float*>(dqs);
  auto dkp = static_cast<float*>(dks);
  auto dvp = static_cast<float*>(dv);
  auto wp = static_cast<float*>(w);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qsp, ksp, v, g, o, dnp, dqp, dkp, dvp, wp, bh,
                                 bg, n, d, dvd, blk, rows, cols, st);
  if (dtype == 0)
    return launch<float>(qsp, ksp, v, g, o, dnp, dqp, dkp, dvp, wp, bh, bg, n,
                         d, dvd, blk, rows, cols, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 tensor-core path (v, g, o bf16; D, Dv <= 256), blocks of blk
// rows (any N).  phq (3,BH,N,D), phk (3,BG,N,D), sst and dsst
// (3,BG,nb,D,Dv) are bf16 scratch (three planes each), zst and dzst
// (BG,nb,D) and w (BH,N) fp32 scratch, nb = ceil(N / blk).  Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
extern "C" int lln_causal_bwd_tc_launch(
    const void* qs, const void* ks, const void* v, const void* g,
    const void* o, const void* den, void* dqs, void* dks, void* dv, void* w,
    void* phq, void* phk, void* sst, void* zst, void* dsst, void* dzst,
    int bh, int bg, int n, int d, int dvd, int blk, void* stream) {
  if (blk < 1 || bg < 1 || bh % bg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto qsp = static_cast<const float*>(qs);
  auto ksp = static_cast<const float*>(ks);
  auto dnp = static_cast<const float*>(den);
#define LLN_CAUSAL_BWD_TC(DP, OC)                                             \
  return launch_tc<DP, OC>(qsp, ksp, v, g, o, dnp, f(dqs), f(dks), f(dv),     \
                           f(w), phq, phk, sst, f(zst), dsst, f(dzst), bh,    \
                           bg, n, d, dvd, blk, st)
  if (d <= 64 && dvd <= 64) LLN_CAUSAL_BWD_TC(64, 64);
  if (d <= 128 && dvd <= 128) LLN_CAUSAL_BWD_TC(128, 128);
  if (d <= 192 && dvd <= 192) LLN_CAUSAL_BWD_TC(192, 128);
  if (d <= 256 && dvd <= 256) LLN_CAUSAL_BWD_TC(256, 128);
#undef LLN_CAUSAL_BWD_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instantiation bf16 (d, dv) takes: out[0..3] for dq_tc_kernel and
// out[4..7] for dkv_tc_kernel, each registers a thread, local (spill)
// bytes a thread, CTAs per SM and dynamic shared bytes (lln::kernel_attrs).
extern "C" int lln_causal_bwd_tc_attrs(int d, int dv, void* out) {
  int* o = static_cast<int*>(out);
  if (d <= 64 && dv <= 64) return tc_attrs<64, 64>(o);
  if (d <= 128 && dv <= 128) return tc_attrs<128, 128>(o);
  if (d <= 192 && dv <= 192) return tc_attrs<192, 128>(o);
  if (d <= 256 && dv <= 256) return tc_attrs<256, 128>(o);
  return static_cast<int>(cudaErrorInvalidValue);
}
