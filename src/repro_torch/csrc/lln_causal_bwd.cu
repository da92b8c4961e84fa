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
// Design.  dq: the products u S^T and (u.v - w) contract over Dv, so a
// column split of S (as in lln_causal.cu) would not serve; one CTA per
// (query head, ROWS rows of D) keeps those rows of S and z and recomputes the
// tile's (u.v - w) matrix.  dk/dv: dk's dS v contracts over Dv and dv's
// Phi(k) dS over D, so one launch holds two kinds of CTA per kv head: dk
// CTAs keep ROWS rows of dS (all columns), dv CTAs COLS columns (all rows).
// Pallas kept (dS, dz) per repeated head, (r, D, Dv) fp32, more than a
// block's shared memory at r=8, D=Dv=128; the inter-tile terms are linear in
// (dS, dz), so each CTA keeps their sum over the r heads and loops over the
// heads, in order, only for the intra-tile terms.  No atomics: the same
// inputs give the same gradients bit for bit.  All products are fp32 on the
// CUDA cores.
//
// Bound on the H100: fp32 operations at the training shapes (see
// kernels/lln_backward.py).
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
