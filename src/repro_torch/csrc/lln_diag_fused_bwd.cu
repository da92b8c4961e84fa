// Backward of the fused causal LLN + block-diagonal softmax forward (§4.2).
//
// Replaces src/repro/kernels/lln_backward.py:lln_diag_fused_bwd_pallas.
// Inputs: qs (BH,N,D), ks (BG,N,D) fp32 (the LLN part's pre-scaled,
// stabilized q/k); q (BH,N,D), k (BG,N,D), v (BG,N,Dv), the cotangent g
// (BH,N,Dv) and the saved output o (BH,N,Dv) in one type (fp32 or bf16);
// den (BH,N) fp32, the LLN normalizer.  Outputs, fp32: dqs, dqd (BH,N,D),
// dks, dkd (BG,N,D), dv (BG,N,Dv); dks, dkd and dv summed over the r query
// heads of a kv head.  stats (4,BH,N) is scratch: the first kernel writes
// each query row's softmax max m and sum l, delta = sum_j p_j (gh.v_j) and
// the LLN cotangent w; the second reads them.
//
// Math (the reference's): gh = g/2; the diag part is recomputed, p =
// softmax(tril(q k^T D^-1/2)) within each blk block; the LLN output is
// rebuilt from the SAVED o as 2 o - p V, so w = (gh.(2 o - p V))/den =
// (2 gh.o - delta)/den, with u = gh/den the LLN gradients are those of
// csrc/lln_causal_bwd.cu; the softmax part is dqd = dsm k D^-1/2, dkd =
// dsm^T q D^-1/2 with dsm = p (gh.v - delta), and dv gains p^T gh.
//
// Design: as csrc/lln_causal_bwd.cu (dq CTAs over rows of D with the
// forward state; dk CTAs over rows and dv CTAs over columns of the reverse
// state summed over the r heads; heads in a fixed order, no atomics), plus
// the softmax part.  A 256x256 fp32 block of p does not fit in shared
// memory, so p is never whole: a dq CTA holds its TILE query rows' scores
// against the block's keys up to them (TILE x blk), which gives m, l and
// delta; a dk/dv CTA walks its key tile against the query chunks of the
// same block from its own rows to the block's end and recomputes each p
// from the saved m and l.  All products are fp32 on the CUDA cores.
//
// Bound on the H100: fp32 operations at the training shapes (see
// kernels/lln_backward.py).
#include "train_common.cuh"

namespace {

template <typename T>
__global__ void dq_kernel(const float* __restrict__ qs,
                          const float* __restrict__ ks,
                          const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const T* __restrict__ o,
                          const float* __restrict__ den_in,
                          float* __restrict__ dqs, float* __restrict__ dqd,
                          float* __restrict__ stats, int n, int d, int dv,
                          int r, int blk, int tile, int rows, float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  const int wv = dv + 1;
  const int kp = max(d, dv) + 1;
  const int rp = rows + 1;
  const int tp = tile + 1;
  const int pp = blk + 1;
  float* qd = smem;                 // tile x dp   q * scale
  float* gh = qd + tile * dp;       // tile x wv   g / 2
  float* kb = gh + tile * wv;       // tile x kp   k or V chunks
  float* P = kb + tile * kp;        // tile x pp   scores -> p -> dsm
  float* DP = P + tile * pp;        // tile x pp   gh . v
  float* fq = DP + tile * pp;       // tile x rp   Phi(q) rows of D
  float* fk = fq + tile * rp;       // tile x rp   Phi(k) rows of D
  float* gm = fk + tile * rp;       // tile x tp   (u.v - w), masked
  float* acc = gm + tile * tp;      // tile x rp   dqd rows of D
  float* S = acc + tile * rp;       // rows x wv   forward state rows
  float* z = S + rows * wv;         // rows
  float* den = z + rows;            // tile
  float* go = den + tile;           // tile        gh . o
  float* dl = go + tile;            // tile        delta
  float* w = dl + tile;             // tile

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
  const size_t bhn = static_cast<size_t>(gridDim.x) * n;

  for (int i = tid; i < rows * wv; i += nt) S[i] = 0.f;
  for (int i = tid; i < rows; i += nt) z[i] = 0.f;

  for (int t0 = 0; t0 < n; t0 += tile) {
    const int b0 = (t0 / blk) * blk;
    const int nk = t0 + tile - b0;
    for (int a = tid; a < tile; a += nt) den[a] = den_in[hq + t0 + a];
    lln::load_tile(qd, dp, q + (hq + t0) * d, d, tile, 0, d, lln::Scale{scale});
    lln::load_tile(gh, wv, g + (hq + t0) * dv, dv, tile, 0, dv, lln::Scale{0.5f});
    lln::load_tile(fq, rp, qs + (hq + t0) * d, d, tile, d0, rw, lln::Exp{});
    __syncthreads();
    for (int a = warp; a < tile; a += nw) {
      float s = 0.f;
      for (int e = lane; e < dv; e += 32)
        s = fmaf(gh[a * wv + e], lln::to_f32(o[(hq + t0 + a) * dv + e]), s);
      s = lln::warp_sum(s);
      if (lane == 0) go[a] = s;
    }
    // Scores against the block's keys up to the tile's last row.
    for (int k0 = b0; k0 <= t0; k0 += tile) {
      lln::load_tile(kb, kp, k + (hk + k0) * d, d, tile, 0, d, lln::Ident{});
      __syncthreads();
      for (int i = tid; i < tile * tile; i += nt) {
        const int a = i / tile, j = i - a * tile;
        P[a * pp + k0 - b0 + j] = k0 + j <= t0 + a
                                      ? lln::dot(qd + a * dp, kb + j * kp, d)
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
      if (lane == 0 && blockIdx.y == 0) {
        stats[hq + t0 + a] = m;
        stats[bhn + hq + t0 + a] = l;
      }
    }
    for (int k0 = b0; k0 <= t0; k0 += tile) {
      __syncthreads();
      lln::load_tile(kb, kp, v + (hk + k0) * dv, dv, tile, 0, dv, lln::Ident{});
      __syncthreads();
      for (int i = tid; i < tile * tile; i += nt) {
        const int a = i / tile, j = i - a * tile;
        DP[a * pp + k0 - b0 + j] = k0 + j <= t0 + a
                                       ? lln::dot(gh + a * wv, kb + j * kp, dv)
                                       : 0.f;
      }
    }
    __syncthreads();
    for (int a = warp; a < tile; a += nw) {
      float s = 0.f;
      for (int j = lane; j < nk; j += 32) s = fmaf(P[a * pp + j], DP[a * pp + j], s);
      s = lln::warp_sum(s);
      if (lane == 0) {
        dl[a] = s;
        w[a] = (2.f * go[a] - s) / den[a];
        if (blockIdx.y == 0) {
          stats[2 * bhn + hq + t0 + a] = s;
          stats[3 * bhn + hq + t0 + a] = w[a];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < tile * tile; i += nt) {
      const int a = i / tile, b = i - a * tile;
      gm[a * tp + b] = b <= a ? DP[a * pp + t0 - b0 + b] / den[a] - w[a] : 0.f;
    }
    for (int i = tid; i < tile * nk; i += nt) {
      const int a = i / nk, j = i - a * nk;
      P[a * pp + j] *= DP[a * pp + j] - dl[a];
    }
    for (int i = tid; i < tile * rw; i += nt) acc[(i / rw) * rp + i % rw] = 0.f;
    for (int k0 = b0; k0 <= t0; k0 += tile) {
      __syncthreads();
      lln::load_tile(kb, kp, k + (hk + k0) * d, d, tile, d0, rw, lln::Ident{});
      __syncthreads();
      for (int i = tid; i < tile * rw; i += nt) {
        const int a = i / rw, e = i - a * rw;
        const float* pa = P + a * pp + k0 - b0;
        float s = acc[a * rp + e];
        for (int j = 0; j < tile; ++j) s = fmaf(pa[j], kb[j * kp + e], s);
        acc[a * rp + e] = s;
      }
    }
    __syncthreads();
    for (int i = tid; i < tile * rw; i += nt) {
      const int a = i / rw, e = i - a * rw;
      dqd[(hq + t0 + a) * d + d0 + e] = acc[a * rp + e] * scale;
    }
    // LLN part: u = gh / den against the forward state.
    lln::load_tile(fk, rp, ks + (hk + t0) * d, d, tile, d0, rw, lln::Exp{});
    lln::load_tile(kb, kp, v + (hk + t0) * dv, dv, tile, 0, dv, lln::Ident{});
    __syncthreads();
    for (int i = tid; i < tile * rw; i += nt) {
      const int a = i / rw, e = i - a * rw;
      float s = 0.f;
      for (int b = 0; b <= a; ++b) s = fmaf(gm[a * tp + b], fk[b * rp + e], s);
      s += lln::dot(gh + a * wv, S + e * wv, dv) / den[a];
      s -= w[a] * z[e];
      dqs[(hq + t0 + a) * d + d0 + e] = fq[a * rp + e] * s;
    }
    __syncthreads();
    for (int i = tid; i < rw * dv; i += nt) {
      const int e = i / dv, c = i - e * dv;
      float s = 0.f;
      for (int b = 0; b < tile; ++b) s = fmaf(fk[b * rp + e], kb[b * kp + c], s);
      S[e * wv + c] += s;
    }
    for (int e = tid; e < rw; e += nt) {
      float s = 0.f;
      for (int b = 0; b < tile; ++b) s += fk[b * rp + e];
      z[e] += s;
    }
    __syncthreads();
  }
}

// blockIdx.y < ndk: a dk CTA over D rows [y*rows, +rows) (dks and dkd);
// otherwise a dv CTA over Dv columns [(y-ndk)*cols, +cols).
template <typename T>
__global__ void dkv_kernel(const float* __restrict__ qs,
                           const float* __restrict__ ks,
                           const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ g,
                           const float* __restrict__ den_in,
                           const float* __restrict__ stats,
                           float* __restrict__ dks, float* __restrict__ dkd,
                           float* __restrict__ dvo, int n, int d, int dv,
                           int r, int blk, int tile, int rows, int cols,
                           int ndk, float scale) {
  extern __shared__ float smem[];
  const int gi = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int dp = d + 1;
  const int tp = tile + 1;
  const size_t hk = static_cast<size_t>(gi) * n;
  const size_t bhn = static_cast<size_t>(gridDim.x) * r * n;
  const float* st_m = stats;
  const float* st_l = stats + bhn;
  const float* st_d = stats + 2 * bhn;
  const float* st_w = stats + 3 * bhn;

  if (static_cast<int>(blockIdx.y) < ndk) {
    // ---- dk: rows [d0, d0+rw) of D ---------------------------------------
    const int wv = dv + 1;
    const int rp = rows + 1;
    float* kt = smem;               // tile x dp   raw k of the key tile
    float* vt = kt + tile * dp;     // tile x wv   V of the key tile
    float* fk = vt + tile * wv;     // tile x rp   Phi(k) rows of D
    float* qd = fk + tile * rp;     // tile x dp   q * scale, one chunk
    float* gh = qd + tile * dp;     // tile x wv   g / 2, one chunk
    float* uf = gh + tile * wv;     // tile x wv   gh / den, first chunk
    float* fq = uf + tile * wv;     // tile x rp   Phi(q) rows of D
    float* pm = fq + tile * rp;     // tile x tp   dsm, masked i >= j
    float* gm = pm + tile * tp;     // tile x tp   (u.v - w), masked
    float* dS = gm + tile * tp;     // rows x wv
    float* dz = dS + rows * wv;     // rows
    float* ak = dz + rows;          // tile x rp   dPhi(k)
    float* ad = ak + tile * rp;     // tile x rp   dkd
    float* mx = ad + tile * rp;     // tile
    float* sm = mx + tile;          // tile
    float* dl = sm + tile;          // tile
    float* w = dl + tile;           // tile
    float* den = w + tile;          // tile
    const int d0 = blockIdx.y * rows;
    const int rw = min(rows, d - d0);
    for (int i = tid; i < rows * wv; i += nt) dS[i] = 0.f;
    for (int i = tid; i < rows; i += nt) dz[i] = 0.f;
    for (int t0 = n - tile; t0 >= 0; t0 -= tile) {
      const int bend = (t0 / blk) * blk + blk;
      __syncthreads();
      lln::load_tile(kt, dp, k + (hk + t0) * d, d, tile, 0, d, lln::Ident{});
      lln::load_tile(vt, wv, v + (hk + t0) * dv, dv, tile, 0, dv, lln::Ident{});
      lln::load_tile(fk, rp, ks + (hk + t0) * d, d, tile, d0, rw, lln::Exp{});
      __syncthreads();
      for (int i = tid; i < tile * rw; i += nt) {
        const int j = i / rw, e = i - j * rw;
        ak[j * rp + e] = lln::dot(dS + e * wv, vt + j * wv, dv) - dz[e];
        ad[j * rp + e] = 0.f;
      }
      for (int hh = 0; hh < r; ++hh) {
        const size_t hq = (static_cast<size_t>(gi) * r + hh) * n;
        for (int i0 = t0; i0 < bend; i0 += tile) {
          const bool first = i0 == t0;
          __syncthreads();
          for (int a = tid; a < tile; a += nt) {
            const size_t at = hq + i0 + a;
            mx[a] = st_m[at];
            sm[a] = st_l[at];
            dl[a] = st_d[at];
            w[a] = st_w[at];
            den[a] = den_in[at];
          }
          lln::load_tile(qd, dp, q + (hq + i0) * d, d, tile, 0, d,
                         lln::Scale{scale});
          lln::load_tile(gh, wv, g + (hq + i0) * dv, dv, tile, 0, dv,
                         lln::Scale{0.5f});
          if (first)
            lln::load_tile(fq, rp, qs + (hq + i0) * d, d, tile, d0, rw,
                           lln::Exp{});
          __syncthreads();
          if (first)
            for (int i = tid; i < tile * dv; i += nt) {
              const int a = i / dv, c = i - a * dv;
              uf[a * wv + c] = gh[a * wv + c] / den[a];
            }
          for (int i = tid; i < tile * tile; i += nt) {
            const int a = i / tile, j = i - a * tile;
            float pv = 0.f, gv = 0.f;
            if (i0 + a >= t0 + j) {
              const float p =
                  expf(lln::dot(qd + a * dp, kt + j * dp, d) - mx[a]) / sm[a];
              const float dpv = lln::dot(gh + a * wv, vt + j * wv, dv);
              pv = p * (dpv - dl[a]);
              gv = dpv / den[a] - w[a];
            }
            pm[a * tp + j] = pv;
            if (first) gm[a * tp + j] = gv;
          }
          __syncthreads();
          for (int i = tid; i < tile * rw; i += nt) {
            const int j = i / rw, e = i - j * rw;
            float s = ad[j * rp + e];
            for (int a = 0; a < tile; ++a) s = fmaf(pm[a * tp + j], qd[a * dp + d0 + e], s);
            ad[j * rp + e] = s;
            if (first) {
              float t = ak[j * rp + e];
              for (int a = j; a < tile; ++a) t = fmaf(gm[a * tp + j], fq[a * rp + e], t);
              ak[j * rp + e] = t;
            }
          }
          if (first) {
            for (int i = tid; i < rw * dv; i += nt) {
              const int e = i / dv, c = i - e * dv;
              float s = 0.f;
              for (int a = 0; a < tile; ++a)
                s = fmaf(fq[a * rp + e], uf[a * wv + c], s);
              dS[e * wv + c] += s;
            }
            for (int e = tid; e < rw; e += nt) {
              float s = 0.f;
              for (int a = 0; a < tile; ++a) s = fmaf(w[a], fq[a * rp + e], s);
              dz[e] += s;
            }
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < tile * rw; i += nt) {
        const int j = i / rw, e = i - j * rw;
        const size_t at = (hk + t0 + j) * d + d0 + e;
        dks[at] = fk[j * rp + e] * ak[j * rp + e];
        dkd[at] = ad[j * rp + e];
      }
    }
    return;
  }

  // ---- dv: columns [c0, c0+cw) of Dv ---------------------------------------
  const int cp = cols + 1;
  float* kt = smem;                 // tile x dp   raw k of the key tile
  float* fk = kt + tile * dp;       // tile x dp   Phi(k) of the key tile
  float* qd = fk + tile * dp;       // tile x dp   q * scale, one chunk
  float* fq = qd + tile * dp;       // tile x dp   Phi(q), first chunk
  float* gh = fq + tile * dp;       // tile x cp   g / 2, this CTA's columns
  float* uc = gh + tile * cp;       // tile x cp   gh / den, first chunk
  float* pm = uc + tile * cp;       // tile x tp   p, masked i >= j
  float* sc = pm + tile * tp;       // tile x tp   Phi(q).Phi(k), masked
  float* dS = sc + tile * tp;       // d x cols
  float* acc = dS + d * cols;       // tile x cp   dv columns
  float* mx = acc + tile * cp;      // tile
  float* sm = mx + tile;            // tile
  float* den = sm + tile;           // tile
  const int c0 = (blockIdx.y - ndk) * cols;
  const int cw = min(cols, dv - c0);
  for (int i = tid; i < d * cols; i += nt) dS[i] = 0.f;
  for (int t0 = n - tile; t0 >= 0; t0 -= tile) {
    const int bend = (t0 / blk) * blk + blk;
    __syncthreads();
    lln::load_tile(kt, dp, k + (hk + t0) * d, d, tile, 0, d, lln::Ident{});
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
      for (int i0 = t0; i0 < bend; i0 += tile) {
        const bool first = i0 == t0;
        __syncthreads();
        for (int a = tid; a < tile; a += nt) {
          mx[a] = st_m[hq + i0 + a];
          sm[a] = st_l[hq + i0 + a];
          den[a] = den_in[hq + i0 + a];
        }
        lln::load_tile(qd, dp, q + (hq + i0) * d, d, tile, 0, d,
                       lln::Scale{scale});
        lln::load_tile(gh, cp, g + (hq + i0) * dv, dv, tile, c0, cw,
                       lln::Scale{0.5f});
        if (first)
          lln::load_tile(fq, dp, qs + (hq + i0) * d, d, tile, 0, d, lln::Exp{});
        __syncthreads();
        if (first)
          for (int i = tid; i < tile * cw; i += nt) {
            const int a = i / cw, c = i - a * cw;
            uc[a * cp + c] = gh[a * cp + c] / den[a];
          }
        for (int i = tid; i < tile * tile; i += nt) {
          const int a = i / tile, j = i - a * tile;
          const bool ok = i0 + a >= t0 + j;
          pm[a * tp + j] =
              ok ? expf(lln::dot(qd + a * dp, kt + j * dp, d) - mx[a]) / sm[a]
                 : 0.f;
          if (first)
            sc[a * tp + j] = ok ? lln::dot(fq + a * dp, fk + j * dp, d) : 0.f;
        }
        __syncthreads();
        for (int i = tid; i < tile * cw; i += nt) {
          const int j = i / cw, c = i - j * cw;
          float s = acc[j * cp + c];
          for (int a = 0; a < tile; ++a) s = fmaf(pm[a * tp + j], gh[a * cp + c], s);
          if (first)
            for (int a = j; a < tile; ++a)
              s = fmaf(sc[a * tp + j], uc[a * cp + c], s);
          acc[j * cp + c] = s;
        }
        if (first)
          for (int i = tid; i < d * cw; i += nt) {
            const int e = i / cw, c = i - e * cw;
            float s = 0.f;
            for (int a = 0; a < tile; ++a)
              s = fmaf(fq[a * dp + e], uc[a * cp + c], s);
            dS[e * cols + c] += s;
          }
      }
    }
    __syncthreads();
    for (int i = tid; i < tile * cw; i += nt) {
      const int j = i / cw, c = i - j * cw;
      dvo[(hk + t0 + j) * dv + c0 + c] = acc[j * cp + c];
    }
  }
}

template <typename T>
int launch(const float* qs, const float* ks, const void* q, const void* k,
           const void* v, const void* g, const void* o, const float* den,
           float* dqs, float* dqd, float* dks, float* dkd, float* dv_,
           float* stats, int bh, int bg, int n, int d, int dv, int blk,
           int rows, int cols, float scale, cudaStream_t stream) {
  if (n % blk != 0 || bh % bg != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = lln::tile_for(blk, 32);
  const int r = bh / bg;
  const size_t tf = static_cast<size_t>(tile);
  const size_t kp = static_cast<size_t>(d > dv ? d : dv) + 1;
  const size_t dq_floats = tf * (d + 1) + tf * (dv + 1) + tf * kp +
                           2 * tf * (blk + 1) + 3 * tf * (rows + 1) +
                           tf * (tile + 1) +
                           static_cast<size_t>(rows) * (dv + 1) + rows + 4 * tf;
  const size_t dk_floats = 2 * tf * (d + 1) + 3 * tf * (dv + 1) +
                           4 * tf * (rows + 1) + 2 * tf * (tile + 1) +
                           static_cast<size_t>(rows) * (dv + 1) + rows +
                           5 * tf;
  const size_t dvk_floats = 4 * tf * (d + 1) + 3 * tf * (cols + 1) +
                            2 * tf * (tile + 1) +
                            static_cast<size_t>(d) * cols + 3 * tf;
  const size_t dq_bytes = dq_floats * sizeof(float);
  const size_t dkv_bytes = (dk_floats > dvk_floats ? dk_floats : dvk_floats) *
                           sizeof(float);
  cudaError_t err = lln::allow_smem(dq_kernel<T>, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lln::allow_smem(dkv_kernel<T>, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto qp = static_cast<const T*>(q);
  const auto kp_ = static_cast<const T*>(k);
  const auto vp = static_cast<const T*>(v);
  const auto gp = static_cast<const T*>(g);
  dq_kernel<T><<<dim3(bh, (d + rows - 1) / rows), 256, dq_bytes, stream>>>(
      qs, ks, qp, kp_, vp, gp, static_cast<const T*>(o), den, dqs, dqd, stats,
      n, d, dv, r, blk, tile, rows, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ndk = (d + rows - 1) / rows;
  const int ndv = (dv + cols - 1) / cols;
  dkv_kernel<T><<<dim3(bg, ndk + ndv), 256, dkv_bytes, stream>>>(
      qs, ks, qp, kp_, vp, gp, den, stats, dks, dkd, dv_, n, d, dv, r, blk,
      tile, rows, cols, ndk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (q, k, v, g, o): 0 = float32, 1 = bfloat16; stats is (4, BH, N)
// fp32 scratch.  Returns cudaGetLastError() (cudaErrorInvalidValue for
// N % blk != 0).
extern "C" int lln_diag_fused_bwd_launch(
    const void* qs, const void* ks, const void* q, const void* k,
    const void* v, const void* g, const void* o, const void* den, void* dqs,
    void* dqd, void* dks, void* dkd, void* dv, void* stats, int bh, int bg,
    int n, int d, int dvd, int blk, int dtype, int rows, int cols, float scale,
    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto qsp = static_cast<const float*>(qs);
  auto ksp = static_cast<const float*>(ks);
  auto dnp = static_cast<const float*>(den);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qsp, ksp, q, k, v, g, o, dnp, f(dqs), f(dqd),
                                 f(dks), f(dkd), f(dv), f(stats), bh, bg, n, d,
                                 dvd, blk, rows, cols, scale, st);
  if (dtype == 0)
    return launch<float>(qsp, ksp, q, k, v, g, o, dnp, f(dqs), f(dqd), f(dks),
                         f(dkd), f(dv), f(stats), bh, bg, n, d, dvd, blk, rows,
                         cols, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
