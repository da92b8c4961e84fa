// Backward of the fused causal LLN + block-diagonal softmax forward (§4.2).
//
// Replaces src/repro/kernels/lln_backward.py:lln_diag_fused_bwd_pallas.
// Inputs: qs (BH,N,D), ks (BG,N,D) fp32 (the LLN part's pre-scaled,
// stabilized q/k); q (BH,N,D), k (BG,N,D), v (BG,N,Dv), the cotangent g
// (BH,N,Dv) and the saved output o (BH,N,Dv) in one type (fp32 or bf16);
// den (BH,N) fp32, the LLN normalizer.  Outputs, fp32: dqs, dqd (BH,N,D),
// dks, dkd (BG,N,D), dv (BG,N,Dv); dks, dkd and dv summed over the r query
// heads of a kv head.  stats (4,BH,N) is scratch: the dq kernel writes each
// query row's softmax max m and sum l, delta = sum_j p_j (gh.v_j) and the
// LLN cotangent w; the dk/dv kernel reads them.
//
// Math (the reference's): gh = g/2; the diag part is recomputed, p =
// softmax(tril(q k^T D^-1/2)) within each blk block; the LLN output is
// rebuilt from the SAVED o as 2 o - p V, so w = (gh.(2 o - p V))/den =
// (2 gh.o - delta)/den, with u = gh/den the LLN gradients are those of
// csrc/lln_causal_bwd.cu; the softmax part is dqd = dsm k D^-1/2, dkd =
// dsm^T q D^-1/2 with dsm = p (gh.v - delta), and dv gains p^T gh.
//
// Two paths, chosen by the caller (kernels/lln_backward.py) by type and
// width, each with its own entry point:
//
// bf16 with D, Dv <= 256 (every model path on the card):
// lln_diag_fused_bwd_tc_launch, on the tensor cores, chunk-parallel over
// the blk blocks.  Six launches:
//   1. phi_split (csrc/fused_state.cuh), twice: Phi(q), Phi(k) as three
//      bf16 planes each.
//   2. state_kernel, forward: the exclusive block states (S_c, z_c) of
//      each kv group, recomputed as the forward made them, so the autograd
//      Function saves nothing more.
//   3. dq_tc_kernel, one CTA per (query head, block, 64-row tile): one
//      online pass over the block's keys up to the diagonal gives the
//      softmax max, sum and delta (as block_diag_bwd.cu's), then w = (g.o -
//      delta)/den, all written to stats; a second pass recomputes p and
//      gh.v per key tile and accumulates dqd += dsm k and the LLN part
//      gmat Phi(k) with gmat = gh.v/den - w; then u S_c^T and w z_c, and
//      dqs = Phi(q) (gmat Phi(k) + u S_c^T - w z_c).
//   4. state_kernel, reverse: the exclusive suffix (dS_c, dz_c), the sums
//      over the later blocks and the r heads of Phi(q)^T u and Phi(q) w,
//      heads then blocks in a fixed order.
//   5. dkv_tc_kernel, three CTAs per (kv group, block, 64-key tile): dkd =
//      dsm^T q; dks = Phi(k) (gmat^T Phi(q) + V dS_c^T - dz_c); dv = (p/2
//      + scores/(2 den))^T g + Phi(k) dS_c = p^T gh + scores^T u + Phi(k)
//      dS_c.  Each walks the r heads and its block's query tiles from its
//      own rows to the block's end in a fixed order and recomputes p from
//      the saved max and sum: no atomics, so two runs are equal bit for
//      bit.  Each query tile's products go into a fresh accumulator that is
//      added to the total in fp32, as the tensor cores' own accumulation
//      does not round to nearest.  At yi-9b's shape that is 3 x 256 CTAs
//      of bounded work.
//   Products: q k^T and g v^T one exact bf16 MMA; every fp32 operand as
//   three bf16 planes (2^-24 relative): against a bf16 operand three MMAs,
//   against another fp32 operand (Phi(q) Phi(k)^T, gmat Phi(k), gmat^T
//   Phi(q), Phi(k) dS) six.  (Two planes, as in the forward, left dks and
//   dqs outside the 1e-5 tolerance at r = 4 and 8.)  Phi(q) and Phi(k)
//   that multiply a result elementwise are the exact exp(qs) and exp(ks).
//   Bound on the H100: the products at the bf16 tensor-core rate, an fp32
//   operand counted once per MMA the two-plane split takes (twice, three
//   times for fp32 x fp32), with the softmax steps and the exps as fp32
//   work (chip_smoke.py:_fused_counts); at the training shape the bytes
//   bound it.
//   Widths: the kernels are templated on the padded width DP of D and Dv
//   (64, 128, 192, 256) and on OC, the output columns of one CTA: DP up to
//   128, or 128 above, so that no CTA holds more than 64 fp32 accumulators
//   a thread per output (MLA's D = 192 with Dv = 128, paligemma's D = Dv =
//   256).  Above 128 the dq CTAs split dqs and dqd into 128-column chunks
//   and the three dk/dv roles split their outputs the same way; each
//   chunk recomputes its tile's scores, whose contractions run over all of
//   D or Dv from shared memory in 16-deep steps.  The dq stage keeps the
//   Phi(k) planes at the chunk's columns only.  The state kernels tile
//   (S_c, z_c) and (dS_c, dz_c) in 32 x 64 pieces at any width.  Shared
//   memory at DP = 256: dq 125 KB, dk/dv 215 KB (the dv role's three
//   Phi(k) planes of the 64-key tile at all of D), one CTA per SM; at DP
//   = 192: 101 KB (two per SM) and 163 KB.
//
// fp32, or a width above 256: lln_diag_fused_bwd_launch, the CUDA-core
// kernels below, IEEE fp32.  As csrc/lln_causal_bwd.cu (dq CTAs over rows
// of D with the forward state; dk CTAs over rows and dv CTAs over columns
// of the reverse state summed over the r heads; heads in a fixed order, no
// atomics), plus the softmax part.  A 256x256 fp32 block of p does not fit
// in shared memory, so p is never whole: a dq CTA holds its TILE query
// rows' scores against the block's keys up to them (TILE x blk), which
// gives m, l and delta; a dk/dv CTA walks its key tile against the query
// chunks of the same block from its own rows to the block's end and
// recomputes each p from the saved m and l.
#include "fused_state.cuh"
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.
// ---------------------------------------------------------------------------

using namespace lln;

constexpr int TC_ROWS = 64;   // query rows (dq) or keys (dk/dv) per CTA
// bf16 planes of every fp32 operand: three keep it to 2^-24 relative, so
// the fp32 gradients stay within 1e-5 of the largest entry (two, as in the
// forward, left dks and dqs outside it at r = 4 and 8).
constexpr int NP = 3;

// Rows of a staged key tile (dq) or query tile (dk/dv).
template <int DP>
__host__ __device__ constexpr int step_rows() { return DP > 64 ? 16 : 32; }

// The dq kernel's stage: k and v at DP columns, the Phi(k) planes at the
// CTA's OC output columns.
template <int DP, int OC>
constexpr size_t dq_smem_bytes() {
  return (2 * TC_ROWS * (DP + 8) +
          2 * step_rows<DP>() * (2 * (DP + 8) + NP * (OC + 8))) *
             sizeof(__nv_bfloat16) +
         TC_ROWS * sizeof(float);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return ((1 + NP) * TC_ROWS + 2 * (2 + NP) * step_rows<DP>()) *
             (DP + 8) * sizeof(__nv_bfloat16) +
         2 * 4 * step_rows<DP>() * sizeof(float);
}

// phk (NP,BG,N,D): Phi(k) planes kcount apart; sst (NP,BG,nb,D,Dv) and zst
// (BG,nb,D): the forward's exclusive block states.  DP: the padded width
// of D and Dv; OC: the columns of dqs and dqd one CTA writes (all of D
// when D <= OC, else chunks of OC, blockIdx.z = tile * chunks + chunk).
template <int DP, int OC>
__global__ void __launch_bounds__(128, 2)
dq_tc_kernel(const float* __restrict__ qs, const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ g,
             const __nv_bfloat16* __restrict__ o,
             const float* __restrict__ den_in,
             const __nv_bfloat16* __restrict__ phk,
             const __nv_bfloat16* __restrict__ sst,
             const float* __restrict__ zst, float* __restrict__ dqs,
             float* __restrict__ dqd, float* __restrict__ stats, int n, int d,
             int dv, int r, int blk, size_t kcount, size_t scount,
             float scale, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 8;
  constexpr int LF = OC + 8;           // the Phi(k) planes' row
  constexpr int KT = step_rows<DP>();
  constexpr int NS = KT / 8;
  constexpr int NO = OC / 8;
  constexpr int TS = TC_ROWS * LD;
  constexpr int KS = KT * LD;
  constexpr int KF = KT * LF;
  constexpr int SS = 2 * KS + NP * KF;  // one stage: k, v, Phi(k) planes
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sg = sq + TS;
  __nv_bfloat16* stg = sg + TS;        // 2 stages
  float* sgo = reinterpret_cast<float*>(stg + 2 * SS);   // g . o per row

  const int h = blockIdx.x;
  const int kvh = h / r;
  const int c = blockIdx.y;
  const int nb = gridDim.y;
  const int b0 = c * blk;
  const int bend = b0 + blk;
  const int nch = (d + OC - 1) / OC;   // column chunks of dqs and dqd
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
  const int ks = (d + 15) / 16, kvs = (dv + 15) / 16;
  const int nod = min(NO, ((cw + 15) / 16) * 2);
  const bool vz = vec != 0;
  const size_t hq = static_cast<size_t>(h) * n;
  const size_t bhn = static_cast<size_t>(gridDim.x) * n;
  const size_t hk = static_cast<size_t>(kvh) * n + b0;
  const __nv_bfloat16* kh = k + hk * d;
  const __nv_bfloat16* vh = v + hk * dv;
  const __nv_bfloat16* fkh = phk + hk * d;

  // Step st < ntiles is pass 0 (k, v), later steps pass 1 (also Phi(k)).
  const auto stage_keys = [&](int st, int sb) {
    const int t = st < ntiles ? st : st - ntiles;
    const int k0 = t * KT, kr = min(KT, nk - k0);
    __nv_bfloat16* s = stg + sb * SS;
    const size_t off = static_cast<size_t>(k0) * d;
    stage_tile<DP>(s, LD, kh + off, d, kr, KT, vz);
    stage_tile<DP>(s + KS, LD, vh + static_cast<size_t>(k0) * dv, dv, kr, KT,
                   vz);
    if (st >= ntiles) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
        stage_rows<OC>(s + 2 * KS + p * KF, LF, fkh + p * kcount + off + c0,
                       d, cw, kr, KT, vz);
    }
  };
  stage_tile<DP>(sq, LD, q + (hq + r0) * d, d, rows, TC_ROWS, vz);
  stage_tile<DP>(sg, LD, g + (hq + r0) * dv, dv, rows, TC_ROWS, vz);
  stage_keys(0, 0);
  cp_async_commit();

  // g . o per row in fp32 (a warp per row).
  for (int i = 0; i < 16; ++i) {
    const int a = warp * 16 + i;
    float s = 0.f;
    if (a < rows) {
      const size_t at = (hq + r0 + a) * dv;
      for (int e = lane; e < dv; e += 32)
        s = fmaf(__bfloat162float(g[at + e]), __bfloat162float(o[at + e]), s);
    }
    s = warp_sum(s);
    if (lane == 0) sgo[a] = s;
  }

  float aq[NO][4], as[NO][4];        // dqd and the LLN part of dqs
  zero_acc(aq);
  zero_acc(as);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f}, w[2] = {0.f, 0.f}, hd[2];
  const int qw = r0 - b0 + warp * 16;
  const int qrow = qw + gq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = warp * 16 + gq + hh * 8;
    hd[hh] = a < rows ? 0.5f / den_in[hq + r0 + a] : 0.f;   // 1 / (2 den)
  }
  const float sl2 = scale * kLog2e;
  const __nv_bfloat16* wq = sq + warp * 16 * LD;
  const __nv_bfloat16* wg = sg + warp * 16 * LD;

  const int steps = 2 * ntiles;
  for (int st = 0; st < steps; ++st) {
    const int pass = st < ntiles ? 0 : 1;
    const int t = st - pass * ntiles, sb = st & 1;
    if (st + 1 < steps) stage_keys(st + 1, sb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* s_k = stg + sb * SS;
    const __nv_bfloat16* s_v = s_k + KS;

    float s[NS][4], dp[NS][4];
    zero_acc(s);
    zero_acc(dp);
    mma_abt_p<NS, DP / 16, 1, 1>(s, wq, 0, LD, s_k, 0, LD, ks, lane);  // q k^T
    mma_abt_p<NS, DP / 16, 1, 1>(dp, wg, 0, LD, s_v, 0, LD, kvs,
                                 lane);                             // g v^T
    const int kb = t * KT;
    const bool edge = kb + KT > qw + 1;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kb + j * 8 + 2 * t4 + (e & 1);
        const int row = qrow + (e >> 1) * 8;
        const bool masked = edge && col > row;
        s[j][e] = masked ? kNegInf : s[j][e] * sl2;
        dp[j][e] *= 0.5f;                                   // gh . v
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[hh], mx);
        const float a = fast_exp2(m[hh] - mn);
        float sum = l[hh] * a, dsum = dl[hh] * a;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
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
          const int a = warp * 16 + gq + hh * 8;
          w[hh] = (sgo[a] - dl[hh]) * (2.f * hd[hh]);
          if (ch == 0 && a < rows && t4 == 0) {
            const size_t at = hq + r0 + a;
            stats[at] = m[hh];
            stats[bhn + at] = l[hh];
            stats[2 * bhn + at] = dl[hh];
            stats[3 * bhn + at] = w[hh];
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int col = kb + j * 8 + 2 * t4 + (e & 1);
          const bool masked = edge && col > qrow + hh * 8;
          const float x = dp[j][e];
          s[j][e] = fast_exp2(s[j][e] - lse[hh]) * (x - dl[hh]);  // dsm
          dp[j][e] = masked ? 0.f : x * (2.f * hd[hh]) - w[hh];   // gmat
        }
      }
      mma_pb_p<NO, NS / 2, NP, 1>(aq, s, s_k + c0, 0, LD, nod,
                                  lane);                   // dsm k
      mma_pb_p<NO, NS / 2, NP, NP>(as, dp, s_k + 2 * KS, KF, LF, nod,
                                   lane);                  // gmat Phi(k)
    }
    __syncthreads();                 // this stage is free for the prefetch
  }
  cp_async_wait<0>();

  // u S_c^T = (g S_c^T) / (2 den): the accumulator is scaled by 2 den, g
  // S_c^T added 32 rows of S (this CTA's columns of dqs) at a time, and
  // scaled back.
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
      const float q0 = aq[j][2 * hh] * scale, q1 = aq[j][2 * hh + 1] * scale;
      float s0 = as[j][2 * hh], s1 = as[j][2 * hh + 1];
      if (c > 0) {
        s0 -= w[hh] * zc[cc];
        if (cc + 1 < d) s1 -= w[hh] * zc[cc + 1];
      }
      s0 *= expf(qs[at + cc]);
      if (cc + 1 < d) s1 *= expf(qs[at + cc + 1]);
      if (vz) {
        *reinterpret_cast<float2*>(dqd + at + cc) = make_float2(q0, q1);
        *reinterpret_cast<float2*>(dqs + at + cc) = make_float2(s0, s1);
      } else {
        dqd[at + cc] = q0;
        dqs[at + cc] = s0;
        if (cc + 1 < d) {
          dqd[at + cc + 1] = q1;
          dqs[at + cc + 1] = s1;
        }
      }
    }
  }
}

// Three CTAs per key tile and output chunk z / 3, by z % 3: the dkd role
// (dsm^T q), the dks role (gmat^T Phi(q), V dS^T, dz) and the dv role (p^T
// gh + scores^T u, Phi(k) dS).  Each writes OC columns of its output (all
// of them when its width is at most OC; z / 3 = tile * chunks + chunk).
// Each query tile's products go into a fresh accumulator that is then
// added to the total in fp32: the tensor cores' own accumulation does not
// round to nearest, and its error would grow with the r x blk query rows
// summed.  phq (NP,BH,N,D), phk (NP,BG,N,D); dsst
// (NP,BG,nb,D,Dv) and dzst (BG,nb,D): the reverse exclusive block states.
template <int DP, int OC>
__global__ void __launch_bounds__(128, 2)
dkv_tc_kernel(const float* __restrict__ ks_in,
              const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ g,
              const float* __restrict__ den_in,
              const float* __restrict__ stats,
              const __nv_bfloat16* __restrict__ phq,
              const __nv_bfloat16* __restrict__ phk,
              const __nv_bfloat16* __restrict__ dsst,
              const float* __restrict__ dzst, float* __restrict__ dks,
              float* __restrict__ dkd, float* __restrict__ dvo, int n, int d,
              int dv, int r, int blk, size_t qcount, size_t kcount,
              size_t scount, float scale, int vec) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 8;
  constexpr int QT = step_rows<DP>();
  constexpr int NQ = QT / 8;           // score tiles of 8 queries per warp
  constexpr int NO = OC / 8;
  constexpr int TS = TC_ROWS * LD;
  constexpr int QS = QT * LD;
  constexpr int SS = (2 + NP) * QS;    // one stage: q, Phi(q) planes, g
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sx = sk + TS;         // V, or the Phi(k) planes TS apart
  __nv_bfloat16* stg = sx + NP * TS;   // 2 stages
  float* sst_ = reinterpret_cast<float*>(stg + 2 * SS);  // 2 x 4 x QT

  const int kv = blockIdx.x;
  const int c = blockIdx.y;
  const int nb = gridDim.y;
  const int role = blockIdx.z % 3;     // 0 dkd, 1 dks, 2 dv
  const int nch = ((d > dv ? d : dv) + OC - 1) / OC;
  const int zc = static_cast<int>(blockIdx.z) / 3;
  const int c0 = zc % nch * OC;        // this CTA's first output column
  const int w = role == 2 ? dv : d;    // its output's width
  const int b0 = c * blk;
  const int bend = b0 + blk;
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
  const size_t bhn = static_cast<size_t>(gridDim.x) * r * n;
  const int nqt = (bend - kb0 + QT - 1) / QT;
  const int steps = r * nqt;
  const int key = kb0 + warp * 16 + gq;   // this thread's first key
  const float sl2 = scale * kLog2e;

  // Each role stages what it reads: q (dkd, dv), Phi(q) (dks, dv), g (all).
  const auto stage_q = [&](int step, int sb) {
    const int hh = step / nqt, i0 = kb0 + (step - hh * nqt) * QT;
    const int rows = min(QT, bend - i0);
    const size_t hq = (static_cast<size_t>(kv) * r + hh) * n + i0;
    __nv_bfloat16* s = stg + sb * SS;
    if (role != 1) stage_tile<DP>(s, LD, q + hq * d, d, rows, QT, vz);
    if (role != 0) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
        stage_tile<DP>(s + (1 + p) * QS, LD, phq + p * qcount + hq * d, d,
                       rows, QT, vz);
    }
    stage_tile<DP>(s + (1 + NP) * QS, LD, g + hq * dv, dv, rows, QT, vz);
    float* ss = sst_ + sb * 4 * QT;
    for (int i = threadIdx.x; i < QT; i += blockDim.x) {
      const bool ok = i < rows;
      ss[i] = ok ? stats[hq + i] + log2f(stats[bhn + hq + i]) : 0.f;  // lse
      ss[QT + i] = ok ? stats[2 * bhn + hq + i] : 0.f;               // delta
      ss[2 * QT + i] = ok ? stats[3 * bhn + hq + i] : 0.f;           // w
      ss[3 * QT + i] = ok ? 0.5f / den_in[hq + i] : 0.f;   // 1 / (2 den)
    }
  };

  if (role != 1) stage_tile<DP>(sk, LD, k + (hk + kb0) * d, d, kr, TC_ROWS, vz);
  if (role != 2) {
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
  const __nv_bfloat16* wk = sk + warp * 16 * LD;
  const __nv_bfloat16* wx = sx + warp * 16 * LD;

  for (int st = 0; st < steps; ++st) {
    const int sb = st & 1;
    if (st + 1 < steps) stage_q(st + 1, sb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int i0 = kb0 + (st % nqt) * QT;
    const int rows = min(QT, bend - i0);
    const __nv_bfloat16* tq = stg + sb * SS;
    const __nv_bfloat16* tf = tq + QS;
    const __nv_bfloat16* tg = tq + (1 + NP) * QS;
    const float* ss = sst_ + sb * 4 * QT;
    // Masks where a query lies before one of the warp's keys or past the
    // block's end.
    const bool edge = i0 < kb0 + warp * 16 + 16 || rows < QT;
    float pt[NQ][4], xt[NQ][4];
    zero_acc(pt);
    zero_acc(xt);
    if (role != 1)
      mma_abt_p<NQ, DP / 16, 1, 1>(pt, wk, 0, LD, tq, 0, LD, ks,
                                   lane);                           // k q^T
    if (role != 2)
      mma_abt_p<NQ, DP / 16, 1, 1>(xt, wx, 0, LD, tg, 0, LD, kvs,
                                   lane);                           // v g^T
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
        const float p = fast_exp2(fmaf(pt[j][e], sl2, -ss[cq]));
        const float hdq = ss[3 * QT + cq];
        if (role == 0)        // dsm = p (gh . v - delta)
          pt[j][e] = ok ? p * (0.5f * xt[j][e] - ss[QT + cq]) : 0.f;
        else if (role == 1)   // gmat = gh . v / den - w
          pt[j][e] = ok ? xt[j][e] * hdq - ss[2 * QT + cq] : 0.f;
        else                  // p / 2 + scores / (2 den)
          pt[j][e] = ok ? 0.5f * p + xt[j][e] * hdq : 0.f;
      }
    }
    zero_acc(part);
    if (role == 0)
      mma_pb_p<NO, NQ / 2, NP, 1>(part, pt, tq + c0, 0, LD, nout,
                                  lane);                              // q
    else if (role == 1)
      mma_pb_p<NO, NQ / 2, NP, NP>(part, pt, tf + c0, QS, LD, nout,
                                   lane);                        // Phi(q)
    else
      mma_pb_p<NO, NQ / 2, NP, 1>(part, pt, tg + c0, 0, LD, nout,
                                  lane);                              // g
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    __syncthreads();                 // this stage is free for the prefetch
  }
  cp_async_wait<0>();

  // The later blocks' reverse state: V dS_c^T (dks) or Phi(k) dS_c (dv).
  if (c < nb - 1 && role != 0) {
    const __nv_bfloat16* sp =
        dsst + (static_cast<size_t>(kv) * nb + c) * d * dv;
    zero_acc(part);
    if (role == 1) {
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
  float* out = role == 0 ? dkd : role == 1 ? dks : dvo;
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
      if (role == 0) {
        x0 *= scale;
        x1 *= scale;
      } else if (role == 1) {   // dks = Phi(k) (... - dz_c)
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
int launch_tc(const float* qs, const float* ks, const void* q, const void* k,
              const void* v, const void* g, const void* o, const float* den,
              float* dqs, float* dqd, float* dks, float* dkd, float* dv_,
              float* stats, void* phq, void* phk, void* sst, float* zst,
              void* dsst, float* dzst, int bh, int bg, int n, int d, int dv,
              int blk, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int r = bh / bg;
  const int nb = n / blk;
  const size_t qcount = static_cast<size_t>(bh) * n * d;
  const size_t kcount = static_cast<size_t>(bg) * n * d;
  const size_t scount = static_cast<size_t>(bg) * nb * d * dv;
  const size_t bhn = static_cast<size_t>(bh) * n;
  const auto qp = static_cast<const bf*>(q);
  const auto kp = static_cast<const bf*>(k);
  const auto vp = static_cast<const bf*>(v);
  const auto gp = static_cast<const bf*>(g);
  const auto fq = static_cast<bf*>(phq);
  const auto fk = static_cast<bf*>(phk);
  const auto sp = static_cast<bf*>(sst);
  const auto dsp = static_cast<bf*>(dsst);
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = d % 8 == 0 && dv % 8 == 0 && al(q) && al(k) && al(v) &&
                  al(g) && al(phq) && al(phk) && al(sst) && al(dsst) &&
                  al(dqs) && al(dqd) && al(dks) && al(dkd) && al(dv_);
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
      qs, qp, kp, vp, gp, static_cast<const bf*>(o), den, fk, sp, zst, dqs,
      dqd, stats, n, d, dv, r, blk, kcount, scount, scale, vec);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = block_states<true, NP>(qs, gp, den, stats + 3 * bhn, 0.5f, dsp,
                                 dzst, nullptr, nullptr, 0, bg, n, d, dv, r,
                                 blk, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_tc_kernel<DP, OC><<<dim3(bg, nb, 3 * nt * dkv_chunks), 128, dkv_bytes,
                          stream>>>(
      ks, qp, kp, vp, gp, den, stats, fq, fk, dsp, dzst, dks, dkd, dv_, n, d,
      dv, r, blk, qcount, kcount, scount, scale, vec);
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

// The bf16 tensor-core path (q, k, v, g, o bf16; D, Dv <= 256).  phq
// (3,BH,N,D), phk (3,BG,N,D), sst and dsst (3,BG,N/blk,D,Dv) are bf16
// scratch (three planes each); zst and dzst (BG,N/blk,D) and stats
// (4,BH,N) fp32 scratch.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int lln_diag_fused_bwd_tc_launch(
    const void* qs, const void* ks, const void* q, const void* k,
    const void* v, const void* g, const void* o, const void* den, void* dqs,
    void* dqd, void* dks, void* dkd, void* dv, void* stats, void* phq,
    void* phk, void* sst, void* zst, void* dsst, void* dzst, int bh, int bg,
    int n, int d, int dvd, int blk, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto qsp = static_cast<const float*>(qs);
  auto ksp = static_cast<const float*>(ks);
  auto dnp = static_cast<const float*>(den);
  if (blk < 1 || n % blk != 0 || bh % bg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define LLN_FUSED_BWD_TC(DP, OC)                                              \
  return launch_tc<DP, OC>(qsp, ksp, q, k, v, g, o, dnp, f(dqs), f(dqd),      \
                           f(dks), f(dkd), f(dv), f(stats), phq, phk, sst,    \
                           f(zst), dsst, f(dzst), bh, bg, n, d, dvd, blk,     \
                           scale, st)
  if (d <= 64 && dvd <= 64) LLN_FUSED_BWD_TC(64, 64);
  if (d <= 128 && dvd <= 128) LLN_FUSED_BWD_TC(128, 128);
  if (d <= 192 && dvd <= 192) LLN_FUSED_BWD_TC(192, 128);
  if (d <= 256 && dvd <= 256) LLN_FUSED_BWD_TC(256, 128);
#undef LLN_FUSED_BWD_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instantiation bf16 (d, dv) takes: out[0..3] for dq_tc_kernel and
// out[4..7] for dkv_tc_kernel, each registers a thread, local (spill)
// bytes a thread, CTAs per SM and dynamic shared bytes (lln::kernel_attrs).
extern "C" int lln_diag_fused_bwd_tc_attrs(int d, int dv, void* out) {
  int* o = static_cast<int*>(out);
  if (d <= 64 && dv <= 64) return tc_attrs<64, 64>(o);
  if (d <= 128 && dv <= 128) return tc_attrs<128, 128>(o);
  if (d <= 192 && dv <= 192) return tc_attrs<192, 128>(o);
  if (d <= 256 && dv <= 256) return tc_attrs<256, 128>(o);
  return static_cast<int>(cudaErrorInvalidValue);
}
