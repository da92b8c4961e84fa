// Log-linear (Fenwick multi-scale) causal LLN forward, with the optional
// final state.
//
// Replaces src/repro/kernels/loglinear.py:loglin_causal_pallas
// (_loglin_causal_kernel).  Inputs qs (BH,N,D) and ks (BG,N,D) are fp32,
// pre-scaled and stabilized (<= 0) with one reference per kv group; v
// (BG,N,Dv) is fp32 or bf16; query row h reads kv row h / r.  Output out
// (BH,N,Dv) in v's type.  With the state (null pointers deselect all four):
// sl (BH,L,D,Dv) and zl (BH,L,1,D), the pyramid of closed granules, and
// s (BH,D,Dv) / z (BH,1,D), the open bucket of the keys after the last
// closed granule (zeros when N % blk == 0), all fp32.
//
// Math, per blk-sized granule j: out = (intra-granule causal Phi(q)Phi(k)^T
// v + Phi(q) A_j) / (the same with z + EPS), with A_j = sum_l w_l S_l over
// the pyramid of the j closed granules, w_l = decay^l; once a granule
// closes, its (S, z) enters the pyramid by a binary increment j -> j+1:
// pure adds (every bucket shares the one reference), merged levels zeroed,
// the top level saturating.  Unoccupied levels hold zeros, so the static
// weights need no occupancy mask.  A_j is a weighted sum of closed granule
// states only, fixed by (i, j) alone, so granule j's queries need nothing
// of the walk but A_j.
//
// Two paths, chosen by the caller (kernels/loglinear.py:_tc_path) by type,
// width and depth, each with its own entry point:
//
// bf16 v with D, Dv <= 128 and at most kMaxLevels levels (the yi-9b serve):
// loglin_causal_tc_launch, on the tensor cores, chunk-parallel over the
// granules.  Three launches:
//   1. phi_split (csrc/fused_state.cuh): Phi(k) as bf16 hi + lo.
//   2. pyramid_kernel: one CTA per (kv group, 32 x 64 state slice) walks
//      the granules in order, once per group (not per query head), in
//      64-row steps, the next step's v and ks in flight during this one's
//      products.  Each step's Phi(k)^T V (Phi(k) in three bf16 planes,
//      exact against bf16 v) goes into a fresh accumulator added to the
//      granule's fp32 sum; a closed granule is carried into the thread's entries of the
//      pyramid (shared memory, carry_in), and the weighted read A_{j+1}
//      and zA_{j+1} (z in fp32 on the CUDA cores) are written for the next
//      launch, A as bf16 hi + lo.  At the end it writes the pyramid and the
//      open bucket, r copies each.
//   3. causal_out_kernel (csrc/causal_out.cuh, shared with lln_causal.cu):
//      one CTA of 4 warps per (query head, granule, 64-row tile), the
//      tiles that walk the most keys first.  Phi(q) = exp(qs) is split
//      into hi + lo as it is loaded, and Phi(q) . zA_j taken in fp32.  The
//      granule's keys up to the tile's last row come in 16- or 32-key
//      tiles of v and Phi(k) hi / lo, staged by cp.async (double-buffered):
//      Phi(q) Phi(k)^T (three MMAs), masked on the diagonal tiles, its row
//      sums for den, scores V (two MMAs).  Then Phi(q) A_j (three MMAs),
//      den and out, rounded once.
//   Bound on the H100: about as many bytes (qs, out and the state dominate)
//   as tensor-core operations (chip_smoke.py:_loglin_counts).
//
// fp32 v, or a wider head or deeper pyramid: loglin_causal_launch, the
// CUDA-core kernel below, IEEE fp32.  One CTA per (query head, COLS value
// columns) walks the sequence granule by granule in TILE-row tiles (the
// last tile of a granule may be short, so any blk works) and keeps in
// shared memory its columns of every pyramid level, of the open granule
// S_open and of the weighted read A = sum_l w_l S_l + S_open (and all of z
// for each).  A is rebuilt once per granule, after the carry, and grows by
// each tile's Phi(k)^T V.  The pad keys of a ragged last tile load as
// Phi(k) = 0 and its pad rows are not written.  Each query head rebuilds
// its group's pyramid.  The pyramid takes L*D*COLS fp32 of shared memory;
// the launcher halves COLS if it would not fit.
#include "causal_out.cuh"
#include "fused_state.cuh"

namespace {

// Enter the closed granule j (carry) into the pyramid P (levels rows of
// `stride` floats, entry i) and return the weighted read sum_l w_l P_l[i].
// The carry reaches level l iff bits 0..l-1 of j are all set; there it
// takes an empty level (bit l clear) or merges with the bucket there and
// moves up (bit l set); the top level saturates.
__device__ __forceinline__ float carry_in(float* P, float carry,
                                          const float* w, int i, int stride,
                                          int j, int levels) {
  const int top = levels - 1;
  bool reach = true;
  for (int l = 0; l < top; ++l) {
    float* p = P + l * stride + i;
    const bool bit = (j >> l) & 1;
    if (reach) {
      if (bit) {
        carry += *p;
        *p = 0.f;
      } else {
        *p = carry;
      }
    }
    reach = reach && bit;
  }
  if (reach) P[top * stride + i] += carry;
  float acc = 0.f;
  for (int l = 0; l < levels; ++l) acc = fmaf(w[l], P[l * stride + i], acc);
  return acc;
}

template <typename VT>
__global__ void loglin_causal_kernel(const float* __restrict__ qs,
                                     const float* __restrict__ ks,
                                     const VT* __restrict__ v,
                                     VT* __restrict__ out,
                                     float* __restrict__ sl_out,
                                     float* __restrict__ zl_out,
                                     float* __restrict__ s_out,
                                     float* __restrict__ z_out, int n, int d,
                                     int dv, int r, int blk, int levels,
                                     int tile, int cols, double decay) {
  extern __shared__ float smem[];
  const int dp = d + 1;             // padded row: conflict-free column reads
  const int tp = tile + 1;
  const int dc = d * cols;
  float* fq = smem;                 // tile x dp     Phi(q)
  float* fk = fq + tile * dp;       // tile x dp     Phi(k)
  float* vt = fk + tile * dp;       // tile x cols   V (this CTA's columns)
  float* sc = vt + tile * cols;     // tile x tp     causal scores
  float* P = sc + tile * tp;        // levels x d x cols  pyramid columns
  float* So = P + levels * dc;      // d x cols      open granule
  float* A = So + dc;               // d x cols      weighted read
  float* Pz = A + dc;               // levels x d    pyramid normalizers
  float* zo = Pz + levels * d;      // d
  float* zA = zo + d;               // d
  float* den = zA + d;              // tile          row normalizers
  float* w = den + tile;            // levels        decay^l

  const int h = blockIdx.x;
  const int kv = h / r;
  const int c0 = blockIdx.y * cols;
  const int cw = min(cols, dv - c0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const float* qh = qs + static_cast<size_t>(h) * n * d;
  const float* kh = ks + static_cast<size_t>(kv) * n * d;
  const VT* vh = v + static_cast<size_t>(kv) * n * dv;

  for (int i = tid; i < levels * dc; i += nt) P[i] = 0.f;
  for (int i = tid; i < dc; i += nt) So[i] = A[i] = 0.f;
  for (int i = tid; i < levels * d; i += nt) Pz[i] = 0.f;
  for (int e = tid; e < d; e += nt) zo[e] = zA[e] = 0.f;
  for (int l = tid; l < levels; l += nt)
    w[l] = static_cast<float>(pow(decay, static_cast<double>(l)));
  __syncthreads();

  for (int g0 = 0, j = 0; g0 < n; g0 += blk, ++j) {
    const int gend = min(blk, n - g0) + g0;
    for (int t0 = g0; t0 < gend; t0 += tile) {
      const int rows = min(tile, gend - t0);
      for (int i = tid; i < tile * d; i += nt) {
        const int a = i / d, e = i - a * d;
        const bool ok = a < rows;
        const size_t g = static_cast<size_t>(t0 + a) * d + e;
        fq[a * dp + e] = ok ? expf(qh[g]) : 0.f;
        fk[a * dp + e] = ok ? expf(kh[g]) : 0.f;   // pad keys: Phi(k) = 0
      }
      for (int i = tid; i < tile * cols; i += nt) {
        const int a = i / cols, c = i - a * cols;
        vt[i] = (a < rows && c < cw)
                    ? lln::to_f32(vh[static_cast<size_t>(t0 + a) * dv + c0 + c])
                    : 0.f;
      }
      __syncthreads();

      // Intra-tile causal scores (earlier tiles of the granule are in A).
      for (int i = tid; i < tile * tile; i += nt) {
        const int a = i / tile, b = i - a * tile;
        float acc = 0.f;
        if (b <= a) {
          const float* qa = fq + a * dp;
          const float* kb = fk + b * dp;
          for (int e = 0; e < d; ++e) acc = fmaf(qa[e], kb[e], acc);
        }
        sc[a * tp + b] = acc;
      }
      __syncthreads();

      // Row normalizers: intra row sum + Phi(q).zA + EPS (a warp per row).
      for (int a = warp; a < rows; a += nw) {
        float acc = 0.f;
        for (int b = lane; b <= a; b += 32) acc += sc[a * tp + b];
        for (int e = lane; e < d; e += 32) acc = fmaf(fq[a * dp + e], zA[e], acc);
        acc = lln::warp_sum(acc);
        if (lane == 0) den[a] = acc + lln::kEps;
      }
      __syncthreads();

      // Outputs: (intra + Phi(q) A) / den.
      for (int i = tid; i < tile * cols; i += nt) {
        const int a = i / cols, c = i - a * cols;
        if (a >= rows || c >= cw) continue;
        float intra = 0.f, inter = 0.f;
        for (int b = 0; b <= a; ++b) intra = fmaf(sc[a * tp + b], vt[b * cols + c], intra);
        const float* qa = fq + a * dp;
        for (int e = 0; e < d; ++e) inter = fmaf(qa[e], A[e * cols + c], inter);
        out[(static_cast<size_t>(h) * n + t0 + a) * dv + c0 + c] =
            lln::from_f32<VT>((intra + inter) / den[a]);
      }
      __syncthreads();

      // The tile's keys join the open granule and the weighted read.
      for (int i = tid; i < dc; i += nt) {
        const int e = i / cols, c = i - e * cols;
        float acc = 0.f;
        for (int b = 0; b < rows; ++b) acc = fmaf(fk[b * dp + e], vt[b * cols + c], acc);
        So[i] += acc;
        A[i] += acc;
      }
      for (int e = tid; e < d; e += nt) {
        float acc = 0.f;
        for (int b = 0; b < rows; ++b) acc += fk[b * dp + e];
        zo[e] += acc;
        zA[e] += acc;
      }
      __syncthreads();
    }
    if (gend - g0 == blk) {         // the granule closed: carry it in
      for (int i = tid; i < dc; i += nt) {
        A[i] = carry_in(P, So[i], w, i, dc, j, levels);
        So[i] = 0.f;
      }
      for (int e = tid; e < d; e += nt) {
        zA[e] = carry_in(Pz, zo[e], w, e, d, j, levels);
        zo[e] = 0.f;
      }
      __syncthreads();
    }
  }

  if (sl_out == nullptr) return;
  for (int i = tid; i < levels * dc; i += nt) {
    const int l = i / dc, e = (i - l * dc) / cols, c = i - l * dc - e * cols;
    if (c < cw)
      sl_out[((static_cast<size_t>(h) * levels + l) * d + e) * dv + c0 + c] = P[i];
  }
  for (int i = tid; i < dc; i += nt) {
    const int e = i / cols, c = i - e * cols;
    if (c < cw) s_out[(static_cast<size_t>(h) * d + e) * dv + c0 + c] = So[i];
  }
  if (blockIdx.y == 0) {
    for (int i = tid; i < levels * d; i += nt)
      zl_out[static_cast<size_t>(h) * levels * d + i] = Pz[i];
    for (int e = tid; e < d; e += nt) z_out[static_cast<size_t>(h) * d + e] = zo[e];
  }
}

size_t smem_bytes(int d, int levels, int tile, int cols) {
  const size_t floats = static_cast<size_t>(tile) * (d + 1) * 2 +
                        static_cast<size_t>(tile) * cols +
                        static_cast<size_t>(tile) * (tile + 1) +
                        static_cast<size_t>(levels + 2) * d * cols +
                        static_cast<size_t>(levels + 2) * d + tile + levels;
  return floats * sizeof(float);
}

template <typename VT>
int launch(const float* qs, const float* ks, const void* v, void* out,
           float* sl, float* zl, float* s, float* z, int bh, int bg, int n,
           int d, int dv, int blk, int levels, int tile, int cols,
           double decay, cudaStream_t stream) {
  constexpr size_t kMaxSmem = 227 * 1024;
  while (cols > 8 && smem_bytes(d, levels, tile, cols) > kMaxSmem) cols /= 2;
  const size_t bytes = smem_bytes(d, levels, tile, cols);
  cudaError_t err = lln::allow_smem(loglin_causal_kernel<VT>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (dv + cols - 1) / cols);
  loglin_causal_kernel<VT><<<grid, 256, bytes, stream>>>(
      qs, ks, static_cast<const VT*>(v), static_cast<VT*>(out), sl, zl, s, z,
      n, d, dv, bh / bg, blk, levels, tile, cols, decay);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16 v on the tensor cores.
// ---------------------------------------------------------------------------

using namespace lln;

constexpr int kMaxLevels = 8;   // pyramid levels of the tensor-core path
constexpr int kEntries = 16;    // state entries per thread of a 32 x 64 slice

// aw (2,BG,nc,D,Dv): A_j as bf16 hi, then lo at + a_count; za (BG,nc,D):
// zA_j.  Slot j = 0 is never written (granule 0 reads no state).  The
// pyramid lives in dynamic shared memory, levels x kEntries x 128 fp32:
// entry k of thread t of level l at (l kEntries + k) 128 + t, so each
// thread carries its own entries and no barrier is needed for it.
template <int NP>
__global__ void __launch_bounds__(128)
pyramid_kernel(const float* __restrict__ ks,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ aw, float* __restrict__ za,
               float* __restrict__ sl_out, float* __restrict__ zl_out,
               float* __restrict__ s_out, float* __restrict__ z_out,
               size_t a_count, int n, int d, int dv, int r, int blk,
               int levels, double decay, int vec) {
  constexpr int LA = SD + 8, LB = SE + 8;
  constexpr int PS = kEntries * 128;    // one level's stride
  extern __shared__ float pyr[];
  __shared__ __align__(16) __nv_bfloat16 sa[NP][SR * LA];
  __shared__ __align__(16) __nv_bfloat16 sb[2][SR * LB];
  __shared__ float zred[4][SD];
  __shared__ float zpy[kMaxLevels * SD];   // the z pyramid, SD per level
  __shared__ float w[kMaxLevels];

  const int gi = blockIdx.x;
  const int d0 = blockIdx.y * SD, e0 = blockIdx.z * SE;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;   // rows 16 wm, columns 32 wn
  const int dd = tid & 31, rq = tid >> 5;    // staging slot
  const int nc = (n + blk - 1) / blk;
  const bool vz = vec != 0;
  const bool with_z = blockIdx.z == 0;
  const int ew = min(SE, dv - e0);

  for (int i = tid; i < levels * PS; i += 128) pyr[i] = 0.f;
  for (int i = tid; i < levels * SD; i += 128) zpy[i] = 0.f;
  if (tid < levels)
    w[tid] = static_cast<float>(pow(decay, static_cast<double>(tid)));
  __syncthreads();

  // The steps (SR rows of one granule) run as one software pipeline: the
  // next step's v (cp.async, double-buffered) and ks (registers) are in
  // flight while the tensor cores work on this one.
  const int spg = (blk + SR - 1) / SR;   // steps per closed granule
  const int nsteps = (nc - 1) * spg + (n - (nc - 1) * blk + SR - 1) / SR;
  float xv[SR / 4];
  const auto fetch = [&](int k) {
    const int j = k / spg, off = (k - j * spg) * SR;
    const int valid = min(SR, min(blk, n - j * blk) - off);
    const size_t r0 = static_cast<size_t>(gi) * n + j * blk + off;
    stage_rows<SE>(sb[k & 1], LB, v + r0 * dv + e0, dv, ew, valid, SR, vz);
#pragma unroll
    for (int u = 0; u < SR / 4; ++u) {
      const int rr = rq + 4 * u;
      xv[u] = rr < valid && d0 + dd < d ? ks[(r0 + rr) * d + d0 + dd] : 0.f;
    }
  };

  float tot[4][4];   // the granule's Phi(k)^T V slice
  zero_acc(tot);
  float zp = 0.f;    // this thread's part of z: column dd, rows rq + 4 u
  float zg = 0.f;    // (tid < SD) the granule's z at row d0 + tid
  fetch(0);
  cp_async_commit();
  for (int k = 0; k < nsteps; ++k) {
    const int j = k / spg, off = (k - j * spg) * SR;
    const int rows = min(blk, n - j * blk);
    const int valid = min(SR, rows - off);
    __syncthreads();                 // the last step's tiles are read
#pragma unroll
    for (int u = 0; u < SR / 4; ++u) {
      const int rr = rq + 4 * u;
      float f = rr < valid && d0 + dd < d ? expf(xv[u]) : 0.f;
      zp += f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const __nv_bfloat16 hb = __float2bfloat16(f);
        sa[p][rr * LA + dd] = hb;
        f -= __bfloat162float(hb);
      }
    }
    if (k + 1 < nsteps) fetch(k + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* sbk = sb[k & 1];
    float part[4][4];
    zero_acc(part);
#pragma unroll
    for (int kk = 0; kk < SR / 16; ++kk) {
      uint32_t af[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        frag_a_trans(af[p], sa[p] + kk * 16 * LA + wm * 16, LA, lane);
#pragma unroll
      for (int jj = 0; jj < 4; jj += 2) {
        uint32_t b[4];
        frag_b_trans(b, sbk + kk * 16 * LB + wn * 32 + jj * 8, LB, lane);
        const uint32_t b0[1][2] = {{b[0], b[1]}}, b1[1][2] = {{b[2], b[3]}};
        mma_planes<NP, 1>(part[jj], af, b0);
        mma_planes<NP, 1>(part[jj + 1], af, b1);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[jj][e] += part[jj][e];
    if (off + SR < rows) continue;   // not the granule's last step
    zred[rq][dd] = zp;
    __syncthreads();
    if (tid < SD)
      zg = ((zred[0][tid] + zred[1][tid]) + zred[2][tid]) + zred[3][tid];
    if (rows < blk) break;           // the open bucket: the last granule
    // Closed: carry it in; emit the read of granule j + 1.
    const bool emit = j + 1 < nc;
    const size_t slot = (static_cast<size_t>(gi) * nc + j + 1) * d;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kq = jj * 4 + 2 * hh;
        const float a0 = carry_in(pyr, tot[jj][2 * hh], w, kq * 128 + tid, PS,
                                  j, levels);
        const float a1 = carry_in(pyr, tot[jj][2 * hh + 1], w,
                                  (kq + 1) * 128 + tid, PS, j, levels);
        const int row = d0 + wm * 16 + gq + hh * 8;
        const int col = e0 + wn * 32 + jj * 8 + 2 * t4;
        if (emit && row < d)
          store_planes<2>(aw + (slot + row) * dv + col, a_count, a0, a1, col,
                          dv);
      }
    }
    if (tid < SD) {
      const float za_j = carry_in(zpy, zg, w, tid, SD, j, levels);
      if (with_z && emit && d0 + tid < d) za[slot + d0 + tid] = za_j;
    }
    zero_acc(tot);
    zp = 0.f;
  }
  cp_async_wait<0>();

  if (sl_out == nullptr) return;
  const bool open = n % blk != 0;      // tot and zg hold the open bucket
  for (int hh2 = 0; hh2 < r; ++hh2) {
    const size_t h = static_cast<size_t>(gi) * r + hh2;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = d0 + wm * 16 + gq + hh * 8;
        const int col = e0 + wn * 32 + jj * 8 + 2 * t4;
        if (row >= d || col >= dv) continue;
        const int k = jj * 4 + 2 * hh;
        for (int l = 0; l < levels; ++l)
          store_pair(sl_out + ((h * levels + l) * d + row) * dv + col,
                     pyr[(l * kEntries + k) * 128 + tid],
                     pyr[(l * kEntries + k + 1) * 128 + tid], col, dv);
        store_pair(s_out + (h * d + row) * dv + col,
                   open ? tot[jj][2 * hh] : 0.f,
                   open ? tot[jj][2 * hh + 1] : 0.f, col, dv);
      }
    }
    if (with_z && tid < SD && d0 + tid < d) {
      for (int l = 0; l < levels; ++l)
        zl_out[(h * levels + l) * d + d0 + tid] = zpy[l * SD + tid];
      z_out[h * d + d0 + tid] = open ? zg : 0.f;
    }
  }
}

template <int DP>
int launch_tc(const float* qs, const float* ks, const void* v, void* out,
              float* sl, float* zl, float* s, float* z, void* phk, void* aw,
              float* za, int bh, int bg, int n, int d, int dv, int blk,
              int levels, double decay, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t kcount = static_cast<size_t>(bg) * n * d;
  const int nc = (n + blk - 1) / blk;
  const size_t a_count = static_cast<size_t>(bg) * nc * d * dv;
  const auto fk = static_cast<bf*>(phk);
  const auto ap = static_cast<bf*>(aw);
  const auto vb = static_cast<const bf*>(v);
  cudaError_t err = phi_split<2>(ks, fk, kcount, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = d % 8 == 0 && dv % 8 == 0 && al(v) && al(out) && al(phk) &&
                  al(aw);
  const size_t pbytes =
      static_cast<size_t>(levels) * kEntries * 128 * sizeof(float);
  // Its static tiles (35 KB) leave less than 48 KB for the pyramid unless
  // the kernel asks, so it always asks.
  err = cudaFuncSetAttribute(pyramid_kernel<3>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pbytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pgrid(bg, (d + SD - 1) / SD, (dv + SE - 1) / SE);
  pyramid_kernel<3><<<pgrid, 128, pbytes, stream>>>(
      ks, vb, ap, za, sl, zl, s, z, a_count, n, d, dv, bh / bg, blk, levels,
      decay, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(causal_out<DP>(qs, vb, fk, ap, za,
                                          static_cast<bf*>(out), nullptr, bh,
                                          bg, n, d, dv, blk, kcount, a_count,
                                          vec, stream));
}

}  // namespace

// v_dtype: 0 = float32, 1 = bfloat16; sl, zl, s and z are all set or all
// null.  Returns cudaGetLastError().
extern "C" int loglin_causal_launch(const void* qs, const void* ks,
                                    const void* v, void* out, void* sl,
                                    void* zl, void* s, void* z, int bh, int bg,
                                    int n, int d, int dv, int v_dtype, int blk,
                                    int levels, int tile, int cols,
                                    double decay, void* stream) {
  if (blk < 1 || levels < 1 || tile < 1 || cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qs);
  auto k = static_cast<const float*>(ks);
  auto a = static_cast<float*>(sl);
  auto b = static_cast<float*>(zl);
  auto c = static_cast<float*>(s);
  auto e = static_cast<float*>(z);
  if (v_dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, a, b, c, e, bh, bg, n, d, dv,
                                 blk, levels, tile, cols, decay, st);
  if (v_dtype == 0)
    return launch<float>(q, k, v, out, a, b, c, e, bh, bg, n, d, dv, blk,
                         levels, tile, cols, decay, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 tensor-core path (v and out bf16; D, Dv <= 128; 1 <= levels <=
// kMaxLevels).  phk (2,BG,N,D) and aw (2,BG,nc,D,Dv) are bf16 scratch, za
// (BG,nc,D) fp32 scratch, nc = ceil(N / blk); sl, zl, s and z are all set
// or all null.  Returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape it does not take).
extern "C" int loglin_causal_tc_launch(const void* qs, const void* ks,
                                       const void* v, void* out, void* sl,
                                       void* zl, void* s, void* z, void* phk,
                                       void* aw, void* za, int bh, int bg,
                                       int n, int d, int dv, int blk,
                                       int levels, double decay,
                                       void* stream) {
  if (blk < 1 || levels < 1 || levels > kMaxLevels || bg < 1 || bh % bg)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qs);
  auto k = static_cast<const float*>(ks);
  auto a = static_cast<float*>(sl);
  auto b = static_cast<float*>(zl);
  auto c = static_cast<float*>(s);
  auto e = static_cast<float*>(z);
  auto zp = static_cast<float*>(za);
  if (d <= 64 && dv <= 64)
    return launch_tc<64>(q, k, v, out, a, b, c, e, phk, aw, zp, bh, bg, n, d,
                         dv, blk, levels, decay, st);
  if (d <= 128 && dv <= 128)
    return launch_tc<128>(q, k, v, out, a, b, c, e, phk, aw, zp, bh, bg, n,
                          d, dv, blk, levels, decay, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
