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
// v + Phi(q) sum_l w_l S_l) / (the same with z + EPS), w_l = decay^l; once
// the granule closes, its (S, z) enters the pyramid by a binary increment
// j -> j+1: pure adds (every bucket shares the one reference), merged
// levels zeroed, the top level saturating.  Unoccupied levels hold zeros,
// so the static weights need no occupancy mask.
//
// Design: the TPU kernel walked the granules on the grid's ordered minor
// axis with the pyramid in VMEM.  GPU blocks run in no order, so one CTA
// per (query head, COLS value columns) loops over the sequence inside the
// CTA, granule by granule in TILE-row tiles (the last tile of a granule may
// be short, so any blk works), and keeps in shared memory its columns of
// every pyramid level, of the open granule S_open and of the weighted read
// A = sum_l w_l S_l + S_open (and all of z for each).  A is rebuilt once
// per granule, after the carry, and grows by each tile's Phi(k)^T V, so a
// query costs one D-long product per column.  The pad keys of a ragged
// last tile load as Phi(k) = 0 and its pad rows are not written.  The final
// state is a plain write after the loop (the TPU revisited an (h,0,0,0)
// output block).  All products are fp32 on the CUDA cores.
//
// Bound on the H100: fp32 operations at the serve shapes (see
// kernels/loglinear.py).  The pyramid takes L*D*COLS fp32 of shared memory
// (64 KB at L = 4, D = 128), so one CTA fits per SM; the launcher halves
// COLS if the pyramid would not fit.
#include "common.cuh"

namespace {

// Enter the closed granule j (open[i]) into the pyramid P (levels rows of
// `stride` floats), empty the open granule and rebuild agg[i] =
// sum_l w_l P_l[i].  The carry reaches level l iff bits 0..l-1 of j are
// all set; there it takes an empty level (bit l clear) or merges with the
// bucket there and moves up (bit l set); the top level saturates.
__device__ __forceinline__ void carry_in(float* P, float* open, float* agg,
                                         const float* w, int i, int stride,
                                         int j, int levels) {
  float carry = open[i];
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
  open[i] = 0.f;
  float acc = 0.f;
  for (int l = 0; l < levels; ++l) acc = fmaf(w[l], P[l * stride + i], acc);
  agg[i] = acc;
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
      for (int i = tid; i < dc; i += nt) carry_in(P, So, A, w, i, dc, j, levels);
      for (int e = tid; e < d; e += nt) carry_in(Pz, zo, zA, w, e, d, j, levels);
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
