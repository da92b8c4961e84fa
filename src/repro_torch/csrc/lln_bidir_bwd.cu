// Backward of the bidirectional LLN forward (the encoder).
//
// Replaces src/repro/kernels/lln_backward.py:lln_bidir_bwd_pallas.
// Inputs: qs (BH,N,D), ks (BG,N,D) fp32; v (BG,N,Dv), the cotangent g
// (BH,N,Dv) and the saved output o (BH,N,Dv) in one type (fp32 or bf16);
// den (BH,N), s (BG,D,Dv) and z (BG,1,D) fp32, the forward's residuals.
// Outputs, fp32: dqs (BH,N,D), dks
// (BG,N,D), dv (BG,N,Dv), dks and dv summed over the r query heads of a kv
// head.  Scratch, fp32: w (BH,N), ds (BG,D,Dv), dz (BG,D).
//
// Math (the reference's): u = g / den, w = (g . o) / den;
//   dqs = Phi(q) * (u s^T - w z);
//   dS = sum_{h in group, i} Phi(q_i)^T u_i,  dz = sum w_i Phi(q_i);
//   dv = Phi(k) dS,  dks = Phi(k) * (v dS^T - dz).
//
// Design: the reference's three kernels.  dq: one CTA per (query head,
// TILE-row tile) with the kv head's s in shared memory, rows padded to
// Dv + 1 so that a warp's 32 consecutive rows of s fall in 32 banks; it
// writes each row's w for the reduce.  Reduce: the TPU revisited one output
// block per kv head in grid order (r, then N); GPU programs run in no order,
// so one CTA per (kv head, COLS columns of dS) loops over the r query heads
// and the sequence in that order, each entry of dS summed by one thread: a
// fixed order and no atomics, so gradients are the same bit for bit from
// run to run.  dk/dv: one CTA per (kv head, TILE-row tile) with dS (rows
// padded) and dz in shared memory.  Any N.  All products are fp32 on the
// CUDA cores.
//
// Bound on the H100: fp32 operations at the encoder shapes (see
// kernels/lln_backward.py).
#include "train_common.cuh"

namespace {

constexpr int TILE = 64;
constexpr int COLS = 32;

template <typename T>
__global__ void bidir_dq_kernel(const float* __restrict__ qs,
                                const T* __restrict__ g,
                                const T* __restrict__ o,
                                const float* __restrict__ den_in,
                                const float* __restrict__ s,
                                const float* __restrict__ z,
                                float* __restrict__ dqs,
                                float* __restrict__ w_out, int n, int d, int dv,
                                int r) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  const int sp = dv + 1;
  float* S = smem;                  // d x sp      forward s
  float* zs = S + d * sp;           // d           forward z
  float* gu = zs + d;               // TILE x dv   g, then u = g / den
  float* fq = gu + TILE * dv;       // TILE x dp   Phi(q)
  float* den = fq + TILE * dp;      // TILE
  float* w = den + TILE;            // TILE

  const int h = blockIdx.x;
  const int kv = h / r;
  const int t0 = blockIdx.y * TILE;
  const int rows = min(TILE, n - t0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const size_t row0 = static_cast<size_t>(h) * n + t0;

  lln::load_tile(S, sp, s + static_cast<size_t>(kv) * d * dv, dv, d, 0, dv,
                 lln::Ident{});
  lln::load_tile(zs, d, z + static_cast<size_t>(kv) * d, d, 1, 0, d,
                 lln::Ident{});
  lln::load_tile(gu, dv, g + row0 * dv, dv, rows, 0, dv, lln::Ident{});
  lln::load_tile(fq, dp, qs + row0 * d, d, rows, 0, d, lln::Exp{});
  for (int a = tid; a < rows; a += nt) den[a] = den_in[row0 + a];
  __syncthreads();
  for (int a = warp; a < rows; a += nw) {
    float acc = 0.f;
    for (int c = lane; c < dv; c += 32)
      acc = fmaf(gu[a * dv + c], lln::to_f32(o[(row0 + a) * dv + c]), acc);
    acc = lln::warp_sum(acc);
    if (lane == 0) {
      w[a] = acc / den[a];
      w_out[row0 + a] = w[a];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * dv; i += nt) gu[i] = gu[i] / den[i / dv];
  __syncthreads();
  for (int i = tid; i < rows * d; i += nt) {
    const int a = i / d, e = i - a * d;
    const float acc = lln::dot(gu + a * dv, S + e * sp, dv);
    dqs[(row0 + a) * d + e] = fq[a * dp + e] * (acc - w[a] * zs[e]);
  }
}

template <typename T>
__global__ void bidir_dsdz_kernel(const float* __restrict__ qs,
                                  const T* __restrict__ g,
                                  const float* __restrict__ den_in,
                                  const float* __restrict__ w_in,
                                  float* __restrict__ ds,
                                  float* __restrict__ dz, int n, int d, int dv,
                                  int r) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* fq = smem;                 // TILE x dp   Phi(q)
  float* ut = fq + TILE * dp;       // TILE x COLS u (this CTA's columns)
  float* dS = ut + TILE * COLS;     // d x COLS
  float* dzs = dS + d * COLS;       // d
  float* den = dzs + d;             // TILE
  float* w = den + TILE;            // TILE

  const int kv = blockIdx.x;
  const int c0 = blockIdx.y * COLS;
  const int cw = min(COLS, dv - c0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = tid; i < d * COLS; i += nt) dS[i] = 0.f;
  for (int i = tid; i < d; i += nt) dzs[i] = 0.f;
  for (int hh = 0; hh < r; ++hh) {
    const size_t hq = (static_cast<size_t>(kv) * r + hh) * n;
    for (int t0 = 0; t0 < n; t0 += TILE) {
      const int rows = min(TILE, n - t0);
      __syncthreads();              // previous tile's readers are done
      for (int a = tid; a < rows; a += nt) {
        den[a] = den_in[hq + t0 + a];
        w[a] = w_in[hq + t0 + a];
      }
      lln::load_tile(fq, dp, qs + (hq + t0) * d, d, rows, 0, d, lln::Exp{});
      __syncthreads();
      for (int i = tid; i < rows * COLS; i += nt) {
        const int a = i / COLS, c = i - a * COLS;
        ut[i] = c < cw ? lln::DivRow{den}(
                             lln::to_f32(g[(hq + t0 + a) * dv + c0 + c]), a)
                       : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < d * COLS; i += nt) {
        const int e = i / COLS, c = i - e * COLS;
        float acc = dS[i];
        for (int a = 0; a < rows; ++a)
          acc = fmaf(fq[a * dp + e], ut[a * COLS + c], acc);
        dS[i] = acc;
      }
      if (blockIdx.y == 0)
        for (int e = tid; e < d; e += nt) {
          float acc = dzs[e];
          for (int a = 0; a < rows; ++a) acc = fmaf(w[a], fq[a * dp + e], acc);
          dzs[e] = acc;
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < d * cw; i += nt) {
    const int e = i / cw, c = i - e * cw;
    ds[(static_cast<size_t>(kv) * d + e) * dv + c0 + c] = dS[e * COLS + c];
  }
  if (blockIdx.y == 0)
    for (int e = tid; e < d; e += nt) dz[static_cast<size_t>(kv) * d + e] = dzs[e];
}

template <typename T>
__global__ void bidir_dkv_kernel(const float* __restrict__ ks,
                                 const T* __restrict__ v,
                                 const float* __restrict__ ds,
                                 const float* __restrict__ dz,
                                 float* __restrict__ dks,
                                 float* __restrict__ dvo, int n, int d,
                                 int dv) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  const int sp = dv + 1;
  float* dS = smem;                 // d x sp
  float* dzs = dS + d * sp;         // d
  float* fk = dzs + d;              // TILE x dp   Phi(k)
  float* vt = fk + TILE * dp;       // TILE x dv

  const int kv = blockIdx.x;
  const int t0 = blockIdx.y * TILE;
  const int rows = min(TILE, n - t0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t row0 = static_cast<size_t>(kv) * n + t0;

  lln::load_tile(dS, sp, ds + static_cast<size_t>(kv) * d * dv, dv, d, 0, dv,
                 lln::Ident{});
  lln::load_tile(dzs, d, dz + static_cast<size_t>(kv) * d, d, 1, 0, d,
                 lln::Ident{});
  lln::load_tile(fk, dp, ks + row0 * d, d, rows, 0, d, lln::Exp{});
  lln::load_tile(vt, dv, v + row0 * dv, dv, rows, 0, dv, lln::Ident{});
  __syncthreads();
  for (int i = tid; i < rows * dv; i += nt) {
    const int j = i / dv, c = i - j * dv;
    const float* fj = fk + j * dp;
    float acc = 0.f;
    for (int e = 0; e < d; ++e) acc = fmaf(fj[e], dS[e * sp + c], acc);
    dvo[(row0 + j) * dv + c] = acc;
  }
  for (int i = tid; i < rows * d; i += nt) {
    const int j = i / d, e = i - j * d;
    const float acc = lln::dot(vt + j * dv, dS + e * sp, dv);
    dks[(row0 + j) * d + e] = fk[j * dp + e] * (acc - dzs[e]);
  }
}

template <typename T>
int launch(const float* qs, const float* ks, const void* v, const void* g,
           const void* o, const float* den, const float* s, const float* z,
           float* dqs, float* dks, float* dv_, float* w, float* ds, float* dz,
           int bh, int bg, int n, int d, int dv, cudaStream_t stream) {
  if (bh % bg != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t tf = TILE;
  const size_t sp = static_cast<size_t>(dv) + 1;
  const size_t dq_bytes = (static_cast<size_t>(d) * sp + d + tf * dv +
                           tf * (d + 1) + 2 * tf) * sizeof(float);
  const size_t red_bytes = (tf * (d + 1) + tf * COLS +
                            static_cast<size_t>(d) * COLS + d + 2 * tf) *
                           sizeof(float);
  const size_t dkv_bytes = (static_cast<size_t>(d) * sp + d + tf * (d + 1) +
                            tf * dv) * sizeof(float);
  cudaError_t err = lln::allow_smem(bidir_dq_kernel<T>, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lln::allow_smem(bidir_dsdz_kernel<T>, red_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lln::allow_smem(bidir_dkv_kernel<T>, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int r = bh / bg;
  const int nb = (n + TILE - 1) / TILE;
  const auto gp = static_cast<const T*>(g);
  bidir_dq_kernel<T><<<dim3(bh, nb), 256, dq_bytes, stream>>>(
      qs, gp, static_cast<const T*>(o), den, s, z, dqs, w, n, d, dv, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 red_grid(bg, (dv + COLS - 1) / COLS);
  bidir_dsdz_kernel<T><<<red_grid, 256, red_bytes, stream>>>(
      qs, gp, den, w, ds, dz, n, d, dv, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bidir_dkv_kernel<T><<<dim3(bg, nb), 256, dkv_bytes, stream>>>(
      ks, static_cast<const T*>(v), ds, dz, dks, dv_, n, d, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (v, g, o): 0 = float32, 1 = bfloat16.  w, ds and dz are fp32
// scratch of (BH,N), (BG,D,Dv) and (BG,D).  Returns cudaGetLastError().
extern "C" int lln_bidir_bwd_launch(
    const void* qs, const void* ks, const void* v, const void* g,
    const void* o, const void* den, const void* s, const void* z, void* dqs,
    void* dks, void* dv, void* w, void* ds, void* dz, int bh, int bg, int n,
    int d, int dvd, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 1)
    return launch<__nv_bfloat16>(c(qs), c(ks), v, g, o, c(den), c(s), c(z),
                                 f(dqs), f(dks), f(dv), f(w), f(ds), f(dz), bh,
                                 bg, n, d, dvd, st);
  if (dtype == 0)
    return launch<float>(c(qs), c(ks), v, g, o, c(den), c(s), c(z), f(dqs),
                         f(dks), f(dv), f(w), f(ds), f(dz), bh, bg, n, d, dvd,
                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}
