// Causal LLN forward (paper eq. 8) with its optional extra outputs.
//
// Replaces src/repro/kernels/lln_attention.py:lln_causal_pallas
// (return_res and return_state).  Inputs qs (BH,N,D) and ks (BG,N,D) are
// fp32, pre-scaled and stabilized (<= 0); v (BG,N,Dv) is fp32 or bf16; query
// row h reads kv row h / r.  Outputs: out (BH,N,Dv) in v's type; optional
// (a null pointer deselects it) den (BH,N) fp32, the row normalizer the
// training backward reads, and s (BH,D,Dv) / z (BH,1,D) fp32, the state
// after the last token.
//
// Two paths, chosen by the caller (kernels/lln_attention.py:_tc_path) by
// type and width, each with its own entry point:
//
// bf16 v with D, Dv <= 128 (every model path on the card):
// lln_causal_tc_launch, on the tensor cores, chunk-parallel over blocks of
// blk rows (the kernels' own choice, lln_attention.TC_BLOCK = 64: of 64,
// 128 and 256 the backward is fastest at 64 on the card and this forward
// about flat; the caller's chunk does not enter the math).  Three launches:
//   1. phi_split (csrc/fused_state.cuh): Phi(k) as bf16 hi + lo.
//   2. state_kernel (fused_state.cuh): the exclusive block states (S_c,
//      z_c) once per kv group, not once per query head (r = 8 times less
//      state work than the CUDA-core kernel at yi-9b's shape), Phi(k) in
//      three bf16 planes against bf16 v, each 64-row step added in fp32;
//      S_c stored as bf16 hi + lo.  With the state it walks on through the
//      last block and writes the inclusive final (s, z) in fp32 into the r
//      query-head rows of the group.
//   3. causal_out_kernel (csrc/causal_out.cuh, shared with
//      loglin_causal.cu): one CTA per (query head, block, 64-row tile):
//      Phi(q) Phi(k)^T masked on the diagonal tile, its row sums, scores V,
//      Phi(q) S_c (fp32 operands as hi + lo), Phi(q) . z_c in fp32, den,
//      and out rounded once; den written with return_res.
//   Any N: the short last block's pad keys are staged as zero rows (Phi(k)
//   = 0 in every state and in the final state) and its pad rows are not
//   written; ks is never zero-padded (a zero ks is Phi(k) = 1).
//   Bound on the H100 (chip_smoke.py:_lln_counts): the bytes (qs, out, ks,
//   v) by about 2x over the products at the bf16 rate, at the serve and
//   training shapes.  What holds it back: causal_out_kernel reloads its
//   fragments per warp and keeps two CTAs per SM; the state walk is one
//   CTA per 32 x 64 state slice (128 at the training shape).
//
// fp32 v, or a width above 128: lln_causal_launch, the CUDA-core kernel
// below, IEEE fp32.  The TPU kernel walked the sequence on the grid's
// ordered minor axis with (S, z) in VMEM; here one CTA per (query head,
// COLS value columns) loops over the sequence in TILE-row tiles and keeps
// its columns of S (D x COLS) and all of z in shared memory.  Per tile:
// scores = tril(Phi(q) Phi(k)^T);  den = rowsum(scores) + Phi(q).z + EPS;
// out = (scores V + Phi(q) S) / den;  then S += Phi(k)^T V and z +=
// colsum Phi(k).  Every column group computes the same den; the first one
// writes it.  The ragged last tile loads pad keys as Phi(k) = 0 and writes
// no pad rows.  Bound: fp32 operations; each column group recomputes the
// tile's scores and each query head its group's state.
#include "causal_out.cuh"
#include "fused_state.cuh"

namespace {

template <typename VT>
__global__ void lln_causal_kernel(const float* __restrict__ qs,
                                  const float* __restrict__ ks,
                                  const VT* __restrict__ v,
                                  VT* __restrict__ out,
                                  float* __restrict__ den_out,
                                  float* __restrict__ s_out,
                                  float* __restrict__ z_out,
                                  int n, int d, int dv, int r, int tile,
                                  int cols) {
  extern __shared__ float smem[];
  const int dp = d + 1;             // padded row: conflict-free column reads
  const int tp = tile + 1;
  float* fq = smem;                 // tile x dp   Phi(q)
  float* fk = fq + tile * dp;       // tile x dp   Phi(k)
  float* vt = fk + tile * dp;       // tile x cols V (this CTA's columns)
  float* sc = vt + tile * cols;     // tile x tp   causal scores
  float* S = sc + tile * tp;        // d x cols    running state columns
  float* z = S + d * cols;          // d           running normalizer
  float* den = z + d;               // tile        row normalizers

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

  for (int i = tid; i < d * cols; i += nt) S[i] = 0.f;
  for (int i = tid; i < d; i += nt) z[i] = 0.f;

  for (int t0 = 0; t0 < n; t0 += tile) {
    const int rows = min(tile, n - t0);
    for (int i = tid; i < tile * d; i += nt) {
      const int a = i / d, e = i - a * d;
      const bool ok = a < rows;
      const size_t g = static_cast<size_t>(t0 + a) * d + e;
      fq[a * dp + e] = ok ? expf(qh[g]) : 0.f;
      fk[a * dp + e] = ok ? expf(kh[g]) : 0.f;     // pad keys: Phi(k) = 0
    }
    for (int i = tid; i < tile * cols; i += nt) {
      const int a = i / cols, c = i - a * cols;
      vt[i] = (a < rows && c < cw)
                  ? lln::to_f32(vh[static_cast<size_t>(t0 + a) * dv + c0 + c])
                  : 0.f;
    }
    __syncthreads();

    // Intra-tile causal scores.
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

    // Row normalizers: intra row sum + Phi(q).z + EPS (one warp per row).
    for (int a = warp; a < rows; a += nw) {
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

    // Outputs: (intra + inter) / den.
    for (int i = tid; i < tile * cols; i += nt) {
      const int a = i / cols, c = i - a * cols;
      if (a >= rows || c >= cw) continue;
      float intra = 0.f, inter = 0.f;
      for (int b = 0; b <= a; ++b) intra = fmaf(sc[a * tp + b], vt[b * cols + c], intra);
      const float* qa = fq + a * dp;
      for (int e = 0; e < d; ++e) inter = fmaf(qa[e], S[e * cols + c], inter);
      out[(static_cast<size_t>(h) * n + t0 + a) * dv + c0 + c] =
          lln::from_f32<VT>((intra + inter) / den[a]);
    }
    __syncthreads();

    // State update: S += Phi(k)^T V, z += colsum Phi(k).
    for (int i = tid; i < d * cols; i += nt) {
      const int e = i / cols, c = i - e * cols;
      float acc = 0.f;
      for (int b = 0; b < rows; ++b) acc = fmaf(fk[b * dp + e], vt[b * cols + c], acc);
      S[i] += acc;
    }
    for (int e = tid; e < d; e += nt) {
      float acc = 0.f;
      for (int b = 0; b < rows; ++b) acc += fk[b * dp + e];
      z[e] += acc;
    }
    __syncthreads();
  }

  if (s_out != nullptr)
    for (int i = tid; i < d * cols; i += nt) {
      const int e = i / cols, c = i - e * cols;
      if (c < cw) s_out[(static_cast<size_t>(h) * d + e) * dv + c0 + c] = S[i];
    }
  if (z_out != nullptr && blockIdx.y == 0)
    for (int e = tid; e < d; e += nt) z_out[static_cast<size_t>(h) * d + e] = z[e];
}

template <typename VT>
int launch(const float* qs, const float* ks, const void* v, void* out,
           float* den, float* s, float* z, int bh, int bg, int n, int d, int dv, int tile,
           int cols, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(tile) * (d + 1) * 2 +
                        static_cast<size_t>(tile) * cols +
                        static_cast<size_t>(tile) * (tile + 1) +
                        static_cast<size_t>(d) * cols + d + tile;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = lln::allow_smem(lln_causal_kernel<VT>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (dv + cols - 1) / cols);
  lln_causal_kernel<VT><<<grid, 256, bytes, stream>>>(
      qs, ks, static_cast<const VT*>(v), static_cast<VT*>(out), den, s, z, n, d,
      dv, bh / bg, tile, cols);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 v on the tensor cores.
// ---------------------------------------------------------------------------

using namespace lln;

template <int DP>
int launch_tc(const float* qs, const float* ks, const void* v, void* out,
              float* den, float* s, float* z, void* phk, void* sst,
              float* zst, int bh, int bg, int n, int d, int dv, int blk,
              cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t kcount = static_cast<size_t>(bg) * n * d;
  const int nb = (n + blk - 1) / blk;
  const size_t scount = static_cast<size_t>(bg) * nb * d * dv;
  const auto fk = static_cast<bf*>(phk);
  const auto sp = static_cast<bf*>(sst);
  const auto vb = static_cast<const bf*>(v);
  cudaError_t err = phi_split<2>(ks, fk, kcount, stream);
  if (err == cudaSuccess)
    err = block_states<false, 3, 2>(ks, vb, nullptr, nullptr, 1.f, sp, zst, s,
                                    z, bh / bg, bg, n, d, dv, 1, blk, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = d % 8 == 0 && dv % 8 == 0 && al(v) && al(out) && al(phk) &&
                  al(sst);
  return static_cast<int>(causal_out<DP>(qs, vb, fk, sp, zst,
                                          static_cast<bf*>(out), den, bh, bg,
                                          n, d, dv, blk, kcount, scount, vec,
                                          stream));
}

}  // namespace

// v_dtype: 0 = float32, 1 = bfloat16; den, s and z may be null.  Returns
// cudaGetLastError().
extern "C" int lln_causal_launch(const void* qs, const void* ks, const void* v,
                                 void* out, void* den, void* s, void* z,
                                 int bh, int bg,
                                 int n, int d, int dv, int v_dtype, int tile,
                                 int cols, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qs);
  auto k = static_cast<const float*>(ks);
  auto dp = static_cast<float*>(den);
  auto sp = static_cast<float*>(s);
  auto zp = static_cast<float*>(z);
  if (v_dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, dp, sp, zp, bh, bg, n, d, dv,
                                 tile, cols, st);
  if (v_dtype == 0)
    return launch<float>(q, k, v, out, dp, sp, zp, bh, bg, n, d, dv, tile, cols,
                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 tensor-core path (v and out bf16; D, Dv <= 128), blocks of blk
// rows (any N).  phk (2,BG,N,D) and sst (2,BG,nb,D,Dv) are bf16 scratch,
// zst (BG,nb,D) fp32 scratch, nb = ceil(N / blk); den, s and z may be null
// (s and z both or neither).  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int lln_causal_tc_launch(const void* qs, const void* ks,
                                    const void* v, void* out, void* den,
                                    void* s, void* z, void* phk, void* sst,
                                    void* zst, int bh, int bg, int n, int d,
                                    int dv, int blk, void* stream) {
  if (blk < 1 || bg < 1 || bh % bg != 0 || (s == nullptr) != (z == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qs);
  auto k = static_cast<const float*>(ks);
  auto dp = static_cast<float*>(den);
  auto sp = static_cast<float*>(s);
  auto zp = static_cast<float*>(z);
  auto zs = static_cast<float*>(zst);
  if (d <= 64 && dv <= 64)
    return launch_tc<64>(q, k, v, out, dp, sp, zp, phk, sst, zs, bh, bg, n, d,
                         dv, blk, st);
  if (d <= 128 && dv <= 128)
    return launch_tc<128>(q, k, v, out, dp, sp, zp, phk, sst, zs, bh, bg, n,
                          d, dv, blk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
