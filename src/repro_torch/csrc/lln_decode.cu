// Chunked LLN decode against a carried state (T new tokens per launch).
//
// Replaces src/repro/kernels/lln_attention.py:lln_decode_pallas.  qs
// (BH,T,D) and ks (BG,T,D) fp32, pre-scaled and stabilized; v (BG,T,Dv)
// fp32 or bf16; s0 (BH,D,Dv) and z0 (BH,1,D) fp32, already rescaled to the
// chunk's key constant.  Outputs out (BH,T,Dv) in v's type, s1 = s0 +
// Phi(k)^T v and z1 = z0 + colsum Phi(k) (fp32).  Query row h reads kv row
// h / r.
//
// Design: the kernel is bound by the state's bytes (read s0, write s1), so
// each element of s0 is read once: one CTA per (query head, 32 value
// columns), 8 warps splitting D, each lane owning one column.  A lane
// accumulates Phi(q_i).s0[:, c] for up to 16 tokens in registers while it
// writes s1 from the same load; partial sums meet in shared memory.  The
// small intra-chunk causal term and the normalizers are recomputed by every
// CTA of a head.  T is looped inside the CTA with no padding (the TPU padded
// T to 16 with keys at -1e30); chunks longer than 16 tokens re-read s0 once
// per 16 tokens.
#include "common.cuh"

namespace {

constexpr int COLS = 32;    // value columns per CTA (one per lane)
constexpr int SLICES = 8;   // warps per CTA, each a slice of D
constexpr int TCHUNK = 16;  // tokens whose partial sums a lane holds

template <typename VT>
__global__ void lln_decode_kernel(const float* __restrict__ qs,
                                  const float* __restrict__ ks,
                                  const VT* __restrict__ v,
                                  const float* __restrict__ s0,
                                  const float* __restrict__ z0,
                                  VT* __restrict__ out,
                                  float* __restrict__ s1,
                                  float* __restrict__ z1, int t, int d,
                                  int dv, int r) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* fq = smem;                      // t x dp   Phi(q)
  float* fk = fq + t * dp;               // t x dp   Phi(k)
  float* vt = fk + t * dp;               // t x COLS V (this CTA's columns)
  float* sc = vt + t * COLS;             // t x t    causal scores
  float* den = sc + t * t;               // t        normalizers
  float* zs = den + t;                   // d        z0
  float* red = zs + d;                   // SLICES x TCHUNK x COLS partials

  const int h = blockIdx.x;
  const int kv = h / r;
  const int c0 = blockIdx.y * COLS;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int slice = tid >> 5;
  const int c = c0 + lane;
  const bool cok = c < dv;

  for (int i = tid; i < t * d; i += nt) {
    const int a = i / d, e = i - a * d;
    fq[a * dp + e] = expf(qs[(static_cast<size_t>(h) * t + a) * d + e]);
    fk[a * dp + e] = expf(ks[(static_cast<size_t>(kv) * t + a) * d + e]);
  }
  for (int i = tid; i < t * COLS; i += nt) {
    const int a = i / COLS, cc = c0 + (i - a * COLS);
    vt[i] = cc < dv ? lln::to_f32(v[(static_cast<size_t>(kv) * t + a) * dv + cc])
                    : 0.f;
  }
  for (int e = tid; e < d; e += nt) zs[e] = z0[static_cast<size_t>(h) * d + e];
  __syncthreads();

  for (int i = tid; i < t * t; i += nt) {
    const int a = i / t, b = i - a * t;
    float acc = 0.f;
    if (b <= a)
      for (int e = 0; e < d; ++e) acc = fmaf(fq[a * dp + e], fk[b * dp + e], acc);
    sc[i] = acc;
  }
  __syncthreads();

  for (int a = slice; a < t; a += SLICES) {
    float acc = 0.f;
    for (int b = lane; b <= a; b += 32) acc += sc[a * t + b];
    for (int e = lane; e < d; e += 32) acc = fmaf(fq[a * dp + e], zs[e], acc);
    acc = lln::warp_sum(acc);
    if (lane == 0) den[a] = acc + lln::kEps;
  }
  if (blockIdx.y == 0) {
    for (int e = tid; e < d; e += nt) {
      float acc = zs[e];
      for (int b = 0; b < t; ++b) acc += fk[b * dp + e];
      z1[static_cast<size_t>(h) * d + e] = acc;
    }
  }

  const float* s0h = s0 + static_cast<size_t>(h) * d * dv;
  float* s1h = s1 + static_cast<size_t>(h) * d * dv;
  for (int i0 = 0; i0 < t; i0 += TCHUNK) {
    const int ni = min(TCHUNK, t - i0);
    float part[TCHUNK];
#pragma unroll
    for (int ii = 0; ii < TCHUNK; ++ii) part[ii] = 0.f;
    for (int e = slice; e < d; e += SLICES) {
      const float sv = cok ? s0h[static_cast<size_t>(e) * dv + c] : 0.f;
#pragma unroll
      for (int ii = 0; ii < TCHUNK; ++ii)
        if (ii < ni) part[ii] = fmaf(fq[(i0 + ii) * dp + e], sv, part[ii]);
      if (i0 == 0 && cok) {
        float add = 0.f;
        for (int b = 0; b < t; ++b) add = fmaf(fk[b * dp + e], vt[b * COLS + lane], add);
        s1h[static_cast<size_t>(e) * dv + c] = sv + add;
      }
    }
#pragma unroll
    for (int ii = 0; ii < TCHUNK; ++ii)
      red[(slice * TCHUNK + ii) * COLS + lane] = part[ii];
    __syncthreads();    // also orders den (above) before its use below
    for (int i = tid; i < ni * COLS; i += nt) {
      const int ii = i / COLS, ln = i - ii * COLS;
      const int cc = c0 + ln;
      if (cc >= dv) continue;
      const int a = i0 + ii;
      float inter = 0.f;
      for (int sl = 0; sl < SLICES; ++sl) inter += red[(sl * TCHUNK + ii) * COLS + ln];
      float intra = 0.f;
      for (int b = 0; b <= a; ++b) intra = fmaf(sc[a * t + b], vt[b * COLS + ln], intra);
      out[(static_cast<size_t>(h) * t + a) * dv + cc] =
          lln::from_f32<VT>((intra + inter) / den[a]);
    }
    __syncthreads();    // red is reused by the next token chunk
  }
}

template <typename VT>
int launch(const float* qs, const float* ks, const void* v, const float* s0,
           const float* z0, void* out, float* s1, float* z1, int bh, int bg,
           int t, int d, int dv, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(t) * (d + 1) * 2 +
                        static_cast<size_t>(t) * COLS +
                        static_cast<size_t>(t) * t + t + d +
                        static_cast<size_t>(SLICES) * TCHUNK * COLS;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = lln::allow_smem(lln_decode_kernel<VT>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (dv + COLS - 1) / COLS);
  lln_decode_kernel<VT><<<grid, SLICES * 32, bytes, stream>>>(
      qs, ks, static_cast<const VT*>(v), s0, z0, static_cast<VT*>(out), s1, z1,
      t, d, dv, bh / bg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v_dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int lln_decode_launch(const void* qs, const void* ks, const void* v,
                                 const void* s0, const void* z0, void* out,
                                 void* s1, void* z1, int bh, int bg, int t,
                                 int d, int dv, int v_dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qs);
  auto k = static_cast<const float*>(ks);
  auto a = static_cast<const float*>(s0);
  auto b = static_cast<const float*>(z0);
  auto s = static_cast<float*>(s1);
  auto z = static_cast<float*>(z1);
  if (v_dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, a, b, out, s, z, bh, bg, t, d, dv, st);
  if (v_dtype == 0)
    return launch<float>(q, k, v, a, b, out, s, z, bh, bg, t, d, dv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
