// Chunked LLN decode against a carried state, with the state's rescale
// folded in (T new tokens per launch).
//
// Replaces src/repro/kernels/lln_attention.py:lln_decode_pallas and the
// rescale of the carried state that runs before it (the reference's
// kernels/ops.py:lln_decode_chunk).  qs (BH,T,D) and ks (BG,T,D) fp32,
// pre-scaled and stabilized; v (BG,T,Dv) fp32 or bf16; s (BH,D,Dv) and z
// (BH,1,D) fp32 at the state's old key constant; scale (BH,) fp32, or null
// for none.  With f = scale[h] (1 when null), fs = f*s and fz = f*z, each
// one fp32 multiply (never fused into an FMA, so a rescale here gives the
// bits of a rescale in torch before a launch without one):
//   out = (Phi(q) fs + intra) / (Phi(q) . fz + intra_z + EPS)   (v's type)
//   s1 = fs + Phi(k)^T v,  z1 = fz + colsum Phi(k)               (fp32)
// Query row h reads kv row h / r.
//
// Bound: the state's bytes (read s, write s1: 16.8 MB per layer at the
// serve shape B=4, H=32, D=Dv=128).  Design:
// - Each element of s is read once, by a 16-byte load, into registers; a
//   thread holds 8 rows x 4 columns and issues its 8 loads before the
//   first use, so every SM has tens of KB in flight.  s1 leaves the same
//   registers by 16-byte stores.
// - One CTA per (query head, CB value columns), its warps over D in row
//   warps of 32 rows.  In a warp, lane (rg, cq) = (lane / 8, lane % 8)
//   takes rows 8 rg .. 8 rg + 7 and columns 4 cq .. 4 cq + 3 of the warp's
//   32, so one load instruction covers four whole 128-byte lines.  CB is the
//   wrapper's choice (kernels/lln_attention.py:_decode_columns): on the
//   H100, 64 columns (two CTAs per SM) beat 128 at T <= 4 and lose above,
//   where each CTA's scores cost more.  A cluster of CTAs splitting D and
//   adding their sums through distributed shared memory was slower at every
//   T (PERF.md).
// - Phi(q) fs is summed over a thread's rows, the warp's row groups
//   (shuffles) and the CTA's row warps, always in that order: no atomics,
//   two runs give the same bits.
// - Tokens go 16 at a time with no padding.  The scores and normalizers of
//   a group need only its staged rows, so they run first, while the state
//   is in flight.  A group of at most 4 tokens takes each state row as its
//   load arrives: its Phi(q) fs sums, its advance, its store of s1, so s1
//   leaves while later rows are still in flight.  A longer group takes its
//   sums, then advances the state by its Phi(k)^T v in registers, so a
//   later group sees the earlier ones through the state and s is never
//   read twice.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int ROWS = 8;    // state rows per thread
constexpr int WROWS = 4 * ROWS;  // state rows per warp (four row groups)
constexpr int TOK = 16;    // tokens per group
constexpr int SUB = 4;     // tokens whose partial sums a thread holds at once
constexpr int THREADS = 512;  // at most, per CTA

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int left) {
  if constexpr (VEC) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(p[0], left > 1 ? p[1] : 0.f, left > 2 ? p[2] : 0.f,
                       left > 3 ? p[3] : 0.f);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, float4 x, int left) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = x;
  } else {
    p[0] = x.x;
    if (left > 1) p[1] = x.y;
    if (left > 2) p[2] = x.z;
    if (left > 3) p[3] = x.w;
  }
}

__device__ __forceinline__ float4 scale4(float4 x, float f) {
  return make_float4(__fmul_rn(x.x, f), __fmul_rn(x.y, f), __fmul_rn(x.z, f),
                     __fmul_rn(x.w, f));
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// ROWS consecutive floats of shared memory (16-byte aligned) as an array.
__device__ __forceinline__ void load_rows(const float* p, float (&x)[ROWS]) {
#pragma unroll
  for (int j = 0; j < ROWS / 4; ++j) {
    const float4 a = reinterpret_cast<const float4*>(p)[j];
    x[4 * j] = a.x;
    x[4 * j + 1] = a.y;
    x[4 * j + 2] = a.z;
    x[4 * j + 3] = a.w;
  }
}

// Grid (BH, ceil(Dv / CB)); rwarps x cwarps warps per CTA.  dp = rwarps *
// WROWS >= D is the staged row pitch.
template <typename VT, int CB, bool VEC>
__global__ void __launch_bounds__(THREADS)
    lln_decode_kernel(const float* __restrict__ qs,
                      const float* __restrict__ ks, const VT* __restrict__ v,
                      const float* __restrict__ s, const float* __restrict__ z,
                      const float* __restrict__ scale, VT* __restrict__ out,
                      float* __restrict__ s1, float* __restrict__ z1, int t,
                      int d, int dv, int r, int rwarps, int cwarps) {
  extern __shared__ __align__(16) float smem[];
  const int dp = rwarps * WROWS;
  const int tk = min(t, TOK);                  // tokens per group, at most
  const int tkp = (tk + SUB - 1) / SUB * SUB;  // staged, zero-padded
  float* fq = smem;                  // tkp x dp   Phi(q)
  float* fk = fq + tkp * dp;         // tkp x dp   Phi(k)
  float* vv = fk + tkp * dp;         // tkp x CB   v (this CTA's columns)
  float* zc = vv + tkp * CB;         // dp         z, advanced per group
  float* red = zc + dp;              // rwarps x tk x CB  partial Phi(q) fs
  float* sc = red + rwarps * tk * CB;  // tk x tk  causal scores
  float* den = sc + tk * tk;         // tk         normalizers

  const int h = blockIdx.x;
  const int kv = h / r;
  const int cb = blockIdx.y * CB;
  const int ncols = min(CB, dv - cb);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = nt >> 5;
  const int rw = warp / cwarps, cw = warp - rw * cwarps;
  const int cl = cw * 32 + (lane & 7) * 4;     // column in the CTA's block
  const int row0 = rw * WROWS + (lane >> 3) * ROWS;
  const int left = dv - (cb + cl);             // columns from cl to Dv

  // The state first: every load in flight before anything waits on one.
  const float* sh = s + static_cast<size_t>(h) * d * dv + cb + cl;
  float4 st[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int e = row0 + i;
    st[i] = (e < d && left > 0) ? load4<VEC>(sh + static_cast<size_t>(e) * dv,
                                             left)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float f = scale != nullptr ? scale[h] : 1.f;
  for (int e = tid; e < dp; e += nt)
    zc[e] = e < d ? __fmul_rn(z[static_cast<size_t>(h) * d + e], f) : 0.f;

  for (int t0 = 0; t0 < t; t0 += TOK) {
    const int n = min(TOK, t - t0);
    const int np = (n + SUB - 1) / SUB * SUB;
    for (int i = tid; i < np * dp; i += nt) {
      const int a = i / dp, e = i - a * dp;
      const bool ok = a < n && e < d;
      fq[i] = ok ? expf(qs[(static_cast<size_t>(h) * t + t0 + a) * d + e])
                 : 0.f;
      fk[i] = ok ? expf(ks[(static_cast<size_t>(kv) * t + t0 + a) * d + e])
                 : 0.f;
    }
    for (int i = tid; i < np * CB; i += nt) {
      const int a = i / CB, c = i - a * CB;
      vv[i] = (a < n && c < ncols)
                  ? lln::to_f32(v[(static_cast<size_t>(kv) * t + t0 + a) * dv
                                  + cb + c])
                  : 0.f;
    }
    __syncthreads();

    // Causal scores and normalizers first: they need only the staged rows,
    // so they overlap the state's loads.  One token per warp (every column
    // block of a head computes the same ones).
    for (int a = warp; a < n; a += nwarps) {
      float rowsum = 0.f;
      for (int b = 0; b <= a; ++b) {
        float acc = 0.f;
        for (int e = lane; e < dp; e += 32)
          acc = fmaf(fq[a * dp + e], fk[b * dp + e], acc);
        acc = lln::warp_sum(acc);
        if (lane == 0) sc[a * tk + b] = acc;
        rowsum += acc;
      }
      float acc = 0.f;
      for (int e = lane; e < dp; e += 32) acc = fmaf(fq[a * dp + e], zc[e], acc);
      acc = lln::warp_sum(acc);
      if (lane == 0) den[a] = acc + rowsum + lln::kEps;
    }

    // Phi(q) fs over this thread's rows, SUB tokens at a time, summed over
    // the warp's four row groups; lanes of row group 0 keep the sums.  A
    // group of at most SUB tokens takes each row as its load arrives: its
    // sums, then its advance by the group's keys and, in the last group, its
    // store, so s1 leaves while later rows are still in flight.
    const bool last = t0 + TOK >= t;
    const bool fused = np == SUB;
    float* s1h = s1 + static_cast<size_t>(h) * d * dv + cb + cl;
    for (int a0 = 0; a0 < np; a0 += SUB) {
      float4 p[SUB];
#pragma unroll
      for (int u = 0; u < SUB; ++u) p[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (t0 == 0 && a0 == 0) st[i] = scale4(st[i], f);
        const float* fqi = fq + a0 * dp + row0 + i;
#pragma unroll
        for (int u = 0; u < SUB; ++u) fma4(p[u], fqi[u * dp], st[i]);
        if (fused) {
          for (int a = 0; a < n; ++a)
            fma4(st[i], fk[a * dp + row0 + i],
                 *reinterpret_cast<const float4*>(vv + a * CB + cl));
          if (last && row0 + i < d && left > 0)
            store4<VEC>(s1h + static_cast<size_t>(row0 + i) * dv, st[i], left);
        }
      }
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
#pragma unroll
        for (int off = 8; off < 32; off <<= 1) {
          p[u].x += __shfl_xor_sync(0xffffffffu, p[u].x, off);
          p[u].y += __shfl_xor_sync(0xffffffffu, p[u].y, off);
          p[u].z += __shfl_xor_sync(0xffffffffu, p[u].z, off);
          p[u].w += __shfl_xor_sync(0xffffffffu, p[u].w, off);
        }
        if (lane < 8 && a0 + u < n)
          *reinterpret_cast<float4*>(red + (rw * tk + a0 + u) * CB + cl) = p[u];
      }
    }
    if (!fused) {
      // The state advances by the group's keys, token by token.
      for (int a = 0; a < n; ++a) {
        float x[ROWS];
        load_rows(fk + a * dp + row0, x);
        const float4 vq = *reinterpret_cast<const float4*>(vv + a * CB + cl);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) fma4(st[i], x[i], vq);
      }
      if (last && left > 0) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          if (row0 + i < d)
            store4<VEC>(s1h + static_cast<size_t>(row0 + i) * dv, st[i], left);
      }
    }
    __syncthreads();

    // Outputs: the row warps' partial sums in a fixed order, the
    // intra-group term, the normalizer.
    for (int i = tid; i < n * ncols; i += nt) {
      const int a = i / ncols, c = i - a * ncols;
      float inter = 0.f;
      for (int w = 0; w < rwarps; ++w) inter += red[(w * tk + a) * CB + c];
      float intra = 0.f;
      for (int b = 0; b <= a; ++b)
        intra = fmaf(sc[a * tk + b], vv[b * CB + c], intra);
      out[(static_cast<size_t>(h) * t + t0 + a) * dv + cb + c] =
          lln::from_f32<VT>((intra + inter) / den[a]);
    }
    for (int e = tid; e < d; e += nt) {
      float acc = zc[e];
      for (int b = 0; b < n; ++b) acc += fk[b * dp + e];
      zc[e] = acc;
    }
    __syncthreads();   // red, the staging and zc are reused or read next
  }
  if (blockIdx.y == 0)
    for (int e = tid; e < d; e += nt) z1[static_cast<size_t>(h) * d + e] = zc[e];
}

template <typename VT, int CB, bool VEC>
int launch(const float* qs, const float* ks, const void* v, const float* s,
           const float* z, const float* scale, void* out, float* s1,
           float* z1, int bh, int bg, int t, int d, int dv,
           cudaStream_t stream) {
  const int rwarps = (d + WROWS - 1) / WROWS;
  const int cwarps = (min(dv, CB) + 31) / 32;
  if (rwarps * cwarps * 32 > THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = rwarps * WROWS;
  const int tk = min(t, TOK);
  const int tkp = (tk + SUB - 1) / SUB * SUB;
  const size_t floats = static_cast<size_t>(tkp) * (2 * dp + CB) + dp +
                        static_cast<size_t>(rwarps) * tk * CB + tk * tk + tk;
  const size_t bytes = floats * sizeof(float);
  auto kernel = lln_decode_kernel<VT, CB, VEC>;
  cudaError_t err = lln::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (dv + CB - 1) / CB);
  kernel<<<grid, rwarps * cwarps * 32, bytes, stream>>>(
      qs, ks, static_cast<const VT*>(v), s, z, scale, static_cast<VT*>(out),
      s1, z1, t, d, dv, bh / bg, rwarps, cwarps);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT, bool VEC>
int launch_cb(int cols, const float* qs, const float* ks, const void* v,
              const float* s, const float* z, const float* scale, void* out,
              float* s1, float* z1, int bh, int bg, int t, int d, int dv,
              cudaStream_t st) {
  switch (cols) {
    case 32:
      return launch<VT, 32, VEC>(qs, ks, v, s, z, scale, out, s1, z1, bh, bg,
                                 t, d, dv, st);
    case 64:
      return launch<VT, 64, VEC>(qs, ks, v, s, z, scale, out, s1, z1, bh, bg,
                                 t, d, dv, st);
    case 128:
      return launch<VT, 128, VEC>(qs, ks, v, s, z, scale, out, s1, z1, bh,
                                  bg, t, d, dv, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename VT>
int launch_vec(int cols, const float* qs, const float* ks, const void* v,
               const float* s, const float* z, const float* scale, void* out,
               float* s1, float* z1, int bh, int bg, int t, int d, int dv,
               cudaStream_t st) {
  const bool vec = dv % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(s) |
                     reinterpret_cast<uintptr_t>(s1)) & 15) == 0;
  if (vec)
    return launch_cb<VT, true>(cols, qs, ks, v, s, z, scale, out, s1, z1, bh,
                               bg, t, d, dv, st);
  return launch_cb<VT, false>(cols, qs, ks, v, s, z, scale, out, s1, z1, bh,
                              bg, t, d, dv, st);
}

}  // namespace

// scale: (BH,) fp32 or null.  v_dtype: 0 = float32, 1 = bfloat16.  cols:
// value columns per CTA, 32, 64 or 128.  Returns the launch's CUDA error
// code.
extern "C" int lln_decode_launch(const void* qs, const void* ks, const void* v,
                                 const void* s, const void* z,
                                 const void* scale, void* out, void* s1,
                                 void* z1, int bh, int bg, int t, int d,
                                 int dv, int v_dtype, int cols, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qs);
  auto k = static_cast<const float*>(ks);
  auto a = static_cast<const float*>(s);
  auto b = static_cast<const float*>(z);
  auto f = static_cast<const float*>(scale);
  auto so = static_cast<float*>(s1);
  auto zo = static_cast<float*>(z1);
  if (v_dtype == 1)
    return launch_vec<__nv_bfloat16>(cols, q, k, v, a, b, f, out, so, zo, bh,
                                     bg, t, d, dv, st);
  if (v_dtype == 0)
    return launch_vec<float>(cols, q, k, v, a, b, f, out, so, zo, bh, bg, t,
                             d, dv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
