// Device helpers shared by the training kernels (lln_diag_fused.cu,
// lln_causal_bwd.cu, lln_diag_fused_bwd.cu): tile loads from device memory
// into padded shared-memory rows, and a dot product over shared rows.
#pragma once

#include "common.cuh"

namespace lln {

// dst[a * sp + c] = f(src[a * ld + c0 + c], a) for a < rows, c < w, where
// src points at the tile's first row.  Every thread of the block takes part;
// each issues kBatch loads before it stores, so that many device-memory
// reads are in flight per thread instead of one.
template <typename T, typename F>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int sp,
                                          const T* __restrict__ src, int ld,
                                          int rows, int c0, int w, F f) {
  constexpr int kBatch = 8;
  const int total = rows * w;
  const int nt = blockDim.x;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * nt) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nt;
      if (i < total) {
        const int a = i / w, c = i - a * w;
        x[u] = to_f32(src[static_cast<size_t>(a) * ld + c0 + c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nt;
      if (i < total) {
        const int a = i / w, c = i - a * w;
        dst[a * sp + c] = f(x[u], a);
      }
    }
  }
}

struct Ident {
  __device__ __forceinline__ float operator()(float x, int) const { return x; }
};
struct Exp {
  __device__ __forceinline__ float operator()(float x, int) const {
    return expf(x);
  }
};
struct Scale {
  float s;
  __device__ __forceinline__ float operator()(float x, int) const {
    return x * s;
  }
};
// x / row[a]: a cotangent over its row normalizer, u = g / den.
struct DivRow {
  const float* row;
  __device__ __forceinline__ float operator()(float x, int a) const {
    return x / row[a];
  }
};

// sum_e a[e] * b[e], fp32 FMAs in order.
__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float acc = 0.f;
  for (int e = 0; e < n; ++e) acc = fmaf(a[e], b[e], acc);
  return acc;
}

// The largest power of two that divides blk, capped at cap: the row tile of
// a kernel whose tiles must not straddle a blk boundary.
inline int tile_for(int blk, int cap) {
  int t = 1;
  while (t < cap && blk % (2 * t) == 0) t *= 2;
  return t;
}

}  // namespace lln
