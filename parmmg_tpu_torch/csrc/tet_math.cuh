// Per-tet geometry shared by the kernels of parmmg_tpu_torch.
//
// Every expression is written in the order of the plain PyTorch versions
// (parmmg_tpu_torch/kernels/quality_k.py, cavity_k.py): explicit cross
// and dot products, sums taken left to right. The sources are compiled
// with -fmad=false, so no multiply-add is contracted and each operation
// rounds as the eager PyTorch operation does; the volume gates and the
// split boolean therefore match their plain versions exactly.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pmt {

// JAX gather convention: a negative index wraps once, the rest is clamped.
__device__ __forceinline__ int fix_idx(int i, int P) {
  if (i < 0) i += P;
  return i < 0 ? 0 : (i >= P ? P - 1 : i);
}

// jnp.maximum(x, lo) / torch.clamp(x, min=lo): NaN propagates.
template <typename T>
__device__ __forceinline__ T maxp(T x, T lo) {
  return (x < lo) ? lo : x;
}

// Index row r of a stream [n,4] int32, four loads through the read-only
// path.
__device__ __forceinline__ int4 index_row(const int* __restrict__ rows,
                                          long long r) {
  return make_int4(__ldg(&rows[4 * r]), __ldg(&rows[4 * r + 1]),
                   __ldg(&rows[4 * r + 2]), __ldg(&rows[4 * r + 3]));
}

// The corners of index row `id` under the gather convention (v) and
// their coordinates through the read-only path (c).
template <typename T>
__device__ __forceinline__ void load_corners(const T* __restrict__ vert,
                                             int P, int4 id, int v[4],
                                             T c[4][3]) {
  v[0] = fix_idx(id.x, P);
  v[1] = fix_idx(id.y, P);
  v[2] = fix_idx(id.z, P);
  v[3] = fix_idx(id.w, P);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[k][j] = __ldg(&vert[3 * (long long)v[k] + j]);
  }
}

// (b-a) x (d-a) . (e-a): six times the signed volume of (a, b, d, e)
template <typename T>
__device__ __forceinline__ T vol6(const T a[3], const T b[3], const T d[3],
                                  const T e[3]) {
  T d1[3], d2[3], d3[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    d1[j] = b[j] - a[j];
    d2[j] = d[j] - a[j];
    d3[j] = e[j] - a[j];
  }
  T x = d1[1] * d2[2] - d1[2] * d2[1];
  T y = d1[2] * d2[0] - d1[0] * d2[2];
  T z = d1[0] * d2[1] - d1[1] * d2[0];
  return (x * d3[0] + y * d3[1]) + z * d3[2];
}

// ((c1-c0) x (c2-c0)) . (c3-c0) / 6
template <typename T>
__device__ __forceinline__ T tet_vol(const T c[4][3]) {
  return vol6(c[0], c[1], c[2], c[3]) / T(6);
}

// The six edges (ea(k), eb(k)) of a tet: (0,1) (0,2) (0,3) (1,2) (1,3)
// (2,3). Compile-time functions, not a table in constant memory: in
// unrolled loops they fold to constants, so corners indexed by them stay
// in registers instead of a local-memory array.
__host__ __device__ constexpr int ea(int k) {
  return k < 3 ? 0 : k < 5 ? 1 : 2;
}
__host__ __device__ constexpr int eb(int k) {
  return k < 3 ? k + 1 : k < 5 ? k - 1 : 3;
}

// Quality of one tet from its corners and the metrics at its corners
// (m4[k] of corner k, C = 1 or 6):
// ALPHA * volm / max(sum l^2, 1e-30)^1.5, non-finite -> 0.
template <typename T, int C>
__device__ __forceinline__ T tet_quality(const T c[4][3], T vol,
                                         const T m4[4][C], T alpha) {
  T rap = T(0), volm;
  if constexpr (C == 1) {
    T h = (((m4[0][0] + m4[1][0]) + m4[2][0]) + m4[3][0]) / T(4);
    T h2 = maxp(h * h, T(1e-30));
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      T ex = c[eb(k)][0] - c[ea(k)][0];
      T ey = c[eb(k)][1] - c[ea(k)][1];
      T ez = c[eb(k)][2] - c[ea(k)][2];
      T l2 = ((ex * ex + ey * ey) + ez * ez) / h2;
      rap = (k == 0) ? l2 : rap + l2;
    }
    volm = vol / maxp((h * h) * h, T(1e-30));
  } else {
    T m[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      m[j] = (((m4[0][j] + m4[1][j]) + m4[2][j]) + m4[3][j]) / T(4);
    }
    // rows of the symmetric tensor (m11 m12 m13 m22 m23 m33)
    const T M[3][3] = {{m[0], m[1], m[2]}, {m[1], m[3], m[4]},
                       {m[2], m[4], m[5]}};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      T e[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) e[j] = c[eb(k)][j] - c[ea(k)][j];
      T w[3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        w[j] = (e[0] * M[0][j] + e[1] * M[1][j]) + e[2] * M[2][j];
      T l2 = (w[0] * e[0] + w[1] * e[1]) + w[2] * e[2];
      rap = (k == 0) ? l2 : rap + l2;
    }
    T det = (m[0] * (m[3] * m[5] - m[4] * m[4])
             - m[1] * (m[1] * m[5] - m[4] * m[2]))
            + m[2] * (m[1] * m[4] - m[3] * m[2]);
    volm = vol * sqrt(maxp(det, T(0)));
  }
  T q = (alpha * volm) / pow(maxp(rap, T(1e-30)), T(1.5));
  return isfinite(q) ? q : T(0);
}

}  // namespace pmt
