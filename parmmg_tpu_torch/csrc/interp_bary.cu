// interp_bary: clamped barycentric coordinates of located points and the
// iso metric interpolated there.
//
// Replaces the Pallas kernel parmmg_tpu/kernels/interp_k.py
// (_interp_bary_pallas :56, body interp_bary_kernel :44, reference
// _interp_bary_ref :38): for each query row, the barycentric coordinates
// of its point in its located tet (ops/locate.py tet_barycoords), clamped
// to the simplex and renormalised (clamp_bary), and the harmonic-in-h
// metric 1 / max(sum_i bary_i / max(h_i, 1e-30), 1e-30)
// (core/metric.py interp_metric). Plain version: parmmg_tpu_torch/
// kernels/interp_k.py:interp_bary_plain, same expression order; built
// with -fmad=false, so the two agree to the last bit.
//
// Stacked call: D shards of P table rows and Q query rows each; all
// shards go in one launch, as the vmapped JAX program does.
//
// Bound on an H100: bytes. Per row the kernel reads 16 B of indices and
// 3 coordinates, and writes 4 weights and one size (32 B in, 20 B out at
// f32); the tables (P x 4 values) are read once in the best case and the
// corner gathers hit L2. About 100 operations a row do not come near the
// vector peak. At the distributed path's shapes (4 x 11,773 rows) the
// bytes take under a microsecond, the order of an empty launch, so the
// kernel is one wave and one dependent chain: shard offsets, index row,
// corner gathers, arithmetic, stores. Design: shorten the chain. A 2-D
// grid (row_grid.cuh): rows of a shard on x, the shard on y, so the
// shard's table and stream offsets come from blockIdx.y with no division
// of the row number; one thread a row issues its index row's and its
// point's loads before the corner gathers.
// The expressions, their order and every IEEE division are the plain
// version's, so the outputs match it bit for bit.
#include <cfloat>

#include "row_grid.cuh"
#include "tet_math.cuh"

template <typename T>
__device__ __forceinline__ T tiny_of();
template <>
__device__ __forceinline__ float tiny_of<float>() { return FLT_MIN; }
template <>
__device__ __forceinline__ double tiny_of<double>() { return DBL_MIN; }

template <typename T>
__global__ void __launch_bounds__(pmt::kRowThreads)
    interp_bary_kernel(const T* __restrict__ vert, const T* __restrict__ met,
                       int P, const int* __restrict__ vids,
                       const T* __restrict__ pts, long long Q,
                       T* __restrict__ bary, T* __restrict__ met_q) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  // this CTA's shard: its table, and row i of its stream
  const long long s = blockIdx.y;
  const T* vs = vert + 3LL * P * s;
  const T* ms = met + (long long)P * s;
  const long long r = s * Q + i;
  const int4 id = pmt::index_row(vids, r);
  const T p[3] = {__ldg(&pts[3 * r]), __ldg(&pts[3 * r + 1]),
                  __ldg(&pts[3 * r + 2])};
  int v4[4];
  T c[4][3], h[4];
  pmt::load_corners(vs, P, id, v4, c);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __ldg(&ms[v4[k]]);

  const T v = pmt::vol6(c[0], c[1], c[2], c[3]);
  T lam[4] = {pmt::vol6(p, c[1], c[2], c[3]), pmt::vol6(c[0], p, c[2], c[3]),
              pmt::vol6(c[0], c[1], p, c[3]), pmt::vol6(c[0], c[1], c[2], p)};
  const T tiny = tiny_of<T>();
  const T denom = (fabs(v) > tiny) ? v : ((v >= T(0)) ? tiny : -tiny);
#pragma unroll
  for (int k = 0; k < 4; ++k) lam[k] = pmt::maxp(lam[k] / denom, T(0));
  const T sum = pmt::maxp(((lam[0] + lam[1]) + lam[2]) + lam[3], T(1e-30));
  T inv = T(0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T b = lam[k] / sum;
    bary[4 * r + k] = b;
    const T w = b / pmt::maxp(h[k], T(1e-30));
    inv = (k == 0) ? w : inv + w;
  }
  met_q[r] = T(1) / pmt::maxp(inv, T(1e-30));
}

template <typename T>
static int launch(const void* vert, const void* met, int P,
                  const void* vids, const void* pts, long long D,
                  long long Q, void* bary, void* met_q, void* stream) {
  interp_bary_kernel<T><<<pmt::row_grid(Q, D), pmt::kRowThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)vert, (const T*)met, P, (const int*)vids, (const T*)pts, Q,
      (T*)bary, (T*)met_q);
  return (int)cudaGetLastError();
}

extern "C" int interp_bary_f32(const void* vert, const void* met, int P,
                               const void* vids, const void* pts,
                               long long D, long long Q, void* bary,
                               void* met_q, void* stream) {
  return launch<float>(vert, met, P, vids, pts, D, Q, bary, met_q, stream);
}

extern "C" int interp_bary_f64(const void* vert, const void* met, int P,
                               const void* vids, const void* pts,
                               long long D, long long Q, void* bary,
                               void* met_q, void* stream) {
  return launch<double>(vert, met, P, vids, pts, D, Q, bary, met_q, stream);
}
