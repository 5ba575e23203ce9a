// split_midpoint: child-volume validity of split's offset midpoint.
//
// Replaces the Pallas kernel parmmg_tpu/kernels/cavity_k.py
// (_split_midpoint_pallas :147, body split_midpoint_kernel :127,
// reference _split_midpoint_ref :115). Plain version:
// parmmg_tpu_torch/kernels/cavity_k.py:split_midpoint_plain.
//
// ok[r] = vol(A) > f*|vol(parent)| && vol(B) > f*|vol(parent)|, where
// child A replaces local slot lj of tet r with newp[r], child B slot li,
// and f = POS_VOL_FRAC.
//
// Bound on an H100: bytes — per row 16 B of indices, 3 midpoint values,
// two slot ids and one byte out (about 37 B at f32), plus the vertex
// table (L2-resident at the main path's size). At the per-shard shapes
// (about 60k rows) that is under a microsecond, the order of an empty
// launch, so the kernel is one wave and one dependent chain: index row,
// corner gathers, arithmetic, store. Design: shorten the chain. One
// thread a row (row_grid.cuh); the row's index, midpoint and slot loads
// are issued together before the corner gathers; corners come through
// the read-only path into registers, and so do the two children, each
// the parent with the midpoint selected into one slot (a pointer to the
// midpoint in that slot instead puts the f64 corners in local memory);
// child B's volume is skipped where child A fails (computing both
// measured slower on an H100, PERF.md). The volumes keep the plain
// version's rounding order (-fmad=false) and its IEEE division by 6, so
// the boolean matches it exactly.
#include "row_grid.cuh"
#include "tet_math.cuh"

template <typename T>
__global__ void __launch_bounds__(pmt::kRowThreads)
    split_midpoint_kernel(const T* __restrict__ vert, int P,
                          const int* __restrict__ tet,
                          const T* __restrict__ newp,
                          const int* __restrict__ li,
                          const int* __restrict__ lj, long long n, T frac,
                          unsigned char* __restrict__ ok) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  // every load of the row before the gathers that depend on it
  const int4 id = pmt::index_row(tet, r);
  const T p[3] = {__ldg(&newp[3 * r]), __ldg(&newp[3 * r + 1]),
                  __ldg(&newp[3 * r + 2])};
  const int sa = __ldg(&lj[r]), sb = __ldg(&li[r]);
  int v[4];
  T c[4][3];
  pmt::load_corners(vert, P, id, v, c);
  // the children: the parent with slot sa (A) or sb (B) at the midpoint
  T a[4][3], b[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[k][j] = (k == sa) ? p[j] : c[k][j];
      b[k][j] = (k == sb) ? p[j] : c[k][j];
    }
  }
  // child B's volume only where child A clears the floor
  const T floor = frac * fabs(pmt::tet_vol(c));
  ok[r] = (pmt::tet_vol(a) > floor) && (pmt::tet_vol(b) > floor);
}

template <typename T>
static int launch(const void* vert, int P, const void* tet, const void* newp,
                  const void* li, const void* lj, long long n, double frac,
                  void* ok, void* stream) {
  split_midpoint_kernel<T><<<pmt::row_grid(n, 1), pmt::kRowThreads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)vert, P, (const int*)tet, (const T*)newp, (const int*)li,
      (const int*)lj, n, (T)frac, (unsigned char*)ok);
  return (int)cudaGetLastError();
}

extern "C" int split_midpoint_f32(const void* vert, int P, const void* tet,
                                  const void* newp, const void* li,
                                  const void* lj, long long n, double frac,
                                  void* ok, void* stream) {
  return launch<float>(vert, P, tet, newp, li, lj, n, frac, ok, stream);
}

extern "C" int split_midpoint_f64(const void* vert, int P, const void* tet,
                                  const void* newp, const void* li,
                                  const void* lj, long long n, double frac,
                                  void* ok, void* stream) {
  return launch<double>(vert, P, tet, newp, li, lj, n, frac, ok, stream);
}

// threads a CTA of the one-row-a-thread kernels' grid, read by the tests
// that place streams at the edges of a CTA
extern "C" const int row_threads = pmt::kRowThreads;
