// quality_vol: fused per-tet quality and signed volume.
//
// Replaces the Pallas kernel parmmg_tpu/kernels/quality_k.py
// (_quality_vol_pallas :114, body quality_vol_kernel :77, math
// quality_vol_math :48). Plain version: parmmg_tpu_torch/kernels/
// quality_k.py:quality_vol_plain.
//
// What bounds it on an H100. Bytes: per row 16 B of indices in and two
// values out (24 B at f32), plus the vertex and metric tables read once
// (about 1.3 MB at the main path's size, so they stay in the 50 MB L2
// and the corner gathers hit L2 or L1). Instructions: the exact
// arithmetic (-fmad=false, IEEE division, pow) is about 370 SASS
// instructions a row at f32 C=1 and 600 at f64, whose issue alone takes
// longer than the bytes (PERF.md, "issue floor"). What sets the pace is
// the dependent chain of each row (index row, gathers, arithmetic,
// stores) and how many of those chains the SMs hold at once.
//
// Design: the persistent tile loop of tile_loop.cuh, with the corners
// in registers (tet_math.cuh folds the edge table at compile time; read
// from a table in constant memory it would put them in local memory).
// The index rows of a CTA's later tiles arrive in shared memory by bulk
// asynchronous copies while its first tile computes. This file holds
// only the epilogue: write q and vol.
#include "tile_loop.cuh"

template <typename T>
struct QualityVolOut {
  static constexpr bool kSide = false;
  T* q;
  T* vol;
  __host__ __device__ const T* side() const { return nullptr; }
  __device__ void operator()(long long r, T qr, T v, T) const {
    q[r] = qr;
    vol[r] = v;
  }
};

template <typename T>
static int launch(const void* vert, const void* met, int C, int P,
                  const void* tet, long long n, double alpha, void* q,
                  void* vol, void* stream) {
  const pmt::Stream<T> a{(const T*)vert, (const T*)met, P, (const int*)tet,
                         n, (T)alpha};
  return pmt::launch_tiles<T>(C, a, QualityVolOut<T>{(T*)q, (T*)vol},
                              stream);
}

extern "C" int quality_vol_f32(const void* vert, const void* met, int C,
                               int P, const void* tet, long long n,
                               double alpha, void* q, void* vol,
                               void* stream) {
  return launch<float>(vert, met, C, P, tet, n, alpha, q, vol, stream);
}

extern "C" int quality_vol_f64(const void* vert, const void* met, int C,
                               int P, const void* tet, long long n,
                               double alpha, void* q, void* vol,
                               void* stream) {
  return launch<double>(vert, met, C, P, tet, n, alpha, q, vol, stream);
}

// rows a tile of the loop (both tile-loop kernels), for the tests that
// size streams at its edges (kernels/build.py tile_rows)
extern "C" const int tile_loop_rows = pmt::TILE;

