// collapse_cavity: gated quality of the retargeted collapse ball.
//
// Replaces the Pallas kernel parmmg_tpu/kernels/cavity_k.py
// (_collapse_cavity_pallas :61, body collapse_cavity_kernel :52,
// reference _collapse_cavity_ref :44). Plain version:
// parmmg_tpu_torch/kernels/cavity_k.py:collapse_cavity_plain.
//
// out[r] = q(new_tet[r]) where vol(new_tet[r]) > vol_floor[r], else -inf
// — the operand of collapse's ball-min scatter.
//
// What bounds it on an H100: as quality_vol.cu — bytes (16 B of indices
// and one floor value in, one value out per row, the tables L2-resident)
// and, tighter, the issue of the ~370 exact SASS instructions a row
// (f32 C=1); the dependent chain of each row sets the pace.
// Design: the persistent tile loop of tile_loop.cuh, with vol_floor as
// its side stream (staged in shared memory beside the index rows). This
// file holds only the epilogue: the volume gate, evaluated in the plain
// version's rounding order (-fmad=false), and one write per row.
#include "tile_loop.cuh"

template <typename T>
struct GatedOut {
  static constexpr bool kSide = true;
  const T* vol_floor;
  T* out;
  __host__ __device__ const T* side() const { return vol_floor; }
  __device__ void operator()(long long r, T q, T v, T floor) const {
    out[r] = (v > floor) ? q : -INFINITY;
  }
};

template <typename T>
static int launch(const void* vert, const void* met, int C, int P,
                  const void* tet, const void* vol_floor, long long n,
                  double alpha, void* out, void* stream) {
  const pmt::Stream<T> a{(const T*)vert, (const T*)met, P, (const int*)tet,
                         n, (T)alpha};
  return pmt::launch_tiles<T>(C, a, GatedOut<T>{(const T*)vol_floor, (T*)out},
                              stream);
}

extern "C" int collapse_cavity_f32(const void* vert, const void* met, int C,
                                   int P, const void* tet,
                                   const void* vol_floor, long long n,
                                   double alpha, void* out, void* stream) {
  return launch<float>(vert, met, C, P, tet, vol_floor, n, alpha, out,
                       stream);
}

extern "C" int collapse_cavity_f64(const void* vert, const void* met, int C,
                                   int P, const void* tet,
                                   const void* vol_floor, long long n,
                                   double alpha, void* out, void* stream) {
  return launch<double>(vert, met, C, P, tet, vol_floor, n, alpha, out,
                        stream);
}

