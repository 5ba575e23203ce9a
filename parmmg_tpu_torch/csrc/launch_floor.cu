// launch_floor: an empty kernel on the grid of the one-row-a-thread
// kernels (row_grid.cuh), for measurement only. Its device time is the
// part of split_midpoint's and interp_bary's time at the same grid that
// no change to their bodies can remove (chip_smoke.py phase 3). Nothing
// on the main path calls it.
#include "row_grid.cuh"

__global__ void __launch_bounds__(pmt::kRowThreads) launch_floor_kernel() {}

// one launch over `rows` rows in each of `shards` shards; returns a
// cudaError_t
extern "C" int launch_floor(long long rows, long long shards, void* stream) {
  launch_floor_kernel<<<pmt::row_grid(rows, shards), pmt::kRowThreads, 0,
                        (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
