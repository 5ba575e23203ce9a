// The grid of the one-row-a-thread kernels (split_midpoint, interp_bary);
// the launch-floor probe (launch_floor.cu) times an empty kernel on the
// same grid.
//
// Rows of a shard run on x, one a thread; shards on y, so a stacked
// launch finds its shard's offsets from blockIdx.y instead of dividing
// the row number.
#pragma once

#include <cuda_runtime.h>

namespace pmt {

// Threads a CTA, measured on an H100 at the main path's shapes (PERF.md).
constexpr int kRowThreads = 128;

// CTAs of `rows` rows in each of `shards` shards
inline dim3 row_grid(long long rows, long long shards) {
  return dim3((unsigned)((rows + kRowThreads - 1) / kRowThreads),
              (unsigned)shards);
}

}  // namespace pmt
