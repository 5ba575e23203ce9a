// The persistent tile loop shared by quality_vol and collapse_cavity.
//
// Both kernels map a stream of tet index rows (tet [N,4] int32) to the
// quality and the signed volume of each row (tet_math.cuh) and differ
// only in what they write: an epilogue, which may read one value of its
// own per row (a side stream, collapse's vol_floor).
//
// The work of a row is a dependent chain: its index row, then 12 corner
// and 4C metric gathers, then 370-600 SASS instructions of exact IEEE
// arithmetic, then the stores. The loop:
// - runs a persistent grid of at most SMs x resident CTAs, balanced so
//   that every CTA walks the same number of tiles of TILE rows (a short
//   stream gives one tile to each CTA, spread over all SMs);
// - reads a CTA's first tile with ordinary loads (one int4 a row), and
//   stages the index rows (16 B a row) and side values of its later
//   tiles in a ring of kStages shared-memory buffers, filled by 1-D bulk
//   asynchronous copies (cp.async.bulk, the TMA's non-tensor form) that
//   one thread issues, at the start and as each stage is read, and that
//   complete on one mbarrier per stage, so they arrive while the tiles
//   before compute; threads read their rows' indices from the ring as
//   one int4;
// - gives each thread one row of a tile and issues every corner and
//   metric gather of the row before any arithmetic.
// A tile that is not whole (the ragged end of the stream) and a stream
// whose base is not 16-byte aligned (a view at an offset) are read with
// ordinary loads instead of the ring, inside the same loop.
#pragma once

#include <cstdint>

#include "tet_math.cuh"

namespace pmt {

// ---- mbarrier and 1-D bulk copy (sm_90), as PTX ------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// order this CTA's earlier generic accesses to shared memory before the
// async proxy's next writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// arrive once and expect `bytes` of copies to complete on this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed; a copy
// that never completes traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// ---- the loop ----------------------------------------------------------

// tables and index stream of one launch
template <typename T>
struct Stream {
  const T* vert;  // [P,3]
  const T* met;   // [P,C]
  int P;
  const int* tet;  // [n,4]
  long long n;
  T alpha;
};

// The shape every (dtype, metric width) takes, measured on an H100 at
// the main path's sizes (PERF.md): 128-thread CTAs, one row a thread, so
// a tile of 128 rows, and two stages. Two rows a thread, 256 or 64
// threads, three stages, or a grid capped for more tiles per CTA were
// slower or no faster at f32 and f64, C = 1 and 6.
constexpr int TILE = 128;
constexpr int kStages = 2;

template <typename T, int C, class Epi>
__global__ void __launch_bounds__(TILE)
    tile_kernel(Stream<T> a, Epi epi, long long tiles) {
  constexpr int NS = kStages;
  constexpr bool SIDE = Epi::kSide;
  constexpr uint32_t TET_BYTES = TILE * 16;
  constexpr uint32_t SIDE_BYTES = SIDE ? TILE * sizeof(T) : 0;
  __shared__ int4 s_tet[NS][TILE];
  __shared__ __align__(16) T s_side[NS][SIDE ? TILE : 1];
  __shared__ uint64_t s_bar[NS];

  const T* side = epi.side();
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.tet) |
        reinterpret_cast<uintptr_t>(side)) & 15) == 0;
  // tiles [0, ring) are whole and may go through the ring
  const long long ring = aligned ? a.n / TILE : 0;
  // this CTA walks the tiles blockIdx.x + i * gridDim.x below `tiles`
  auto tile = [&](int i) { return blockIdx.x + (long long)i * gridDim.x; };
  // The first tile is read with ordinary loads: there is nothing for its
  // index rows to overlap with. Tiles 1, 2, ... come through the ring,
  // tile i in stage (i - 1) % NS, copied while the tiles before compute.
  // (A tile below `ring` is also below `tiles`.)
  const bool staged = tile(1) < ring;

  // thread 0: copy the i-th tile of this CTA into its stage
  auto issue = [&](int i) {
    if (tile(i) >= ring) return;
    uint64_t* bar = &s_bar[(i - 1) % NS];
    mbar_expect(bar, TET_BYTES + SIDE_BYTES);
    bulk_load(s_tet[(i - 1) % NS], a.tet + 4 * tile(i) * TILE, TET_BYTES,
              bar);
    if constexpr (SIDE)
      bulk_load(s_side[(i - 1) % NS], side + tile(i) * TILE, SIDE_BYTES,
                bar);
  };
  if (staged && threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(&s_bar[s], 1);
    fence_mbar_init();
    for (int i = 1; i <= NS; ++i) issue(i);
  }

  for (int i = 0; tile(i) < tiles; ++i) {
    const long long r = tile(i) * TILE + threadIdx.x;
    int4 id;
    T sv = T(0);
    if (i > 0 && tile(i) < ring) {
      // the barriers thread 0 initialised are visible from here on
      if (i == 1) __syncthreads();
      const int s = (i - 1) % NS;
      mbar_wait(&s_bar[s], ((i - 1) / NS) & 1);
      id = s_tet[s][threadIdx.x];
      if constexpr (SIDE) sv = s_side[s][threadIdx.x];
      // once every thread has read stage s, refill it with tile i + NS
      if (tile(i + NS) < ring) {
        __syncthreads();
        if (threadIdx.x == 0) {
          fence_proxy_async();
          issue(i + NS);
        }
      }
    } else {
      // ordinary loads (one int4 where the stream is aligned); rows past
      // the end repeat the last row and store nothing
      const long long rr = min(r, a.n - 1);
      if (aligned) {
        id = __ldg(reinterpret_cast<const int4*>(a.tet) + rr);
      } else {
        id = index_row(a.tet, rr);
      }
      if constexpr (SIDE) sv = __ldg(&side[rr]);
    }

    // every gather of the row, then the arithmetic
    int v4[4];
    T c[4][3], m4[4][C];
    load_corners(a.vert, a.P, id, v4, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int d = 0; d < C; ++d)
        m4[j][d] = __ldg(&a.met[C * (long long)v4[j] + d]);
    }
    const T v = tet_vol(c);
    const T q = tet_quality<T, C>(c, v, m4, a.alpha);
    if (r < a.n) epi(r, q, v, sv);
  }
}

// SM count and resident CTAs per SM of one instantiation, queried once
// per device and cached
struct Occupancy {
  int dev = -1, sms = 0, resident = 0, err = 0;
};

template <typename T, int C, class Epi>
static const Occupancy& occupancy() {
  static Occupancy o;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0 && o.dev != dev) {
    err = (int)cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (err == 0)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o.resident, tile_kernel<T, C, Epi>, TILE, 0);
    if (err == 0) o.dev = dev;
  }
  o.err = err;
  return o;
}

// Launch the loop over `a` with epilogue `epi` on `stream`. Returns a
// cudaError_t.
template <typename T, int C, class Epi>
int launch_tiles(const Stream<T>& a, const Epi& epi, void* stream) {
  const Occupancy& o = occupancy<T, C, Epi>();
  if (o.err) return o.err;
  const long long tiles = (a.n + TILE - 1) / TILE;
  long long grid = (long long)o.sms * o.resident;
  if (grid > tiles) grid = tiles;
  if (grid == 0) return 0;
  // the fewest CTAs that walk the same number of tiles each
  const long long per = (tiles + grid - 1) / grid;
  grid = (tiles + per - 1) / per;
  tile_kernel<T, C, Epi><<<(unsigned)grid, TILE, 0, (cudaStream_t)stream>>>(
      a, epi, tiles);
  return (int)cudaGetLastError();
}

// launch_tiles for a runtime metric width C (1 or 6)
template <typename T, class Epi>
int launch_tiles(int C, const Stream<T>& a, const Epi& epi, void* stream) {
  return C == 6 ? launch_tiles<T, 6>(a, epi, stream)
                : launch_tiles<T, 1>(a, epi, stream);
}

}  // namespace pmt
