// Row-wise bitonic sort of S rows of N int32 arrays (Hopper, sm_90a).
//
// Replaces the TPU kernel density_tpu/kernels/bigsort.py::sort (the
// Pallas segmented bitonic network). Same contract: sort by the first
// n_keys arrays, signed and lexicographic, carrying the rest (1-3 arrays
// in all); N a power of two. It runs the very same Batcher network
// (stage k, pass distance j, partner i ^ j, ascending where
// (i & k) == 0), so its output equals the TPU kernel's element for
// element, ties included.
//
// What bounds it on this card: bytes, in principle. A sort of 38 x
// 65536 x 2 int32 arrays moves 40 MB in and out once (12 us at 3.35
// TB/s), but the network has log2 N (log2 N + 1) / 2 passes, and a pass
// that goes through shared memory and a __syncthreads() costs far more
// than its bytes. So each pass runs at the cheapest level that holds
// both partners (the levels of sort_levels.cuh, shared with bitonic.cu:
// registers, warp shuffles, a column layout through shared memory), and
// this file's plan adds one global launch per merge stage:
//   * one tile launch sorts tiles of T elements: the whole row up to
//     16384, else 8192 (a tile of 16384 has an SM to itself;
//     `tools/sort_tiles.py` times each tile);
//   * each merge stage k above T: its passes of distance k/2 ... 4096
//     touch only index bits 12 ... log2 k - 1, and the direction (i & k)
//     is the same across them, so one global launch (per 4 bits) runs
//     them in registers, each thread holding the elements of a row that
//     differ only in those bits; then one tile launch in tiles of 4096
//     (so that more CTAs share an SM) runs distances 2048 ... 1.
// For N > T that is 1 + 2 log2(N/T) launches a sort: 7 for N = 65536.
// The first launch reads the caller's arrays and writes the output, so
// nothing is copied.

#include "sort_levels.cuh"

namespace {

constexpr int kMergeLogTile = 12;    // merge stages: tiles of 4096
#ifndef BIGSORT_LOG_TILE             // longer rows: tiles of 8192 (a
#define BIGSORT_LOG_TILE 13          //   diagnostic build may set 12-14)
#endif
constexpr int kLogTile = BIGSORT_LOG_TILE;
static_assert(kMergeLogTile <= kLogTile && kLogTile <= kMaxLogTile,
              "BIGSORT_LOG_TILE must lie in 12 ... 14");

// The schedule: one tile launch sorts every tile; each merge stage above
// the tile is a global launch per 4 bits above the merge tile, then one
// merge-tile launch.
struct Plan {
  template <int NA, int NK>
  static int run(const Arrays& src, int32_t* const* dst, int S, int log_n,
                 cudaStream_t st) {
    int rc = tile_setup<NA, NK>();
    if (rc) return rc;
    const int log_t = log_n <= kMaxLogTile ? log_n : kLogTile;
    if ((rc = launch_tile<NA, NK>(src, dst, S, log_n, log_t, 2, st)))
      return rc;
    const Arrays out = {{dst[0], dst[1], dst[2]}};
    const int log_m = kMergeLogTile;  // log_t >= log_m wherever a merge runs
    for (int log_k = log_t + 1; log_k <= log_n; ++log_k) {
      if ((rc = launch_global_stage<NA, NK>(dst, S, log_n, log_m, log_k, st)))
        return rc;
      if ((rc = launch_tile<NA, NK>(out, dst, S, log_n, log_m, 1 << log_k,
                                    st)))
        return rc;
    }
    return 0;
  }
};

}  // namespace

// Sorts the contiguous, 16-byte aligned (S, N) arrays s0..s2 into the
// fresh outputs d0..d2; unused arrays are null. Returns the CUDA error
// code (0 = success).
extern "C" int bigsort_sort(const void* s0, const void* s1, const void* s2,
                            void* d0, void* d1, void* d2, int n_arrays,
                            int n_keys, int S, int N, void* stream) {
  return dispatch<Plan>(s0, s1, s2, d0, d1, d2, n_arrays, n_keys, S, N,
                        stream);
}
