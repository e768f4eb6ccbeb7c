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
// What bounds it on this card: bytes. A sort of 38 x 65536 x 2 int32
// arrays moves 40 MB in and out once (12 us at 3.35 TB/s); the compares
// are far below the ALU rate. The design keeps as many passes as it can
// in shared memory:
//   * tile kernel: a tile of T = min(N, 4096) elements of every array
//     (at most 3 x 16 KB = 48 KB of dynamic shared memory, no opt-in)
//     runs all passes with distance < T in shared memory;
//   * pass kernel: a pass whose distance is >= T is one launch of
//     coalesced global compare-exchanges.
// For N = 65536 that is 1 full tile sort, then for each of the 4 merge
// stages above T its global passes (1+2+3+4) and one tile merge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;

template <int NK>
__device__ __forceinline__ bool lex_less(int32_t a1, int32_t a2,
                                         int32_t b1, int32_t b2) {
  if (NK == 1) return a1 < b1;
  return a1 < b1 || (a1 == b1 && a2 < b2);
}

// compare-exchange of (lo, hi): swap when out of order for `asc`
template <int NA, int NK>
__device__ __forceinline__ void cmp_swap(int32_t* const* arr, int64_t lo,
                                         int64_t hi, bool asc) {
  int32_t l1 = arr[0][lo], h1 = arr[0][hi];
  int32_t l2 = 0, h2 = 0;
  if (NK == 2) {
    l2 = arr[1][lo];
    h2 = arr[1][hi];
  }
  bool swap = asc ? lex_less<NK>(h1, h2, l1, l2)
                  : lex_less<NK>(l1, l2, h1, h2);
  if (swap) {
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      int32_t t = arr[a][lo];
      arr[a][lo] = arr[a][hi];
      arr[a][hi] = t;
    }
  }
}

// One launch per tile: load T elements of every array into shared
// memory, run stages k in [k_lo, k_hi] (the first one from distance
// j_first, the others from k/2) down to distance 1, store back.
template <int NA, int NK>
__global__ void tile_kernel(int32_t* a0, int32_t* a1, int32_t* a2, int N,
                            int T, int k_lo, int k_hi, int j_first) {
  extern __shared__ int32_t smem[];
  int32_t* g[3] = {a0, a1, a2};
  int32_t* s[3] = {smem, smem + T, smem + 2 * T};
  const int64_t base = (int64_t)blockIdx.x * T;  // flat tile start
  const int row_base = (int)(base % N);          // tile start in its row
#pragma unroll
  for (int a = 0; a < NA; ++a)
    for (int i = threadIdx.x; i < T; i += blockDim.x) s[a][i] = g[a][base + i];
  __syncthreads();
  for (int k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = (k == k_lo ? j_first : k >> 1); j >= 1; j >>= 1) {
      for (int p = threadIdx.x; p < (T >> 1); p += blockDim.x) {
        int lo = ((p / j) * (j << 1)) + (p % j);
        bool asc = (((row_base + lo) & k) == 0);
        cmp_swap<NA, NK>(s, lo, lo + j, asc);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
    for (int i = threadIdx.x; i < T; i += blockDim.x) g[a][base + i] = s[a][i];
}

// One global pass of stage k at distance j (j >= T): one thread per pair.
template <int NA, int NK>
__global__ void pass_kernel(int32_t* a0, int32_t* a1, int32_t* a2, int N,
                            int64_t n_pairs, int k, int j) {
  int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  int32_t* g[3] = {a0, a1, a2};
  const int half = N >> 1;
  const int64_t row = p / half;
  const int pp = (int)(p % half);
  const int lo = ((pp / j) * (j << 1)) + (pp % j);
  const int64_t off = row * N;
  cmp_swap<NA, NK>(g, off + lo, off + lo + j, (lo & k) == 0);
}

template <int NA, int NK>
int run(int32_t* a0, int32_t* a1, int32_t* a2, int S, int N,
        cudaStream_t stream) {
  const int T = N < kTile ? N : kTile;
  const int tiles = (int)((int64_t)S * N / T);
  const int tthreads = (T >> 1) < 1024 ? (T >> 1) : 1024;
  const size_t smem = (size_t)NA * T * sizeof(int32_t);
  tile_kernel<NA, NK><<<tiles, tthreads, smem, stream>>>(a0, a1, a2, N, T, 2,
                                                        T, 1);
  const int64_t n_pairs = (int64_t)S * (N >> 1);
  const int pthreads = 256;
  const int pblocks = (int)((n_pairs + pthreads - 1) / pthreads);
  for (int k = T << 1; k <= N; k <<= 1) {
    for (int j = k >> 1; j >= T; j >>= 1)
      pass_kernel<NA, NK><<<pblocks, pthreads, 0, stream>>>(a0, a1, a2, N,
                                                           n_pairs, k, j);
    tile_kernel<NA, NK><<<tiles, tthreads, smem, stream>>>(a0, a1, a2, N, T,
                                                          k, k, T >> 1);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Sorts in place. a1/a2 may be null when n_arrays < 2/3. Returns the
// CUDA error code of the launches (0 = success).
extern "C" int bigsort_sort(void* a0, void* a1, void* a2, int n_arrays,
                            int n_keys, int S, int N, void* stream) {
  int32_t* p0 = static_cast<int32_t*>(a0);
  int32_t* p1 = static_cast<int32_t*>(a1);
  int32_t* p2 = static_cast<int32_t*>(a2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 2 || (N & (N - 1)) != 0 || S < 1) return (int)cudaErrorInvalidValue;
  if (n_keys == 1) {
    if (n_arrays == 1) return run<1, 1>(p0, p1, p2, S, N, st);
    if (n_arrays == 2) return run<2, 1>(p0, p1, p2, S, N, st);
    if (n_arrays == 3) return run<3, 1>(p0, p1, p2, S, N, st);
  } else if (n_keys == 2) {
    if (n_arrays == 2) return run<2, 2>(p0, p1, p2, S, N, st);
    if (n_arrays == 3) return run<3, 2>(p0, p1, p2, S, N, st);
  }
  return (int)cudaErrorInvalidValue;
}
