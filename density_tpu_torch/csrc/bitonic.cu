// Row-wise bitonic sort, the whole network in one launch (Hopper, sm_90a).
//
// Replaces the TPU kernel density_tpu/kernels/bitonic.py::sort (the
// Pallas kernel that runs every pass of the Batcher network on a row held
// in VMEM, driven by a pass table). Same contract as bigsort.cu: sort S
// rows of N int32 arrays by the first n_keys (signed, lexicographic),
// carrying the rest (1-3 arrays); N a power of two >= 256. The network is
// the same (stage k, distance j, partner i ^ j, ascending where
// (i & k) == 0), so the output equals bigsort.cu's and the TPU kernels'
// element for element, ties included.
//
// One CTA per row, one launch per sort:
//   * a row of NA * N * 4 bytes within the card's opt-in shared-memory
//     limit (227 KB on the H100: N <= 16384 with 3 arrays) is loaded
//     once, runs every pass in shared memory and is stored once;
//   * a longer row is cut into tiles of T elements, the largest power of
//     two that fits: each tile is sorted in shared memory in turn; then
//     for each stage k > T the passes of distance >= T run over the row
//     in global memory (it stays in L2), with __syncthreads() between
//     passes, and the passes below T run tile by tile in shared memory.
//
// What bounds it on this card: bytes. A sort of 38 x 65536 x 2 int32
// arrays must move 40 MB in and out once (12 us at 3.35 TB/s); the
// compares are far below the ALU rate. The design keeps every pass of a
// small row in shared memory and needs no second launch; for rows past
// shared memory it trades parallelism (one SM per row) for launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

template <int NK>
__device__ __forceinline__ bool lex_less(int32_t a1, int32_t a2, int32_t b1,
                                         int32_t b2) {
  if (NK == 1) return a1 < b1;
  return a1 < b1 || (a1 == b1 && a2 < b2);
}

// compare-exchange of (lo, hi): swap when out of order for `asc`
template <int NA, int NK>
__device__ __forceinline__ void cmp_swap(int32_t* const* arr, int lo, int hi,
                                         bool asc) {
  const int32_t l1 = arr[0][lo], h1 = arr[0][hi];
  int32_t l2 = 0, h2 = 0;
  if (NK == 2) {
    l2 = arr[1][lo];
    h2 = arr[1][hi];
  }
  const bool swap = asc ? lex_less<NK>(h1, h2, l1, l2)
                        : lex_less<NK>(l1, l2, h1, h2);
  if (swap) {
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int32_t t = arr[a][lo];
      arr[a][lo] = arr[a][hi];
      arr[a][hi] = t;
    }
  }
}

// The passes of stage k from distance j_hi down to j_lo over `len`
// elements of `arr` (shared or global memory), whose first element is
// element `first` of its row (the direction depends on the row index).
template <int NA, int NK>
__device__ void passes(int32_t* const* arr, int len, int first, int k,
                       int j_hi, int j_lo) {
  for (int j = j_hi; j >= j_lo; j >>= 1) {
    for (int p = threadIdx.x; p < (len >> 1); p += blockDim.x) {
      const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
      cmp_swap<NA, NK>(arr, lo, lo + j, ((first + lo) & k) == 0);
    }
    __syncthreads();
  }
}

template <int NA>
__device__ void copy_tile(int32_t* const* dst, int32_t* const* src, int T) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
    for (int i = threadIdx.x; i < T; i += blockDim.x) dst[a][i] = src[a][i];
  __syncthreads();
}

template <int NA, int NK>
__global__ void __launch_bounds__(kThreads)
    bitonic_kernel(int32_t* a0, int32_t* a1, int32_t* a2, int N, int T) {
  extern __shared__ int32_t smem[];
  const int64_t off = (int64_t)blockIdx.x * N;
  int32_t* row[3] = {a0 + off, NA > 1 ? a1 + off : nullptr,
                     NA > 2 ? a2 + off : nullptr};
  int32_t* s[3] = {smem, smem + T, smem + 2 * T};
  // every tile sorted through stage T (the whole row when T == N)
  for (int c = 0; c < N; c += T) {
    int32_t* g[3] = {row[0] + c, NA > 1 ? row[1] + c : nullptr,
                     NA > 2 ? row[2] + c : nullptr};
    copy_tile<NA>(s, g, T);
    for (int k = 2; k <= T; k <<= 1) passes<NA, NK>(s, T, c, k, k >> 1, 1);
    copy_tile<NA>(g, s, T);
  }
  // the merge stages above T: long distances in global memory, short
  // ones tile by tile in shared memory
  for (int k = T << 1; k <= N; k <<= 1) {
    passes<NA, NK>(row, N, 0, k, k >> 1, T);
    for (int c = 0; c < N; c += T) {
      int32_t* g[3] = {row[0] + c, NA > 1 ? row[1] + c : nullptr,
                       NA > 2 ? row[2] + c : nullptr};
      copy_tile<NA>(s, g, T);
      passes<NA, NK>(s, T, c, k, T >> 1, 1);
      copy_tile<NA>(g, s, T);
    }
  }
}

template <int NA, int NK>
int run(int32_t* a0, int32_t* a1, int32_t* a2, int S, int N,
        cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  int T = N;
  while (T > 2 && (size_t)NA * T * sizeof(int32_t) > (size_t)optin) T >>= 1;
  const size_t smem = (size_t)NA * T * sizeof(int32_t);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(bitonic_kernel<NA, NK>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (T >> 1) < kThreads ? (T >> 1) : kThreads;
  bitonic_kernel<NA, NK><<<S, threads, smem, stream>>>(a0, a1, a2, N, T);
  return (int)cudaGetLastError();
}

}  // namespace

// Sorts in place. a1/a2 may be null when n_arrays < 2/3. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int bitonic_sort(void* a0, void* a1, void* a2, int n_arrays,
                            int n_keys, int S, int N, void* stream) {
  int32_t* p0 = static_cast<int32_t*>(a0);
  int32_t* p1 = static_cast<int32_t*>(a1);
  int32_t* p2 = static_cast<int32_t*>(a2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 256 || (N & (N - 1)) != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
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
