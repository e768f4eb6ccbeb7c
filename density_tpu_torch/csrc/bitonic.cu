// Row-wise bitonic sort, a row held on chip in one launch (Hopper,
// sm_90a).
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
// What bounds it on this card: bytes, in principle (a sort of 38 x
// 65536 x 2 int32 arrays moves 40 MB in and out once, 12 us at 3.35
// TB/s); in practice the passes' trips through shared memory and the
// barriers between them. The TPU kernel's trait is that the whole
// network runs in one launch on a row held on chip; here that row lives
// in the shared memory of a thread-block cluster:
//   * N <= 16384: one CTA per row runs the whole network in the levels of
//     sort_levels.cuh (registers, warp shuffles, a column layout through
//     shared memory): bigsort.cu's tile kernel, one launch;
//   * N = 32768 or 65536: a cluster of C = N / 8192 CTAs (4 or 8, within
//     the portable limit) holds the row, 8192 elements of each array in
//     each CTA's shared memory (66 KB for 2 arrays, 99 KB for 3). Each CTA
//     sorts its tile in its own levels. For each merge stage k = 16384
//     ... N, the passes of distance >= 8192 differ only in the CTA-rank
//     bits (b = 1-3 of them): after a cluster barrier, each thread
//     gathers through distributed shared memory the 2^b elements that
//     differ only in those bits, from its own slice of the tile in each
//     CTA of its group of 2^b, runs the b passes in registers and writes
//     them back; after a second barrier the CTA runs distances 4096 ...
//     1 in its own levels. One launch, two cluster barriers a stage;
//   * N > 65536: the cluster kernel sorts each 65536-element span; each
//     merge stage above it is one global launch per 4 bits above the span
//     (sort_levels.cuh's global kernel) plus one cluster launch for the
//     distances below it: 1 + 2 log2(N / 65536) launches up to N = 2^20.
// A cluster launch that the card refuses returns its error; nothing
// falls back. The first launch reads the caller's arrays and writes the
// output, so nothing is copied.

#include <cooperative_groups.h>

#include "sort_levels.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMinLogN = 8;                      // N >= 256
constexpr int kLogT = 13;                        // a cluster CTA's tile
constexpr int kLogSpan = kLogT + 3;              // 8 CTAs: 65536
constexpr int kClusterThreads = tile_threads(kLogT);  // 512

// Stage k's passes on the CTA-rank bits log2 T ... log2 T + B - 1, on
// the cluster's shared memory: CTA m of each group of G = 2^B ranks takes
// slice m of the tile indices, thread t the indices m T/G + t + 512 i,
// i < kE / G. It loads the G elements of each of its indices (one from
// each CTA of the group, consecutive threads on consecutive slots), runs
// the B passes in registers (the direction, (col0 & k), is the group's)
// and writes them back. Index x + 512 i lies in slot pad(x) + 528 i, so
// each access is a pointer of the group plus a compile-time offset.
template <int NA, int NK, int B>
__device__ __forceinline__ void cluster_passes(cg::cluster_group& cl,
                                               int32_t* smem, int col0,
                                               int k) {
  constexpr int G = 1 << B, T = 1 << kLogT, pitch = tile_pitch(kLogT);
  constexpr int step = kClusterThreads + kClusterThreads / 32;
  const int rank = (int)cl.block_rank();
  const int base = rank & ~(G - 1);
  int32_t* const mine =
      smem + pad((rank & (G - 1)) * (T / G) + (int)threadIdx.x);
  int32_t* r[G];
#pragma unroll
  for (int g = 0; g < G; ++g) r[g] = cl.map_shared_rank(mine, base | g);
  int32_t v[NA][kE];  // element g of index i at i G + g
#pragma unroll
  for (int i = 0; i < kE / G; ++i)
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int g = 0; g < G; ++g)
        v[a][i * G + g] = r[g][a * pitch + i * step];
  const bool asc = (col0 & k) == 0;
#pragma unroll
  for (int q = B - 1; q >= 0; --q)
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (!(e & (1 << q))) reg_ce<NA, NK, kE>(v, e, e | (1 << q), asc);
#pragma unroll
  for (int i = 0; i < kE / G; ++i)
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int g = 0; g < G; ++g)
        r[g][a * pitch + i * step] = v[a][i * G + g];
}

// One cluster of C = span / T CTAs per span of a row (the whole row up to
// 65536). Sort launch (k_first = 2): each CTA sorts its tile, then the
// merge stages 2T ... span run across the cluster. Merge launch (k_first
// = k > span, its distances >= span done by the global launch before):
// stage k from distance span/2 down to 1.
template <int NA, int NK>
__global__ void __launch_bounds__(kClusterThreads, 2)
    cluster_kernel(Arrays src, int32_t* d0, int32_t* d1, int32_t* d2,
                   int log_n, int k_first) {
  extern __shared__ int32_t smem[];
  constexpr int T = 1 << kLogT, pitch = tile_pitch(kLogT);
  cg::cluster_group cl = cg::this_cluster();
  int32_t* s[3] = {smem, smem + pitch, smem + 2 * pitch};
  int32_t* dst[3] = {d0, d1, d2};
  const int row = blockIdx.x >> (log_n - kLogT);
  const int col0 = (blockIdx.x << kLogT) & ((1 << log_n) - 1);
  const int tid = threadIdx.x, first = tid * kE;
  const int log_span = log_n < kLogSpan ? log_n : kLogSpan;
  int32_t v[NA][kE];
#pragma unroll
  for (int a = 0; a < NA; ++a)
    load_elems(v[a], src.p[a] + ((int64_t)row << log_n) + col0 + first, T);
  int k = k_first;
  if (k == 2) {
    tile_stages<NA, NK, kClusterThreads>(v, s, kLogT, col0, 2, T, false);
    k = 2 * T;
  }
  const int k_last = k_first > 2 ? k_first : 1 << log_span;
  for (; k <= k_last; k <<= 1) {
    to_smem<NA>(s, v, pad(first));
    cl.sync();
    const int log_k = 31 - __clz(k);
    switch ((log_k < log_span ? log_k : log_span) - kLogT) {
      case 1: cluster_passes<NA, NK, 1>(cl, smem, col0, k); break;
      case 2: cluster_passes<NA, NK, 2>(cl, smem, col0, k); break;
      default: cluster_passes<NA, NK, 3>(cl, smem, col0, k);
    }
    cl.sync();
    from_smem_cols<NA>(v, s, tid, kClusterThreads);
    tile_stages<NA, NK, kClusterThreads>(v, s, kLogT, col0, k, k, true);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
    store_elems(dst[a] + ((int64_t)row << log_n) + col0 + first, v[a], T);
}

// The cluster kernel's opt-in shared memory, set once per device.
// Returns the CUDA error code.
template <int NA, int NK>
int cluster_setup() {
  static std::atomic<int> done[kMaxDevices];
  return per_device(done, [] {
    return (int)cudaFuncSetAttribute(
        cluster_kernel<NA, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tile_smem(NA, kLogT));
  });
}

// The launch of cluster_kernel<NA, NK> over S rows of 2^log_n (> 16384);
// `attr` holds its cluster dimension.
template <int NA>
cudaLaunchConfig_t cluster_config(int S, int log_n, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  const int log_span = log_n < kLogSpan ? log_n : kLogSpan;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << (log_span - kLogT);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S << (log_n - kLogT));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = tile_smem(NA, kLogT);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NA, int NK>
int launch_cluster(const Arrays& src, int32_t* const* dst, int S, int log_n,
                   int k_first, cudaStream_t st) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<NA>(S, log_n, st, &attr);
  return (int)cudaLaunchKernelEx(&cfg, cluster_kernel<NA, NK>, src, dst[0],
                                 dst[1], dst[2], log_n, k_first);
}

struct Plan {
  template <int NA, int NK>
  static int run(const Arrays& src, int32_t* const* dst, int S, int log_n,
                 cudaStream_t st) {
    int rc;
    if (log_n <= kMaxLogTile) {
      if ((rc = tile_setup<NA, NK>())) return rc;
      return launch_tile<NA, NK>(src, dst, S, log_n, log_n, 2, st);
    }
    if ((rc = cluster_setup<NA, NK>())) return rc;
    if ((rc = launch_cluster<NA, NK>(src, dst, S, log_n, 2, st))) return rc;
    const Arrays out = {{dst[0], dst[1], dst[2]}};
    for (int log_k = kLogSpan + 1; log_k <= log_n; ++log_k) {
      if ((rc = launch_global_stage<NA, NK>(dst, S, log_n, kLogSpan, log_k,
                                            st)))
        return rc;
      if ((rc = launch_cluster<NA, NK>(out, dst, S, log_n, 1 << log_k, st)))
        return rc;
    }
    return 0;
  }
};

// The number of clusters of the cluster kernel that the card holds at
// once (cudaOccupancyMaxActiveClusters) for rows of 2^log_n > 16384,
// written to dst[0][0].
struct Occupancy {
  template <int NA, int NK>
  static int run(const Arrays&, int32_t* const* dst, int, int log_n,
                 cudaStream_t) {
    if (log_n <= kMaxLogTile) return (int)cudaErrorInvalidValue;
    int rc = cluster_setup<NA, NK>();
    if (rc) return rc;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config<NA>(1, log_n, 0, &attr);
    return (int)cudaOccupancyMaxActiveClusters(dst[0], cluster_kernel<NA, NK>,
                                               &cfg);
  }
};

}  // namespace

// Sorts the contiguous, 16-byte aligned (S, N) arrays s0..s2 into the
// fresh outputs d0..d2; unused arrays are null. Returns the CUDA error
// code (0 = success).
extern "C" int bitonic_sort(const void* s0, const void* s1, const void* s2,
                            void* d0, void* d1, void* d2, int n_arrays,
                            int n_keys, int S, int N, void* stream) {
  if (N < (1 << kMinLogN)) return (int)cudaErrorInvalidValue;
  return dispatch<Plan>(s0, s1, s2, d0, d1, d2, n_arrays, n_keys, S, N,
                        stream);
}

// Writes to *clusters how many clusters of the sort of rows of N > 16384
// elements (n_arrays, n_keys) the card holds at once. Returns the CUDA
// error code.
extern "C" int bitonic_clusters(int n_arrays, int n_keys, int N,
                                int* clusters) {
  return dispatch<Occupancy>(nullptr, nullptr, nullptr, clusters, nullptr,
                             nullptr, n_arrays, n_keys, 1, N, nullptr);
}
