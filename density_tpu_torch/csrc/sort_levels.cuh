// The levels of the row-wise bitonic network shared by bigsort.cu and
// bitonic.cu (Hopper, sm_90a): each pass of the Batcher network (stage
// k, distance j, partner i ^ j, ascending where (i & k) == 0) runs at the
// cheapest level that holds both partners.
//   * registers: a thread holds kE = 16 consecutive elements of each
//     array (loaded and stored as 16-byte vectors); distances 1-8 run in
//     the thread, 16-256 in the warp through __shfl_xor_sync;
//   * shared memory: a stage's passes of distance >= 512 run in the
//     registers of a second, column layout (thread t holds tile elements
//     t + T/16 r), reached by one transpose through padded,
//     conflict-free shared memory each way with a __syncthreads(). A
//     descending stage flips its keys (~x) and runs ascending;
//   * tile_kernel: one CTA per tile of T <= 16384 elements runs every
//     pass of distance < T (a sort of the tile, or one merge stage);
//   * global_kernel: the passes of one merge stage on up to 4 index bits
//     above a tile, each thread holding the elements of a row that differ
//     only in those bits, in place in global memory.
// Each file keeps its own launch plan; `dispatch` instantiates it for
// every (arrays, keys) the kernels take. Indices are shifts and masks,
// 32-bit inside a row.
//
// Everything here has internal linkage (the unnamed namespace, which the
// including file reopens for its own code): each library keeps its own
// instances. A template's static local (the `tile_setup` slots) would
// otherwise be one symbol for every library loaded in the process, and
// the second library would skip its own shared-memory attribute.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int kMaxLogTile = 14;      // a row of up to 16384 is one tile
constexpr int kLogE = 4;             // a tile thread holds kE elements
constexpr int kE = 1 << kLogE;       //   of each array in registers
constexpr int kWarpSpan = 32 * kE;   // distances below stay in a warp
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWindow = 4;        // a global launch runs <= 4 passes
constexpr int kGlobalThreads = 256;

struct Arrays {
  const int32_t* p[3];
};

template <int NK>
__device__ __forceinline__ bool lex_less(int32_t a1, int32_t a2,
                                         int32_t b1, int32_t b2) {
  if (NK == 1) return a1 < b1;
  return a1 < b1 || (a1 == b1 && a2 < b2);
}

// compare-exchange of register slots m1 < m2 (indices known at compile
// time once the caller's loops are unrolled). A descending pair compares
// its keys flipped (~x reverses the order of int32); with asc a
// compile-time true that folds away. With one key the key takes min and
// max, and the carried arrays swap where the low key changed (a swap
// always changes it: ties never swap).
template <int NA, int NK, int M>
__device__ __forceinline__ void reg_ce(int32_t (&v)[NA][M], int m1, int m2,
                                       bool asc) {
  const int32_t f = asc ? 0 : -1;
  bool swap;
  if constexpr (NK == 1) {
    const int32_t x = v[0][m1] ^ f, y = v[0][m2] ^ f;
    const int32_t mn = min(x, y);
    swap = mn != x;
    v[0][m1] = mn ^ f;
    v[0][m2] = max(x, y) ^ f;
  } else {
    swap = lex_less<NK>(v[0][m2] ^ f, v[1][m2] ^ f, v[0][m1] ^ f,
                        v[1][m1] ^ f);
  }
#pragma unroll
  for (int a = NK == 1 ? 1 : 0; a < NA; ++a) {
    const int32_t x = v[a][m1], y = v[a][m2];
    v[a][m1] = swap ? y : x;
    v[a][m2] = swap ? x : y;
  }
}

__host__ __device__ constexpr int tile_threads(int log_t) {
  return log_t <= kLogE + 5 ? 32 : 1 << (log_t - kLogE);
}

// Words of shared memory per array of a tile: one pad word every 32.
__host__ __device__ constexpr int tile_pitch(int log_t) {
  return (1 << log_t) + ((1 << log_t) >> 5);
}

// Shared-memory slot of tile element i. The pad makes both access
// patterns conflict-free: a warp's 32 consecutive elements, and element
// e of 32 lanes that each hold 16 consecutive ones (16 lane + e + lane/2
// covers the 32 banks).
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Passes of distance j_top ... 1 (j_top < kE) inside a thread, whose
// element 0 has row index base. kAsc: every pass ascending (the caller
// flipped the keys of a descending stage); else the direction of each
// pair from (index & k).
template <int NA, int NK, bool kAsc>
__device__ __forceinline__ void register_passes(int32_t (&v)[NA][kE],
                                                int base, int k, int j_top) {
#pragma unroll
  for (int lj = kLogE - 1; lj >= 0; --lj) {
    if ((1 << lj) > j_top) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (!(e & (1 << lj)))
        reg_ce<NA, NK, kE>(v, e, e | (1 << lj),
                           kAsc || ((base + e) & k) == 0);
  }
}

// Ascending passes of distance kE d_top ... kE inside a warp: element e
// of lane l meets element e of lane l ^ d. The low lane keeps the
// smaller; both lanes decide the same swap and, on a swap, each takes the
// other's values.
template <int NA, int NK>
__device__ __forceinline__ void warp_passes(int32_t (&v)[NA][kE], int lane,
                                            int d_top) {
  for (int d = d_top; d >= 1; d >>= 1) {
    const bool low = (lane & d) == 0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int32_t x1 = v[0][e], y1 = __shfl_xor_sync(kFullMask, x1, d);
      bool swap;
      if constexpr (NK == 1) {
        v[0][e] = low ? min(x1, y1) : max(x1, y1);
        swap = v[0][e] != x1;
      } else {
        const int32_t x2 = v[1][e], y2 = __shfl_xor_sync(kFullMask, x2, d);
        const int32_t l1 = low ? x1 : y1, h1 = low ? y1 : x1;
        const int32_t l2 = low ? x2 : y2, h2 = low ? y2 : x2;
        swap = lex_less<NK>(h1, h2, l1, l2);
        v[0][e] = swap ? y1 : x1;
        v[1][e] = swap ? y2 : x2;
      }
#pragma unroll
      for (int a = NK; a < NA; ++a) {
        const int32_t y = __shfl_xor_sync(kFullMask, v[a][e], d);
        v[a][e] = swap ? y : v[a][e];
      }
    }
  }
}

// ~x reverses the order of int32 keys, so a descending stage runs as an
// ascending one on flipped keys (f = -1; 0 leaves them).
template <int NA, int NK>
__device__ __forceinline__ void flip_keys(int32_t (&v)[NA][kE], int32_t f) {
#pragma unroll
  for (int a = 0; a < NK; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) v[a][e] ^= f;
}

// A thread's kE elements of each array between registers and shared
// memory, at slots p0 ... p0 + kE - 1 (p0 = pad(first): the kE elements
// never cross a pad word).
template <int NA>
__device__ __forceinline__ void to_smem(int32_t* const* s,
                                        const int32_t (&v)[NA][kE], int p0) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) s[a][p0 + e] = v[a][e];
}

template <int NA>
__device__ __forceinline__ void from_smem(int32_t (&v)[NA][kE],
                                          int32_t* const* s, int p0) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) v[a][e] = s[a][p0 + e];
}

// The column layout (T >= 1024, nthr = T / kE threads): thread t holds
// tile elements t + nthr r, r = 0 ... kE - 1, so the top log2 kE bits of
// the tile index are its register bits. Its slots in shared memory are
// read and written by consecutive lanes at consecutive addresses. nthr is
// a multiple of 32, so pad(t + nthr r) = pad(t) + (nthr + nthr/32) r: one
// base and, where nthr is known at compile time, constant offsets.
template <int NA>
__device__ __forceinline__ void to_smem_cols(int32_t* const* s,
                                             const int32_t (&v)[NA][kE],
                                             int tid, int nthr) {
  const int p = pad(tid), step = nthr + (nthr >> 5);
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int r = 0; r < kE; ++r) s[a][p + r * step] = v[a][r];
}

template <int NA>
__device__ __forceinline__ void from_smem_cols(int32_t (&v)[NA][kE],
                                               int32_t* const* s, int tid,
                                               int nthr) {
  const int p = pad(tid), step = nthr + (nthr >> 5);
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int r = 0; r < kE; ++r) v[a][r] = s[a][p + r * step];
}

// Passes of stage k on tile-index bits hb ... cb in the column layout
// (cb = log2 T - log2 kE, its lowest register bit).
template <int NA, int NK>
__device__ __forceinline__ void column_passes(int32_t (&v)[NA][kE], int tid,
                                              int nthr, int col0, int k,
                                              int cb, int hb) {
#pragma unroll
  for (int q = kLogE - 1; q >= 0; --q) {
    if (cb + q > hb) continue;
#pragma unroll
    for (int r = 0; r < kE; ++r)
      if (!(r & (1 << q)))
        reg_ce<NA, NK, kE>(v, r, r | (1 << q),
                           ((col0 + tid + r * nthr) & k) == 0);
  }
}

// One pass of distance j >= kWarpSpan in shared memory (then T = 16 x
// threads, so each thread has kE / 2 pairs): four pairs at a time are
// loaded before any is compared, and stored back after.
template <int NA, int NK>
__device__ __forceinline__ void smem_pass(int32_t* const* s, int tid,
                                          int nthr, int col0, int k, int j) {
  constexpr int B = 4;
#pragma unroll
  for (int m0 = 0; m0 < kE / 2; m0 += B) {
    int32_t x[NA][2 * B];
    int lo[B];
#pragma unroll
    for (int m = 0; m < B; ++m) {
      const int p = tid + (m0 + m) * nthr;
      lo[m] = ((p & ~(j - 1)) << 1) | (p & (j - 1));
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        x[a][m] = s[a][pad(lo[m])];
        x[a][m + B] = s[a][pad(lo[m] | j)];
      }
    }
#pragma unroll
    for (int m = 0; m < B; ++m)
      reg_ce<NA, NK, 2 * B>(x, m, m + B, ((col0 + lo[m]) & k) == 0);
#pragma unroll
    for (int m = 0; m < B; ++m) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        s[a][pad(lo[m])] = x[a][m];
        s[a][pad(lo[m] | j)] = x[a][m + B];
      }
    }
  }
}

// A thread's kE consecutive elements of one array (16-byte aligned) as
// four 16-byte accesses; a tile of T < kE elements goes one by one.
__device__ __forceinline__ void load_elems(int32_t (&x)[kE],
                                           const int32_t* g, int T) {
  if (T >= kE) {
#pragma unroll
    for (int q = 0; q < kE / 4; ++q) {
      const int4 w = reinterpret_cast<const int4*>(g)[q];
      x[4 * q] = w.x;
      x[4 * q + 1] = w.y;
      x[4 * q + 2] = w.z;
      x[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) x[e] = e < T ? g[e] : 0;
  }
}

__device__ __forceinline__ void store_elems(int32_t* g,
                                            const int32_t (&x)[kE], int T) {
  if (T >= kE) {
#pragma unroll
    for (int q = 0; q < kE / 4; ++q)
      reinterpret_cast<int4*>(g)[q] =
          make_int4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (e < T) g[e] = x[e];
  }
}

// Stages k_first ... k_last of a tile of T = 2^log_t elements whose
// element 0 is row element col0, on the registers v of one CTA of T / 16
// threads (at least 32; kThreads, where the caller knows it at compile
// time) and its shared memory s (tile_pitch words per array). A stage
// k > T runs its distances T/2 ... 1. Thread t holds tile elements
// 16 t ... 16 t + 15 on entry and exit; with `cols`, the first stage
// (then a merge, k_first > T >= 1024) finds v in the column layout
// instead.
//
// A pass of distance < 16 runs in the thread, one of 16 ... 256 in its
// warp (shuffles). A stage with distances >= 512 first moves to the
// column layout through shared memory and runs its top bits there (all
// of them up to T = 8192; bit 9 of a 16384-tile stays one pass in shared
// memory), then moves back: two __syncthreads() a stage instead of one a
// pass. From stage 16 on, a thread's direction is the same for all its
// passes of the stage, so a descending stage flips the keys and runs
// ascending.
template <int NA, int NK, int kThreads = 0>
__device__ __forceinline__ void tile_stages(int32_t (&v)[NA][kE],
                                            int32_t* const* s, int log_t,
                                            int col0, int k_first,
                                            int k_last, bool cols) {
  const int T = 1 << log_t;
  const int tid = threadIdx.x, nthr = kThreads ? kThreads : blockDim.x;
  const int first = tid * kE;
  const int p0 = first + (first >> 5);
  const int cb = log_t - kLogE;
  for (int k = k_first; k <= k_last; k <<= 1) {
    int j = (k > T ? T : k) >> 1;
    if (j >= kWarpSpan) {
      const int hb = 31 - __clz(j);
      if (hb >= cb) {
        // the stage's top bits in registers of the column layout
        if (!(cols && k == k_first)) {
          to_smem<NA>(s, v, p0);
          __syncthreads();
          from_smem_cols<NA>(v, s, tid, nthr);
        }
        column_passes<NA, NK>(v, tid, nthr, col0, k, cb, hb);
        to_smem_cols<NA>(s, v, tid, nthr);
        j = 1 << (cb - 1);
      } else {
        to_smem<NA>(s, v, p0);
      }
      __syncthreads();
      for (; j >= kWarpSpan; j >>= 1) {  // bit 9 of a 16384-tile
        smem_pass<NA, NK>(s, tid, nthr, col0, k, j);
        __syncthreads();
      }
      from_smem<NA>(v, s, p0);
    }
    if (k < kE) {
      register_passes<NA, NK, false>(v, col0 + first, k, j);
      continue;
    }
    const int32_t f = ((col0 + first) & k) ? -1 : 0;
    flip_keys<NA, NK>(v, f);
    if (j >= kE) {
      warp_passes<NA, NK>(v, tid & 31, j / kE);
      j = kE / 2;
    }
    register_passes<NA, NK, true>(v, 0, 0, j);
    flip_keys<NA, NK>(v, f);
  }
}

// One CTA per tile of T = 2^log_t elements of a row. Sort launch
// (k_first = 2): stages 2 ... T, all distances. Merge launch (k_first =
// k > T): stage k from distance T/2 down to 1; a merge of a tile of
// >= 1024 loads straight into the column layout (each load coalesced
// over a warp). A tile of T < 512 leaves the lanes past T / 16 idle;
// their zeros never meet a real element, since every partner of a real
// element lies in the tile.
template <int NA, int NK>
__global__ void __launch_bounds__(1024)
    tile_kernel(Arrays src, int32_t* d0, int32_t* d1, int32_t* d2,
                int log_n, int log_t, int k_first) {
  extern __shared__ int32_t smem[];
  const int T = 1 << log_t;
  const int pitch = tile_pitch(log_t);
  int32_t* s[3] = {smem, smem + pitch, smem + 2 * pitch};
  int32_t* dst[3] = {d0, d1, d2};
  const int row = blockIdx.x >> (log_n - log_t);
  const int col0 = (blockIdx.x << log_t) & ((1 << log_n) - 1);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int first = tid * kE;
  const bool live = first < T;
  const bool cols_first = k_first > T && T >= 2 * kWarpSpan;
  int32_t v[NA][kE];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int32_t* g = src.p[a] + ((int64_t)row << log_n) + col0;
#pragma unroll
    for (int e = 0; e < kE; ++e) v[a][e] = 0;
    if (cols_first) {
#pragma unroll
      for (int r = 0; r < kE; ++r) v[a][r] = g[tid + r * nthr];
    } else if (live) {
      load_elems(v[a], g + first, T);
    }
  }
  tile_stages<NA, NK>(v, s, log_t, col0, k_first,
                      k_first > T ? k_first : T, cols_first);
  if (live) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
      store_elems(dst[a] + ((int64_t)row << log_n) + col0 + first, v[a], T);
  }
}

// The passes of stage k on index bits lo_bit ... lo_bit + L - 1, in place:
// each thread holds the 2^L elements of a row that differ only in those
// bits (consecutive threads on consecutive columns).
template <int NA, int NK, int L>
__global__ void __launch_bounds__(kGlobalThreads)
    global_kernel(int32_t* d0, int32_t* d1, int32_t* d2, int log_n,
                  int lo_bit, int k, int64_t n_threads) {
  constexpr int M = 1 << L;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  const int per_row = log_n - L;
  const int64_t row = t >> per_row;
  const int r = (int)t & ((1 << per_row) - 1);
  const int col = ((r >> lo_bit) << (lo_bit + L)) | (r & ((1 << lo_bit) - 1));
  int32_t* g[3] = {d0, d1, d2};
  int32_t v[NA][M];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    g[a] += (row << log_n) + col;
#pragma unroll
    for (int m = 0; m < M; ++m) v[a][m] = g[a][m << lo_bit];
  }
  const bool asc = (col & k) == 0;
#pragma unroll
  for (int b = L - 1; b >= 0; --b) {
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (!(m & (1 << b))) reg_ce<NA, NK, M>(v, m, m | (1 << b), asc);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int m = 0; m < M; ++m) g[a][m << lo_bit] = v[a][m];
  }
}

size_t tile_smem(int na, int log_t) {
  return (size_t)na * tile_pitch(log_t) * sizeof(int32_t);
}

// The tile kernel's opt-in shared memory, set once per device (the
// attribute is the current device's). Returns the CUDA error code.
template <int NA, int NK>
int tile_setup() {
  static std::atomic<int> done[kMaxDevices];
  return per_device(done, [] {
    return (int)cudaFuncSetAttribute(
        tile_kernel<NA, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tile_smem(NA, kMaxLogTile));
  });
}

template <int NA, int NK>
int launch_tile(const Arrays& src, int32_t* const* dst, int S, int log_n,
                int log_t, int k_first, cudaStream_t st) {
  tile_kernel<NA, NK><<<S << (log_n - log_t), tile_threads(log_t),
                        tile_smem(NA, log_t), st>>>(
      src, dst[0], dst[1], dst[2], log_n, log_t, k_first);
  return (int)cudaGetLastError();
}

template <int NA, int NK, int L>
int launch_window(int32_t* const* d, int S, int log_n, int lo_bit, int k,
                  cudaStream_t st) {
  const int64_t n = (int64_t)S << (log_n - L);
  const int blocks = (int)((n + kGlobalThreads - 1) / kGlobalThreads);
  global_kernel<NA, NK, L><<<blocks, kGlobalThreads, 0, st>>>(
      d[0], d[1], d[2], log_n, lo_bit, k, n);
  return (int)cudaGetLastError();
}

// The passes of merge stage 2^log_k on index bits log_m ... log_k - 1,
// in place: one global launch per kMaxWindow bits, the top window first.
template <int NA, int NK>
int launch_global_stage(int32_t* const* d, int S, int log_n, int log_m,
                        int log_k, cudaStream_t st) {
  for (int hi = log_k; hi > log_m; hi -= kMaxWindow) {
    const int L = hi - log_m < kMaxWindow ? hi - log_m : kMaxWindow;
    const int k = 1 << log_k;
    int rc;
    switch (L) {
      case 1: rc = launch_window<NA, NK, 1>(d, S, log_n, hi - L, k, st); break;
      case 2: rc = launch_window<NA, NK, 2>(d, S, log_n, hi - L, k, st); break;
      case 3: rc = launch_window<NA, NK, 3>(d, S, log_n, hi - L, k, st); break;
      default: rc = launch_window<NA, NK, 4>(d, S, log_n, hi - L, k, st);
    }
    if (rc) return rc;
  }
  return 0;
}

int log2_exact(int x) {
  if (x < 2 || (x & (x - 1))) return -1;
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// Calls `plan.template run<NA, NK>(src, dst, S, log_n, st)` for the
// kernels' (arrays, keys): 1-3 arrays, 1-2 keys. Returns the CUDA error
// code (0 = success), cudaErrorInvalidValue for an argument it refuses.
template <class Plan>
int dispatch(const void* s0, const void* s1, const void* s2, void* d0,
             void* d1, void* d2, int n_arrays, int n_keys, int S, int N,
             void* stream) {
  const Arrays src = {{static_cast<const int32_t*>(s0),
                       static_cast<const int32_t*>(s1),
                       static_cast<const int32_t*>(s2)}};
  int32_t* dst[3] = {static_cast<int32_t*>(d0), static_cast<int32_t*>(d1),
                     static_cast<int32_t*>(d2)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int log_n = log2_exact(N);
  if (log_n < 1 || S < 1 || (int64_t)S * N > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n_keys == 1) {
    if (n_arrays == 1) return Plan::template run<1, 1>(src, dst, S, log_n, st);
    if (n_arrays == 2) return Plan::template run<2, 1>(src, dst, S, log_n, st);
    if (n_arrays == 3) return Plan::template run<3, 1>(src, dst, S, log_n, st);
  } else if (n_keys == 2) {
    if (n_arrays == 2) return Plan::template run<2, 2>(src, dst, S, log_n, st);
    if (n_arrays == 3) return Plan::template run<3, 2>(src, dst, S, log_n, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
