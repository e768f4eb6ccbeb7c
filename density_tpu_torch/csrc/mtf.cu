// Segmented move-to-front depths over a K-slot list (Hopper, sm_90a),
// built for K = 5 (lion's prediction queue) and K = 2 (cheetah's and
// lion's MTF-2 dictionaries: chunk_a and chunk_b of a hash).
//
// Replaces no Pallas kernel: the JAX package computes both scans as
// doubling scans outside any kernel (density_tpu/engine/mtf.py's
// `mtf_depths_sorted`, and density_tpu/engine/grouping.py's
// `seg_mtf2_before` / `seg_mtf2_before_packed`), which the port's plain
// versions (density_tpu_torch/kernels/mtf.py) run as some 40 launches
// at K = 5 and some 60 at K = 2 at each of log2(n) levels. Same contract
// at both K: (S, n) segment starts `first`, int32 values and `valid`
// flags in, int32 depths in [0, K] out, per row:
//   * a segment start empties the list (the element that starts it
//     included);
//   * a valid element's depth is its slot in the list if it is there,
//     else the count of live slots if its value is 0 and the list is not
//     full (the zero-initialised queue and dictionaries of lion.rs and
//     cheetah.rs), else K (a miss);
//   * the element then moves to the front (a miss drops the oldest of a
//     full list); an invalid element gets K and changes nothing.
// At K = 2 the planners' two dictionary flags are depth 0 (the value is
// chunk_a) and depth 1 (it is chunk_b and not chunk_a).
//
// What bounds it on this card: bytes. Each element needs its two flags
// and its value read and its depth written, 10 bytes, against a few
// dozen integer operations. The list (K slot values, a count and a
// sticky segment bit) fits in registers, so the scan is one pass of
// reduce-then-scan, one launch at any n:
//   * a block takes a tile of kItems<K> * 256 consecutive elements of
//     one row; the tile is loaded once, coalesced, through shared memory,
//     and every thread keeps its kItems<K> values and flags in registers;
//   * each thread folds its run into the run's summary, the MTF state
//     that the run leaves (its distinct values by recency, capped at K),
//     whose composition is D(a ++ b) = take_K(D(b) ++ (D(a) \ set(D(b))))
//     unless b starts a segment;
//   * a warp scans the summaries with shuffles (5 steps), the block's
//     eight warps through shared memory;
//   * tiles of one row pass their summaries on by decoupled look-back
//     on a scratch buffer that the wrapper allocates: a tile publishes
//     its own summary, then its thread 0 combines its predecessors'
//     summaries back to the nearest tile that has published an inclusive
//     prefix, that starts a segment, or that fills the list (text's
//     segments are short, so that is nearly always the tile just before);
//   * each thread walks its run again from its exclusive prefix, in
//     registers, and the depths go out coalesced through shared memory.
// The input is read once. A tile waits only for tiles of lower block
// index, which the card starts first (as CUB's single-pass scans also
// assume), so the look-back cannot wait on a block that never runs.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Elements a thread (8, 16 or 32), chosen on the card (PERF.md, the
// kernel table).
template <int K>
constexpr int kItems = 16;
template <int K>
constexpr int kTile = kThreads * kItems<K>;
// A tile's status word: what it has published (bits 0-1), its own
// summary's count and sticky bit (bits 2-4, 5), its inclusive prefix's
// count (bits 6-8). Its slot values sit in the payload: K of the tile's
// summary, then K of the inclusive prefix.
constexpr int kAggregate = 1;
constexpr int kInclusive = 2;

// The MTF state a run of elements leaves: d[0..cnt) its distinct values,
// most recent first; sticky if a segment starts in the run.
template <int K>
struct Queue {
  static_assert(K >= 1 && K <= 7, "a count takes 3 bits of the status");
  int d[K];
  int cnt;
  int sticky;
};

template <int K>
struct Smem {
  static constexpr int T = kTile<K>;
  int v[T + T / 32];  // values, then depths (padded: no conflicts)
  alignas(16) uint8_t f[T];  // first | valid << 1
  Queue<K> warp[kWarps];
  Queue<K> prefix;
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

template <int K>
__device__ __forceinline__ Queue<K> empty_queue() {
  Queue<K> q;
#pragma unroll
  for (int j = 0; j < K; ++j) q.d[j] = 0;
  q.cnt = 0;
  q.sticky = 0;
  return q;
}

// The state of a run a followed by a run b.
template <int K>
__device__ __forceinline__ Queue<K> combine(const Queue<K>& a,
                                            const Queue<K>& b) {
  if (b.sticky) return b;
  Queue<K> r = b;
  int pos = b.cnt;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bool in_b = false;
#pragma unroll
    for (int m = 0; m < K; ++m) in_b |= m < b.cnt && a.d[j] == b.d[m];
    const bool keep = j < a.cnt && !in_b;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (keep && pos == i) r.d[i] = a.d[j];
    pos += keep;
  }
  r.cnt = min(pos, K);
  r.sticky = a.sticky;
  return r;
}

// One element (f: first | valid << 1): returns its depth and moves it to
// the front.
template <int K>
__device__ __forceinline__ int step(Queue<K>& q, int v, int f) {
  if (f & 1) {
    q.cnt = 0;
    q.sticky = 1;
  }
  if (!(f & 2)) return K;
  int at = K;
#pragma unroll
  for (int j = K - 1; j >= 0; --j)
    if (j < q.cnt && q.d[j] == v) at = j;
  const int depth = at < K ? at : (v == 0 && q.cnt < K ? q.cnt : K);
  const int last = at < K ? at : K - 1;  // slots 1..last move down one
#pragma unroll
  for (int j = K - 1; j >= 1; --j)
    if (j <= last) q.d[j] = q.d[j - 1];
  q.d[0] = v;
  q.cnt = min(q.cnt + (at == K), K);
  return depth;
}

template <int K>
__device__ __forceinline__ Queue<K> shfl_up(const Queue<K>& q, int o) {
  Queue<K> r;
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = __shfl_up_sync(kFull, q.d[j], o);
  const int cs = __shfl_up_sync(kFull, (q.cnt << 1) | q.sticky, o);
  r.cnt = cs >> 1;
  r.sticky = cs & 1;
  return r;
}

using Status = cuda::atomic_ref<int, cuda::thread_scope_device>;

template <int K>
__device__ void publish(int* status, int* payload, int64_t tile, int kind,
                        const Queue<K>& agg, const Queue<K>& incl) {
  int* p = payload + tile * (2 * K);
  if (kind == kAggregate) {
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = agg.d[j];
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) p[K + j] = incl.d[j];
  }
  Status(status[tile]).store(
      kind | (agg.cnt << 2) | (agg.sticky << 5) | (incl.cnt << 6),
      cuda::memory_order_release);
}

// Thread 0 of tile `tile` (block `blk`): publishes the tile's summary
// and returns its exclusive prefix in the row.
template <int K>
__device__ Queue<K> look_back(int* status, int* payload, int64_t blk,
                              int tile, const Queue<K>& agg,
                              bool starts_segment) {
  const Queue<K> none = empty_queue<K>();
  if (tile == 0 || agg.sticky) {
    // the inclusive prefix is the summary itself
    publish(status, payload, blk, kInclusive, agg, agg);
    if (tile == 0 || starts_segment) return none;
  } else {
    publish(status, payload, blk, kAggregate, agg, none);
  }
  Queue<K> acc = none;
  for (int64_t j = blk - 1;; --j) {
    int w;
    while (((w = Status(status[j]).load(cuda::memory_order_acquire)) & 3) ==
           0)
      __nanosleep(32);
    const bool incl = (w & 3) == kInclusive;
    const int* p = payload + j * (2 * K) + (incl ? K : 0);
    Queue<K> got;
#pragma unroll
    for (int m = 0; m < K; ++m) got.d[m] = __ldcg(p + m);
    got.cnt = incl ? (w >> 6) & 7 : (w >> 2) & 7;
    got.sticky = incl ? 0 : (w >> 5) & 1;
    acc = combine(got, acc);
    if (incl || acc.sticky || acc.cnt == K) break;
  }
  if (!agg.sticky)
    publish(status, payload, blk, kInclusive, agg, combine(acc, agg));
  return acc;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    mtf_kernel(const uint8_t* __restrict__ first,
               const int32_t* __restrict__ vals,
               const uint8_t* __restrict__ valid,
               int32_t* __restrict__ depth, int* status, int* payload,
               int64_t n, int tiles) {
  constexpr int kN = kItems<K>, kT = kTile<K>;
  static_assert(kN == 8 || kN == 16 || kN == 32, "flags: 8-byte words");
  // 2 flag bits an element
  using Bits = typename std::conditional<(kN > 16), uint64_t, uint32_t>::type;
  __shared__ Smem<K> s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x % tiles;
  const int64_t start = (int64_t)tile * kT;
  const int64_t base = (int64_t)(blockIdx.x / tiles) * n + start;
  const int len = n - start < kT ? (int)(n - start) : kT;

  // load the tile coalesced; each thread takes kN consecutive elements
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int i = k * kThreads + t;
    int v = 0, f = 0;
    if (i < len) {
      v = vals[base + i];
      f = (first[base + i] != 0) | ((valid[base + i] != 0) << 1);
    }
    s.v[pad(i)] = v;
    s.f[i] = (uint8_t)f;
  }
  __syncthreads();
  int v[kN];
  uint32_t words[kN / 4];
#pragma unroll
  for (int c = 0; c < kN / 8; ++c) {
    const uint2 w = reinterpret_cast<const uint2*>(s.f)[t * (kN / 8) + c];
    words[2 * c] = w.x;
    words[2 * c + 1] = w.y;
  }
  Bits fb = 0;
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    v[e] = s.v[pad(t * kN + e)];
    fb |= (Bits)((words[e >> 2] >> (8 * (e & 3))) & 3u) << (2 * e);
  }

  // the run's summary, then the warp's inclusive scan of them
  Queue<K> q = empty_queue<K>();
#pragma unroll
  for (int e = 0; e < kN; ++e) step(q, v[e], (fb >> (2 * e)) & 3);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Queue<K> up = shfl_up(q, o);
    if (lane >= o) q = combine(up, q);
  }
  Queue<K> ex = shfl_up(q, 1);
  if (lane == 0) ex = empty_queue<K>();
  if (lane == 31) s.warp[warp] = q;
  __syncthreads();

  Queue<K> before = empty_queue<K>();
  for (int w = 0; w < warp; ++w) before = combine(before, s.warp[w]);
  ex = combine(before, ex);
  if (t == 0) {
    Queue<K> agg = empty_queue<K>();
    for (int w = 0; w < kWarps; ++w) agg = combine(agg, s.warp[w]);
    s.prefix = tiles == 1 ? empty_queue<K>()
                          : look_back(status, payload, blockIdx.x, tile, agg,
                                      fb & 1);
  }
  __syncthreads();

  // walk the run again from its exclusive prefix
  q = combine(s.prefix, ex);
#pragma unroll
  for (int e = 0; e < kN; ++e)
    s.v[pad(t * kN + e)] = step(q, v[e], (fb >> (2 * e)) & 3);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int i = k * kThreads + t;
    if (i < len) depth[base + i] = s.v[pad(i)];
  }
}

// A memset of the status words (rows of several tiles) and one launch
// on `stream`; returns the CUDA error code.
template <int K>
int run(const void* first, const void* vals, const void* valid, void* depth,
        void* scratch, int S, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (S == 0 || n == 0) return (int)cudaGetLastError();
  const int64_t tiles = ((int64_t)n + kTile<K> - 1) / kTile<K>;
  const int64_t blocks = (int64_t)S * tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int* status = static_cast<int*>(scratch);
  if (tiles > 1) {
    if (status == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t e =
        cudaMemsetAsync(status, 0, blocks * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  mtf_kernel<K><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(first), static_cast<const int32_t*>(vals),
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(depth),
      status, tiles > 1 ? status + blocks : nullptr, n, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Elements a block takes at K = 5 and at K = 2: the wrapper sizes the
// scratch from it.
extern "C" int mtf_tile() { return kTile<5>; }
extern "C" int mtf2_tile() { return kTile<2>; }

// first, valid: (S, n) bytes of 0 or 1; vals: (S, n) int32; depth: (S, n)
// int32 out. scratch: (1 + 2K) int32 a tile of every row when a row has
// more than one tile, else unused; its status words are zeroed here.
// mtf_depths is K = 5, mtf2_depths K = 2.
extern "C" int mtf_depths(const void* first, const void* vals,
                          const void* valid, void* depth, void* scratch,
                          int S, int n, void* stream) {
  return run<5>(first, vals, valid, depth, scratch, S, n, stream);
}

extern "C" int mtf2_depths(const void* first, const void* vals,
                           const void* valid, void* depth, void* scratch,
                           int S, int n, void* stream) {
  return run<2>(first, vals, valid, depth, scratch, S, n, stream);
}
