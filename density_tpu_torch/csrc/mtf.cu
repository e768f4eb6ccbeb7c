// Segmented move-to-front depths over lion's 5-slot prediction queue
// (Hopper, sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this scan with
// jax.lax.associative_scan (density_tpu/engine/mtf.py, the doubling scan
// of `mtf_depths_sorted`), which the port's plain version
// (density_tpu_torch/kernels/mtf.py::depths_plain) runs as some 40
// launches at each of log2(n) levels. Same contract: (S, n) segment
// starts `first`, int32 values and `valid` flags in, int32 depths in
// [0, 5] out, per row:
//   * a segment start empties the queue (the element that starts it
//     included);
//   * a valid element's depth is its slot in the queue if it is there,
//     else the count of live slots if its value is 0 and the queue is not
//     full (the zero-initialised queue of lion.rs), else 5 (a miss);
//   * the element then moves to the front (a miss drops the oldest of a
//     full queue); an invalid element gets 5 and changes nothing.
//
// What bounds it on this card: bytes. Each element needs its two flags
// and its value read and its depth written, 10 bytes, against a few
// dozen integer operations. The queue (5 slot values, a count and a
// sticky segment bit) fits in registers, so the scan is one pass of
// reduce-then-scan, one launch at any n:
//   * a block takes a tile of 4096 consecutive elements of one row, 16 a
//     thread; the tile is loaded once, coalesced, through shared memory,
//     and every thread keeps its 16 values and flags in registers;
//   * each thread folds its run into the run's summary, the MTF state
//     that the run leaves (its distinct values by recency, capped at 5),
//     whose composition is D(a ++ b) = take_5(D(b) ++ (D(a) \ set(D(b))))
//     unless b starts a segment;
//   * a warp scans the summaries with shuffles (5 steps), the block's
//     eight warps through shared memory;
//   * tiles of one row pass their summaries on by decoupled look-back
//     on a scratch buffer that the wrapper allocates: a tile publishes
//     its own summary, then its thread 0 combines its predecessors'
//     summaries back to the nearest tile that has published an inclusive
//     prefix, that starts a segment, or that fills the queue (text's
//     segments are short, so that is nearly always the tile just before);
//   * each thread walks its run again from its exclusive prefix, in
//     registers, and the depths go out coalesced through shared memory.
// The input is read once. A tile waits only for tiles of lower block
// index, which the card starts first (as CUB's single-pass scans also
// assume), so the look-back cannot wait on a block that never runs.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 5;  // queue slots; a depth of K is a miss
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // elements a thread
constexpr int kTile = kThreads * kItems;
// A tile's status word: what it has published (bits 0-1), its own
// summary's count and sticky bit (bits 2-4, 5), its inclusive prefix's
// count (bits 6-8). Its slot values sit in the payload: 5 of the tile's
// summary, then 5 of the inclusive prefix.
constexpr int kAggregate = 1;
constexpr int kInclusive = 2;
constexpr int kPayload = 2 * K;

// The MTF state a run of elements leaves: d[0..cnt) its distinct values,
// most recent first; sticky if a segment starts in the run.
struct Queue {
  int d[K];
  int cnt;
  int sticky;
};

struct Smem {
  int v[kTile + kTile / 32];  // values, then depths (padded: no conflicts)
  alignas(16) uint8_t f[kTile];  // first | valid << 1
  Queue warp[kWarps];
  Queue prefix;
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ Queue empty_queue() {
  Queue q;
#pragma unroll
  for (int j = 0; j < K; ++j) q.d[j] = 0;
  q.cnt = 0;
  q.sticky = 0;
  return q;
}

// The state of a run a followed by a run b.
__device__ __forceinline__ Queue combine(const Queue& a, const Queue& b) {
  if (b.sticky) return b;
  Queue r = b;
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
__device__ __forceinline__ int step(Queue& q, int v, int f) {
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

__device__ __forceinline__ Queue shfl_up(const Queue& q, int o) {
  Queue r;
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = __shfl_up_sync(kFull, q.d[j], o);
  const int cs = __shfl_up_sync(kFull, (q.cnt << 1) | q.sticky, o);
  r.cnt = cs >> 1;
  r.sticky = cs & 1;
  return r;
}

using Status = cuda::atomic_ref<int, cuda::thread_scope_device>;

__device__ void publish(int* status, int* payload, int64_t tile, int kind,
                        const Queue& agg, const Queue& incl) {
  int* p = payload + tile * kPayload;
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
__device__ Queue look_back(int* status, int* payload, int64_t blk, int tile,
                           const Queue& agg, bool starts_segment) {
  const Queue none = empty_queue();
  if (tile == 0 || agg.sticky) {
    // the inclusive prefix is the summary itself
    publish(status, payload, blk, kInclusive, agg, agg);
    if (tile == 0 || starts_segment) return none;
  } else {
    publish(status, payload, blk, kAggregate, agg, none);
  }
  Queue acc = none;
  for (int64_t j = blk - 1;; --j) {
    int w;
    while (((w = Status(status[j]).load(cuda::memory_order_acquire)) & 3) ==
           0)
      __nanosleep(32);
    const bool incl = (w & 3) == kInclusive;
    const int* p = payload + j * kPayload + (incl ? K : 0);
    Queue got;
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

__global__ void __launch_bounds__(kThreads)
    mtf_kernel(const uint8_t* __restrict__ first,
               const int32_t* __restrict__ vals,
               const uint8_t* __restrict__ valid,
               int32_t* __restrict__ depth, int* status, int* payload,
               int64_t n, int tiles) {
  __shared__ Smem s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x % tiles;
  const int64_t start = (int64_t)tile * kTile;
  const int64_t base = (int64_t)(blockIdx.x / tiles) * n + start;
  const int len = n - start < kTile ? (int)(n - start) : kTile;

  // load the tile coalesced; each thread takes 16 consecutive elements
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
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
  int v[kItems];
  unsigned fb = 0;  // 2 bits an element
  const int4 fw = reinterpret_cast<const int4*>(s.f)[t];
  const int words[4] = {fw.x, fw.y, fw.z, fw.w};
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    v[e] = s.v[pad(t * kItems + e)];
    fb |= (((unsigned)words[e >> 2] >> (8 * (e & 3))) & 3u) << (2 * e);
  }

  // the run's summary, then the warp's inclusive scan of them
  Queue q = empty_queue();
#pragma unroll
  for (int e = 0; e < kItems; ++e) step(q, v[e], (fb >> (2 * e)) & 3);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Queue up = shfl_up(q, o);
    if (lane >= o) q = combine(up, q);
  }
  Queue ex = shfl_up(q, 1);
  if (lane == 0) ex = empty_queue();
  if (lane == 31) s.warp[warp] = q;
  __syncthreads();

  Queue before = empty_queue();
  for (int w = 0; w < warp; ++w) before = combine(before, s.warp[w]);
  ex = combine(before, ex);
  if (t == 0) {
    Queue agg = empty_queue();
    for (int w = 0; w < kWarps; ++w) agg = combine(agg, s.warp[w]);
    s.prefix = tiles == 1 ? empty_queue()
                          : look_back(status, payload, blockIdx.x, tile, agg,
                                      fb & 1);
  }
  __syncthreads();

  // walk the run again from its exclusive prefix
  q = combine(s.prefix, ex);
#pragma unroll
  for (int e = 0; e < kItems; ++e)
    s.v[pad(t * kItems + e)] = step(q, v[e], (fb >> (2 * e)) & 3);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + t;
    if (i < len) depth[base + i] = s.v[pad(i)];
  }
}

}  // namespace

// Elements a block takes: the wrapper sizes the scratch from it.
extern "C" int mtf_tile() { return kTile; }

// first, valid: (S, n) bytes of 0 or 1; vals: (S, n) int32; depth: (S, n)
// int32 out. scratch: (1 + 10) int32 a tile of every row when a row has
// more than one tile (ceil(n / 4096)), else unused; its status words are
// zeroed here. A memset (rows of several tiles) and one launch on
// `stream`. Returns the CUDA error code.
extern "C" int mtf_depths(const void* first, const void* vals,
                          const void* valid, void* depth, void* scratch,
                          int S, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (S == 0 || n == 0) return (int)cudaGetLastError();
  const int64_t tiles = ((int64_t)n + kTile - 1) / kTile;
  const int64_t blocks = (int64_t)S * tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int* status = static_cast<int*>(scratch);
  if (tiles > 1) {
    if (status == nullptr) return (int)cudaErrorInvalidValue;
    cudaMemsetAsync(status, 0, blocks * sizeof(int), st);
  }
  mtf_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(first), static_cast<const int32_t*>(vals),
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(depth),
      status, tiles > 1 ? status + blocks : nullptr, n, (int)tiles);
  return (int)cudaGetLastError();
}
