// Encode assembly: per-quad tokens -> block streams on a u16 lattice
// (Hopper, sm_90a).
//
// Replaces the TPU kernel density_tpu/kernels/packroute.py::pack (the
// Pallas routing-network pack, with the sig_pack and prefix sums that
// ran in XLA around it). Same contract: for each of S streams, blocks of
// q quads become [signature words][w0 (w1) per token] at the block's
// word offset, padding blocks (index >= ceil(nbytes / block)) add
// nothing, the 1-3 ragged tail bytes, which the caller stamped into
// w0/w1 at the partial quad, land at Wtot and Wtot + 1, and every word
// past them is 0.
//
// What bounds it on this card: bytes. Every input quad of a real block
// is read once (flags, pw, w0, w1: 16 bytes) and every output word is
// written once. The TPU needed monotone shift-routing networks to place
// tokens without a scatter; here each word goes to its destination, in
// ONE launch:
//   * K thread-block clusters per stream, of C = min(8, N / 8192) CTAs
//     each (cudaLaunchKernelEx with a cluster dimension); CTA r of
//     cluster k takes the contiguous span k C + r of the stream's K C
//     equal spans of quads. K is 1 while the streams' clusters fill the
//     card (S = 38 at 65536 quads: 304 CTAs); for fewer, longer streams
//     K grows (to 32) as far as all S K clusters fit on the card at once;
//   * pass 1: each CTA sums the words of its span's real blocks from pw
//     alone (16-byte loads) and publishes the sum in its shared memory.
//     After one cluster barrier every CTA reads the lower ranks' sums
//     through distributed shared memory. With K > 1 each cluster then
//     publishes its total in a device word tagged with the call's epoch
//     (so the words never need zeroing) and reads the others' totals,
//     waiting for each to carry this call's epoch; all clusters are
//     resident at once, so none waits on one that cannot run. So every
//     CTA knows its first word and the stream's total Wtot;
//   * it then zeroes its share of [Wtot + ragged, ow) (the only zero
//     writes), and the CTA holding the last real block stamps the
//     ragged words;
//   * pass 2, in rounds of 2048 quads: each thread loads 8 consecutive
//     quads of the four arrays (16-byte loads), counts its words (a
//     signature at a block start, pw per quad), and a CTA-wide scan
//     gives its offset; it packs its part of the block's signature (the
//     block's lanes OR theirs by shuffles) and scatters its words into a
//     shared-memory image of the round's output, which the CTA then
//     stores with 16-byte stores. pw is read a second time here, mostly
//     from L2.
// A cluster launch that the card refuses returns its error; nothing
// falls back.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 8;                    // consecutive quads per thread
constexpr int kRound = kThreads * kE;    // quads per CTA per round
constexpr int kCtaQuads = 8192;          // span of a CTA at N <= 65536
constexpr int kMaxCluster = 8;
constexpr int kMaxK = 32;                // clusters per stream
constexpr int kMinQ = 16;
// a round's words: 2 per quad, sig_words (<= 4) per block of >= 16
// quads, and up to 3 words of 16-byte alignment in front
constexpr int kBufWords = 2 * kRound + kRound / kMinQ * 4 + 4;

__device__ __forceinline__ int4 ld4(const int32_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void store_tagged(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// Waits until word p carries `epoch` in its high half; returns the low
// half. A wait of about a second means a cluster never ran: trap (a
// launch error) rather than hang.
__device__ __forceinline__ int wait_tagged(const unsigned long long* p,
                                           unsigned epoch) {
  for (long long it = 0;; ++it) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
    if ((unsigned)(v >> 32) == epoch) return (int)(unsigned)v;
    if (it > (1ll << 20)) __trap();
    __nanosleep(64);
  }
}

// Stores words [lo, hi) of the output row from `img`, whose word i is
// row word base4 + i (base4 a multiple of 4): 16-byte stores where a
// whole aligned quadruple lies in [lo, hi), single words at the edges.
__device__ __forceinline__ void store_range(int32_t* orow, const int32_t* img,
                                            int base4, int lo, int hi) {
  const int n4 = ((hi + 3) >> 2) - (base4 >> 2);
  for (int c = threadIdx.x; c < n4; c += kThreads) {
    const int g = base4 + 4 * c;
    if (g >= lo && g + 4 <= hi) {
      *reinterpret_cast<int4*>(orow + g) =
          *reinterpret_cast<const int4*>(img + 4 * c);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (g + j >= lo && g + j < hi) orow[g + j] = img[4 * c + j];
    }
  }
}

// Zeroes words [lo, hi) of the output row (hi a multiple of 4).
__device__ __forceinline__ void zero_range(int32_t* orow, int lo, int hi) {
  const int c0 = lo >> 2;
  for (int c = c0 + threadIdx.x; 4 * c < hi; c += kThreads) {
    const int g = 4 * c;
    if (g >= lo) {
      *reinterpret_cast<int4*>(orow + g) = make_int4(0, 0, 0, 0);
    } else {
      for (int j = lo - g; j < 4; ++j) orow[g + j] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    packroute_kernel(const int32_t* __restrict__ flags,
                     const int32_t* __restrict__ pw,
                     const int32_t* __restrict__ w0,
                     const int32_t* __restrict__ w1,
                     const int32_t* __restrict__ nbytes,
                     int32_t* __restrict__ out,
                     unsigned long long* __restrict__ tagged, int N, int q,
                     int sig_words, int flag_bits, int block, int ow, int K,
                     unsigned epoch) {
  __shared__ __align__(16) int32_t img[kBufWords];
  __shared__ int warp_tot[kWarps];
  __shared__ int span_words, cluster_before, stream_words;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int cid = blockIdx.x / C;  // cluster
  const int s = cid / K, k = cid % K;
  const int part = k * C + rank;   // this CTA's span of the stream
  const int64_t row = (int64_t)s * N;
  int32_t* orow = out + (int64_t)s * ow;
  const int nb_s = nbytes[s];
  const int nbr = (nb_s + block - 1) / block;  // real blocks
  const int real_q = min(N, nbr * q);          // their quads
  const int span = N / (K * C);
  const int q0 = part * span;
  const int q1 = min(q0 + span, real_q);       // <= q0: nothing real

  // pass 1: the words of the span's real blocks
  int acc = 0;
#pragma unroll 4
  for (int c = q0 + 4 * tid; c < q1; c += 4 * kThreads) {
    const int4 p = ld4(pw + row + c);
    acc += p.x + p.y + p.z + p.w + ((c & (q - 1)) == 0 ? sig_words : 0);
  }
  acc = warp_sum(acc);
  if (lane == 0) warp_tot[wid] = acc;
  __syncthreads();
  if (tid == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_tot[w];
    span_words = t;
  }
  cl.sync();  // every CTA's span_words is visible to the cluster
  // lane r of each warp reads rank r's sum
  const int v = lane < C ? *cl.map_shared_rank(&span_words, lane) : 0;
  int base = warp_sum(lane < rank ? v : 0);
  int wtot = warp_sum(v);
  cluster_arrive();  // done with the other CTAs' shared memory
  if (K > 1) {  // the other clusters of the stream
    unsigned long long* row_tags = tagged + (int64_t)s * K;
    if (rank == 0 && tid == 0)
      store_tagged(row_tags + k, (unsigned long long)epoch << 32 |
                                     (unsigned)wtot);
    if (wid == 0) {
      int t = 0;
      if (lane < K) t = lane == k ? wtot : wait_tagged(row_tags + lane, epoch);
      const int before = warp_sum(lane < k ? t : 0);
      t = warp_sum(t);
      if (lane == 0) {
        cluster_before = before;
        stream_words = t;
      }
    }
    __syncthreads();
    base += cluster_before;
    wtot = stream_words;
  }

  // the ragged words after the last block, then zeros to the row's end
  const int rag = nb_s & 3;
  const int zero0 = wtot + (rag > 0) + (rag > 2);
  if (rag > 0 && tid == 0 && (nbr - 1) * q / span == part) {
    const int64_t fq = row + min(nb_s >> 2, N - 1);
    if (wtot < ow) orow[wtot] = w0[fq] & 0xFFFF;
    if (rag > 2 && wtot + 1 < ow) orow[wtot + 1] = w1[fq] & 0xFFFF;
  }
  if (zero0 < ow) {
    const int n4 = (ow >> 2) - (zero0 >> 2);  // quadruples to touch
    const int per = (n4 + K * C - 1) / (K * C);
    const int lo = max(zero0, 4 * ((zero0 >> 2) + part * per));
    const int hi = min(ow, 4 * ((zero0 >> 2) + (part + 1) * per));
    if (lo < hi) zero_range(orow, lo, hi);
  }

  // pass 2: place signatures and payload words, a round at a time
  const int fmask = (1 << flag_bits) - 1;
  const int lanes_per_block = q / kE;  // 2, 4 or 8
  int carry = base;
  for (int r0 = q0; r0 < q1; r0 += kRound) {
    const int g0 = r0 + kE * tid;  // this thread's first quad
    const bool mine = g0 < q1;     // q1 is a multiple of q >= kE
    int f[kE], p[kE], a[kE], b[kE];
    if (mine) {
#pragma unroll
      for (int h = 0; h < kE; h += 4) {
        const int4 vf = ld4(flags + row + g0 + h);
        const int4 vp = ld4(pw + row + g0 + h);
        const int4 va = ld4(w0 + row + g0 + h);
        const int4 vb = ld4(w1 + row + g0 + h);
        f[h] = vf.x; f[h + 1] = vf.y; f[h + 2] = vf.z; f[h + 3] = vf.w;
        p[h] = vp.x; p[h + 1] = vp.y; p[h + 2] = vp.z; p[h + 3] = vp.w;
        a[h] = va.x; a[h + 1] = va.y; a[h + 2] = va.z; a[h + 3] = va.w;
        b[h] = vb.x; b[h + 1] = vb.y; b[h + 2] = vb.z; b[h + 3] = vb.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) f[e] = p[e] = a[e] = b[e] = 0;
    }
    const int i0 = g0 & (q - 1);  // index of the first quad in its block
    const bool first = mine && i0 == 0;
    int cnt = first ? sig_words : 0;
    unsigned long long sig = 0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      cnt += p[e];
      sig |= (unsigned long long)(f[e] & fmask) << ((i0 + e) * flag_bits);
    }
    // the block's lanes are aligned groups of lanes_per_block
    for (int o = 1; o < lanes_per_block; o <<= 1)
      sig |= __shfl_xor_sync(kFull, sig, o);
    const int incl = warp_incl_scan(cnt, lane);
    if (lane == 31) warp_tot[wid] = incl;
    __syncthreads();  // warp totals in; the last round's stores done
    int before = 0, rtot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_tot[w];
      before += w < wid ? t : 0;
      rtot += t;
    }
    const int base4 = carry & ~3;
    int pos = (carry & 3) + before + incl - cnt;  // index in img
    if (first) {
      for (int j = 0; j < sig_words; ++j)
        img[pos + j] = (int)((sig >> (16 * j)) & 0xFFFF);
      pos += sig_words;
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (p[e] >= 1) img[pos] = a[e] & 0xFFFF;
      if (p[e] == 2) img[pos + 1] = b[e] & 0xFFFF;
      pos += p[e];
    }
    __syncthreads();  // the round's image is complete
    store_range(orow, img, base4, carry, min(carry + rtot, ow));
    carry += rtot;
  }
  cluster_wait();  // no CTA leaves while another may read its span_words
}

// The clusters of 8 CTAs that the current device holds at once (0 where
// the query fails), asked once per device.
int resident_clusters() {
  static std::atomic<int> slots[kMaxDevices];
  return per_device(slots, [] {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kMaxCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kMaxCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int c = 0;
    return cudaOccupancyMaxActiveClusters(&c, packroute_kernel, &cfg) ==
                   cudaSuccess
               ? c
               : 0;
  });
}

}  // namespace

// flags, pw, w0, w1: (S, N) int32, 16-byte aligned; nbytes: (S,) int32;
// out: (S, ow) int32, 16-byte aligned, ow = 2N + (N / q) sig_words;
// tagged: 32 S words that only this kernel writes (on this stream), and
// epoch a value that no earlier call on them used (never 0). N a
// multiple of 16384, q 16, 32 or 64. One launch on `stream`. Returns the
// CUDA error code.
extern "C" int packroute(const void* flags, const void* pw, const void* w0,
                         const void* w1, const void* nbytes, void* out,
                         void* tagged, int S, int N, int q, int sig_words,
                         int flag_bits, int block, int ow, int epoch,
                         void* stream) {
  if ((q != 16 && q != 32 && q != 64) || N < 16384 || N % 16384 != 0 ||
      q * flag_bits > 64 || q * flag_bits > 16 * sig_words ||
      sig_words < 1 || sig_words > 4 || flag_bits < 1 || flag_bits > 3 ||
      ow != 2 * N + (N / q) * sig_words || epoch == 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const int C = N / kCtaQuads < kMaxCluster ? N / kCtaQuads : kMaxCluster;
  // clusters per stream: a power of two, spans of at least 8192 quads in
  // whole rounds, and every cluster of the launch resident at once
  int K = 1;
  if (C == kMaxCluster) {
    const int fit = resident_clusters() / S;
    while (2 * K <= kMaxK && 2 * K <= fit &&
           N % (2 * K * C * kCtaQuads) == 0)
      K *= 2;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S * (unsigned)(K * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, packroute_kernel, static_cast<const int32_t*>(flags),
      static_cast<const int32_t*>(pw), static_cast<const int32_t*>(w0),
      static_cast<const int32_t*>(w1), static_cast<const int32_t*>(nbytes),
      static_cast<int32_t*>(out),
      static_cast<unsigned long long*>(tagged), N, q, sig_words, flag_bits,
      block, ow, K, (unsigned)epoch);
}
