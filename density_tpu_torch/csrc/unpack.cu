// Decode token extraction: block streams -> per-quad (flags, w0, w1)
// (Hopper, sm_90a).
//
// Replaces the TPU kernels density_tpu/kernels/unpack.py::unpack (two
// Pallas shift-routing kernels with flags_from_sig and
// flag_payload_words in XLA between them). Same contract, for flag_bits
// 1, 2 and 3:
//   * live block (woff >= 0, not copy): its sig_words signature words at
//     woff give each quad's flag (LSB-first, straddling words for 3-bit
//     flags) and payload words pw (plain 2, map 1, predicted 0); tokens
//     read w0 = words[woff + sig_words + intra] and, for pw >= 1, w1 at
//     the next word (intra = payload words of the block's earlier
//     quads);
//   * copy block: flags 0 and w0/w1 = words[woff + 2j], words[woff+2j+1];
//   * dead block (woff < 0): zeros.
// Every read is bounds-checked against W: a word past W reads 0. A live
// block whose start (or signature) lies outside [0, W) is malformed: the
// kernel writes zeros for it and raises the error flag, which the
// caller reads when it likes (no host sync here). No read leaves the
// array and no word goes to another token's slot.
//
// What bounds it on this card: bytes (the compressed words read once,
// three int32 outputs per quad written once). The TPU routed payload
// words with monotone shift networks because it has no fast gather; here
// each thread takes 4 consecutive quads of one block (q / 4 threads a
// block, the blocks of all streams in order), in one launch:
//   * it reads its block's offset and copy bit, then the signature
//     word(s) holding its 4 flags;
//   * a shuffle scan over the block's q / 4 threads gives the payload
//     words before its quads (woff gives each block's start, so no scan
//     crosses blocks);
//   * it gathers its tokens' words (through L1: the block's threads read
//     neighbouring words) and stores flags, w0 and w1 with 16-byte
//     stores.
// Staging a tile's compressed words in shared memory first, with
// 16-byte loads, measured slower on the H100 (tools/ab_kernels.py; see
// PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kQT = 4;  // quads per thread

__device__ __forceinline__ int rd(const int32_t* row, int64_t i, int W) {
  return (i >= 0 && i < W) ? (__ldg(row + i) & 0xFFFF) : 0;
}

__device__ __forceinline__ int payload_words(int flag, int flag_bits) {
  if (flag == 0) return 2;
  if (flag_bits == 1) return 1;
  if (flag_bits == 2) return flag == 3 ? 0 : 1;
  return flag >= 6 ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    unpack_kernel(const int32_t* __restrict__ words,
                  const int32_t* __restrict__ woff,
                  const uint8_t* __restrict__ is_copy,
                  int32_t* __restrict__ flags, int32_t* __restrict__ w0,
                  int32_t* __restrict__ w1, int32_t* __restrict__ err,
                  int64_t n_blocks, int NB, int W, int q, int sig_words,
                  int flag_bits) {
  const int lane = threadIdx.x & 31;
  const int G = q / kQT;  // threads per block: 4, 8 or 16
  const int64_t gb = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / G;
  const int i0 = (threadIdx.x % G) * kQT;  // first quad in the block
  const bool in = gb < n_blocks;
  const int32_t* row = words + (gb / NB) * (int64_t)W;
  int wo = -1, cp = 0;
  if (in) {
    wo = __ldg(woff + gb);
    cp = is_copy != nullptr && is_copy[gb] != 0;
  }
  if (wo >= 0 && (wo >= W || (!cp && wo > W - sig_words))) {
    if (i0 == 0) atomicOr(err, 1);
    wo = -1;  // malformed: zeros, as a dead block
  }
  int f[kQT] = {0, 0, 0, 0}, pws[kQT] = {0, 0, 0, 0};
  int sum = 0;
  if (wo >= 0 && !cp) {
    const int bit0 = i0 * flag_bits, k = bit0 >> 4;
    unsigned sigw = (unsigned)rd(row, (int64_t)wo + k, W);
    if (k + 1 < sig_words)
      sigw |= (unsigned)rd(row, (int64_t)wo + k + 1, W) << 16;
    sigw >>= bit0 & 15;
    const int mask = (1 << flag_bits) - 1;
#pragma unroll
    for (int e = 0; e < kQT; ++e) {
      f[e] = (int)((sigw >> (e * flag_bits)) & mask);
      pws[e] = payload_words(f[e], flag_bits);
      sum += pws[e];
    }
  }
  // exclusive scan of the payload words over the block's G threads
  int incl = sum;
  for (int o = 1; o < G; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o, G);
    if ((lane & (G - 1)) >= o) incl += y;
  }
  int a[kQT] = {0, 0, 0, 0}, c[kQT] = {0, 0, 0, 0};
  if (wo >= 0 && !cp) {
    int64_t pos = (int64_t)wo + sig_words + incl - sum;
#pragma unroll
    for (int e = 0; e < kQT; ++e) {
      if (pws[e] >= 1) {
        a[e] = rd(row, pos, W);
        c[e] = rd(row, pos + 1, W);
      }
      pos += pws[e];
    }
  } else if (wo >= 0) {
#pragma unroll
    for (int e = 0; e < kQT; ++e) {
      a[e] = rd(row, (int64_t)wo + 2 * (i0 + e), W);
      c[e] = rd(row, (int64_t)wo + 2 * (i0 + e) + 1, W);
    }
  }
  if (in) {
    const int64_t o = gb * q + i0;
    *reinterpret_cast<int4*>(flags + o) = make_int4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<int4*>(w0 + o) = make_int4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<int4*>(w1 + o) = make_int4(c[0], c[1], c[2], c[3]);
  }
}

}  // namespace

// words: (S, W) int32 u16 values; woff: (S, NB) int32; is_copy: (S, NB)
// uint8 or null; flags/w0/w1: (S, NB * q) int32, 16-byte aligned; err:
// one int32, set nonzero if a live block is malformed. q 16, 32 or 64.
// One memset of err and one launch on `stream`. Returns the CUDA error
// code.
extern "C" int unpack(const void* words, const void* woff,
                      const void* is_copy, void* flags, void* w0, void* w1,
                      void* err, int S, int NB, int W, int q, int sig_words,
                      int flag_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((q != 16 && q != 32 && q != 64) || sig_words < 1 || sig_words > 4 ||
      flag_bits < 1 || flag_bits > 3 || q * flag_bits > 16 * sig_words)
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(err, 0, sizeof(int32_t), st);
  const int64_t n_blocks = (int64_t)S * NB;
  if (n_blocks == 0) return (int)cudaGetLastError();
  const int64_t threads = n_blocks * (q / kQT);
  unpack_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads,
                  0, st>>>(
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(woff),
      static_cast<const uint8_t*>(is_copy), static_cast<int32_t*>(flags),
      static_cast<int32_t*>(w0), static_cast<int32_t*>(w1),
      static_cast<int32_t*>(err), n_blocks, NB, W, q, sig_words, flag_bits);
  return (int)cudaGetLastError();
}
