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
// kernel writes zeros for it and raises the error flag, on which the
// wrapper raises DecodeError. No read leaves the array and no word goes
// to another token's slot.
//
// What bounds it on this card: bytes (the compressed words read once,
// three int32 outputs per quad written once). The TPU routed payload
// words with monotone shift networks because it has no fast gather; on
// the GPU one warp per block gathers its tokens directly, with a warp
// scan for the intra-block offsets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int rd(const int32_t* row, int64_t i, int W) {
  return (i >= 0 && i < W) ? (row[i] & 0xFFFF) : 0;
}

__device__ __forceinline__ int payload_words(int flag, int flag_bits) {
  if (flag == 0) return 2;
  if (flag_bits == 1) return 1;
  if (flag_bits == 2) return flag == 3 ? 0 : 1;
  return flag >= 6 ? 1 : 0;
}

__global__ void unpack_kernel(const int32_t* words, const int32_t* woff,
                              const uint8_t* is_copy, int32_t* flags,
                              int32_t* w0, int32_t* w1, int32_t* err,
                              int64_t n_blocks, int NB, int W, int q,
                              int sig_words, int flag_bits) {
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_blocks) return;  // whole warps exit together
  const int64_t s = w / NB;
  const int32_t* row = words + s * (int64_t)W;
  const int per = (q + 31) >> 5;
  const int64_t q0 = w * q;
  const int wo = woff[w];
  const bool cp = is_copy != nullptr && is_copy[w] != 0;
  const bool dead = wo < 0;
  const bool bad = !dead && (wo >= W || (!cp && wo > W - sig_words));
  if (bad && lane == 0) atomicOr(err, 1);
  if (dead || bad) {
    for (int i = lane; i < q; i += 32) {
      flags[q0 + i] = 0;
      w0[q0 + i] = 0;
      w1[q0 + i] = 0;
    }
    return;
  }
  if (cp) {
    for (int i = lane; i < q; i += 32) {
      flags[q0 + i] = 0;
      w0[q0 + i] = rd(row, (int64_t)wo + 2 * i, W);
      w1[q0 + i] = rd(row, (int64_t)wo + 2 * i + 1, W);
    }
    return;
  }
  // the signature as one 64-bit word (sig_words <= 4)
  const int myword = lane < sig_words ? rd(row, (int64_t)wo + lane, W) : 0;
  unsigned long long sig = 0;
  for (int k = 0; k < sig_words; ++k)
    sig |= (unsigned long long)(unsigned)__shfl_sync(kFull, myword, k)
           << (16 * k);
  const int mask = (1 << flag_bits) - 1;
  int mysum = 0;
  for (int t = 0; t < per; ++t) {
    const int i = lane * per + t;
    if (i < q) mysum += payload_words((int)((sig >> (i * flag_bits)) & mask),
                                      flag_bits);
  }
  int incl = mysum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  int64_t pos = (int64_t)wo + sig_words + (incl - mysum);
  for (int t = 0; t < per; ++t) {
    const int i = lane * per + t;
    if (i >= q) break;
    const int f = (int)((sig >> (i * flag_bits)) & mask);
    const int p = payload_words(f, flag_bits);
    flags[q0 + i] = f;
    w0[q0 + i] = p >= 1 ? rd(row, pos, W) : 0;
    w1[q0 + i] = p >= 1 ? rd(row, pos + 1, W) : 0;
    pos += p;
  }
}

}  // namespace

// words: (S, W) int32 u16 values; woff: (S, NB) int32; is_copy: (S, NB)
// uint8 or null; flags/w0/w1: (S, NB * q) int32; err: one int32.
// Returns the CUDA error code of the launches.
extern "C" int unpack(const void* words, const void* woff,
                      const void* is_copy, void* flags, void* w0, void* w1,
                      void* err, int S, int NB, int W, int q, int sig_words,
                      int flag_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q < 1 || sig_words < 1 || sig_words > 4 || flag_bits < 1 ||
      flag_bits > 3 || q * flag_bits > 16 * sig_words)
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(err, 0, sizeof(int32_t), st);
  const int64_t n_blocks = (int64_t)S * NB;
  if (n_blocks == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int grid = (int)((n_blocks * 32 + threads - 1) / threads);
  unpack_kernel<<<grid, threads, 0, st>>>(
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(woff),
      static_cast<const uint8_t*>(is_copy), static_cast<int32_t*>(flags),
      static_cast<int32_t*>(w0), static_cast<int32_t*>(w1),
      static_cast<int32_t*>(err), n_blocks, NB, W, q, sig_words, flag_bits);
  return (int)cudaGetLastError();
}
