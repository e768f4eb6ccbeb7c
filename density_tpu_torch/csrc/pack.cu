// Encode assembly in 4096-quad tiles: per-quad tokens -> block streams on
// a u16 lattice (Hopper, sm_90a).
//
// Replaces the TPU kernel density_tpu/kernels/pack.py::pack (the Pallas
// pack that places tokens with one-hot MXU matmuls, walking each stream
// in groups of up to 16384 quads with the running word base carried in
// SMEM). Same contract as packroute.cu: for each of S streams, blocks of
// q quads become [signature words][w0 (w1) per token] at the block's word
// offset, padding blocks (index >= ceil(nbytes / block)) add nothing, and
// the 1-3 ragged tail bytes, which the caller stamped into w0/w1 at the
// partial quad, follow the last real block's payload. Here N need only be
// a multiple of 4096 (the TPU kernel's GQ_MIN), and the signature is
// packed bit by bit, so lion's 3-bit flags may cross u16 words.
//
// One CTA (1024 threads) per stream walks it in tiles of 4096 quads, in
// order, carrying the word base in a register: the TPU kernel's
// sequential (stream, group) grid, without a scratch round trip. Each
// tile, in shared memory:
//   1. load pw (4 quads per thread) and the flags; a tile-wide exclusive
//      scan of pw gives every token's payload offset;
//   2. per-block word counts (sig_words + payload, plus the ragged
//      halfwords on the last real block, 0 for padding blocks) and their
//      scan give the blocks' word offsets;
//   3. signature words, w0/w1 and the ragged tail are written into a
//      shared buffer of the tile's words (each exactly once);
//   4. the tile's contiguous word range goes to global memory with
//      coalesced stores.
// Words past each stream's end are zeroed by the kernel.
//
// What bounds it on this card: bytes (16 bytes read per quad, each output
// word written once). One CTA per stream suits the many short streams of
// small-stream containers (311-622 CTAs); a few long streams run on few
// SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 4096;  // quads per tile (GQ_MIN of the TPU kernel)
constexpr int kThreads = 1024;
constexpr int kPer = kTile / kThreads;  // quads per thread
constexpr int kMinQ = 16;               // lion's 16-quad blocks
constexpr int kMaxBlocks = kTile / kMinQ;
constexpr int kMaxSig = 4;
// every token plain, a signature per block, two ragged halfwords
constexpr int kBufWords = 2 * kTile + kMaxBlocks * kMaxSig + 2;

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive scan of one value per thread over the whole CTA (kThreads
// threads); `total` receives the sum. All threads must call it.
__device__ int cta_excl_scan(int v, int* warp_sh, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int incl = warp_incl_scan(v, lane);
  if (lane == 31) warp_sh[wid] = incl;
  __syncthreads();
  if (wid == 0) warp_sh[lane] = warp_incl_scan(warp_sh[lane], lane);
  __syncthreads();
  const int excl = (wid > 0 ? warp_sh[wid - 1] : 0) + incl - v;
  *total = warp_sh[(kThreads >> 5) - 1];
  __syncthreads();  // warp_sh is reused by the next scan
  return excl;
}

__global__ void __launch_bounds__(kThreads)
    pack_kernel(const int32_t* flags, const int32_t* pw, const int32_t* w0,
                const int32_t* w1, const int32_t* nbytes, int32_t* out, int N,
                int q, int sig_words, int flag_bits, int block, int ow) {
  __shared__ uint16_t buf[kBufWords];
  __shared__ uint8_t fl[kTile];
  __shared__ int bstart[kMaxBlocks + 1];  // pw prefix at each block start
  __shared__ int boff[kMaxBlocks];        // block word offsets in the tile
  __shared__ int warp_sh[32];
  const int t = threadIdx.x;
  const int64_t row = (int64_t)blockIdx.x * N;
  int32_t* orow = out + (int64_t)blockIdx.x * ow;
  const int nb = nbytes[blockIdx.x];
  const int nbr = (nb + block - 1) / block;  // real blocks
  const int ragged = nb & 3;
  const int rag_hw = (ragged + 1) >> 1;
  const int nbt = kTile / q;  // blocks per tile
  const int fmask = (1 << flag_bits) - 1;
  int base = 0;  // words of the stream written so far
  for (int tile = 0; tile * kTile < N && tile * nbt < nbr; ++tile) {
    const int64_t q0 = row + (int64_t)tile * kTile;
    const int b0 = tile * nbt;
    // 1. payload words, scanned over the tile
    int p[kPer];
    int mysum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = t * kPer + k;
      p[k] = pw[q0 + i];
      mysum += p[k];
      fl[i] = (uint8_t)(flags[q0 + i] & fmask);
    }
    int pay_tile;
    int excl = cta_excl_scan(mysum, warp_sh, &pay_tile);
    if ((t * kPer) % q == 0) bstart[(t * kPer) / q] = excl;
    if (t == 0) bstart[nbt] = pay_tile;
    __syncthreads();
    // 2. block word counts and offsets
    int bw = 0;
    if (t < nbt && b0 + t < nbr)
      bw = sig_words + bstart[t + 1] - bstart[t] +
           (b0 + t == nbr - 1 ? rag_hw : 0);
    int tile_words;
    const int bexcl = cta_excl_scan(bw, warp_sh, &tile_words);
    if (t < nbt) boff[t] = bexcl;
    __syncthreads();
    // 3. the tile's words in shared memory
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = t * kPer + k;
      const int b = i / q;
      const int d = boff[b] + sig_words + excl - bstart[b];
      if (b0 + b < nbr && p[k] >= 1 && d < kBufWords) {
        buf[d] = (uint16_t)w0[q0 + i];
        if (p[k] == 2 && d + 1 < kBufWords) buf[d + 1] = (uint16_t)w1[q0 + i];
      }
      excl += p[k];
    }
    for (int x = t; x < nbt * sig_words; x += kThreads) {
      const int b = x / sig_words, w = x - b * sig_words;
      if (b0 + b >= nbr) continue;
      unsigned v = 0;  // bits [16w, 16w + 16) of the block's signature
      for (int bit = 0; bit < 16; ++bit) {
        const int g = 16 * w + bit;
        const int i = g / flag_bits;
        if (i < q) v |= (unsigned)((fl[b * q + i] >> (g - i * flag_bits)) & 1)
                        << bit;
      }
      buf[boff[b] + w] = (uint16_t)v;
    }
    const int lb = nbr - 1 - b0;  // the last real block, if in this tile
    if (t == 0 && ragged && lb >= 0 && lb < nbt) {
      const int d = boff[lb] + sig_words + bstart[lb + 1] - bstart[lb];
      const int fq = nb / 4 < N - 1 ? nb / 4 : N - 1;
      if (d < kBufWords) buf[d] = (uint16_t)w0[row + fq];
      if (ragged > 2 && d + 1 < kBufWords) buf[d + 1] = (uint16_t)w1[row + fq];
    }
    __syncthreads();
    // 4. coalesced store of the tile's word range
    const int n_words = tile_words < kBufWords ? tile_words : kBufWords;
    for (int x = t; x < n_words; x += kThreads)
      if (base + x < ow) orow[base + x] = buf[x];
    base += tile_words;
    __syncthreads();  // buf is reused by the next tile
  }
  for (int x = base + t; x < ow; x += kThreads) orow[x] = 0;
}

}  // namespace

// flags, pw, w0, w1: (S, N) int32; nbytes: (S,) int32; out: (S, ow) int32.
// Returns the CUDA error code of the launch.
extern "C" int pack(const void* flags, const void* pw, const void* w0,
                    const void* w1, const void* nbytes, void* out, int S,
                    int N, int q, int sig_words, int flag_bits, int block,
                    int ow, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % kTile != 0 || q < kMinQ || kTile % q != 0 || q % kPer != 0 ||
      sig_words < 1 || sig_words > kMaxSig || flag_bits < 1 ||
      flag_bits > 3 || q * flag_bits > 16 * sig_words || S < 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  pack_kernel<<<S, kThreads, 0, st>>>(
      static_cast<const int32_t*>(flags), static_cast<const int32_t*>(pw),
      static_cast<const int32_t*>(w0), static_cast<const int32_t*>(w1),
      static_cast<const int32_t*>(nbytes), static_cast<int32_t*>(out), N, q,
      sig_words, flag_bits, block, ow);
  return (int)cudaGetLastError();
}
