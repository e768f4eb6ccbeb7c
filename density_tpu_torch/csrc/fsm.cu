// One pass of the fixed point over the copy-block set: the blowup-
// protection FSM's copy decisions for a batch of streams (Hopper,
// sm_90a).
//
// Replaces no Pallas kernel: the JAX package replays the FSM with
// jax.lax.scan (density_tpu/engine/protection.py:32, `replay_fsm`),
// vmapped over streams. Same machine as the port's plain version
// (density_tpu_torch/engine/protection.py::replay_fsm, from the
// reference's protection_state.rs:9-47), a stream at a time:
//   * every block ticks the counter; on every 16th tick (block index
//     i & 15 == 0) copy_penalty_start halves, with a floor of 1;
//   * while a penalty is armed the block is a copy and the penalty
//     decays; when it reaches 0, copy_penalty_start grows by 1;
//   * otherwise the block's incompressible bit updates `prev`, and two
//     incompressible blocks in a row arm the penalty at
//     copy_penalty_start.
// Blocks at or past ceil(nbytes / block) are never copies.
//
// What bounds it: the chain. A block's decision depends on every block
// before it in its stream, so a stream is walked in order; the streams
// are independent and few (38 and a tail in a bulk call). So:
//   * one CTA takes the whole batch, a warp a stream in turn (up to 32
//     warps), and reduces "changed" and "any" with __syncthreads_or:
//     one launch, no memset, no atomics;
//   * a warp takes 1024 blocks of its stream at a time, a word of 32
//     blocks a lane: each lane loads its 32 bytes of bits (and of the
//     last pass's copy set) as two 16-byte loads and folds them into a
//     register word;
//   * the warp walks the words in order, every lane alike, the FSM state
//     in registers. A word is walked by events, not by blocks: from a
//     block with no penalty the next trigger is the lowest set bit of
//     bits & (bits << 1 | prev), and a penalty covers the next
//     `penalty` blocks at once, so a word of compressible blocks is one
//     step and a word of copies a few;
//   * lane k keeps the copy word of word k, masks it to real blocks,
//     writes its 32 bytes and compares them with the last pass's.
// The input is read once and the copy set written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int kChunk = 32 * 32;  // blocks a warp takes at once

struct Fsm {
  int penalty;
  int start;  // copy_penalty_start
  int prev;   // the last encoded block's bit
};

// copy_penalty_start after the 16th ticks among the blocks [lo, hi) of a
// word (offsets 0 and 16: words start at multiples of 32).
__device__ __forceinline__ int halved(int start, int lo, int hi) {
  const int k = (lo == 0 && hi > 0) + (lo <= 16 && hi > 16);
  return max(start >> k, 1);
}

// Walks the 32 blocks of one word (bit j: block j's incompressible bit)
// and returns their copy decisions.
__device__ __forceinline__ unsigned walk(Fsm& f, unsigned bits) {
  unsigned copy = 0;
  int pos = 0;
  while (pos < 32) {
    if (f.penalty > 0) {  // copies: decay() at each
      const int n = min(f.penalty, 32 - pos);
      f.start = halved(f.start, pos, pos + n);
      copy |= (n == 32 ? kFull : (1u << n) - 1u) << pos;
      f.penalty -= n;
      if (f.penalty == 0) f.start += 1;
      pos += n;
    } else {  // encoded blocks: update(bit) at each, up to a trigger
      const unsigned at = 1u << pos;
      const unsigned pair = ((bits << 1) & ~at) | (f.prev ? at : 0u);
      const unsigned t = bits & pair & (kFull << pos);
      if (t == 0) {
        f.start = halved(f.start, pos, 32);
        f.prev = bits >> 31;
        pos = 32;
      } else {
        const int j = __ffs(t) - 1;
        f.start = halved(f.start, pos, j + 1);
        f.penalty = f.start;
        f.prev = 1;
        pos = j + 1;
      }
    }
  }
  return copy;
}

// 4 bytes (byte j: block j, any nonzero byte set) -> 4 bits.
__device__ __forceinline__ unsigned fold4(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// 4 bits -> 4 bytes of 0 or 1.
__device__ __forceinline__ unsigned spread4(unsigned n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// 32 bytes at a 16-byte aligned p -> a word.
__device__ __forceinline__ unsigned load_word(const uint8_t* p) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  return fold4(a.x) | fold4(a.y) << 4 | fold4(a.z) << 8 | fold4(a.w) << 12 |
         fold4(b.x) << 16 | fold4(b.y) << 20 | fold4(b.z) << 24 |
         fold4(b.w) << 28;
}

__device__ __forceinline__ void store_word(uint8_t* p, unsigned w) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(spread4(w & 15), spread4(w >> 4 & 15),
                    spread4(w >> 8 & 15), spread4(w >> 12 & 15));
  q[1] = make_uint4(spread4(w >> 16 & 15), spread4(w >> 20 & 15),
                    spread4(w >> 24 & 15), spread4(w >> 28));
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    fsm_kernel(const uint8_t* __restrict__ bits,
               const int32_t* __restrict__ nbytes,
               const uint8_t* __restrict__ prev_copy,
               uint8_t* __restrict__ copy, int32_t* __restrict__ flags,
               int S, int nb, int block) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  unsigned changed = 0, any = 0;
  for (int s = threadIdx.x >> 5; s < S; s += warps) {
    const int64_t nbr64 = ((int64_t)nbytes[s] + block - 1) / block;
    const int nbr = nbr64 < 0 ? 0 : nbr64 > nb ? nb : (int)nbr64;
    const int64_t row = (int64_t)s * nb;
    Fsm f{0, 1, 0};
    for (int c = 0; c < nb; c += kChunk) {
      const int b0 = c + 32 * lane;  // this lane's word's first block
      const bool mine = b0 < nb;
      const unsigned word = mine ? load_word(bits + row + b0) : 0u;
      const unsigned last = mine ? load_word(prev_copy + row + b0) : 0u;
      // the words holding real blocks, walked in order in every lane
      const int words = min(32, (nbr - c + 31) / 32);
      unsigned out = 0;
      for (int k = 0; k < words; ++k) {
        const unsigned cw = walk(f, __shfl_sync(kFull, word, k));
        if (lane == k) out = cw;
      }
      const int real = nbr - b0;
      out &= real >= 32 ? kFull : real > 0 ? (1u << real) - 1u : 0u;
      if (mine) store_word(copy + row + b0, out);
      changed |= out ^ last;
      any |= out;
    }
  }
  const int c = __syncthreads_or(changed != 0);
  const int a = __syncthreads_or(any != 0);
  if (threadIdx.x == 0) {
    flags[0] = c;
    flags[1] = a;
  }
}

}  // namespace

// bits, prev_copy: (S, nb) bytes of 0 or 1, copy: (S, nb) bytes out, all
// 16-byte aligned, nb a multiple of 32; nbytes: (S,) int32; flags: 2
// int32 out, (changed, any): whether copy differs from prev_copy
// anywhere, and whether any block is a copy. One launch on `stream`.
// Returns the CUDA error code.
extern "C" int fsm_step(const void* bits, const void* nbytes,
                        const void* prev_copy, void* copy, void* flags,
                        int S, int nb, int block, void* stream) {
  if (S < 1 || nb < 0 || nb % 32 != 0 || block < 1)
    return (int)cudaErrorInvalidValue;
  const int warps = S < kMaxWarps ? S : kMaxWarps;
  fsm_kernel<<<1, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const int32_t*>(nbytes),
      static_cast<const uint8_t*>(prev_copy), static_cast<uint8_t*>(copy),
      static_cast<int32_t*>(flags), S, nb, block);
  return (int)cudaGetLastError();
}
