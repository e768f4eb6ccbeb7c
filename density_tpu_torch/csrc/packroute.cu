// Encode assembly: per-quad tokens -> block streams on a u16 lattice
// (Hopper, sm_90a).
//
// Replaces the TPU kernel density_tpu/kernels/packroute.py::pack (the
// Pallas routing-network pack, with the sig_pack and prefix sums that
// ran in XLA around it). Same contract: for each of S streams, blocks of
// q quads become [signature words][w0 (w1) per token] at the block's
// word offset, padding blocks (index >= ceil(nbytes / block)) add
// nothing, and the 1-3 ragged tail bytes, which the caller stamped into
// w0/w1 at the partial quad, land at Wtot and Wtot + 1.
//
// What bounds it on this card: bytes. Every input quad is read once
// (flags, pw, w0, w1: 16 bytes) and every output word written once. The
// TPU needed monotone shift-routing networks to place tokens without a
// scatter; on the GPU each token computes its destination and stores
// directly:
//   1. blk_sum:   one warp per block sums its payload words;
//   2. row_scan:  one CTA per stream scans the block word counts into
//                 block offsets and the stream's word total;
//   3. place:     one warp per block packs the signature (flag_bits per
//                 quad, LSB-first), scans the payload words inside the
//                 block and stores signature, w0 and w1;
//   4. ragged:    one thread per stream stamps the tail words.
// The output is zeroed first (cudaMemsetAsync), so words past the end
// of a stream read 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__global__ void blk_sum(const int32_t* pw, int32_t* blk_pay,
                        int64_t n_blocks, int q) {
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_blocks) return;  // whole warps exit together
  const int32_t* p = pw + w * q;
  int s = 0;
  for (int i = lane; i < q; i += 32) s += p[i];
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if (lane == 0) blk_pay[w] = s;
}

// One CTA (1024 threads) per stream: exclusive scan of the block word
// counts (sig_words + payload for real blocks, 0 for padding blocks).
__global__ void row_scan(const int32_t* blk_pay, const int32_t* nbytes,
                         int32_t* blk_off, int32_t* wtot, int nb,
                         int sig_words, int block) {
  __shared__ int warp_tot[32];
  __shared__ int carry_sh;
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nbr = (nbytes[s] + block - 1) / block;
  const int32_t* pay = blk_pay + (int64_t)s * nb;
  int32_t* off = blk_off + (int64_t)s * nb;
  if (threadIdx.x == 0) carry_sh = 0;
  int pay_all = 0;  // payload words of every block, real or not
  for (int c0 = 0; c0 < nb; c0 += blockDim.x) {
    __syncthreads();  // carry_sh from the previous chunk is visible
    const int carry = carry_sh;
    const int b = c0 + threadIdx.x;
    const int p = b < nb ? pay[b] : 0;
    pay_all += p;
    const int v = (b < nb && b < nbr) ? p + sig_words : 0;
    const int incl = warp_incl_scan(v, lane);
    if (lane == 31) warp_tot[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      const int nw = blockDim.x >> 5;
      int t = lane < nw ? warp_tot[lane] : 0;
      t = warp_incl_scan(t, lane);
      if (lane < nw) warp_tot[lane] = t;
    }
    __syncthreads();
    const int before = (wid > 0 ? warp_tot[wid - 1] : 0) + incl - v;
    if (b < nb) off[b] = carry + before;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1)
      carry_sh = carry + warp_tot[(blockDim.x >> 5) - 1];
  }
  // stream total in words: all payload words + one signature per real
  // block (the ragged tail goes after it)
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) pay_all += __shfl_xor_sync(kFull, pay_all, o);
  __shared__ int pay_sh;
  if (threadIdx.x == 0) pay_sh = 0;
  __syncthreads();
  if (lane == 0) atomicAdd(&pay_sh, pay_all);
  __syncthreads();
  if (threadIdx.x == 0) wtot[s] = pay_sh + nbr * sig_words;
}

// One warp per block: signature + payload placement. Each lane owns
// `per` consecutive quads (per = ceil(q / 32)).
__global__ void place(const int32_t* flags, const int32_t* pw,
                      const int32_t* w0, const int32_t* w1,
                      const int32_t* nbytes, const int32_t* blk_off,
                      int32_t* out, int64_t n_blocks, int nb, int q,
                      int sig_words, int flag_bits, int block, int ow) {
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_blocks) return;
  const int64_t s = w / nb;
  const int b = (int)(w % nb);
  const int per = (q + 31) >> 5;
  const int64_t q0 = w * q;  // flat index of the block's first quad
  const int nbr = (nbytes[s] + block - 1) / block;
  int32_t* orow = out + s * (int64_t)ow;
  const int base = blk_off[w];

  // signature: quad i's flag at bits [i*flag_bits, (i+1)*flag_bits)
  unsigned long long sig = 0;
  int mysum = 0;
  for (int t = 0; t < per; ++t) {
    const int i = lane * per + t;
    if (i < q) {
      sig |= (unsigned long long)(flags[q0 + i] & ((1 << flag_bits) - 1))
             << (i * flag_bits);
      mysum += pw[q0 + i];
    }
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    unsigned lo = __shfl_xor_sync(kFull, (unsigned)sig, o);
    unsigned hi = __shfl_xor_sync(kFull, (unsigned)(sig >> 32), o);
    sig |= ((unsigned long long)hi << 32) | lo;
  }
  if (b < nbr && lane < sig_words) {
    const int d = base + lane;
    if (d < ow) orow[d] = (int32_t)((sig >> (16 * lane)) & 0xFFFF);
  }

  // payload: exclusive prefix of pw inside the block
  int intra = warp_incl_scan(mysum, lane) - mysum;
  for (int t = 0; t < per; ++t) {
    const int i = lane * per + t;
    if (i >= q) break;
    const int p = pw[q0 + i];
    const int d = base + sig_words + intra;
    if (p >= 1 && d >= 0 && d < ow) orow[d] = w0[q0 + i] & 0xFFFF;
    if (p == 2 && d + 1 < ow) orow[d + 1] = w1[q0 + i] & 0xFFFF;
    intra += p;
  }
}

__global__ void ragged(const int32_t* w0, const int32_t* w1,
                       const int32_t* nbytes, const int32_t* wtot,
                       int32_t* out, int S, int N, int ow) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int rag = nbytes[s] % 4;
  const int fq = nbytes[s] / 4 < N - 1 ? nbytes[s] / 4 : N - 1;
  const int64_t src = (int64_t)s * N + fq;
  const int t = wtot[s];
  int32_t* orow = out + (int64_t)s * ow;
  if (rag > 0 && t >= 0 && t < ow) orow[t] = w0[src] & 0xFFFF;
  if (rag > 2 && t + 1 >= 0 && t + 1 < ow) orow[t + 1] = w1[src] & 0xFFFF;
}

}  // namespace

// flags, pw, w0, w1: (S, N) int32; nbytes: (S,) int32; out: (S, ow)
// int32; scratch: 2 * S * (N / q) + S int32. Returns the CUDA error.
extern "C" int packroute(const void* flags, const void* pw, const void* w0,
                         const void* w1, const void* nbytes, void* out,
                         void* scratch, int S, int N, int q, int sig_words,
                         int flag_bits, int block, int ow, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q < 1 || N % q != 0 || q * flag_bits > 64 || sig_words > 4 ||
      sig_words < 1)
    return (int)cudaErrorInvalidValue;
  const int nb = N / q;
  const int64_t n_blocks = (int64_t)S * nb;
  int32_t* blk_pay = static_cast<int32_t*>(scratch);
  int32_t* blk_off = blk_pay + n_blocks;
  int32_t* wtot = blk_off + n_blocks;
  const int32_t* nb_p = static_cast<const int32_t*>(nbytes);
  cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)S * ow, st);
  const int threads = 256;
  const int grid = (int)((n_blocks * 32 + threads - 1) / threads);
  blk_sum<<<grid, threads, 0, st>>>(static_cast<const int32_t*>(pw), blk_pay,
                                    n_blocks, q);
  row_scan<<<S, 1024, 0, st>>>(blk_pay, nb_p, blk_off, wtot, nb, sig_words,
                               block);
  place<<<grid, threads, 0, st>>>(
      static_cast<const int32_t*>(flags), static_cast<const int32_t*>(pw),
      static_cast<const int32_t*>(w0), static_cast<const int32_t*>(w1), nb_p,
      blk_off, static_cast<int32_t*>(out), n_blocks, nb, q, sig_words,
      flag_bits, block, ow);
  ragged<<<(S + 127) / 128, 128, 0, st>>>(
      static_cast<const int32_t*>(w0), static_cast<const int32_t*>(w1), nb_p,
      wtot, static_cast<int32_t*>(out), S, N, ow);
  return (int)cudaGetLastError();
}
