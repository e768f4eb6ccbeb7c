// Native host runtime of density_tpu_torch: the port's own copy of the
// JAX package's `density_tpu/native/libdensity.cpp`. Its code is that
// file's, unchanged; only comments differ.
//
// Clean-room C++ implementation of the three density block formats
// (reference: src/codec/codec.rs:34-126, src/codec/protection_state.rs:9-47,
// src/algorithms/*/).
//
// Roles in the port:
//   1. density-compatible C ABI ({chameleon,cheetah,lion}_{encode,decode,
//      safe_encode_buffer_size}) (reference: chameleon.rs:70-84,
//      cheetah.rs:105-118, lion.rs:193-206).
//   2. Stream scanner: per-block offsets and copy flags of a compressed
//      stream, so the device decode can run over all blocks at once (the
//      serial block-boundary chain is inherent to the headerless format).
//   3. Thread pool over independent streams (dtpu_{encode,decode,scan}_many):
//      the host decode route, and the exact fallback for streams whose
//      device fixed point does not converge.
//
// Build: density_tpu_torch/native/build.py (g++ -O3 -shared -fPIC -pthread).

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <atomic>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kHashMul = 0x9D6EF916u;
constexpr int kHashBits = 16;

inline uint16_t hash16(uint32_t quad) {
  return static_cast<uint16_t>((quad * kHashMul) >> (32 - kHashBits));
}

// The wire format is explicitly little-endian; this runtime relies on
// host-LE memcpy loads/stores. Refuse to build elsewhere (the
// reference proves BE portability with byte-shuffling loads; here the
// guard keeps silent corruption impossible on s390x-style hosts).
#if defined(__BYTE_ORDER__) && (__BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__)
#error "libdensity.cpp assumes a little-endian host"
#endif

inline uint32_t load_u32le(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint16_t load_u16le(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
inline void store_u32le(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
inline void store_u16le(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
inline void store_u64le(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }

// Blowup-protection FSM (reference: protection_state.rs:9-47).
struct Protection {
  uint8_t copy_penalty = 0;
  uint8_t copy_penalty_start = 1;
  bool previous_incompressible = false;
  uint64_t counter = 0;

  bool revert_to_copy() {
    if ((counter & 0xF) == 0 && copy_penalty_start > 1) copy_penalty_start >>= 1;
    counter++;
    return copy_penalty > 0;
  }
  void decay() {
    if (--copy_penalty == 0) copy_penalty_start++;
  }
  void update(bool incompressible) {
    if (incompressible) {
      if (previous_incompressible) copy_penalty = copy_penalty_start;
      previous_incompressible = true;
    } else {
      previous_incompressible = false;
    }
  }
};

// ---------------------------------------------------------------------------
// Chameleon: 1-bit flags, 64-bit signature, 256-byte blocks
// (reference: chameleon.rs:34-151)
// ---------------------------------------------------------------------------

struct Chameleon {
  static constexpr size_t kBlock = 256;
  static constexpr size_t kSigBytes = 8;
  std::vector<uint32_t> dict;
  Chameleon() : dict(1u << kHashBits, 0) {}

  void reset() { std::fill(dict.begin(), dict.end(), 0); }
  size_t encode(const uint8_t* in, size_t in_size, uint8_t* out, size_t out_cap);
  size_t decode(const uint8_t* in, size_t in_size, uint8_t* out, size_t out_cap);
  inline uint32_t step_flag(uint64_t flag, const uint8_t* in, size_t& ip);
  size_t decode_tail(const uint8_t* in, size_t in_size, size_t& ip,
                     uint8_t* out, size_t out_cap, size_t op,
                     Protection& prot);
  // Streaming variants: dictionary state lives in the struct (instance
  // reuse, reference codec.rs:16); the protection FSM is caller-owned
  // so it survives across chunks. decode_p consumes only provably
  // complete blocks unless final_chunk.
  size_t encode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                  size_t out_cap, Protection& prot);
  size_t decode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                  size_t out_cap, Protection& prot, bool final_chunk,
                  size_t* consumed);
};

size_t Chameleon::encode(const uint8_t* in, size_t in_size, uint8_t* out,
                         size_t out_cap) {
  Protection prot;
  return encode_p(in, in_size, out, out_cap, prot);
}

size_t Chameleon::decode(const uint8_t* in, size_t in_size, uint8_t* out,
                         size_t out_cap) {
  Protection prot;
  size_t consumed = 0;
  return decode_p(in, in_size, out, out_cap, prot, true, &consumed);
}

size_t Chameleon::encode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                           size_t out_cap, Protection& prot) {
  size_t op = 0;
  for (size_t bs = 0; bs < in_size; bs += kBlock) {
    size_t blen = in_size - bs < kBlock ? in_size - bs : kBlock;
    const uint8_t* block = in + bs;
    if (prot.revert_to_copy()) {
      if (op + blen > out_cap) return 0;
      std::memcpy(out + op, block, blen);
      op += blen;
      prot.decay();
      continue;
    }
    size_t mark = op;
    size_t sig_pos = op;
    uint64_t sig = 0;
    int shift = 0;
    op += kSigBytes;
    if (op > out_cap) return 0;
    size_t full = blen / 4;
    if (op + blen + kSigBytes > out_cap) return 0;  // worst case for block
    for (size_t q = 0; q < full; q++) {
      uint32_t quad = load_u32le(block + 4 * q);
      uint16_t h = hash16(quad);
      uint32_t& slot = dict[h];
      if (slot != quad) {
        // plain flag = 0 (no bit set)
        store_u32le(out + op, quad);
        op += 4;
        slot = quad;
      } else {
        sig |= 1ull << shift;
        store_u16le(out + op, h);
        op += 2;
      }
      shift += 1;
    }
    size_t rem = blen - 4 * full;
    if (rem) {
      std::memcpy(out + op, block + 4 * full, rem);
      op += rem;
    }
    store_u64le(out + sig_pos, sig);
    prot.update(op - mark >= kBlock);
  }
  return op;
}

// One token of the chameleon decode chain (reference: chameleon.rs:105-135).
inline uint32_t Chameleon::step_flag(uint64_t flag, const uint8_t* in,
                                     size_t& ip) {
  if (flag == 0) {
    uint32_t quad = load_u32le(in + ip);
    ip += 4;
    dict[hash16(quad)] = quad;
    return quad;
  }
  uint16_t h = load_u16le(in + ip);
  ip += 2;
  return dict[h];
}

size_t Chameleon::decode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                           size_t out_cap, Protection& prot,
                           bool final_chunk, size_t* consumed) {
  size_t ip = 0, op = 0;
  auto plain = [&](size_t& ip) { return step_flag(0, in, ip); };
  auto mapped = [&](size_t& ip) { return step_flag(1, in, ip); };
  while (in_size - ip >= kSigBytes + kBlock) {
    if (prot.revert_to_copy()) {
      if (op + kBlock > out_cap) return 0;
      std::memcpy(out + op, in + ip, kBlock);
      ip += kBlock;
      op += kBlock;
      prot.decay();
      continue;
    }
    size_t mark = ip;
    uint64_t sig;
    std::memcpy(&sig, in + ip, 8);
    ip += 8;
    if (op + kBlock > out_cap) return 0;
    for (int u = 0; u < 64; u++) {
      uint32_t quad = (sig & 1) ? mapped(ip) : plain(ip);
      sig >>= 1;
      store_u32le(out + op, quad);
      op += 4;
    }
    prot.update(ip - mark >= kBlock);
  }
  *consumed = ip;
  if (!final_chunk) return op;  // tail only at end-of-stream
  size_t r = decode_tail(in, in_size, ip, out, out_cap, op, prot);
  if (r == static_cast<size_t>(-1)) return 0;
  *consumed = ip;
  return r;
}

// End-of-stream tail (reference codec.rs:98-126; strict
// `remaining > block_size` copy rule at codec.rs:104-110). Returns the
// final output size, or (size_t)-1 on output overflow.
size_t Chameleon::decode_tail(const uint8_t* in, size_t in_size,
                              size_t& ip, uint8_t* out, size_t out_cap,
                              size_t op, Protection& prot) {
  constexpr size_t kFail = static_cast<size_t>(-1);
  while (in_size - ip > 0) {
    if (prot.revert_to_copy()) {
      size_t rem = in_size - ip;
      if (rem > kBlock) {
        if (op + kBlock > out_cap) return kFail;
        std::memcpy(out + op, in + ip, kBlock);
        ip += kBlock;
        op += kBlock;
        prot.decay();
        continue;
      }
      if (op + rem > out_cap) return kFail;
      std::memcpy(out + op, in + ip, rem);
      ip += rem;
      return op + rem;
    }
    size_t mark = ip;
    if (in_size - ip < kSigBytes) return op;  // malformed; stop safely
    uint64_t sig;
    std::memcpy(&sig, in + ip, 8);
    ip += 8;
    for (int u = 0; u < 64; u++) {
      uint64_t flag = sig & 1;
      sig >>= 1;
      if (flag == 0) {
        size_t rem = in_size - ip;
        if (rem == 0) return op;
        if (rem <= 3) {
          if (op + rem > out_cap) return kFail;
          std::memcpy(out + op, in + ip, rem);
          ip += rem;
          return op + rem;
        }
      }
      if (op + 4 > out_cap) return kFail;
      uint32_t quad = step_flag(flag, in, ip);
      store_u32le(out + op, quad);
      op += 4;
    }
    prot.update(ip - mark >= kBlock);
  }
  return op;
}

// ---------------------------------------------------------------------------
// Cheetah: 2-bit flags, dual MRU dictionary + 1 prediction slot,
// 128-byte blocks (reference: cheetah.rs:42-203)
// ---------------------------------------------------------------------------

struct Cheetah {
  static constexpr size_t kBlock = 128;
  static constexpr size_t kSigBytes = 8;
  // chunk_a/chunk_b interleaved per hash: one cache line serves both
  // slots (mirrors the reference's ChunkData layout, cheetah.rs:36-39;
  // split arrays cost a second miss on every dictionary access).
  struct Chunk {
    uint32_t a, b;
  };
  std::vector<Chunk> chunk;
  std::vector<uint32_t> pred;
  uint16_t last_hash = 0;
  Cheetah()
      : chunk(1u << kHashBits, Chunk{0, 0}), pred(1u << kHashBits, 0) {}

  void reset() {
    std::fill(chunk.begin(), chunk.end(), Chunk{0, 0});
    std::fill(pred.begin(), pred.end(), 0);
    last_hash = 0;
  }
  size_t encode(const uint8_t* in, size_t in_size, uint8_t* out, size_t out_cap);
  size_t decode(const uint8_t* in, size_t in_size, uint8_t* out, size_t out_cap);
  size_t encode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                  size_t out_cap, Protection& prot);
  size_t decode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                  size_t out_cap, Protection& prot, bool final_chunk,
                  size_t* consumed);
  inline uint32_t step_flag(uint64_t flag, const uint8_t* in, size_t& ip);
  size_t decode_tail(const uint8_t* in, size_t in_size, size_t& ip,
                     uint8_t* out, size_t out_cap, size_t op,
                     Protection& prot);
};

size_t Cheetah::encode(const uint8_t* in, size_t in_size, uint8_t* out,
                       size_t out_cap) {
  Protection prot;
  return encode_p(in, in_size, out, out_cap, prot);
}

size_t Cheetah::decode(const uint8_t* in, size_t in_size, uint8_t* out,
                       size_t out_cap) {
  Protection prot;
  size_t consumed = 0;
  return decode_p(in, in_size, out, out_cap, prot, true, &consumed);
}

size_t Cheetah::encode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                         size_t out_cap, Protection& prot) {
  size_t op = 0;
  for (size_t bs = 0; bs < in_size; bs += kBlock) {
    size_t blen = in_size - bs < kBlock ? in_size - bs : kBlock;
    const uint8_t* block = in + bs;
    if (prot.revert_to_copy()) {
      if (op + blen > out_cap) return 0;
      std::memcpy(out + op, block, blen);
      op += blen;
      prot.decay();
      continue;
    }
    size_t mark = op;
    size_t sig_pos = op;
    uint64_t sig = 0;
    int shift = 0;
    op += kSigBytes;
    if (op + blen + kSigBytes > out_cap) return 0;
    size_t full = blen / 4;
    for (size_t q = 0; q < full; q++) {
      uint32_t quad = load_u32le(block + 4 * q);
      uint16_t h = hash16(quad);
      uint32_t& p = pred[last_hash];
      if (p != quad) {
        Chunk& c = chunk[h];
        if (c.a != quad) {
          if (c.b != quad) {
            // plain flag = 0
            store_u32le(out + op, quad);
            op += 4;
          } else {
            sig |= 2ull << shift;  // map B
            store_u16le(out + op, h);
            op += 2;
          }
          c.b = c.a;
          c.a = quad;
        } else {
          sig |= 1ull << shift;  // map A
          store_u16le(out + op, h);
          op += 2;
        }
        p = quad;
      } else {
        sig |= 3ull << shift;  // predicted
      }
      shift += 2;
      last_hash = h;
    }
    size_t rem = blen - 4 * full;
    if (rem) {
      std::memcpy(out + op, block + 4 * full, rem);
      op += rem;
    }
    store_u64le(out + sig_pos, sig);
    prot.update(op - mark >= kBlock);
  }
  return op;
}

// One token of the cheetah decode chain (reference: cheetah.rs:68-105).
inline uint32_t Cheetah::step_flag(uint64_t flag, const uint8_t* in,
                                   size_t& ip) {
  uint32_t quad;
  uint16_t h;
  switch (flag) {
    case 0: {
      quad = load_u32le(in + ip);
      ip += 4;
      h = hash16(quad);
      Chunk& c = chunk[h];
      c.b = c.a;
      c.a = quad;
      pred[last_hash] = quad;
      break;
    }
    case 1: {
      h = load_u16le(in + ip);
      ip += 2;
      quad = chunk[h].a;
      pred[last_hash] = quad;
      break;
    }
    case 2: {
      h = load_u16le(in + ip);
      ip += 2;
      Chunk& c = chunk[h];
      quad = c.b;
      c.b = c.a;
      c.a = quad;
      pred[last_hash] = quad;
      break;
    }
    default: {
      quad = pred[last_hash];
      h = hash16(quad);
      break;
    }
  }
  last_hash = h;
  return quad;
}

size_t Cheetah::decode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                         size_t out_cap, Protection& prot,
                         bool final_chunk, size_t* consumed) {
  size_t ip = 0, op = 0;
  auto step = [&](uint64_t flag, size_t& ip) -> uint32_t {
    return step_flag(flag, in, ip);
  };
  while (in_size - ip >= kSigBytes + kBlock) {
    if (prot.revert_to_copy()) {
      if (op + kBlock > out_cap) return 0;
      std::memcpy(out + op, in + ip, kBlock);
      ip += kBlock;
      op += kBlock;
      prot.decay();
      continue;
    }
    size_t mark = ip;
    uint64_t sig;
    std::memcpy(&sig, in + ip, 8);
    ip += 8;
    if (op + kBlock > out_cap) return 0;
    for (int u = 0; u < 32; u++) {
      uint32_t quad = step(sig & 3, ip);
      sig >>= 2;
      store_u32le(out + op, quad);
      op += 4;
    }
    prot.update(ip - mark >= kBlock);
  }
  *consumed = ip;
  if (!final_chunk) return op;  // tail only at end-of-stream
  size_t r = decode_tail(in, in_size, ip, out, out_cap, op, prot);
  if (r == static_cast<size_t>(-1)) return 0;
  *consumed = ip;
  return r;
}

// End-of-stream tail: the final (< sig + block) span, where the input
// may run out mid-block (reference codec.rs:98-126). Returns the final
// output size, or (size_t)-1 on output overflow.
size_t Cheetah::decode_tail(const uint8_t* in, size_t in_size, size_t& ip,
                            uint8_t* out, size_t out_cap, size_t op,
                            Protection& prot) {
  constexpr size_t kFail = static_cast<size_t>(-1);
  while (in_size - ip > 0) {
    if (prot.revert_to_copy()) {
      size_t rem = in_size - ip;
      if (rem > kBlock) {
        if (op + kBlock > out_cap) return kFail;
        std::memcpy(out + op, in + ip, kBlock);
        ip += kBlock;
        op += kBlock;
        prot.decay();
        continue;
      }
      if (op + rem > out_cap) return kFail;
      std::memcpy(out + op, in + ip, rem);
      ip += rem;
      return op + rem;
    }
    size_t mark = ip;
    if (in_size - ip < kSigBytes) return op;  // malformed; stop safely
    uint64_t sig;
    std::memcpy(&sig, in + ip, 8);
    ip += 8;
    for (int u = 0; u < 32; u++) {
      uint64_t flag = sig & 3;
      sig >>= 2;
      if (flag == 0) {
        size_t rem = in_size - ip;
        if (rem == 0) return op;
        if (rem <= 3) {
          if (op + rem > out_cap) return kFail;
          std::memcpy(out + op, in + ip, rem);
          ip += rem;
          return op + rem;
        }
      }
      if (op + 4 > out_cap) return kFail;
      uint32_t quad = step_flag(flag, in, ip);
      store_u32le(out + op, quad);
      op += 4;
    }
    prot.update(ip - mark >= kBlock);
  }
  return op;
}

// ---------------------------------------------------------------------------
// Lion: 3-bit flags, dual dictionary + 5-deep prediction queue,
// 6-byte signatures, 64-byte blocks (reference: lion.rs:59-352)
// ---------------------------------------------------------------------------

struct Lion {
  static constexpr size_t kBlock = 64;
  static constexpr size_t kSigBytes = 6;
  struct Pred {
    uint32_t a, b, c, d, e;
  };
  // interleaved dual dictionary (one cache line per hash; mirrors the
  // reference's ChunkData layout, lion.rs:36-39)
  struct Chunk {
    uint32_t a, b;
  };
  std::vector<Chunk> chunk;
  std::vector<Pred> pred;
  uint16_t last_hash = 0;
  Lion()
      : chunk(1u << kHashBits, Chunk{0, 0}),
        pred(1u << kHashBits, Pred{0, 0, 0, 0, 0}) {}

  static void shift5(Pred& p, uint32_t quad) {
    p.e = p.d;
    p.d = p.c;
    p.c = p.b;
    p.b = p.a;
    p.a = quad;
  }

  void reset() {
    std::fill(chunk.begin(), chunk.end(), Chunk{0, 0});
    std::fill(pred.begin(), pred.end(), Pred{0, 0, 0, 0, 0});
    last_hash = 0;
  }
  size_t encode(const uint8_t* in, size_t in_size, uint8_t* out, size_t out_cap);
  size_t decode(const uint8_t* in, size_t in_size, uint8_t* out, size_t out_cap);
  size_t encode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                  size_t out_cap, Protection& prot);
  size_t decode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                  size_t out_cap, Protection& prot, bool final_chunk,
                  size_t* consumed);
  inline uint32_t step_flag(uint64_t flag, const uint8_t* in, size_t& ip);
  size_t decode_tail(const uint8_t* in, size_t in_size, size_t& ip,
                     uint8_t* out, size_t out_cap, size_t op,
                     Protection& prot);
};

// 6-byte signature read (reference: lion.rs:339-351): an 8-byte load
// masked to 48 bits when enough input remains, else a padded copy.
inline uint64_t lion_read_sig(const uint8_t* in, size_t in_size,
                              size_t& ip) {
  if (in_size - ip <= 7) {
    uint8_t sb[8] = {0};
    size_t n = in_size - ip < 6 ? in_size - ip : 6;
    std::memcpy(sb, in + ip, n);
    ip += 6;
    uint64_t v;
    std::memcpy(&v, sb, 8);
    return v;
  }
  uint64_t v;
  std::memcpy(&v, in + ip, 8);
  ip += 6;
  return v & 0x0000FFFFFFFFFFFFull;
}

size_t Lion::encode(const uint8_t* in, size_t in_size, uint8_t* out,
                    size_t out_cap) {
  Protection prot;
  return encode_p(in, in_size, out, out_cap, prot);
}

size_t Lion::decode(const uint8_t* in, size_t in_size, uint8_t* out,
                    size_t out_cap) {
  Protection prot;
  size_t consumed = 0;
  return decode_p(in, in_size, out, out_cap, prot, true, &consumed);
}

size_t Lion::encode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                      size_t out_cap, Protection& prot) {
  size_t op = 0;
  for (size_t bs = 0; bs < in_size; bs += kBlock) {
    size_t blen = in_size - bs < kBlock ? in_size - bs : kBlock;
    const uint8_t* block = in + bs;
    if (prot.revert_to_copy()) {
      if (op + blen > out_cap) return 0;
      std::memcpy(out + op, block, blen);
      op += blen;
      prot.decay();
      continue;
    }
    size_t mark = op;
    size_t sig_pos = op;
    uint64_t sig = 0;
    int shift = 0;
    op += kSigBytes;
    if (op + blen + kSigBytes + 2 > out_cap) return 0;
    size_t full = blen / 4;
    for (size_t q = 0; q < full; q++) {
      uint32_t quad = load_u32le(block + 4 * q);
      uint16_t h = hash16(quad);
      Pred& p = pred[last_hash];
      if (p.a == quad) {
        sig |= 1ull << shift;  // predicted A
      } else if (p.b == quad) {
        sig |= 2ull << shift;
        p.b = p.a;
        p.a = quad;
      } else if (p.c == quad) {
        sig |= 3ull << shift;
        p.c = p.b;
        p.b = p.a;
        p.a = quad;
      } else if (p.d == quad) {
        sig |= 4ull << shift;
        p.d = p.c;
        p.c = p.b;
        p.b = p.a;
        p.a = quad;
      } else if (p.e == quad) {
        sig |= 5ull << shift;
        shift5(p, quad);
      } else {
        Chunk& c = chunk[h];
        if (c.a == quad) {
          sig |= 6ull << shift;  // map A
          store_u16le(out + op, h);
          op += 2;
          shift5(p, quad);
        } else if (c.b == quad) {
          sig |= 7ull << shift;  // map B
          store_u16le(out + op, h);
          op += 2;
          c.b = c.a;
          c.a = quad;
          shift5(p, quad);
        } else {
          // plain flag = 0
          store_u32le(out + op, quad);
          op += 4;
          c.b = c.a;
          c.a = quad;
          shift5(p, quad);
        }
      }
      shift += 3;
      last_hash = h;
    }
    size_t rem = blen - 4 * full;
    if (rem) {
      std::memcpy(out + op, block + 4 * full, rem);
      op += rem;
    }
    // write only 6 significant bytes (reference: lion.rs:334-336)
    uint8_t sb[8];
    store_u64le(sb, sig);
    std::memcpy(out + sig_pos, sb, 6);
    prot.update(op - mark >= kBlock);
  }
  return op;
}

// One token of the lion decode chain (reference: lion.rs:88-186).
inline uint32_t Lion::step_flag(uint64_t flag, const uint8_t* in,
                                size_t& ip) {
  uint32_t quad;
  uint16_t h;
  Pred& p = pred[last_hash];
  switch (flag) {
    case 0: {
      quad = load_u32le(in + ip);
      ip += 4;
      h = hash16(quad);
      Chunk& c = chunk[h];
      c.b = c.a;
      c.a = quad;
      shift5(p, quad);
      break;
    }
    case 6: {
      h = load_u16le(in + ip);
      ip += 2;
      quad = chunk[h].a;
      shift5(p, quad);
      break;
    }
    case 7: {
      h = load_u16le(in + ip);
      ip += 2;
      Chunk& c = chunk[h];
      quad = c.b;
      c.b = c.a;
      c.a = quad;
      shift5(p, quad);
      break;
    }
    case 1: {
      quad = p.a;
      h = hash16(quad);
      break;
    }
    case 2: {
      quad = p.b;
      h = hash16(quad);
      p.b = p.a;
      p.a = quad;
      break;
    }
    case 3: {
      quad = p.c;
      h = hash16(quad);
      p.c = p.b;
      p.b = p.a;
      p.a = quad;
      break;
    }
    case 4: {
      quad = p.d;
      h = hash16(quad);
      p.d = p.c;
      p.c = p.b;
      p.b = p.a;
      p.a = quad;
      break;
    }
    default: {
      quad = p.e;
      h = hash16(quad);
      shift5(p, quad);
      break;
    }
  }
  last_hash = h;
  return quad;
}

size_t Lion::decode_p(const uint8_t* in, size_t in_size, uint8_t* out,
                      size_t out_cap, Protection& prot,
                      bool final_chunk, size_t* consumed) {
  size_t ip = 0, op = 0;
  auto read_sig = [&](size_t& ip) -> uint64_t {
    return lion_read_sig(in, in_size, ip);
  };
  auto step = [&](uint64_t flag, size_t& ip) -> uint32_t {
    return step_flag(flag, in, ip);
  };
  while (in_size - ip >= kSigBytes + kBlock) {
    if (prot.revert_to_copy()) {
      if (op + kBlock > out_cap) return 0;
      std::memcpy(out + op, in + ip, kBlock);
      ip += kBlock;
      op += kBlock;
      prot.decay();
      continue;
    }
    size_t mark = ip;
    uint64_t sig = read_sig(ip);
    if (op + kBlock > out_cap) return 0;
    for (int u = 0; u < 16; u++) {
      uint32_t quad = step(sig & 7, ip);
      sig >>= 3;
      store_u32le(out + op, quad);
      op += 4;
    }
    prot.update(ip - mark >= kBlock);
  }
  *consumed = ip;
  if (!final_chunk) return op;  // tail only at end-of-stream
  size_t r = decode_tail(in, in_size, ip, out, out_cap, op, prot);
  if (r == static_cast<size_t>(-1)) return 0;
  *consumed = ip;
  return r;
}

// End-of-stream tail (mirrors Cheetah::decode_tail; 3-bit flags,
// 16-quad blocks). Returns final output size or (size_t)-1 on overflow.
size_t Lion::decode_tail(const uint8_t* in, size_t in_size, size_t& ip,
                         uint8_t* out, size_t out_cap, size_t op,
                         Protection& prot) {
  constexpr size_t kFail = static_cast<size_t>(-1);
  while (in_size - ip > 0) {
    if (prot.revert_to_copy()) {
      size_t rem = in_size - ip;
      if (rem > kBlock) {
        if (op + kBlock > out_cap) return kFail;
        std::memcpy(out + op, in + ip, kBlock);
        ip += kBlock;
        op += kBlock;
        prot.decay();
        continue;
      }
      if (op + rem > out_cap) return kFail;
      std::memcpy(out + op, in + ip, rem);
      ip += rem;
      return op + rem;
    }
    size_t mark = ip;
    if (in_size - ip < kSigBytes) return op;  // malformed; stop safely
    uint64_t sig = lion_read_sig(in, in_size, ip);
    for (int u = 0; u < 16; u++) {
      uint64_t flag = sig & 7;
      sig >>= 3;
      if (flag == 0) {
        size_t rem = in_size - ip;
        if (rem == 0) return op;
        if (rem <= 3) {
          if (op + rem > out_cap) return kFail;
          std::memcpy(out + op, in + ip, rem);
          ip += rem;
          return op + rem;
        }
      }
      if (op + 4 > out_cap) return kFail;
      uint32_t quad = step_flag(flag, in, ip);
      store_u32le(out + op, quad);
      op += 4;
    }
    prot.update(ip - mark >= kBlock);
  }
  return op;
}

// ---------------------------------------------------------------------------
// Stream scanner: walks the block-boundary chain of a compressed stream
// and emits per-block metadata so the device side can decode blocks in
// parallel. This is the host-side planning step of decode -- the
// serial chain is inherent to the headerless format (each block's size
// is only known from its signature, whose position depends on all prior
// blocks), so it runs here as a tight native loop.
//
// Outputs per block:
//   in_offset[b]   byte offset of block b in the compressed stream
//   out_offset[b]  byte offset of block b in the decoded stream
//   is_copy[b]     1 if the block is a verbatim copy (protection FSM)
// Returns number of blocks, or (size_t)-1 on malformed input.
// ---------------------------------------------------------------------------

template <typename CodecTraits>
static size_t scan_stream(const uint8_t* in, size_t in_size,
                          int64_t* in_offsets, int64_t* out_offsets,
                          uint8_t* is_copy, size_t max_blocks,
                          int64_t* pred_tokens = nullptr,
                          int64_t* total_tokens = nullptr) {
  constexpr size_t kBlock = CodecTraits::kBlock;
  constexpr size_t kSigBytes = CodecTraits::kSigBytes;
  constexpr int kFlagBits = CodecTraits::kFlagBits;
  constexpr int kQuads = kBlock / 4;
  int64_t n_pred = 0, n_tok = 0;
  Protection prot;
  size_t ip = 0, op = 0, nb = 0;
  while (in_size - ip > 0) {
    if (nb >= max_blocks) return static_cast<size_t>(-1);
    in_offsets[nb] = static_cast<int64_t>(ip);
    out_offsets[nb] = static_cast<int64_t>(op);
    if (prot.revert_to_copy()) {
      is_copy[nb++] = 1;
      size_t rem = in_size - ip;
      if (rem > kBlock) {
        ip += kBlock;
        op += kBlock;
        prot.decay();
        continue;
      }
      ip += rem;
      op += rem;
      break;
    }
    is_copy[nb++] = 0;
    size_t mark = ip;
    if (in_size - ip < kSigBytes) return static_cast<size_t>(-1);
    uint64_t sig;
    if (kSigBytes == 6) {
      if (in_size - ip <= 7) {
        uint8_t sb[8] = {0};
        std::memcpy(sb, in + ip, 6);
        std::memcpy(&sig, sb, 8);
      } else {
        std::memcpy(&sig, in + ip, 8);
        sig &= 0x0000FFFFFFFFFFFFull;
      }
      ip += 6;
    } else {
      std::memcpy(&sig, in + ip, 8);
      ip += 8;
    }
    bool ended = false;
    for (int q = 0; q < kQuads; q++) {
      uint64_t flag = sig & ((1u << kFlagBits) - 1);
      sig >>= kFlagBits;
      size_t tok = CodecTraits::payload_bytes(flag);
      n_tok++;
      if (tok == 0) n_pred++;
      if (tok == 4) {  // plain: check ragged tail semantics
        size_t rem = in_size - ip;
        if (rem == 0) {
          ended = true;
          break;
        }
        if (rem <= 3) {
          ip += rem;
          op += rem;
          ended = true;
          break;
        }
      } else if (tok == 2) {
        if (in_size - ip < 2) return static_cast<size_t>(-1);
      }
      ip += tok;
      op += 4;
      if (ip > in_size) return static_cast<size_t>(-1);
    }
    if (ended) break;
    prot.update(ip - mark >= kBlock);
  }
  if (pred_tokens) *pred_tokens = n_pred;
  if (total_tokens) *total_tokens = n_tok;
  return nb;
}

struct ChameleonTraits {
  static constexpr size_t kBlock = 256;
  static constexpr size_t kSigBytes = 8;
  static constexpr int kFlagBits = 1;
  static size_t payload_bytes(uint64_t flag) { return flag ? 2 : 4; }
};
struct CheetahTraits {
  static constexpr size_t kBlock = 128;
  static constexpr size_t kSigBytes = 8;
  static constexpr int kFlagBits = 2;
  static size_t payload_bytes(uint64_t flag) {
    switch (flag) {
      case 0: return 4;
      case 3: return 0;
      default: return 2;
    }
  }
};
struct LionTraits {
  static constexpr size_t kBlock = 64;
  static constexpr size_t kSigBytes = 6;
  static constexpr int kFlagBits = 3;
  static size_t payload_bytes(uint64_t flag) {
    if (flag == 0) return 4;
    if (flag >= 6) return 2;
    return 0;
  }
};

inline size_t safe_size(size_t size, size_t block, size_t sig_bytes) {
  // reference: codec.rs:18-21
  size_t blocks = size / block;
  return size + blocks * sig_bytes + (size % block ? sig_bytes : 0);
}

// ---------------------------------------------------------------------------
// Streaming / stateful session: the analogue of the reference's codec
// instance reuse (reference: codec.rs:16 clear_state, chameleon.rs:45-53
// construct-per-call statics). Dictionary state persists across chunks;
// the protection FSM is carried between calls; partial blocks are
// buffered internally so arbitrary chunk boundaries produce the exact
// bytes of a one-shot encode of the concatenated input.
// ---------------------------------------------------------------------------

struct DtpuStream {
  int codec;  // 0 chameleon / 1 cheetah / 2 lion
  Chameleon cham;
  Cheetah che;
  Lion li;
  Protection eprot, dprot;
  std::vector<uint8_t> ehold, dhold;
  // Set when a decode overflow may have advanced dictionary state
  // mid-call; every later call fails until reset() (a retry would
  // re-apply state transitions to the held bytes and corrupt output).
  bool poisoned = false;
  explicit DtpuStream(int c) : codec(c) {}
  size_t block() const { return codec == 0 ? 256 : codec == 1 ? 128 : 64; }
  size_t sig_bytes() const { return codec == 2 ? 6 : 8; }
  void reset() {
    cham.reset();
    che.reset();
    li.reset();
    eprot = Protection{};
    dprot = Protection{};
    ehold.clear();
    dhold.clear();
    poisoned = false;
  }
};

}  // namespace

extern "C" {

// --- density-compatible C ABI (reference: chameleon.rs:70-84 etc.) ---------

size_t chameleon_encode(const uint8_t* input, size_t input_size,
                        uint8_t* output, size_t output_size) {
  Chameleon c;
  return c.encode(input, input_size, output, output_size);
}
size_t chameleon_decode(const uint8_t* input, size_t input_size,
                        uint8_t* output, size_t output_size) {
  Chameleon c;
  return c.decode(input, input_size, output, output_size);
}
size_t chameleon_safe_encode_buffer_size(size_t size) {
  return safe_size(size, 256, 8);
}

size_t cheetah_encode(const uint8_t* input, size_t input_size, uint8_t* output,
                      size_t output_size) {
  Cheetah c;
  return c.encode(input, input_size, output, output_size);
}
size_t cheetah_decode(const uint8_t* input, size_t input_size, uint8_t* output,
                      size_t output_size) {
  Cheetah c;
  return c.decode(input, input_size, output, output_size);
}
size_t cheetah_safe_encode_buffer_size(size_t size) {
  return safe_size(size, 128, 8);
}

size_t lion_encode(const uint8_t* input, size_t input_size, uint8_t* output,
                   size_t output_size) {
  Lion l;
  return l.encode(input, input_size, output, output_size);
}
size_t lion_decode(const uint8_t* input, size_t input_size, uint8_t* output,
                   size_t output_size) {
  Lion l;
  return l.decode(input, input_size, output, output_size);
}
size_t lion_safe_encode_buffer_size(size_t size) {
  return safe_size(size, 64, 6);
}

// --- stream scanners (device-decode support) -------------------------------

size_t chameleon_scan(const uint8_t* in, size_t in_size, int64_t* in_offsets,
                      int64_t* out_offsets, uint8_t* is_copy,
                      size_t max_blocks) {
  return scan_stream<ChameleonTraits>(in, in_size, in_offsets, out_offsets,
                                      is_copy, max_blocks);
}
size_t cheetah_scan(const uint8_t* in, size_t in_size, int64_t* in_offsets,
                    int64_t* out_offsets, uint8_t* is_copy,
                    size_t max_blocks) {
  return scan_stream<CheetahTraits>(in, in_size, in_offsets, out_offsets,
                                    is_copy, max_blocks);
}
size_t lion_scan(const uint8_t* in, size_t in_size, int64_t* in_offsets,
                 int64_t* out_offsets, uint8_t* is_copy, size_t max_blocks) {
  return scan_stream<LionTraits>(in, in_size, in_offsets, out_offsets, is_copy,
                                 max_blocks);
}

// --- streaming / stateful sessions ------------------------------------------

void* dtpu_stream_new(int codec) {
  if (codec < 0 || codec > 2) return nullptr;
  return new DtpuStream(codec);
}

void dtpu_stream_free(void* sp) { delete static_cast<DtpuStream*>(sp); }

void dtpu_stream_reset(void* sp) { static_cast<DtpuStream*>(sp)->reset(); }

// Feed `n` input bytes; writes encoded bytes for every COMPLETE block
// (all buffered input when final_chunk). Returns bytes written, or
// (size_t)-1 if out_cap cannot hold the worst-case encoding of the
// pending blocks.  Capacity is validated BEFORE any codec state is
// touched, so -1 really does mean "nothing consumed, retry with a
// larger buffer" (the input bytes remain buffered either way).
size_t dtpu_stream_encode(void* sp, const uint8_t* in, size_t n,
                          uint8_t* out, size_t out_cap, int final_chunk) {
  auto* s = static_cast<DtpuStream*>(sp);
  if (s->poisoned) return static_cast<size_t>(-1);
  s->ehold.insert(s->ehold.end(), in, in + n);
  size_t avail = s->ehold.size();
  size_t take = final_chunk ? avail : avail / s->block() * s->block();
  if (take == 0) return 0;
  // worst-case bound includes the extra per-block signature slack the
  // encoder reserves mid-stream (encode_p checks op+blen+sig per block)
  if (safe_size(take, s->block(), s->sig_bytes()) + s->sig_bytes() >
      out_cap) {
    if (final_chunk) return static_cast<size_t>(-1);
    // encode as many whole blocks as provably fit; hold the rest
    size_t blk = s->block(), sig = s->sig_bytes();
    size_t fit = out_cap > sig ? (out_cap - sig) / (blk + sig) * blk : 0;
    take = fit < take ? fit : take;
    if (take == 0) return static_cast<size_t>(-1);
  }
  size_t w;
  switch (s->codec) {
    case 0: w = s->cham.encode_p(s->ehold.data(), take, out, out_cap,
                                 s->eprot); break;
    case 1: w = s->che.encode_p(s->ehold.data(), take, out, out_cap,
                                s->eprot); break;
    default: w = s->li.encode_p(s->ehold.data(), take, out, out_cap,
                                s->eprot); break;
  }
  if (w == 0) {  // unreachable given the pre-check; fail closed
    s->poisoned = true;
    return static_cast<size_t>(-1);
  }
  s->ehold.erase(s->ehold.begin(), s->ehold.begin() + take);
  return w;
}

// Feed `n` compressed bytes; writes decoded bytes for every block that
// is provably complete (the reference fast-loop criterion,
// codec.rs:88); the tail runs when final_chunk. Returns bytes written,
// or (size_t)-1 if out_cap is too small.
size_t dtpu_stream_decode(void* sp, const uint8_t* in, size_t n,
                          uint8_t* out, size_t out_cap, int final_chunk) {
  auto* s = static_cast<DtpuStream*>(sp);
  // A poisoned session's dictionary state already advanced past the
  // failed pass; re-running decode_p over the retained dhold would
  // resolve map tokens against doubly-applied state and emit silently
  // corrupt bytes.  Enforce the documented every-later-call-fails
  // contract (same as dtpu_stream_encode above) until reset().
  if (s->poisoned) return static_cast<size_t>(-1);
  s->dhold.insert(s->dhold.end(), in, in + n);
  if (s->dhold.empty()) return 0;
  size_t consumed = 0;
  size_t w;
  switch (s->codec) {
    case 0: w = s->cham.decode_p(s->dhold.data(), s->dhold.size(), out,
                                 out_cap, s->dprot, final_chunk,
                                 &consumed); break;
    case 1: w = s->che.decode_p(s->dhold.data(), s->dhold.size(), out,
                                out_cap, s->dprot, final_chunk,
                                &consumed); break;
    default: w = s->li.decode_p(s->dhold.data(), s->dhold.size(), out,
                                out_cap, s->dprot, final_chunk,
                                &consumed); break;
  }
  if (w == 0 && consumed == 0) {
    // Legitimate zero: not enough buffered input for one provably
    // complete block yet (decoder state untouched).
    size_t need = s->sig_bytes() + s->block();
    bool starved = !final_chunk && s->dhold.size() < need;
    if (!starved) {
      // Overflow (or malformed final tail): decode_p may already have
      // advanced dictionary state for earlier blocks, so a retry with
      // a larger buffer would double-apply state.  Poison the session
      // until reset().
      s->poisoned = true;
      return static_cast<size_t>(-1);
    }
  }
  s->dhold.erase(s->dhold.begin(), s->dhold.begin() + consumed);
  return w;
}

// Bytes currently buffered inside the session: which=0 -> encoder-side
// input hold, which=1 -> decoder-side compressed hold.  Exported so
// callers can size output buffers without re-deriving the retention
// bound from the decoder's internal fast-loop criterion.
size_t dtpu_stream_held(void* sp, int which) {
  auto* s = static_cast<DtpuStream*>(sp);
  return which == 0 ? s->ehold.size() : s->dhold.size();
}

// --- batched one-shot ops over independent streams (host runtime) ----------
// Streams are independent compression units (fresh state per stream,
// reference chameleon.rs:45-53), so batches parallelize across worker
// threads with no synchronization beyond a shared work counter.  This
// is the framework's host-side data-parallel executor -- the CPU
// mirror of the device's streams-axis sharding (SURVEY.md section 2b).

static void run_parallel(int64_t n, int n_threads,
                         void (*fn)(int64_t, void*), void* ctx) {
  if (n_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; i++) fn(i, ctx);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      fn(i, ctx);
    }
  };
  std::vector<std::thread> ts;
  int nt = n_threads < n ? n_threads : static_cast<int>(n);
  ts.reserve(nt - 1);
  for (int t = 1; t < nt; t++) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
}

struct ManyCtx {
  int codec;
  const uint8_t* blob;
  const int64_t* in_off;
  const int64_t* in_len;
  uint8_t* out;
  const int64_t* out_off;
  const int64_t* out_cap;
  int64_t* out_len;  // written: result sizes (or -1 on failure)
};

static void decode_one_idx(int64_t i, void* p) {
  auto* c = static_cast<ManyCtx*>(p);
  size_t w = 0;
  const uint8_t* in = c->blob + c->in_off[i];
  uint8_t* out = c->out + c->out_off[i];
  size_t cap = static_cast<size_t>(c->out_cap[i]);
  size_t n = static_cast<size_t>(c->in_len[i]);
  switch (c->codec) {
    case 0: { Chameleon x; w = x.decode(in, n, out, cap); break; }
    case 1: { Cheetah x; w = x.decode(in, n, out, cap); break; }
    default: { Lion x; w = x.decode(in, n, out, cap); break; }
  }
  c->out_len[i] = (w == 0 && n > 0) ? -1 : static_cast<int64_t>(w);
}

static void encode_one_idx(int64_t i, void* p) {
  auto* c = static_cast<ManyCtx*>(p);
  size_t w = 0;
  const uint8_t* in = c->blob + c->in_off[i];
  uint8_t* out = c->out + c->out_off[i];
  size_t cap = static_cast<size_t>(c->out_cap[i]);
  size_t n = static_cast<size_t>(c->in_len[i]);
  switch (c->codec) {
    case 0: { Chameleon x; w = x.encode(in, n, out, cap); break; }
    case 1: { Cheetah x; w = x.encode(in, n, out, cap); break; }
    default: { Lion x; w = x.encode(in, n, out, cap); break; }
  }
  c->out_len[i] = (w == 0 && n > 0) ? -1 : static_cast<int64_t>(w);
}

// Decode `n` independent streams in parallel. blob holds the
// concatenated compressed streams at in_off/in_len; results land at
// out + out_off[i] (caller-sized via out_cap); out_len[i] receives the
// decoded size or -1.  Returns the number of failed streams.
int64_t dtpu_decode_many(int codec, const uint8_t* blob,
                         const int64_t* in_off, const int64_t* in_len,
                         uint8_t* out, const int64_t* out_off,
                         const int64_t* out_cap, int64_t* out_len,
                         int64_t n, int n_threads) {
  ManyCtx c{codec, blob, in_off, in_len, out, out_off, out_cap, out_len};
  run_parallel(n, n_threads, decode_one_idx, &c);
  int64_t fails = 0;
  for (int64_t i = 0; i < n; i++) fails += out_len[i] < 0;
  return fails;
}

int64_t dtpu_encode_many(int codec, const uint8_t* blob,
                         const int64_t* in_off, const int64_t* in_len,
                         uint8_t* out, const int64_t* out_off,
                         const int64_t* out_cap, int64_t* out_len,
                         int64_t n, int n_threads) {
  ManyCtx c{codec, blob, in_off, in_len, out, out_off, out_cap, out_len};
  run_parallel(n, n_threads, encode_one_idx, &c);
  int64_t fails = 0;
  for (int64_t i = 0; i < n; i++) fails += out_len[i] < 0;
  return fails;
}

struct ScanManyCtx {
  int codec;
  const uint8_t* blob;
  const int64_t* in_off;
  const int64_t* in_len;
  int64_t* blk_in_off;   // (n, max_blocks) flattened
  int64_t* blk_out_off;
  uint8_t* blk_copy;
  int64_t* n_blocks;     // per stream, -1 on malformed
  int64_t* pred_tokens;  // per stream
  int64_t* total_tokens;
  int64_t max_blocks;
};

static void scan_one_idx(int64_t i, void* p) {
  auto* c = static_cast<ScanManyCtx*>(p);
  const uint8_t* in = c->blob + c->in_off[i];
  size_t n = static_cast<size_t>(c->in_len[i]);
  int64_t* io = c->blk_in_off + i * c->max_blocks;
  int64_t* oo = c->blk_out_off + i * c->max_blocks;
  uint8_t* cp = c->blk_copy + i * c->max_blocks;
  size_t nb;
  switch (c->codec) {
    case 0:
      nb = scan_stream<ChameleonTraits>(in, n, io, oo, cp, c->max_blocks,
                                        c->pred_tokens + i,
                                        c->total_tokens + i);
      break;
    case 1:
      nb = scan_stream<CheetahTraits>(in, n, io, oo, cp, c->max_blocks,
                                      c->pred_tokens + i,
                                      c->total_tokens + i);
      break;
    default:
      nb = scan_stream<LionTraits>(in, n, io, oo, cp, c->max_blocks,
                                   c->pred_tokens + i,
                                   c->total_tokens + i);
      break;
  }
  c->n_blocks[i] = nb == static_cast<size_t>(-1)
                       ? -1 : static_cast<int64_t>(nb);
}

// Scan `n` independent streams in parallel into flattened per-block
// metadata (row i at [i*max_blocks, ...)).  Returns #malformed.
int64_t dtpu_scan_many(int codec, const uint8_t* blob,
                       const int64_t* in_off, const int64_t* in_len,
                       int64_t* blk_in_off, int64_t* blk_out_off,
                       uint8_t* blk_copy, int64_t* n_blocks,
                       int64_t* pred_tokens, int64_t* total_tokens,
                       int64_t n, int64_t max_blocks, int n_threads) {
  ScanManyCtx c{codec, blob, in_off, in_len, blk_in_off, blk_out_off,
                blk_copy, n_blocks, pred_tokens, total_tokens,
                max_blocks};
  run_parallel(n, n_threads, scan_one_idx, &c);
  int64_t fails = 0;
  for (int64_t i = 0; i < n; i++) fails += n_blocks[i] < 0;
  return fails;
}

// --- vendored LZ4 block codec (bench pareto point) --------------------------
// Clean-room implementation of the public LZ4 block format
// (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md):
// sequences of [token | literal-length ext | literals | 2-byte LE
// offset | match-length ext], greedy matcher over a 2^16-entry
// position hash.  Exists so benches/competitors.py can print a real
// lz4 speed/ratio point next to the codecs (the reference benches
// lz4_flex, benches/lz4.rs:37-41); this is NOT part of the density
// format surface.

static inline uint32_t lz4_hash(uint32_t v) {
  return (v * 2654435761u) >> 16;  // Knuth multiplicative, 16-bit bucket
}

size_t dtpu_lz4_compress(const uint8_t* in, size_t n, uint8_t* out,
                         size_t cap) {
  if (n == 0 || cap < 16) return 0;
  std::vector<int64_t> htab(1u << 16, -1);
  size_t ip = 0, op = 0, anchor = 0;
  // matches must end >= 5 bytes before the end; stop searching there
  size_t mlimit = n > 12 ? n - 12 : 0;
  size_t searches = 0;  // skip-strength acceleration: after many
  //                       consecutive misses, step faster through
  //                       incompressible regions (standard LZ4 trick)
  while (ip < mlimit) {
    uint32_t v;
    std::memcpy(&v, in + ip, 4);
    uint32_t h = lz4_hash(v);
    int64_t cand = htab[h];
    htab[h] = static_cast<int64_t>(ip);
    uint32_t cv;
    if (cand < 0 || ip - static_cast<size_t>(cand) > 65535 ||
        (std::memcpy(&cv, in + cand, 4), cv != v)) {
      ip += 1 + (searches++ >> 6);
      continue;
    }
    searches = 0;
    // extend the match (bounded so the last 5 bytes stay literals)
    size_t m = ip + 4, c = static_cast<size_t>(cand) + 4;
    size_t mend = n - 5;
    while (m < mend && in[m] == in[c]) { m++; c++; }
    size_t lit = ip - anchor, mlen = m - ip;
    // emit token + literal run + offset + match-length extension
    size_t need = 1 + lit / 255 + 1 + lit + 2 + (mlen - 4) / 255 + 1;
    if (op + need + 16 > cap) return 0;
    size_t tok_pos = op++;
    size_t l = lit;
    uint8_t tok_l;
    if (l >= 15) {
      tok_l = 15;
      l -= 15;
      while (l >= 255) { out[op++] = 255; l -= 255; }
      out[op++] = static_cast<uint8_t>(l);
    } else {
      tok_l = static_cast<uint8_t>(l);
    }
    std::memcpy(out + op, in + anchor, lit);
    op += lit;
    uint16_t off = static_cast<uint16_t>(ip - static_cast<size_t>(cand));
    out[op++] = static_cast<uint8_t>(off & 0xFF);
    out[op++] = static_cast<uint8_t>(off >> 8);
    size_t ml = mlen - 4;
    uint8_t tok_m;
    if (ml >= 15) {
      tok_m = 15;
      ml -= 15;
      while (ml >= 255) { out[op++] = 255; ml -= 255; }
      out[op++] = static_cast<uint8_t>(ml);
    } else {
      tok_m = static_cast<uint8_t>(ml);
    }
    out[tok_pos] = static_cast<uint8_t>((tok_l << 4) | tok_m);
    // index interior positions sparsely to keep the matcher fast
    if (ip + 2 < mlimit) {
      uint32_t v2;
      std::memcpy(&v2, in + ip + 2, 4);
      htab[lz4_hash(v2)] = static_cast<int64_t>(ip + 2);
    }
    ip = m;
    anchor = m;
  }
  // final literal-only sequence
  size_t lit = n - anchor;
  size_t need = 1 + lit / 255 + 1 + lit;
  if (op + need > cap) return 0;
  size_t tok_pos = op++;
  size_t l = lit;
  if (l >= 15) {
    out[tok_pos] = 15u << 4;
    l -= 15;
    while (l >= 255) { out[op++] = 255; l -= 255; }
    out[op++] = static_cast<uint8_t>(l);
  } else {
    out[tok_pos] = static_cast<uint8_t>(l << 4);
  }
  std::memcpy(out + op, in + anchor, lit);
  op += lit;
  return op;
}

size_t dtpu_lz4_decompress(const uint8_t* in, size_t n, uint8_t* out,
                           size_t cap) {
  size_t ip = 0, op = 0;
  while (ip < n) {
    uint8_t tok = in[ip++];
    size_t lit = tok >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= n) return static_cast<size_t>(-1);
        b = in[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > n || op + lit > cap) return static_cast<size_t>(-1);
    if (ip + lit + 16 <= n && op + lit + 16 <= cap) {
      // wild copy: unconditional 16-byte chunks with slop margin
      for (size_t i = 0; i < lit; i += 16)
        std::memcpy(out + op + i, in + ip + i, 16);
    } else {
      std::memcpy(out + op, in + ip, lit);
    }
    ip += lit;
    op += lit;
    if (ip >= n) break;  // stream ends with a literal-only sequence
    if (ip + 2 > n) return static_cast<size_t>(-1);
    size_t off = in[ip] | (static_cast<size_t>(in[ip + 1]) << 8);
    ip += 2;
    if (off == 0 || off > op) return static_cast<size_t>(-1);
    size_t mlen = (tok & 0xF) + 4;
    if ((tok & 0xF) == 15) {
      uint8_t b;
      do {
        if (ip >= n) return static_cast<size_t>(-1);
        b = in[ip++];
        mlen += b;
      } while (b == 255);
    }
    if (op + mlen > cap) return static_cast<size_t>(-1);
    const uint8_t* src = out + op - off;
    uint8_t* dst = out + op;
    if (off >= 16 && op + mlen + 16 <= cap) {
      for (size_t i = 0; i < mlen; i += 16)
        std::memcpy(dst + i, src + i, 16);
    } else if (off >= mlen) {
      std::memcpy(dst, src, mlen);
    } else if (off >= 8 && op + mlen + 8 <= cap) {
      // overlapping but chunk-safe: each 8-byte block reads bytes
      // already written at least 8 positions back (may slop up to 7
      // bytes past mlen, bounds-checked against cap above)
      for (size_t i = 0; i < mlen; i += 8) std::memcpy(dst + i, src + i, 8);
    } else {
      // short-period replication (off < 8): byte-wise
      for (size_t i = 0; i < mlen; i++) dst[i] = src[i];
    }
    op += mlen;
  }
  return op;
}

}  // extern "C"
