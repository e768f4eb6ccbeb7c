"""Wire-format constants (the port's own copy).

These pin the wire format and must match the reference bit for bit;
they mirror the JAX package's `constants.py`: the block geometry of all
three codecs (`SPECS`, which `api.safe_encode_buffer_size` reads), their
flags, the decode-side dictionary ops of the grouping scans and the
sort keys' bias.

Hash: h = (quad *u32 0x9D6EF916) >> 16, a u16.
All multi-byte values are little-endian. Signature flags are packed
LSB-first: quad i of a block occupies bits [i w, (i + 1) w) of the
signature, w the codec's flag bits.
"""

from __future__ import annotations

import dataclasses

HASH_MULTIPLIER = 0x9D6EF916
HASH_BITS = 16
# the multiplier as a signed int32, for int32 tensor arithmetic (torch
# refuses a Python int above 2**31 - 1 as an int32 operand)
HASH_MULTIPLIER_I32 = HASH_MULTIPLIER - (1 << 32)

PLAIN_FLAG = 0x0  # shared by all codecs (reference: algorithms.rs:5)

CHAMELEON_FLAG_BITS = 1  # flag 0 plain, 1 map
CHAMELEON_MAP_FLAG = 0x1
CHAMELEON_SIG_BYTES = 8
CHAMELEON_BLOCK_SIZE = 256  # bytes; 64 quads/block
CHAMELEON_DECODE_UNIT = 8  # bytes out per decode unit (2 quads)

# cheetah (reference: cheetah.rs:18-24, 188-196)
CHEETAH_MAP_A_FLAG = 0x1
CHEETAH_MAP_B_FLAG = 0x2
CHEETAH_PREDICTED_FLAG = 0x3

# lion (reference: lion.rs:18-28, 317-325); predicted A-E are 1-5
LION_PREDICTED_A_FLAG = 0x1
LION_MAP_A_FLAG = 0x6
LION_MAP_B_FLAG = 0x7

# decode-side dictionary ops (`grouping.seg_sel2_before`): keep, swap
# the two slots, insert a constant
OP_ID, OP_SWAP, OP_INS = 0, 1, 2

# sort keys: the signed order of k ^ BIAS is the unsigned order of k
BIAS = -2**31


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Static geometry of one codec's wire format."""

    name: str
    flag_bits: int
    sig_bytes: int
    block_size: int
    decode_unit: int

    @property
    def quads_per_block(self) -> int:
        return self.block_size // 4

    @property
    def sig_words(self) -> int:
        """Signature size in u16 words."""
        return self.sig_bytes // 2

    def safe_encode_buffer_size(self, size: int) -> int:
        """Worst-case encoded size (reference: codec.rs:18-21)."""
        blocks = size // self.block_size
        extra = self.sig_bytes if size % self.block_size else 0
        return size + blocks * self.sig_bytes + extra


CHAMELEON = CodecSpec("chameleon", CHAMELEON_FLAG_BITS, CHAMELEON_SIG_BYTES,
                      CHAMELEON_BLOCK_SIZE, CHAMELEON_DECODE_UNIT)
CHEETAH = CodecSpec("cheetah", flag_bits=2, sig_bytes=8, block_size=128,
                    decode_unit=4)
LION = CodecSpec("lion", flag_bits=3, sig_bytes=6, block_size=64,
                 decode_unit=4)
SPECS = {"chameleon": CHAMELEON, "cheetah": CHEETAH, "lion": LION}


def hash_u16(quad: int) -> int:
    """Scalar hash helper (python ints)."""
    return ((quad * HASH_MULTIPLIER) & 0xFFFFFFFF) >> (32 - HASH_BITS)
