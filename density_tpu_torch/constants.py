"""Chameleon wire-format constants (the port's own copy).

These pin the wire format and must match the reference bit for bit;
they mirror the chameleon part of the JAX package's `constants.py`.

Hash: h = (quad *u32 0x9D6EF916) >> 16, a u16.
All multi-byte values are little-endian. Signature flags are packed
LSB-first: quad i of a block occupies bit i of the 64-bit signature.
"""

from __future__ import annotations

import dataclasses

HASH_MULTIPLIER = 0x9D6EF916
HASH_BITS = 16
# the multiplier as a signed int32, for int32 tensor arithmetic (torch
# refuses a Python int above 2**31 - 1 as an int32 operand)
HASH_MULTIPLIER_I32 = HASH_MULTIPLIER - (1 << 32)

CHAMELEON_FLAG_BITS = 1  # flag 0 plain, 1 map
CHAMELEON_SIG_BYTES = 8
CHAMELEON_BLOCK_SIZE = 256  # bytes; 64 quads/block


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Static geometry of one codec's wire format."""

    name: str
    flag_bits: int
    sig_bytes: int
    block_size: int

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
                      CHAMELEON_BLOCK_SIZE)


def hash_u16(quad: int) -> int:
    """Scalar hash helper (python ints)."""
    return ((quad * HASH_MULTIPLIER) & 0xFFFFFFFF) >> (32 - HASH_BITS)
